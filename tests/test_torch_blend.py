"""Port blend (`blend_packed_torch`, `blend_tiles_torch`, `blend_tiles_cuda`
on the CPU) vs the JAX package's `blend_tiles_jnp`.

Tolerance atol 2e-5 with n_contrib exact, as `tests/test_pallas_blend.py:
57-66` holds the Pallas kernel to the jnp oracle: the recurrences multiply
the same float32 factors in a different order (per instance here, a cumprod
tree there). Both sides blend the SAME screen quantities (JAX -> numpy ->
torch) and the same instance lists.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.core.types import make_render_settings
from gsplat_tpu.ops.binning import bin_gaussians
from gsplat_tpu.ops.projection import preprocess
from gsplat_tpu.ops.rasterize_jnp import blend_tiles_jnp, blend_tiles_oit_jnp
from gsplat_tpu.render import grid_dims
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops.rasterize_cuda import blend_packed_torch, blend_tiles_cuda
from gsplat_tpu_torch.ops.rasterize_torch import blend_tiles_torch
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_binning import to_port

ATOL = 2e-5
CAP = 1 << 14


def build(n=600, width=96, height=80, seed=3, empty=False, oit=False):
    """The port's screen, the JAX blend's output (the OIT oracle's with
    `oit`) and the grid."""
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width,
                         height=height, sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    if empty:
        alive = jnp.zeros_like(alive)
    settings = make_render_settings(sh_degree=1, instance_capacity=CAP)
    gx, gy = grid_dims(camera, 16)

    @jax.jit
    def jax_side(params, alive):
        js = preprocess(params, alive, camera, settings, gx, gy)
        jbins = bin_gaussians(js, gx, gy, CAP)
        blend = blend_tiles_oit_jnp if oit else blend_tiles_jnp
        return js, jbins, blend(js, jbins, gx, gy, 16, 1024, 128)

    js, jbins, oj = jax_side(params, alive)
    assert int(jbins.overflow) == 0
    assert int(oj.overflow) == 0
    return to_port(js), oj, gx, gy


def assert_matches(color, invdepth, final_t, n_contrib, oj):
    np.testing.assert_allclose(color, np.asarray(oj.color), atol=ATOL)
    np.testing.assert_allclose(invdepth, np.asarray(oj.invdepth), atol=ATOL)
    np.testing.assert_allclose(final_t, np.asarray(oj.final_t), atol=ATOL)
    np.testing.assert_array_equal(n_contrib, np.asarray(oj.n_contrib))


@pytest.mark.parametrize("width,height", [(96, 80), (200, 120), (72, 40)])
def test_blend_packed_torch_matches_jnp(width, height):
    """Also covers sizes that are not a multiple of 16 (padded edge tiles)."""
    ts, oj, gx, gy = build(width=width, height=height)
    pb = tb.pack_bins(ts, gx, gy)
    out = blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy, track_contrib=True)
    assert out.shape == (gx * gy, 256, 8) and out.dtype == torch.float32
    assert_matches(out[..., 0:3].numpy(), out[..., 3].numpy(), out[..., 4].numpy(),
                   out[..., 5].numpy().astype(np.int32), oj)
    assert np.all(out[..., 6:8].numpy() == 0)
    off = blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    assert np.all(off[..., 5].numpy() == 0)
    np.testing.assert_array_equal(off[..., :5].numpy(), out[..., :5].numpy())


def test_blend_tiles_cuda_on_cpu_is_the_plain_twin():
    ts, oj, gx, gy = build()
    pb = tb.pack_bins(ts, gx, gy)
    o = blend_tiles_cuda(ts, pb, gx, gy, 16, track_contrib=True)
    assert_matches(o.color.numpy(), o.invdepth.numpy(), o.final_t.numpy(),
                   o.n_contrib.numpy(), oj)
    # the OIT mode: the K5' twin's raw sums and the quotient, against the
    # JAX OIT oracle at its Pallas kernels' tolerance (atol 3e-5)
    ts, oj_oit, gx, gy = build(oit=True)
    pb = tb.pack_bins(ts, gx, gy)
    o = blend_tiles_cuda(ts, pb, gx, gy, 16, track_contrib=True, blend_mode="oit")
    for f in ("color", "invdepth", "final_t"):
        np.testing.assert_allclose(getattr(o, f).numpy(), np.asarray(getattr(oj_oit, f)),
                                   atol=3e-5, err_msg=f)
    assert not o.n_contrib.any()


def test_blend_tiles_torch_matches_jnp():
    ts, oj, gx, gy = build()
    tbins = tb.bin_gaussians(ts, gx, gy)
    o = blend_tiles_torch(ts, tbins, gx, gy, 16, 1024, 128)
    assert o.overflow == 0
    assert_matches(o.color.numpy(), o.invdepth.numpy(), o.final_t.numpy(),
                   o.n_contrib.numpy(), oj)


def test_empty_scene_blends_to_background():
    ts, oj, gx, gy = build(n=16, empty=True)
    pb = tb.pack_bins(ts, gx, gy)
    assert pb.num_instances == 0
    out = blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy, track_contrib=True)
    assert np.all(out[..., 0:4].numpy() == 0) and np.all(out[..., 4].numpy() == 1.0)
    assert np.all(out[..., 5].numpy() == 0)
    assert_matches(out[..., 0:3].numpy(), out[..., 3].numpy(), out[..., 4].numpy(),
                   out[..., 5].numpy().astype(np.int32), oj)


def test_nan_conic_or_opacity_drops_the_pair():
    """The keep rule (power <= 0, alpha >= 1/255) is false for NaN: such an
    instance blends as one of opacity 0, which the keep rule also drops."""
    ts, _, gx, gy = build()
    pb = tb.pack_bins(ts, gx, gy)
    nan_t, zero_t = pb.inst_t.clone(), pb.inst_t.clone()
    nan_t[2, ::7] = float("nan")
    nan_t[5, 3::11] = float("nan")
    zero_t[5, ::7] = 0.0
    zero_t[5, 3::11] = 0.0
    got = blend_packed_torch(nan_t, pb.tile_start, pb.tile_end, gx, gy, track_contrib=True)
    want = blend_packed_torch(zero_t, pb.tile_start, pb.tile_end, gx, gy, track_contrib=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_count_pairs_counts_the_walk():
    """Pairs walked per pixel = instances up to and including the stopping
    one; a pixel that never saturates walks its whole range."""
    ts, _, gx, gy = build()
    pb = tb.pack_bins(ts, gx, gy)
    out, pairs = blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy,
                                    count_pairs=True)
    lengths = (pb.tile_end - pb.tile_start).numpy()
    assert 0 < pairs <= int(lengths.sum()) * 256
    saturated = out[..., 4].numpy() < 1e-3
    if not saturated.any():
        assert pairs == int(lengths.sum()) * 256


@pytest.mark.slow
def test_blend_packed_torch_matches_pallas_interpret():
    """Against the JAX package's production blend: Pallas kernel K2 in
    interpret mode, fed by its own `pack_bins` (kernel K1)."""
    import gsplat_tpu.ops.rasterize_pallas as rp
    from gsplat_tpu.ops.binning import pack_bins as j_pack_bins

    sc = make_test_scene(np.random.default_rng(3), n=600, width=96, height=80, sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    settings = make_render_settings(sh_degree=1, instance_capacity=CAP)
    gx, gy = grid_dims(camera, 16)
    js = jax.jit(lambda p, a: preprocess(p, a, camera, settings, gx, gy))(params, alive)
    jp = j_pack_bins(js, gx, gy, CAP)
    op = rp.blend_tiles_pallas(js, jp, gx, gy, 16, track_contrib=True)
    pb = tb.pack_bins(to_port(js), gx, gy)
    out = blend_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy, track_contrib=True)
    assert_matches(out[..., 0:3].numpy(), out[..., 3].numpy(), out[..., 4].numpy(),
                   out[..., 5].numpy().astype(np.int32), op)
