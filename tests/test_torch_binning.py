"""Port binning vs the JAX package, both fed the SAME screen quantities.

The JAX `ScreenGaussians` goes to the port through numpy, so no ulp of
preprocess enters. With zero overflow on the JAX side, the two `pack_bins`
must agree exactly, as `tests/test_pack_bins.py:46-79` asks of the JAX
package's own two paths: same per-tile ranges, same instance order
(tile, depth bits, gid), and instance tables equal bit for bit. The JAX
`pack_bins` runs its Pallas expand kernel in interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.core.types import make_render_settings
from gsplat_tpu.ops import binning as jb
from gsplat_tpu.ops.projection import preprocess
from gsplat_tpu.render import grid_dims
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops.projection import ScreenGaussians
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs

CAP = 1 << 15


def screen_pair(seed, n, tight_cull, width=160, height=112):
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width,
                         height=height, sh_degree=2)
    params, camera, alive = scene_to_inputs(sc)
    settings = make_render_settings(sh_degree=2, instance_capacity=CAP,
                                    tight_cull=tight_cull)
    gx, gy = grid_dims(camera, 16)
    js = jax.jit(lambda p, a: preprocess(p, a, camera, settings, gx, gy))(params, alive)
    ts = to_port(js)
    return js, ts, gx, gy


def to_port(js) -> ScreenGaussians:
    return ScreenGaussians(**{
        f: torch.from_numpy(np.array(getattr(js, f))) for f in (
            "mean2d", "conic", "opacity", "rgb", "depth", "radius", "cull_qmax",
            "rect_min", "rect_max", "tiles_touched", "mask")
    })


def assert_packed_equal(tp, jp, gx, gy):
    assert int(jp.overflow) == 0
    k = int(jp.num_instances)
    assert tp.num_instances == k and tp.overflow == 0
    np.testing.assert_array_equal(tp.tile_start.numpy(), np.asarray(jp.tile_start))
    np.testing.assert_array_equal(tp.tile_end.numpy(), np.asarray(jp.tile_end))
    # the JAX buffer is padded to its capacity; its first K slots are valid
    jt = np.asarray(jp.tile_id)
    assert np.all(jt[:k] < gx * gy) and np.all(jt[k:] == gx * gy)
    np.testing.assert_array_equal(tp.tile_id.numpy(), jt[:k])
    np.testing.assert_array_equal(tp.gauss_id.numpy(), np.asarray(jp.gauss_id)[:k])
    assert tp.inst_t.shape == (16, k) and tp.inst_t.dtype == torch.float32
    np.testing.assert_array_equal(tp.inst_t.numpy(), np.asarray(jp.inst_t)[:, :k])


@pytest.mark.parametrize("seed,n,tight_cull", [(3, 1500, True), (7, 1500, False)])
def test_pack_bins_matches_jax(seed, n, tight_cull):
    js, ts, gx, gy = screen_pair(seed, n, tight_cull)
    jp = jax.jit(lambda s: jb.pack_bins(s, gx, gy, CAP, 16, tight_cull=tight_cull))(js)
    tp = tb.pack_bins(ts, gx, gy, 16, tight_cull=tight_cull)
    assert tp.num_instances > 1000
    assert_packed_equal(tp, jp, gx, gy)


@pytest.mark.parametrize("seed,tight_cull", [(3, True), (7, False)])
def test_pack_bins_hybrid_matches_jax(seed, tight_cull):
    """Hybrid packets (the training default): the folded conic, opacity and
    rgb rows rounded to bf16, mean2d and invz exact. Bit for bit equal to
    the JAX package's bf16 pair packing on the live slots."""
    js, ts, gx, gy = screen_pair(seed, 1500, tight_cull)
    jp = jax.jit(lambda s: jb.pack_bins(s, gx, gy, CAP, 16, tight_cull=tight_cull,
                                        packet_dtype="hybrid"))(js)
    tp = tb.pack_bins(ts, gx, gy, 16, tight_cull=tight_cull, packet_dtype="hybrid")
    assert_packed_equal(tp, jp, gx, gy)
    f32 = tb.pack_bins(ts, gx, gy, 16, tight_cull=tight_cull)
    rows = tp.inst_t.numpy()
    np.testing.assert_array_equal(rows[[0, 1, 9]], f32.inst_t.numpy()[[0, 1, 9]])
    assert (rows[2:9] != f32.inst_t.numpy()[2:9]).mean() > 0.9  # rounded
    assert not (rows[2:9].view(np.uint32) & 0xFFFF).any()  # on the bf16 grid
    # all-bf16 packets round rows 2-8 as hybrid does and mean2d and invz too
    bf = tb.pack_bins(ts, gx, gy, 16, tight_cull=tight_cull, packet_dtype="bfloat16")
    np.testing.assert_array_equal(bf.inst_t.numpy()[2:9], rows[2:9])
    np.testing.assert_array_equal(bf.inst_t[[0, 1, 9]].numpy(),
                                  tb.round_bf16(f32.inst_t[[0, 1, 9]]).numpy())


@pytest.mark.parametrize("seed,tight_cull", [(3, True), (7, False)])
def test_pack_bins_bf16_matches_jax(seed, tight_cull):
    """All-bf16 packets: all ten rows rounded to bf16 (invz computed in
    float32 first), stored as float32. Bit for bit equal to the JAX
    package's bf16 table cast to float32 on the live slots."""
    js, ts, gx, gy = screen_pair(seed, 1500, tight_cull)
    jp = jax.jit(lambda s: jb.pack_bins(s, gx, gy, CAP, 16, tight_cull=tight_cull,
                                        packet_dtype=jnp.bfloat16))(js)
    assert jp.inst_t.dtype == jnp.bfloat16
    jp = jp.replace(inst_t=jp.inst_t.astype(jnp.float32))
    tp = tb.pack_bins(ts, gx, gy, 16, tight_cull=tight_cull, packet_dtype="bfloat16")
    assert_packed_equal(tp, jp, gx, gy)
    assert not (tp.inst_t.numpy()[:10].view(np.uint32) & 0xFFFF).any()
    with pytest.raises(ValueError, match="packet_dtype"):
        tb.pack_bins(ts, gx, gy, 16, packet_dtype="float16")


def test_pack_bins_empty_scene_matches_jax():
    js, _, gx, gy = screen_pair(1, 64, True)
    js = js.replace(tiles_touched=jnp.zeros_like(js.tiles_touched),
                    mask=jnp.zeros_like(js.mask))
    jp = jax.jit(lambda s: jb.pack_bins(s, gx, gy, 1 << 10, 16))(js)
    tp = tb.pack_bins(to_port(js), gx, gy, 16)
    assert tp.num_instances == 0 and tp.inst_t.shape == (16, 0)
    assert_packed_equal(tp, jp, gx, gy)


@pytest.mark.parametrize("tight_cull", [True, False])
def test_bin_gaussians_and_row_runs_match_jax(tight_cull):
    """The plain reference `bin_gaussians` (the JAX two-sort algorithm) and
    `compute_row_runs` equal the JAX package's, and the port's `pack_bins`
    gives the same instance order as its own `bin_gaussians`."""
    js, ts, gx, gy = screen_pair(11, 1500, tight_cull)
    for got, want in zip(tb.compute_row_runs(ts, 16, tight_cull),
                         jb.compute_row_runs(js, 16, tight_cull)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jbins = jax.jit(lambda s: jb.bin_gaussians(s, gx, gy, CAP, 16, tight_cull=tight_cull))(js)
    tbins = tb.bin_gaussians(ts, gx, gy, 16, tight_cull=tight_cull)
    k = int(jbins.num_instances)
    assert tbins.num_instances == k and int(jbins.overflow) == 0
    for f in ("tile_start", "tile_end"):
        np.testing.assert_array_equal(getattr(tbins, f).numpy(), np.asarray(getattr(jbins, f)))
    for f in ("tile_id", "gauss_id"):
        np.testing.assert_array_equal(getattr(tbins, f).numpy(), np.asarray(getattr(jbins, f))[:k])
    tp = tb.pack_bins(ts, gx, gy, 16, tight_cull=tight_cull)
    np.testing.assert_array_equal(tp.gauss_id.numpy(), tbins.gauss_id.numpy())
    np.testing.assert_array_equal(tp.tile_start.numpy(), tbins.tile_start.numpy())


def test_conic_box_qmin_matches_jax():
    rng = np.random.default_rng(4)
    m = 512
    mx, my = (rng.uniform(-20, 60, m).astype(np.float32) for _ in range(2))
    a = rng.uniform(0.01, 1.0, m).astype(np.float32)
    c = rng.uniform(0.01, 1.0, m).astype(np.float32)
    b = (rng.uniform(-0.9, 0.9, m) * np.sqrt(a * c)).astype(np.float32)
    x0, y0 = (rng.integers(0, 4, m).astype(np.float32) * 16 for _ in range(2))
    args = (mx, my, a, b, c, x0, y0)
    got = tb._conic_box_qmin(*(torch.from_numpy(v) for v in args), 16.0)
    want = jb._conic_box_qmin(*(jnp.asarray(v) for v in args), 16.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_bins_cuda_wrappers_refuse_cpu_tensors():
    _, ts, gx, gy = screen_pair(3, 200, True)
    tables = tb._emission_tables(ts, 16, True)
    with pytest.raises(ValueError, match="CUDA"):
        tb.expand_instances(*tables[:5], ts.depth, tables[5], gx, True)
    assert tb.expand_instances.launches == 0
