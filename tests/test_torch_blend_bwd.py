"""The port's blend backward (`BlendFunction`: the K3' twin
`blend_bwd_packed_torch` and the K4' twin `reduce_by_gid_torch` on the CPU)
vs `jax.grad` of the JAX package's blends.

Same scene as `tests/test_pallas_blend.py:42-54` (600 gaussians, 96x80,
SH 1, seed 3) and the same loss (`:69-88`); the tolerance is its max
relative error < 5e-5 per gradient (`:98-101`): the two sides sum the same
per-pixel terms in different orders. Both sides differentiate w.r.t. the
SAME screen quantities (JAX -> numpy -> torch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.core.types import make_render_settings
from gsplat_tpu.ops.binning import bin_gaussians
from gsplat_tpu.ops.projection import preprocess
from gsplat_tpu.ops.rasterize_jnp import blend_tiles_jnp
from gsplat_tpu.render import grid_dims
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import rasterize_cuda as rc
from gsplat_tpu_torch.ops.projection import ScreenGaussians
from gsplat_tpu_torch.ops.reduce import reduce_by_gid_torch
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_binning import to_port

REL = 5e-5
CAP = 1 << 14
FIELDS = ("mean2d", "conic", "opacity", "rgb", "depth")


def build(n=600, width=96, height=80, seed=3):
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width, height=height,
                         sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    settings = make_render_settings(sh_degree=1, max_per_tile=1024, instance_capacity=CAP)
    gx, gy = grid_dims(camera, 16)
    js = jax.jit(lambda p, a: preprocess(p, a, camera, settings, gx, gy))(params, alive)
    rng = np.random.default_rng(0)
    tgt = rng.random((gx * gy, 256, 3)).astype(np.float32)
    wd = rng.random((gx * gy, 256)).astype(np.float32)
    return js, gx, gy, tgt, wd


def jax_grads(js, gx, gy, tgt, wd, blend):
    def f(mean2d, conic, opacity, rgb, depth):
        s2 = js.replace(mean2d=mean2d, conic=conic, opacity=opacity, rgb=rgb, depth=depth)
        out = blend(s2)
        return (jnp.sum((out.color - tgt) ** 2) + jnp.sum(out.invdepth * wd)
                + jnp.sum(out.final_t * 0.3))

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(getattr(js, k) for k in FIELDS))


def port_grads(js, gx, gy, tgt, wd, packet_dtype="float32"):
    ts = to_port(js)
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in FIELDS}
    screen = ScreenGaussians(**{**{f: getattr(ts, f) for f in (
        "radius", "cull_qmax", "rect_min", "rect_max", "tiles_touched", "mask")}, **leaves})
    pb = tb.pack_bins(screen, gx, gy, packet_dtype=packet_dtype)
    out = rc.blend_tiles_cuda(screen, pb, gx, gy, reduce_pack=packet_dtype == "hybrid")
    loss = (((out.color - torch.from_numpy(tgt)) ** 2).sum()
            + (out.invdepth * torch.from_numpy(wd)).sum() + (out.final_t * 0.3).sum())
    loss.backward()
    return [leaves[k].grad for k in FIELDS], pb


def assert_grads_close(want, got):
    for name, a, b in zip(FIELDS, want, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, name
        rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-8)
        assert rel < REL, f"{name}: max rel err {rel}"


def test_blend_function_grads_match_jax_grad_jnp():
    js, gx, gy, tgt, wd = build()
    jbins = bin_gaussians(js, gx, gy, CAP)
    want = jax_grads(js, gx, gy, tgt, wd,
                     lambda s: blend_tiles_jnp(s, jbins, gx, gy, 16, 1024, 128))
    got, pb = port_grads(js, gx, gy, tgt, wd)
    assert pb.num_instances > 1000
    assert float(np.abs(np.asarray(want[0])).max()) > 0
    assert_grads_close(want, got)


def hybrid_bounds(js, gx, gy, tgt, wd):
    """Per gaussian, the sum over its instances of |gradient row| of this
    file's loss on hybrid packets, in the layout of `FIELDS` (d invz
    chained to d depth): what bf16 rounding of the rows can move."""
    ts = to_port(js)
    pb = tb.pack_bins(ts, gx, gy, packet_dtype="hybrid")
    args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    fwd = rc.blend_packed_torch(*args)
    dout = torch.zeros_like(fwd)
    dout[..., :3] = 2.0 * (fwd[..., :3] - torch.from_numpy(tgt))
    dout[..., 3] = torch.from_numpy(wd)
    dout[..., 4] = 0.3
    rows = rc.blend_bwd_packed_torch(*args, fwd, dout)
    absum = reduce_by_gid_torch(rows.abs(), pb.gauss_id, ts.depth.shape[0])
    depth = ts.depth
    dinvz_ddepth = torch.where(depth > 0.2, 1.0 / (depth * depth), torch.zeros_like(depth))
    bounds = (absum[0:2].T, absum[2:5].T, absum[5], absum[6:9].T, absum[9] * dinvz_ddepth)
    return fwd, [b.numpy() for b in bounds]


def assert_grads_within(want, got, bounds, ulps):
    """|got - want| <= ulps * 2^-8 * bound + REL * max|want| per entry
    (2^-8 is bf16's unit roundoff)."""
    for name, a, b, bnd in zip(FIELDS, want, got, bounds):
        a = np.asarray(a)
        err = np.abs(a - b.numpy())
        lim = ulps * 2.0**-8 * bnd + REL * np.abs(a).max()
        assert (err <= lim).all(), f"{name}: worst err/limit {(err / lim).max()}"


def test_blend_function_hybrid_matches_jax_grad_on_rounded_screen():
    """Hybrid packets through the Function. The forward blends the bf16
    rounded conic, opacity and rgb, so it equals the JAX blend of a screen
    rounded the same way (atol 2e-5, the forward tolerance of
    `test_torch_blend.py`). The backward rounds each per-instance gradient
    row to bf16 (relative error <= 2^-8) before the sum, so each gradient
    entry is within 2^-8 of the sum of its instances' |rows| of `jax.grad`
    at that screen, plus the float32 tolerance (5e-5 of the largest
    entry); and it differs from the float32 Function's."""
    js, gx, gy, tgt, wd = build()
    bf = lambda x: x.astype(jnp.bfloat16).astype(jnp.float32)
    jr = js.replace(conic=bf(js.conic), opacity=bf(js.opacity), rgb=bf(js.rgb))
    jbins = bin_gaussians(js, gx, gy, CAP)
    blend = lambda s: blend_tiles_jnp(s, jbins, gx, gy, 16, 1024, 128)
    want = jax_grads(jr, gx, gy, tgt, wd, blend)
    jout = blend(jr)

    fwd, bounds = hybrid_bounds(js, gx, gy, tgt, wd)
    np.testing.assert_allclose(fwd[..., :3].numpy(), np.asarray(jout.color), atol=2e-5)
    np.testing.assert_allclose(fwd[..., 4].numpy(), np.asarray(jout.final_t), atol=2e-5)
    got, _ = port_grads(js, gx, gy, tgt, wd, packet_dtype="hybrid")
    assert_grads_within(want, got, bounds, 1)
    f32, _ = port_grads(js, gx, gy, tgt, wd)
    assert all(not torch.equal(b, c) for b, c in zip(got, f32))


def test_blend_bwd_twin_rows_and_reduce():
    """The twin's rows reduced per gaussian equal the Function's gradients
    (d conic in the true basis, d invz chained to d depth), rows of
    instances past every pixel's stop are zero, and a NaN conic or opacity
    row, which the forward drops, gets zero gradient rows."""
    js, gx, gy, tgt, wd = build()
    pb = tb.pack_bins(to_port(js), gx, gy)
    args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    fwd = rc.blend_packed_torch(*args)
    dout = torch.from_numpy(np.random.default_rng(1).normal(size=fwd.shape).astype(np.float32))
    rows = rc.blend_bwd_packed_torch(*args, fwd, dout)
    assert rows.shape == (10, pb.num_instances) and torch.isfinite(rows).all()
    assert (rows.abs().sum(0) > 0).float().mean() > 0.5

    nan_t = pb.inst_t.clone()
    nan_t[2, ::7] = float("nan")
    nan_t[5, 3::11] = float("nan")
    nan_fwd = rc.blend_packed_torch(nan_t, *args[1:])
    nan_rows = rc.blend_bwd_packed_torch(nan_t, *args[1:], nan_fwd, dout)
    assert torch.isfinite(nan_rows).all()
    assert (nan_rows[:, ::7] == 0).all() and (nan_rows[:, 3::11] == 0).all()


def test_blend_bwd_wrapper_refuses_cpu_tensors():
    js, gx, gy, _, _ = build(n=100)
    pb = tb.pack_bins(to_port(js), gx, gy)
    fwd = torch.zeros((gx * gy, 256, 8))
    with pytest.raises(ValueError, match="CUDA"):
        rc.blend_bwd(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy, fwd, fwd)
    assert rc.blend_bwd.launches == 0


@pytest.mark.slow
@pytest.mark.parametrize("packet_dtype", ["float32", "hybrid"])
def test_blend_function_grads_match_pallas_interpret(packet_dtype):
    """Against the JAX package's production backward: Pallas K3 and K4 in
    interpret mode, on instances packed by its own `pack_bins` (K1). In
    hybrid mode both sides round each per-instance gradient row to bf16;
    rows whose float32 sums differ in the last bits can round to
    neighbouring bf16 values (one ulp, 2^-7 of the row), so each entry is
    held within 2^-7 of the sum of its instances' |rows|."""
    import types

    from jax.experimental import pallas as pl

    import gsplat_tpu.ops.rasterize_pallas as rp
    from gsplat_tpu.ops.binning import pack_bins as j_pack_bins

    orig = pl.pallas_call
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    saved, rp.pl = rp.pl, shim
    try:
        js, gx, gy, tgt, wd = build()
        hybrid = packet_dtype == "hybrid"
        jp = j_pack_bins(js, gx, gy, CAP, packet_dtype="hybrid" if hybrid else jnp.float32)
        want = jax_grads(js, gx, gy, tgt, wd,
                         lambda s: rp.blend_tiles_pallas(s, jp, gx, gy, 16, reduce_pack=hybrid))
    finally:
        rp.pl = saved
    got, _ = port_grads(js, gx, gy, tgt, wd, packet_dtype=packet_dtype)
    if hybrid:
        assert_grads_within(want, got, hybrid_bounds(js, gx, gy, tgt, wd)[1], 2)
    else:
        assert_grads_close(want, got)
