"""The port's OIT blend mode and all-bf16 packets vs the JAX package.

OIT (`blend_mode="oit"`): the K5' twin `blend_oit_packed_torch` plus the
quotient (`blend_tiles_cuda` on the CPU), the oracle-level
`blend_tiles_oit_torch`, and the gradients through `OITBlendFunction` (the
K6' twin `blend_oit_bwd_packed_torch` and the K4' twin) against
`blend_tiles_oit_jnp` and `jax.grad` of it; then `render()` and one train
step against the JAX package with `backend="jnp"`. Tolerances are the JAX
package's own for its Pallas OIT kernels (`tests/test_pallas_blend.py:
526-627`): atol 3e-5 on the forward (per-pixel sums in another order), max
relative error 5e-5 per gradient, atol 5e-5 between OIT and the sorted
blend where splats do not overlap.

bf16 packets (`packet_dtype="bfloat16"`): the blend stays within the JAX
package's bounds of the float32 blend (`test_pallas_blend.py:143-160`), and
the backward rounds its gradient rows to bf16 before the reduce. The
table's bit equality with the JAX `pack_bins` is in `test_torch_binning.py`.

Both sides get the SAME screen quantities (JAX -> numpy -> torch).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.config import OptimizationConfig as JOpt
from gsplat_tpu.core.types import make_render_settings
from gsplat_tpu.ops.binning import bin_gaussians
from gsplat_tpu.ops.projection import preprocess
from gsplat_tpu.ops.rasterize_jnp import blend_tiles_oit_jnp
from gsplat_tpu.render import grid_dims
from gsplat_tpu.render import render as j_render
from gsplat_tpu.train import step as jstep
from gsplat_tpu_torch.config import OptimizationConfig as TOpt
from gsplat_tpu_torch.convert import PARAM_FIELDS, train_state_from_numpy
from gsplat_tpu_torch.core.types import make_render_settings as t_settings
from gsplat_tpu_torch.ops import binning as tb
from gsplat_tpu_torch.ops import rasterize_cuda as rc
from gsplat_tpu_torch.ops.projection import ScreenGaussians
from gsplat_tpu_torch.ops.rasterize_torch import blend_tiles_oit_torch
from gsplat_tpu_torch.ops.reduce import reduce_by_gid_torch
from gsplat_tpu_torch.render import render as t_render
from gsplat_tpu_torch.train import step as tstep
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_binning import to_port
from tests.test_torch_blend_bwd import FIELDS, assert_grads_close, assert_grads_within, jax_grads
from tests.test_torch_projection import port_inputs
from tests.test_torch_train_step import jax_state_to_numpy, rel_err, run_jax_step, step_inputs

ATOL = 3e-5
REL = 5e-5
CAP = 1 << 14


def build(n=600, width=96, height=80, seed=3, empty=False):
    """The JAX screen, its bins and the JAX OIT oracle's output."""
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width, height=height,
                         sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    if empty:
        alive = jnp.zeros_like(alive)
    settings = make_render_settings(sh_degree=1, instance_capacity=CAP)
    gx, gy = grid_dims(camera, 16)

    @jax.jit
    def jax_side(params, alive):
        js = preprocess(params, alive, camera, settings, gx, gy)
        jbins = bin_gaussians(js, gx, gy, CAP)
        return js, jbins, blend_tiles_oit_jnp(js, jbins, gx, gy, 16, 1024, 128)

    js, jbins, oj = jax_side(params, alive)
    assert int(jbins.overflow) == 0 and int(oj.overflow) == 0
    return js, jbins, oj, gx, gy


def assert_blend_close(o, oj, atol=ATOL):
    for f in ("color", "invdepth", "final_t"):
        np.testing.assert_allclose(getattr(o, f).detach().numpy(), np.asarray(getattr(oj, f)),
                                   atol=atol, err_msg=f)
    assert not o.n_contrib.any()


def leaf_screen(js):
    """The port's screen of `js` with its `FIELDS` as fresh autograd leaves."""
    ts = to_port(js)
    leaves = {k: getattr(ts, k).clone().requires_grad_(True) for k in FIELDS}
    return ScreenGaussians(**{**vars(ts), **leaves}), leaves


def grads_and_bins(js, gx, gy, tgt, wd, packet_dtype="float32"):
    """Gradients of `jax_grads`' loss through `blend_tiles_cuda(blend_mode=
    "oit")` on the CPU, w.r.t. the screen arrays of `FIELDS`."""
    screen, leaves = leaf_screen(js)
    pb = tb.pack_bins(screen, gx, gy, packet_dtype=packet_dtype)
    out = rc.blend_tiles_cuda(screen, pb, gx, gy, blend_mode="oit",
                              reduce_pack=packet_dtype != "float32")
    loss = (((out.color - torch.from_numpy(tgt)) ** 2).sum()
            + (out.invdepth * torch.from_numpy(wd)).sum() + (out.final_t * 0.3).sum())
    loss.backward()
    return [leaves[k].grad for k in FIELDS], pb


def loss_inputs(gx, gy):
    rng = np.random.default_rng(0)
    return (rng.random((gx * gy, 256, 3)).astype(np.float32),
            rng.random((gx * gy, 256)).astype(np.float32))


@pytest.mark.parametrize("width,height", [(96, 80), (200, 120), (72, 40)])
def test_blend_oit_packed_torch_matches_jnp(width, height):
    """The K5' twin's raw sums, with the quotient of `blend_tiles_cuda`.
    Also covers sizes that are not a multiple of 16 (padded edge tiles)."""
    js, _, oj, gx, gy = build(width=width, height=height)
    ts = to_port(js)
    pb = tb.pack_bins(ts, gx, gy)
    raw, evaluated, kept = rc.blend_oit_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end,
                                                     gx, gy, count_pairs=True)
    assert raw.shape == (gx * gy, 256, 8) and raw.dtype == torch.float32
    assert not raw[..., 6:8].any()
    assert (raw[..., 5] > 0).all() and (raw[..., 5] <= 1).all()
    assert evaluated == pb.num_instances * 256 and 0 < kept < evaluated
    o = rc.blend_tiles_cuda(ts, pb, gx, gy, 16, blend_mode="oit")
    assert_blend_close(o, oj)
    np.testing.assert_array_equal(o.final_t.numpy(), raw[..., 5].numpy())


@pytest.mark.parametrize("width,height", [(96, 80), (200, 120), (72, 40)])
def test_blend_tiles_oit_torch_matches_jnp(width, height):
    js, _, oj, gx, gy = build(width=width, height=height)
    ts = to_port(js)
    o = blend_tiles_oit_torch(ts, tb.bin_gaussians(ts, gx, gy), gx, gy, 16, 1024, 128)
    assert o.overflow == 0
    assert_blend_close(o, oj)


def test_oit_empty_scene_is_background_with_zero_gradients():
    """No instance: D = 0 and 1 - T = 0 at every pixel, so the clamped
    quotient gives color 0, and the gradients are zero, not NaN."""
    js, _, oj, gx, gy = build(n=16, empty=True)
    screen, leaves = leaf_screen(js)
    pb = tb.pack_bins(screen, gx, gy)
    assert pb.num_instances == 0
    raw = rc.blend_oit_packed_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    assert not raw[..., 0:5].any() and (raw[..., 5] == 1).all()
    o = rc.blend_tiles_cuda(screen, pb, gx, gy, 16, blend_mode="oit")
    assert not o.color.any() and not o.invdepth.any() and (o.final_t == 1).all()
    assert_blend_close(o, oj)
    (o.color.sum() + o.invdepth.sum() + o.final_t.sum()).backward()
    for k in FIELDS:
        assert torch.isfinite(leaves[k].grad).all() and not leaves[k].grad.any(), k


def test_oit_equals_sorted_without_overlap():
    """Where no two splats share a pixel, OIT equals the sorted blend
    (`test_pallas_blend.py:586-627`): 24 tiny round splats on a 16 px grid."""
    js, _, _, gx, gy = build(n=24, seed=12)
    ts = to_port(js)
    n = ts.depth.shape[0]
    mean2d = torch.stack([(torch.arange(n) % 6) * 16.0 + 8.0,
                          torch.div(torch.arange(n), 6, rounding_mode="floor") * 16.0 + 8.0], -1)
    r = 8
    rect_min = torch.stack([torch.div(mean2d[:, 0] - r, 16, rounding_mode="floor"),
                            torch.div(mean2d[:, 1] - r, 16, rounding_mode="floor")], -1)
    rect_max = torch.stack([torch.div(mean2d[:, 0] + r, 16, rounding_mode="floor") + 1,
                            torch.div(mean2d[:, 1] + r, 16, rounding_mode="floor") + 1], -1)
    grid = torch.tensor([gx, gy])
    rect_min = torch.minimum(torch.clamp(rect_min, min=0), grid - 1).to(torch.int32)
    rect_max = torch.minimum(torch.clamp(rect_max, min=1), grid).to(torch.int32)
    tiles = (rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1])
    screen = ScreenGaussians(**{**{f: getattr(ts, f) for f in (
        "opacity", "rgb", "depth", "radius")},
        "mean2d": mean2d.to(torch.float32),
        "conic": torch.tensor([2.0, 0.0, 2.0]).expand(n, 3).contiguous(),
        "rect_min": rect_min, "rect_max": rect_max, "tiles_touched": tiles.to(torch.int32),
        "mask": torch.ones(n, dtype=torch.bool), "cull_qmax": torch.full((n,), 1e9)})
    pb = tb.pack_bins(screen, gx, gy)
    assert pb.num_instances >= n
    srt = rc.blend_tiles_cuda(screen, pb, gx, gy, 16)
    oit = rc.blend_tiles_cuda(screen, pb, gx, gy, 16, blend_mode="oit")
    np.testing.assert_allclose(oit.color.numpy(), srt.color.numpy(), atol=5e-5)
    np.testing.assert_allclose(oit.final_t.numpy(), srt.final_t.numpy(), atol=5e-5)
    assert (oit.final_t < 0.5).any()  # the splats are there


def test_oit_function_grads_match_jax_grad_jnp():
    js, jbins, _, gx, gy = build()
    tgt, wd = loss_inputs(gx, gy)
    want = jax_grads(js, gx, gy, tgt, wd,
                     lambda s: blend_tiles_oit_jnp(s, jbins, gx, gy, 16, 1024, 128))
    got, pb = grads_and_bins(js, gx, gy, tgt, wd)
    assert pb.num_instances > 1000
    assert all(float(np.abs(np.asarray(w)).max()) > 0 for w in want)
    assert_grads_close(want, got)


def test_blend_tiles_oit_torch_grads_match_jax_grad_jnp():
    """Autograd through the oracle-level twin, straight-through clamp
    included, against `jax.grad` through the JAX oracle."""
    js, jbins, _, gx, gy = build()
    tgt, wd = loss_inputs(gx, gy)
    want = jax_grads(js, gx, gy, tgt, wd,
                     lambda s: blend_tiles_oit_jnp(s, jbins, gx, gy, 16, 1024, 128))
    screen, leaves = leaf_screen(js)
    out = blend_tiles_oit_torch(screen, tb.bin_gaussians(screen, gx, gy), gx, gy, 16, 1024, 128)
    (((out.color - torch.from_numpy(tgt)) ** 2).sum() + (out.invdepth * torch.from_numpy(wd)).sum()
     + (out.final_t * 0.3).sum()).backward()
    assert_grads_close(want, [leaves[k].grad for k in FIELDS])


def test_oit_bwd_twin_rows():
    """The K6' twin's rows are finite and mostly non-zero; a NaN conic or
    opacity row, which K5''s keep rule drops, gets zero rows; the rows
    reduced per gaussian are the Function's gradients. The wrappers of
    K5' and K6' refuse CPU tensors."""
    js, _, _, gx, gy = build()
    ts = to_port(js)
    pb = tb.pack_bins(ts, gx, gy)
    args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    fwd = rc.blend_oit_packed_torch(*args)
    dout = torch.from_numpy(np.random.default_rng(1).normal(size=fwd.shape).astype(np.float32))
    rows = rc.blend_oit_bwd_packed_torch(*args, fwd, dout)
    assert rows.shape == (10, pb.num_instances) and torch.isfinite(rows).all()
    assert (rows.abs().sum(0) > 0).float().mean() > 0.5

    nan_t = pb.inst_t.clone()
    nan_t[2, ::7] = float("nan")
    nan_t[5, 3::11] = float("nan")
    zero_t = pb.inst_t.clone()
    zero_t[5, ::7] = 0.0
    zero_t[5, 3::11] = 0.0
    nan_fwd = rc.blend_oit_packed_torch(nan_t, *args[1:])
    torch.testing.assert_close(nan_fwd, rc.blend_oit_packed_torch(zero_t, *args[1:]),
                               rtol=0, atol=0)
    nan_rows = rc.blend_oit_bwd_packed_torch(nan_t, *args[1:], nan_fwd, dout)
    assert torch.isfinite(nan_rows).all()
    assert not nan_rows[:, ::7].any() and not nan_rows[:, 3::11].any()

    with pytest.raises(ValueError, match="CUDA"):
        rc.blend_oit_fwd(*args)
    with pytest.raises(ValueError, match="CUDA"):
        rc.blend_oit_bwd(*args, fwd, dout)
    assert rc.blend_oit_fwd.launches == 0 and rc.blend_oit_bwd.launches == 0


def render_scene(n=500, width=100, height=76, seed=9):
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width, height=height,
                         sh_degree=3)
    params, camera, alive = scene_to_inputs(sc)
    return params, camera, alive.at[::5].set(False)


def jax_settings(**kw):
    return make_render_settings(sh_degree=3, max_per_tile=1024, instance_capacity=1 << 14,
                                backend="jnp", **kw)


def test_render_oit_matches_jax_jnp():
    params, camera, alive = render_scene()
    bg = [0.2, 0.4, 0.6]
    jo = jax.jit(lambda p, a: j_render(camera, p, a, jax_settings(blend_mode="oit"),
                                       jnp.asarray(bg)))(params, alive)
    assert int(jo["instance_overflow"]) == 0 and int(jo["tile_overflow"]) == 0
    tp, tc, ta = port_inputs(params, camera, alive)
    with torch.no_grad():
        to = t_render(tc, tp, ta, t_settings(sh_degree=3, blend_mode="oit"), bg, device="cpu")
    assert to["render"].shape == (76, 100, 3)
    for key in ("render", "invdepth", "final_t"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]), atol=ATOL, err_msg=key)
    assert to["num_instances"] == int(jo["num_instances"])


def test_render_oit_gradients_match_jax_grad():
    """`render()` gradients in OIT mode w.r.t. every parameter,
    `mean2d_offset` and the exposure vs `jax.grad` of the JAX render."""
    params, camera, alive = render_scene()
    h, w = camera.height, camera.width
    rng = np.random.default_rng(2)
    tgt = rng.random((h, w, 3)).astype(np.float32)
    wd = rng.random((h, w)).astype(np.float32)
    exposure = np.eye(3, 4, dtype=np.float32)
    exposure[:3, :3] *= np.float32(0.9)
    exposure[:3, 3] = [0.05, 0.02, 0.01]
    bg = [0.1, 0.2, 0.3]
    n = params.xyz.shape[0]

    def loss_terms(out, xp, tgt, wd):
        return (xp.sum((out["render"] - tgt) ** 2) + xp.sum(out["invdepth"] * wd)
                + xp.sum(out["final_t"] * 0.3))

    def jloss(p, off, e):
        return loss_terms(j_render(camera, p, alive, jax_settings(blend_mode="oit"),
                                   jnp.asarray(bg), mean2d_offset=off, exposure=e), jnp, tgt, wd)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.zeros((n, 2), jnp.float32), jnp.asarray(exposure))

    tp, tc, ta = port_inputs(params, camera, alive)
    off = torch.zeros((n, 2), requires_grad=True)
    texp = torch.tensor(exposure, requires_grad=True)
    out = t_render(tc, tp, ta, t_settings(sh_degree=3, blend_mode="oit"), bg,
                   mean2d_offset=off, exposure=texp, device="cpu")
    loss_terms(out, torch, torch.from_numpy(tgt), torch.from_numpy(wd)).backward()
    for f in PARAM_FIELDS:
        want = np.asarray(getattr(jg[0], f))
        assert np.abs(want).max() > 0, f
        assert rel_err(want, getattr(tp, f).grad.numpy()) < REL, f
    assert rel_err(jg[1], off.grad.numpy()) < REL, "mean2d_offset"
    assert rel_err(jg[2], texp.grad.numpy()) < REL, "exposure"


def test_train_step_oit_matches_jax():
    """One OIT train step (float32 packets, dense Adam, exposure) from a
    JAX state carried across, at the tolerances of
    `test_torch_train_step.py:test_train_step_matches_jax`."""
    params, camera, alive = render_scene()
    jset = jax_settings(blend_mode="oit")
    jfn = jstep.make_train_step(JOpt(), jset, use_exposure=True)
    jstate = jstep.init_train_state(params, alive, num_images=3)
    jstate, _ = run_jax_step(jfn, jstate, camera, step_inputs(camera, 3), 1.6e-4, 0.01, 0.5, 2)
    inp = step_inputs(camera)
    args = (1.6e-4, 0.01, 0.5, 1)
    jnew, jm = run_jax_step(jfn, jstate, camera, inp, *args)

    tstate = train_state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    _, tc, _ = port_inputs(jstate.params, camera, jstate.alive)
    tfn = tstep.make_train_step(TOpt(), t_settings(sh_degree=3, blend_mode="oit"),
                                use_exposure=True)
    tnew, tm = tfn(tstate, tc, *(torch.from_numpy(inp[k]) for k in (
        "gt_image", "alpha_mask", "invdepth_gt", "depth_mask", "bg")), *args)

    for key in ("loss", "l1", "depth_l1"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert int(tm["n_visible"]) == int(jm["n_visible"]) > 0
    assert tnew.step == int(jnew.step)
    np.testing.assert_array_equal(tnew.adam_counts.numpy(), np.asarray(jnew.adam_counts))
    np.testing.assert_array_equal(tnew.stats["denom"].numpy(), np.asarray(jnew.stats["denom"]))
    assert rel_err(jnew.stats["grad_accum"], tnew.stats["grad_accum"].numpy()) < REL
    for f in PARAM_FIELDS:
        assert rel_err(getattr(jnew.adam_m, f), tnew.adam_m[f].numpy()) < REL, f
        assert rel_err(getattr(jnew.adam_v, f), tnew.adam_v[f].numpy()) < 2 * REL, f
        np.testing.assert_allclose(tnew.params[f].numpy(), np.asarray(getattr(jnew.params, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tnew.exposure.numpy(), np.asarray(jnew.exposure), rtol=0, atol=1e-6)


def test_bf16_packets_blend_close_to_f32():
    """Sorted blend of bf16 packets against float32 packets, within the
    bounds the JAX package holds its own bf16 packets to
    (`test_pallas_blend.py:143-160`: max 0.1, mean 5e-3)."""
    js, _, _, gx, gy = build()
    ts = to_port(js)
    f32 = rc.blend_tiles_cuda(ts, tb.pack_bins(ts, gx, gy), gx, gy)
    bf16 = rc.blend_tiles_cuda(ts, tb.pack_bins(ts, gx, gy, packet_dtype="bfloat16"), gx, gy)
    d = (f32.color - bf16.color).abs()
    assert torch.isfinite(bf16.color).all()
    assert 0 < float(d.max()) < 0.1 and float(d.mean()) < 5e-3


@pytest.mark.parametrize("blend_mode", ["sorted", "oit"])
def test_reduce_packs_gradient_rows_with_bf16_packets(monkeypatch, blend_mode):
    """`render()` asks the reduce for bf16 rounding with bf16 packets, as the
    JAX VJP does for a bf16 table (`rasterize_pallas.py:1166,1232`); the
    port's table is float32 in every mode, so this cannot follow from its
    dtype. Hybrid packets round too; float32 ones do not."""
    params, camera, alive = render_scene(n=200)
    tp, tc, ta = port_inputs(params, camera, alive)
    seen = []

    def spy(dinst, gauss_id, n_gauss, pack_bf16=False):
        seen.append(pack_bf16)
        return reduce_by_gid_torch(dinst, gauss_id, n_gauss, pack_bf16)

    monkeypatch.setattr(rc, "reduce_by_gid", spy)
    for packets in ("bfloat16", "hybrid", "float32"):
        out = t_render(tc, tp, ta, t_settings(sh_degree=3, blend_mode=blend_mode,
                                              packet_dtype=packets), [0, 0, 0], device="cpu")
        out["render"].sum().backward()
    assert seen == [True, True, False]
    assert torch.isfinite(tp.xyz.grad).all()


@pytest.mark.slow
@pytest.mark.parametrize("packet_dtype", ["float32", "hybrid"])
def test_oit_matches_pallas_interpret(packet_dtype):
    """Against the JAX package's production OIT path: Pallas K5 and K6 (and
    K4) in interpret mode, on instances packed by its own `pack_bins` (K1).
    Forward at atol 3e-5; gradients at max relative error 5e-5 in float32,
    and in hybrid mode within 2^-7 of the sum of each entry's instances'
    |rows| (both sides round each row to bf16; rows whose float32 sums
    differ in the last bits can round one bf16 ulp apart)."""
    from jax.experimental import pallas as pl

    import gsplat_tpu.ops.rasterize_pallas as rp
    from gsplat_tpu.ops.binning import pack_bins as j_pack_bins

    hybrid = packet_dtype == "hybrid"
    js, _, _, gx, gy = build()
    tgt, wd = loss_inputs(gx, gy)
    orig = pl.pallas_call
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    shim.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    saved, rp.pl = rp.pl, shim
    try:
        jp = j_pack_bins(js, gx, gy, CAP, packet_dtype="hybrid" if hybrid else jnp.float32)
        blend = lambda s: rp.blend_tiles_pallas(s, jp, gx, gy, 16, blend_mode="oit",
                                                reduce_pack=hybrid)
        jout = blend(js)
        want = jax_grads(js, gx, gy, tgt, wd, blend)
    finally:
        rp.pl = saved
    ts = to_port(js)
    pb = tb.pack_bins(ts, gx, gy, packet_dtype=packet_dtype)
    assert_blend_close(rc.blend_tiles_cuda(ts, pb, gx, gy, blend_mode="oit"), jout)
    got, _ = grads_and_bins(js, gx, gy, tgt, wd, packet_dtype)
    if not hybrid:
        assert_grads_close(want, got)
        return
    # per gaussian, the sum over its instances of |row| of this loss
    args = (pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    raw = rc.blend_oit_packed_torch(*args).requires_grad_(True)
    wq = (1.0 - raw[..., 5]) / torch.clamp(raw[..., 4], min=1e-8)
    loss = ((((raw[..., 0:3] * wq[..., None]) - torch.from_numpy(tgt)) ** 2).sum()
            + (raw[..., 3] * wq * torch.from_numpy(wd)).sum() + (raw[..., 5] * 0.3).sum())
    (dout,) = torch.autograd.grad(loss, raw)
    rows = rc.blend_oit_bwd_packed_torch(*args, raw.detach(), dout)
    absum = reduce_by_gid_torch(rows.abs(), pb.gauss_id, ts.depth.shape[0])
    depth = ts.depth
    dinvz_ddepth = torch.where(depth > 0.2, 1.0 / (depth * depth), torch.zeros_like(depth))
    bounds = (absum[0:2].T, absum[2:5].T, absum[5], absum[6:9].T, absum[9] * dinvz_ddepth)
    assert_grads_within(want, got, [b.numpy() for b in bounds], 2)
