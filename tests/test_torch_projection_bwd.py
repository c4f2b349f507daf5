"""The projection's backward on the CPU: `preprocess_bwd_torch` (the plain
twin of the backward kernel `gs_project_bwd`) against `jax.vjp` of the JAX
package's `preprocess` and against autograd of `preprocess_torch`, and the
dispatch of `preprocess` through `ProjectFunction`; and the twin in
float64 against float64 autograd on the projection's edge table.

Seeded `make_test_scene` inputs (n = 600, every 7th row dead), seeded
standard-normal cotangents on all five differentiable outputs (mean2d,
conic, opacity, rgb, depth) and on none of the others.

Tolerances, per gradient column (one component over all live rows, the
per-row convention of the kernels' card checks): |a - b| <= rtol * max|b|
+ atol. Against JAX rtol 1e-4, atol 1e-6: float32 chains through 1/tz^2,
two quaternion normalisations and the antialiasing ratio, in two
libraries. Against autograd of the twin rtol 1e-5. An elementwise relative
tolerance is no measure here: some entries are the small remainder of
terms that cancel (the scaling and rotation gradients of round, dilated
splats), and there autograd and `jax.vjp` themselves differ by 2.4e-4 of
the entry, while every column agrees within 6e-6 of its largest value.
"""

import dataclasses
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core.types import make_render_settings as j_settings
from gsplat_tpu.ops.projection import preprocess as j_preprocess
from gsplat_tpu.render import grid_dims
from gsplat_tpu_torch.core.types import make_render_settings as t_settings
from gsplat_tpu_torch.ops import projection as pj
from gsplat_tpu_torch.render import grid_dims as t_grid_dims
from gsplat_tpu_torch.synthetic import projection_edge_table, tiny_scene
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_projection import port_inputs

N = 600
PARAMS = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")
GRADS = PARAMS + ("mean2d_offset",)
COT_SHAPES = ((N, 2), (N, 3), (N,), (N, 3), (N,))


def scene(sh_degree, antialiasing, tight_cull, seed=5):
    sc = make_test_scene(np.random.default_rng(seed), n=N, width=160, height=112,
                         sh_degree=sh_degree)
    params, camera, alive = scene_to_inputs(sc)
    alive = alive.at[::7].set(False)
    kw = dict(sh_degree=sh_degree, antialiasing=antialiasing, tight_cull=tight_cull)
    rng = np.random.default_rng(seed + 100)
    cot = [rng.standard_normal(s).astype(np.float32) for s in COT_SHAPES]
    return params, camera, alive, kw, cot


def twin_inputs(params, camera, alive):
    tp, tc, ta = port_inputs(params, camera, alive)
    for f in PARAMS:
        getattr(tp, f).requires_grad_(True)
    return tp, tc, ta


def autograd_of(fn, tp, ta, tc, settings, gx, gy, cot):
    """Autograd through `fn` (a preprocess) with the cotangents, for the
    six parameters and the offset."""
    off = torch.zeros((N, 2), requires_grad=True)
    s = fn(tp, ta, tc, settings, gx, gy, off)
    return torch.autograd.grad((s.mean2d, s.conic, s.opacity, s.rgb, s.depth),
                               [getattr(tp, f) for f in PARAMS] + [off],
                               [torch.from_numpy(c) for c in cot])


def assert_cols_close(got, want, rtol, atol, what):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    assert got.shape == want.shape, what
    if not want.size:
        return
    bound = rtol * np.abs(want).max(axis=0) + atol
    worst = (np.abs(got - want) - bound).max()
    assert worst <= 0, f"{what}: exceeds rtol {rtol} of its column max by {worst}"


@pytest.mark.parametrize("sh_degree,antialiasing,tight_cull", [
    (0, False, True), (1, True, False), (2, False, False), (3, True, True), (3, False, True),
    (4, True, False)])
def test_backward_twin_matches_jax_and_autograd(sh_degree, antialiasing, tight_cull):
    params, camera, alive, kw, cot = scene(sh_degree, antialiasing, tight_cull)
    gx, gy = grid_dims(camera, 16)
    js = j_settings(**kw)

    def f(p, off):
        s = j_preprocess(p, alive, camera, js, gx, gy, off)
        return s.mean2d, s.conic, s.opacity, s.rgb, s.depth

    _, vjp = jax.vjp(f, params, jnp.zeros((N, 2), jnp.float32))
    j_params, j_off = vjp(tuple(jnp.asarray(c) for c in cot))
    jax_grads = [np.asarray(getattr(j_params, g)) for g in PARAMS] + [np.asarray(j_off)]

    tp, tc, ta = twin_inputs(params, camera, alive)
    settings = t_settings(**kw)
    auto = autograd_of(pj.preprocess_torch, tp, ta, tc, settings, gx, gy, cot)
    with torch.no_grad():
        twin = pj.preprocess_bwd_torch(tp, ta, tc, settings, [torch.from_numpy(c) for c in cot])

    live = np.asarray(alive)
    assert live.sum() > 400
    k = (sh_degree + 1) ** 2
    for name, got, ag, jg in zip(GRADS, twin, auto, jax_grads):
        got = got.numpy()
        assert got.shape == jg.shape, name
        assert_cols_close(got[live], jg[live], 1e-4, 1e-6, f"{name} vs jax.vjp")
        assert_cols_close(got[live], ag.numpy()[live], 1e-5, 0.0, f"{name} vs autograd")
        # a dead row gets exactly 0: its parameters are never read
        assert not got[~live].any(), f"{name}: dead rows"
    rest = twin[GRADS.index("features_rest")].numpy()
    assert not rest[:, k - 1:].any(), "coefficients above the active degree"
    if k > 1:
        assert rest[live, :k - 1].any()


def edge_autograd(params, alive, camera, settings, gx, gy, cot, dtype):
    """Autograd of `preprocess_torch` in `dtype` on the edge table."""
    leaves = {f: getattr(params, f).to(dtype).requires_grad_(True) for f in PARAMS}
    off = torch.zeros((alive.shape[0], 2), dtype=dtype, requires_grad=True)
    s = pj.preprocess_torch(SimpleNamespace(**leaves), alive, camera_as(camera, dtype), settings,
                            gx, gy, off)
    return torch.autograd.grad((s.mean2d, s.conic, s.opacity, s.rgb, s.depth),
                               [leaves[f] for f in PARAMS] + [off], [c.to(dtype) for c in cot])


def camera_as(camera, dtype):
    return dataclasses.replace(camera, **{f: getattr(camera, f).to(dtype) for f in (
        "world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")})


@pytest.mark.parametrize("sh_degree,antialiasing", [
    (0, False), (1, True), (2, False), (3, True), (4, False), (4, True)])
def test_backward_twin_float64_on_edge_table(sh_degree, antialiasing):
    """The edge table (`projection_edge_table`: near plane, frustum clamp,
    2D determinants that cancel to 0, op x 255 at 1, SH colours at 0, rect
    edges on tile borders) on every live row, the rows included where
    float32 autograd is no reference (it misses float64 autograd there):
    the twin's arithmetic in float64 against float64 autograd, rtol 1e-5
    per column. The worst columns are on the splats whose covariance has
    a condition number near 1e11, and the gap falls with it."""
    _, _, camera = tiny_scene(n=64, width=640, height=480, sh_degree=4, device="cpu")
    gx, gy = t_grid_dims(camera, 16)
    params, alive, _ = projection_edge_table(camera, "cpu")
    gen = torch.Generator().manual_seed(5)
    n = alive.shape[0]
    cot = [torch.randn(s, generator=gen) for s in ((n, 2), (n, 3), (n,), (n, 3), (n,))]
    settings = t_settings(sh_degree=sh_degree, antialiasing=antialiasing)
    auto64 = edge_autograd(params, alive, camera, settings, gx, gy, cot, torch.float64)
    auto32 = edge_autograd(params, alive, camera, settings, gx, gy, cot, torch.float32)
    p64 = SimpleNamespace(**{f: getattr(params, f).double() for f in PARAMS})
    with torch.no_grad():
        twin = pj.preprocess_bwd_torch(p64, alive, camera_as(camera, torch.float64), settings,
                                       [c.double() for c in cot])
    live = alive.numpy()
    missed = np.zeros(n, bool)
    for name, got, a64, a32 in zip(GRADS, twin, auto64, auto32):
        got, a64, a32 = (t.reshape(n, -1).numpy() for t in (got, a64, a32))
        assert np.array_equal(np.isfinite(got[live]), np.isfinite(a64[live])), name
        fin = np.isfinite(a64[live])
        assert_cols_close(np.where(fin, got[live], 0), np.where(fin, a64[live], 0), 1e-5, 0.0,
                          f"{name} in float64 vs float64 autograd")
        scale = np.abs(np.where(fin, a64[live], 0)).max(axis=0)
        missed[live] |= (np.abs(a32[live] - a64[live]) > 1e-5 * scale).any(axis=1)
        assert not got[~live].any(), f"{name}: dead rows"
    # the table holds rows that a float32 reference cannot judge
    assert missed.sum() > 100


def test_preprocess_dispatches_to_the_twins_on_cpu(monkeypatch):
    """`preprocess` on CPU tensors: the forward twin's screen, through
    `ProjectFunction` with `preprocess_bwd_torch` as its backward."""
    params, camera, alive, kw, cot = scene(3, True, True, seed=9)
    gx, gy = grid_dims(camera, 16)
    settings = t_settings(**kw)
    tp, tc, ta = twin_inputs(params, camera, alive)

    calls = []
    orig = pj.preprocess_bwd_torch
    monkeypatch.setattr(pj, "preprocess_bwd_torch",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = autograd_of(pj.preprocess, tp, ta, tc, settings, gx, gy, cot)
    assert calls == [1]
    want = autograd_of(pj.preprocess_torch, tp, ta, tc, settings, gx, gy, cot)
    live = np.asarray(alive)
    for name, g, w in zip(GRADS, got, want):
        assert_cols_close(g.numpy()[live], w.numpy()[live], 1e-5, 0.0, name)

    off = torch.zeros((N, 2), requires_grad=True)
    screen = pj.preprocess(tp, ta, tc, settings, gx, gy, off)
    with torch.no_grad():
        ref = pj.preprocess_torch(tp, ta, tc, settings, gx, gy, off)
    for f in pj.ScreenGaussians.__dataclass_fields__:
        a, b = getattr(screen, f), getattr(ref, f)
        assert torch.equal(a, b), f
        assert a.requires_grad == (f not in pj._NON_DIFF), f
    # inference: the forward alone, nothing recorded
    with torch.inference_mode():
        inf = pj.preprocess(tp, ta, tc, settings, gx, gy)
    assert inf.mean2d.grad_fn is None
    # a kernel wrapper never takes a CPU tensor: no silent fallback
    with pytest.raises(ValueError, match="CUDA"):
        pj.project_fwd(tp, ta, tc, settings, gx, gy)


def test_plain_route_is_autograd_of_the_twin():
    """`scripts/plain_projection.py`'s route: `preprocess` gives autograd
    of the forward twin, exactly, and the kernels' wrappers come back after."""
    from gsplat_tpu_torch.scripts.plain_projection import plain_route

    params, camera, alive, kw, cot = scene(2, True, True, seed=9)
    gx, gy = grid_dims(camera, 16)
    settings = t_settings(**kw)
    tp, tc, ta = twin_inputs(params, camera, alive)
    saved = pj.project_fwd, pj.project_bwd, pj.preprocess_bwd_torch
    with plain_route():
        got = autograd_of(pj.preprocess, tp, ta, tc, settings, gx, gy, cot)
    assert (pj.project_fwd, pj.project_bwd, pj.preprocess_bwd_torch) == saved
    want = autograd_of(pj.preprocess_torch, tp, ta, tc, settings, gx, gy, cot)
    for name, g, w in zip(GRADS, got, want):
        assert torch.equal(g, w), name


def test_import_needs_no_compiler_or_card():
    code = ("import gsplat_tpu_torch.ops.projection, gsplat_tpu_torch._kernels as k, sys; "
            "assert k.load.cache_info().currsize == 0; assert 'triton' not in sys.modules; "
            "assert 'projection' in k.SOURCES")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
