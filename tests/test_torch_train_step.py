"""The port's train step and render gradients vs the JAX package.

- `render()` gradients w.r.t. every parameter, `mean2d_offset` and the
  exposure vs `jax.grad` of `gsplat_tpu.render.render` (backend "jnp"):
  max relative error < 5e-5 per gradient, the blend-backward tolerance of
  `tests/test_pallas_blend.py:98-101`.
- One float32 `make_train_step` step from a JAX `TrainState` carried across
  (`convert.train_state_from_numpy`) vs the JAX step (backend "jnp"),
  dense Adam with exposure and sparse Adam without: loss at rtol 1e-5;
  Adam moments, stats and params at the tolerance the 5e-5 gradient error
  allows (stated at each check); step counts exactly.
- The densify and opacity-reset steps on that state.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu.config import OptimizationConfig as JOpt
from gsplat_tpu.core.types import make_render_settings as j_settings
from gsplat_tpu.render import render as j_render
from gsplat_tpu.train import step as jstep
from gsplat_tpu_torch.config import OptimizationConfig as TOpt
from gsplat_tpu_torch.convert import PARAM_FIELDS, train_state_from_numpy
from gsplat_tpu_torch.core.types import make_render_settings as t_settings
from gsplat_tpu_torch.render import render as t_render
from gsplat_tpu_torch.train import step as tstep
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_projection import port_inputs

REL = 5e-5


def scene(n=500, width=100, height=76, seed=9):
    sc = make_test_scene(np.random.default_rng(seed), n=n, width=width, height=height,
                         sh_degree=3)
    params, camera, alive = scene_to_inputs(sc)
    return params, camera, alive.at[::5].set(False)


def rel_err(want, got):
    want = np.asarray(want, np.float64)
    return float(np.abs(want - np.asarray(got, np.float64)).max() / (np.abs(want).max() + 1e-12))


def test_render_gradients_match_jax_grad():
    params, camera, alive = scene()
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

    js = j_settings(sh_degree=3, max_per_tile=1024, instance_capacity=1 << 14, backend="jnp")

    def jloss(p, off, e):
        return loss_terms(j_render(camera, p, alive, js, jnp.asarray(bg), mean2d_offset=off,
                                   exposure=e), jnp, tgt, wd)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.zeros((n, 2), jnp.float32), jnp.asarray(exposure))

    tp, tc, ta = port_inputs(params, camera, alive)
    off = torch.zeros((n, 2), requires_grad=True)
    texp = torch.tensor(exposure, requires_grad=True)
    out = t_render(tc, tp, ta, t_settings(sh_degree=3), bg, mean2d_offset=off, exposure=texp,
                   device="cpu")
    loss_terms(out, torch, torch.from_numpy(tgt), torch.from_numpy(wd)).backward()

    for f in PARAM_FIELDS:
        want = np.asarray(getattr(jg[0], f))
        assert np.abs(want).max() > 0, f
        assert rel_err(want, getattr(tp, f).grad.numpy()) < REL, f
    assert rel_err(jg[1], off.grad.numpy()) < REL, "mean2d_offset"
    assert rel_err(jg[2], texp.grad.numpy()) < REL, "exposure"


def jax_state_to_numpy(state):
    tree = lambda t: {f: np.asarray(getattr(t, f)) for f in PARAM_FIELDS}
    return dict(
        params=tree(state.params), alive=np.asarray(state.alive), adam_m=tree(state.adam_m),
        adam_v=tree(state.adam_v), adam_counts=np.asarray(state.adam_counts),
        exposure=np.asarray(state.exposure), exp_m=np.asarray(state.exp_m),
        exp_v=np.asarray(state.exp_v), exp_step=np.asarray(state.exp_step),
        stats={k: np.asarray(v) for k, v in state.stats.items()}, step=int(state.step),
    )


def step_inputs(camera, seed=4):
    rng = np.random.default_rng(seed)
    h, w = camera.height, camera.width
    mask = np.ones((h, w, 1), np.float32)
    mask[:, : w // 4] = 0.0
    return dict(
        gt_image=rng.random((h, w, 3)).astype(np.float32),
        alpha_mask=mask,
        invdepth_gt=rng.random((h, w)).astype(np.float32) * 0.3,
        depth_mask=np.ones((h, w), np.float32),
        bg=np.array([0.1, 0.2, 0.3], np.float32),
    )


def run_jax_step(fn, state, camera, inp, xyz_lr, exp_lr, depth_w, idx):
    return fn(state, camera, *(jnp.asarray(inp[k]) for k in (
        "gt_image", "alpha_mask", "invdepth_gt", "depth_mask", "bg")),
        jnp.float32(xyz_lr), jnp.float32(exp_lr), jnp.float32(depth_w), jnp.int32(idx))


@pytest.fixture(scope="module")
def carried():
    """A JAX state after one step (non-zero moments and stats) and the inputs."""
    params, camera, alive = scene()
    state = jstep.init_train_state(params, alive, num_images=3)
    fn = jstep.make_train_step(JOpt(), j_settings(sh_degree=3, max_per_tile=1024,
                                                  instance_capacity=1 << 14, backend="jnp"),
                               use_exposure=True)
    state, _ = run_jax_step(fn, state, camera, step_inputs(camera, 3), 1.6e-4, 0.01, 0.5, 2)
    return state, camera


@pytest.mark.parametrize("optimizer_type,use_exposure", [("default", True),
                                                         ("sparse_adam", False)])
def test_train_step_matches_jax(carried, optimizer_type, use_exposure):
    jstate, camera = carried
    inp = step_inputs(camera)
    args = (1.6e-4, 0.01, 0.5, 1)
    jfn = jstep.make_train_step(
        JOpt(optimizer_type=optimizer_type),
        j_settings(sh_degree=3, max_per_tile=1024, instance_capacity=1 << 14, backend="jnp"),
        use_exposure=use_exposure)
    jnew, jm = run_jax_step(jfn, jstate, camera, inp, *args)

    tstate = train_state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    _, tc, _ = port_inputs(jstate.params, camera, jstate.alive)
    tfn = tstep.make_train_step(TOpt(optimizer_type=optimizer_type), t_settings(sh_degree=3),
                                use_exposure=use_exposure)
    tnew, tm = tfn(tstate, tc, *(torch.from_numpy(inp[k]) for k in (
        "gt_image", "alpha_mask", "invdepth_gt", "depth_mask", "bg")), *args)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["l1"]), float(jm["l1"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["depth_l1"]), float(jm["depth_l1"]), rtol=1e-5)
    assert int(tm["n_visible"]) == int(jm["n_visible"]) > 0
    assert tm["num_instances"] == int(jm["num_instances"])
    assert tnew.step == int(jnew.step) == int(jstate.step) + 1
    np.testing.assert_array_equal(tnew.adam_counts.numpy(), np.asarray(jnew.adam_counts))
    np.testing.assert_array_equal(tnew.alive.numpy(), np.asarray(jnew.alive))
    np.testing.assert_array_equal(tnew.stats["denom"].numpy(), np.asarray(jnew.stats["denom"]))
    np.testing.assert_array_equal(tnew.stats["max_radii2d"].numpy(),
                                  np.asarray(jnew.stats["max_radii2d"]))
    # grad_accum and the first moments are linear in the gradients: the
    # gradient tolerance, relative to each array's largest entry
    assert rel_err(jnew.stats["grad_accum"], tnew.stats["grad_accum"].numpy()) < REL
    for f in PARAM_FIELDS:
        assert rel_err(getattr(jnew.adam_m, f), tnew.adam_m[f].numpy()) < REL, f
        # v is quadratic in the gradient: twice the relative error
        assert rel_err(getattr(jnew.adam_v, f), tnew.adam_v[f].numpy()) < 2 * REL, f
        # an Adam step moves a row by at most ~lr; a relative gradient error
        # e moves the step by ~lr * e, so the params agree to 1e-6 absolute
        np.testing.assert_allclose(tnew.params[f].numpy(), np.asarray(getattr(jnew.params, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tnew.exposure.numpy(), np.asarray(jnew.exposure), rtol=0, atol=1e-6)
    assert int(tnew.exp_step) == int(jnew.exp_step)


def test_densify_and_opacity_reset_steps_match_jax(carried):
    """One densify step with the JAX draws fed in, then an opacity reset:
    masks and alive exact, new rows at float32 rounding."""
    jstate, _ = carried
    # push the stats over the threshold for a mix of clone and split rows
    gacc = np.asarray(jstate.stats["grad_accum"]) * 50.0
    jstate = jstate.replace(stats={**jstate.stats, "grad_accum": jnp.asarray(gacc)})
    opt = JOpt()
    extent = 10.0
    jnew, jinfo = jstep.make_densify_step(opt)(jstate, jnp.float32(extent), 20)
    # the draws `make_densify_step` feeds `densify_and_prune` (densify.py:146-150)
    _, sub = jax.random.split(jstate.rng)
    key_a, key_b = jax.random.split(sub)
    c = jstate.alive.shape[0]
    normals = np.stack([np.asarray(jax.random.normal(k, (c, 3))) for k in (key_a, key_b)])

    tstate = train_state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    tnew, tinfo = tstep.make_densify_step(TOpt())(tstate, extent, 20,
                                                  normals=torch.from_numpy(normals))
    for k in ("n_cloned", "n_split", "n_pruned", "n_dropped", "n_alive"):
        assert tinfo[k] == int(jinfo[k]), k
    assert tinfo["n_cloned"] > 0 and tinfo["n_split"] > 0
    np.testing.assert_array_equal(tnew.alive.numpy(), np.asarray(jnew.alive))
    np.testing.assert_array_equal(tnew.adam_counts.numpy(), np.asarray(jnew.adam_counts))
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(tnew.params[f].numpy(), np.asarray(getattr(jnew.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(tnew.adam_m[f].numpy(), np.asarray(getattr(jnew.adam_m, f)))
    for k in ("grad_accum", "denom", "max_radii2d"):
        assert not tnew.stats[k].any()

    jr = jstep.opacity_reset_step(jnew)
    tr = tstep.opacity_reset_step(tnew)
    np.testing.assert_allclose(tr.params["opacity"].numpy(), np.asarray(jr.params.opacity),
                               rtol=1e-6, atol=1e-6)
    assert not tr.adam_m["opacity"].any() and not tr.adam_v["opacity"].any()
