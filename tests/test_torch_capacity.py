"""The port's capacity controller, resize and pixel cache against the JAX
package's.

- The capacity ladder (`next_pow2`, `quantize_capacity`, `round128`) on the
  same values, and `CapacityController` fed the same recorded observation
  sequences (grow on overflow, grow at utilization, no resize in the band,
  shrink after the window rolls past a spike, the event window, a densify
  run's counts): identical decisions, step by step.
- `resize_train_state` growing and shrinking one seeded state, carried
  across with `convert.train_state_from_numpy`: every per-gaussian array
  equal to JAX's bit for bit; the shrink refuses to drop an alive row; the
  generator and the exposure state are kept.
- The loop on `mini_blender` with `capacity=0` and a tight init: the
  capacity grows, the state stays finite, and every view reads its own
  pixels.
- The pixel cache's LRU eviction order against the JAX loop's for one
  access sequence under a small budget.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu import capacity as jcap
from gsplat_tpu.train import loop as jloop
from gsplat_tpu.train.resize import resize_train_state as j_resize
from gsplat_tpu_torch import capacity as tcap
from gsplat_tpu_torch.convert import PARAM_FIELDS, train_state_from_numpy
from gsplat_tpu_torch.train import loop as tloop
from gsplat_tpu_torch.train.resize import resize_train_state as t_resize
from tests.test_torch_train_step import jax_state_to_numpy


def test_capacity_ladder_matches_jax():
    values = [0, 1, 127, 128, 129, 4095, 4096, 4097, 100_000, 131_072, 131_073, 300_000,
              524_288, 524_289, 1_000_001, 1_310_720, 5_000_000, 3 << 22]
    for n in values:
        assert tcap.next_pow2(n) == jcap.next_pow2(n)
        assert tcap.round128(n) == jcap.round128(n)
        for floor in (4096, 1 << 17):
            assert tcap.quantize_capacity(n, floor) == jcap.quantize_capacity(n, floor)


def densify_run_counts():
    """Alive counts and dropped children of a densify run: doubling rounds
    that overflow, an opacity-reset mass prune, then a long steady tail."""
    rng = np.random.default_rng(3)
    obs = [(200_000, 0), (390_000, 0), (620_000, 25_000), (900_000, 0), (1_300_000, 0)]
    obs.append("event")
    obs += [(int(300_000 + rng.integers(0, 20_000)), 0) for _ in range(25)]
    obs.append("event")
    obs += [(int(250_000 + rng.integers(0, 5_000)), 0) for _ in range(4)]
    return obs


SEQUENCES = {
    # (controller kwargs, observations; "event" = notify_structural_change)
    "grow_on_overflow": (dict(capacity=1 << 18, floor=1 << 17), [(1 << 18, 5), (1 << 18, 1)]),
    "grow_at_utilization": (dict(capacity=1 << 20), [(int(0.8 * (1 << 20)), 0),
                                                     (int(0.71 * (1 << 20)), 0)]),
    "no_resize_in_band": (dict(capacity=1 << 20), [(1 << 18, 0)] * 49),
    "shrink_after_window": (dict(capacity=1 << 23),
                            [(3_000_000, 0)] + [(100_000, 0)] * 99),
    "sustained_gap_needed": (dict(capacity=1 << 20), [(1 << 19, 0)] * 50),
    "event_window": (dict(capacity=1 << 23, window=50, event_window=5),
                     [(3_000_000, 0), "event"] + [(100_000, 0)] * 60),
    "event_without_gap": (dict(capacity=1 << 20, window=50, event_window=5),
                          ["event"] + [(1 << 19, 0)] * 5),
    # the loops' gaussian-axis settings on a densify run's counts
    "gaussian_axis": (dict(capacity=262_144, window=10, event_window=3, floor=4096,
                           grow_frac=0.75, grow_margin=1.5, shrink_margin=1.6),
                      densify_run_counts()),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_controller_decisions_match_jax(name):
    kw, seq = SEQUENCES[name]
    kw = dict(kw)
    cap = kw.pop("capacity")
    j, t = jcap.CapacityController(cap, **kw), tcap.CapacityController(cap, **kw)
    decisions = []
    for obs in seq:
        if obs == "event":
            j.notify_structural_change()
            t.notify_structural_change()
            continue
        got, want = t.update(*obs), j.update(*obs)
        assert got == want and t.capacity == j.capacity, (name, obs)
        decisions.append(got)
    # each sequence makes the decision it was recorded for
    resized = [d for d in decisions if d is not None]
    want_resizes = {"no_resize_in_band": 0, "sustained_gap_needed": 0,
                    "event_without_gap": 0, "grow_on_overflow": 2, "grow_at_utilization": 1,
                    "shrink_after_window": 1, "event_window": 1}
    if name in want_resizes:
        assert len(resized) == want_resizes[name]
    else:
        assert len(resized) >= 3  # grows, then a shrink after the prune


def seeded_jax_state(capacity=512, n_alive=100, seed=0):
    """A JAX TrainState with every per-row array distinguishable and the
    alive rows scattered."""
    import dataclasses

    from gsplat_tpu.core.types import GaussianParams
    from gsplat_tpu.model import init_from_pcd
    from gsplat_tpu.train.step import init_train_state

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_alive, 3)).astype(np.float32)
    params, alive = init_from_pcd(pts, rng.random((n_alive, 3)).astype(np.float32),
                                  max_sh_degree=1, capacity=capacity)
    state = init_train_state(params, alive, num_images=3)
    scatter = np.zeros(capacity, bool)
    scatter[rng.choice(capacity // 2, n_alive, replace=False) * 2 + 1] = True

    def rows(like):
        return GaussianParams(**{f: jnp.asarray(rng.normal(size=getattr(like, f).shape),
                                                jnp.float32) for f in PARAM_FIELDS})

    return dataclasses.replace(
        state, params=rows(state.params), alive=jnp.asarray(scatter),
        adam_m=rows(state.adam_m), adam_v=rows(state.adam_v),
        adam_counts=jnp.asarray(rng.integers(0, 1000, capacity), jnp.int32),
        exposure=jnp.asarray(rng.normal(size=state.exposure.shape), jnp.float32),
        stats={"grad_accum": jnp.asarray(rng.random(capacity), jnp.float32),
               "denom": jnp.asarray(rng.integers(0, 9, capacity), jnp.float32),
               "max_radii2d": jnp.asarray(rng.integers(0, 50, capacity), jnp.int32)},
    )


def assert_states_equal(t, j):
    jn = jax_state_to_numpy(j)
    for name in ("params", "adam_m", "adam_v"):
        for f in PARAM_FIELDS:
            got = getattr(t, name)[f].numpy()
            assert got.shape == jn[name][f].shape
            np.testing.assert_array_equal(got.view(np.int32), jn[name][f].view(np.int32),
                                          err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(t.alive.numpy(), jn["alive"])
    np.testing.assert_array_equal(t.adam_counts.numpy(), jn["adam_counts"])
    for k, v in jn["stats"].items():
        np.testing.assert_array_equal(t.stats[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("sizes", [(1024,), (128,), (1024, 128), (128, 512), (640, 256)])
def test_resize_matches_jax_bitwise(sizes):
    jstate = seeded_jax_state()
    tstate = train_state_from_numpy(jax_state_to_numpy(jstate), "cpu", seed=4)
    gen_state = tstate.rng.get_state()
    for c in sizes:
        jstate, tstate2 = j_resize(jstate, c), t_resize(tstate, c)
        assert tstate2.capacity == c
        assert_states_equal(tstate2, jstate)
        assert tstate2.rng is tstate.rng and tstate2.exposure is tstate.exposure
        tstate = tstate2
    assert torch.equal(tstate.rng.get_state(), gen_state)
    assert int(tstate.alive.sum()) == 100
    # dead rows are inert
    dead = ~tstate.alive
    assert (tstate.params["scaling"][dead] == -15.0).all()
    assert (tstate.params["opacity"][dead] == -15.0).all()


def test_resize_shrink_refuses_to_drop_alive_rows():
    tstate = train_state_from_numpy(jax_state_to_numpy(seeded_jax_state(n_alive=200)), "cpu")
    with pytest.raises(ValueError, match="200 rows alive"):
        t_resize(tstate, 128)
    assert t_resize(tstate, 256).capacity == 256  # room for them all
    assert t_resize(tstate, tstate.capacity) is tstate


def test_loop_grows_capacity_and_reads_each_views_pixels(mini_blender, monkeypatch):
    """capacity=0 turns the gaussian-axis controller on: with a tight init
    and a densify round every two iterations the alive count crosses the
    grow threshold and the state is resized mid-run. Every view the loop
    fetches must hold that view's own pixels."""
    from gsplat_tpu_torch import model as tmodel
    from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gsplat_tpu_torch.data import readers

    orig_read = readers.read_blender_scene_info

    def small_scene(path, **kw):
        info = orig_read(path, **kw)
        rng = np.random.default_rng(0)
        info.points = (rng.random((512, 3)) * 2.6 - 1.3).astype(np.float32)
        info.colors = rng.random((512, 3)).astype(np.float32)
        info.normals = np.zeros((512, 3), np.float32)
        return info

    monkeypatch.setattr(readers, "read_blender_scene_info", small_scene)
    monkeypatch.setattr(tloop, "init_from_pcd", lambda p, c, **kw: tmodel.init_from_pcd(
        p, c, **{**kw, "capacity": 1024}))
    fetched = []
    orig_get = tloop.PixelCache.get

    def checked_get(self, cam):
        out = orig_get(self, cam)
        fetched.append(cam.image_name)
        assert torch.equal(out[0], torch.as_tensor(cam.image)), cam.image_name
        return out

    monkeypatch.setattr(tloop.PixelCache, "get", checked_get)
    caps = []
    opt = OptimizationConfig(iterations=6, densify_from_iter=1, densification_interval=2,
                             densify_until_iter=100, densify_grad_threshold=0.0,
                             opacity_reset_interval=1000)
    state, scene, _ = tloop.train(
        ModelConfig(source_path=mini_blender, sh_degree=1, eval=True), opt,
        PipelineConfig(capacity=0), saving_iterations=(), quiet=True, log_every=4,
        on_iteration=lambda it, s, m: caps.append(s.capacity), device="cpu")
    assert caps[0] == 1024 and state.capacity > 1024  # growth fired
    assert int(state.alive.sum()) > 500
    assert all(torch.isfinite(v).all() for v in state.params.values())
    assert len(fetched) == 6 and set(fetched) == {c.image_name for c in scene.get_train_cameras()}


def fake_view(rng, uid, h, w, depth):
    return SimpleNamespace(
        uid=uid, image=rng.random((h, w, 3)).astype(np.float32),
        alpha_mask=np.ones((h, w, 1), np.float32),
        invdepth=rng.random((h, w)).astype(np.float32) if depth else None,
        depth_mask=np.ones((h, w, 1), np.float32) if depth else None)


def test_pixel_cache_evicts_in_the_jax_loops_order(monkeypatch):
    rng = np.random.default_rng(2)
    # train and test views share uids (per-split indices): the key tells them apart
    views = [fake_view(rng, i % 3, 16 + 8 * (i % 2), 24, depth=i % 3 == 0) for i in range(6)]
    budget = 3 * 24 * 24 * 4 * 6  # about three views' tensors
    monkeypatch.setattr(jloop, "_PIXEL_CACHE_BYTES", budget)
    jcache = {}
    tcache = tloop.PixelCache("cpu", budget=budget)
    order = [0, 1, 2, 0, 3, 4, 1, 5, 5, 2, 0, 3, 4, 4, 1]
    for i in order:
        want = jloop._device_batch(views[i], _cache=jcache)
        got = tcache.get(views[i])
        assert list(tcache.entries) == list(jcache), i
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert tcache.nbytes() <= budget
    assert any(k not in tcache.entries for k in [(id(v.image), v.uid) for v in views])
