"""The JAX training loop and the port's, side by side, step by step.

`gsplat_tpu.train.loop.train` (jnp backend, float32 packets) and
`gsplat_tpu_torch.train.loop.train` (`device="cpu"`) train on one
gaussian-GT COLMAP scene written by the port's
`scripts/make_fixtures.make_colmap_gaussian_scene` at `SMALL_RECIPE` size
(9 views of 96x64, 128 SfM points, `--eval`), from one seed, on a shrunk
schedule. Every iteration of both runs is recorded through the loops'
`on_iteration` hook and by wrapping the names each loop calls:

- `make_densify_step`: the JAX round's split draws (`jax.random.split` of
  the state's key, then one `normal(k, (C, 3))` per child,
  `gsplat_tpu/train/densify.py:146-150`) are taken before the round and
  fed to the port's `densify_and_prune` as `normals`; so the capacity of
  every round must be the same in both loops;
- `init_from_pcd`: a tight first capacity, so that the gaussian-capacity
  controller grows it within a short run;
- `resize_train_state`, `opacity_reset_step`, `make_train_step`: when the
  capacity changes, the opacity resets and the SH degree steps.

The schedule is shrunk by `OptimizationConfig` (densify every 2 iterations,
a low gradient threshold, a fast opacity LR so that reset gaussians fall
under the prune threshold within a few steps) and by renumbering the loops'
iterations: both loops count `for iteration in range(first + 1, last + 1)`,
and the test gives their module a `range` that yields a chosen sequence for
that call, so that a few dozen steps reach iterations 1000, 2000 and 3000,
where the SH degree steps (`iteration % 1000 == 0` in both loops).

Held bit for bit, at every densify round and after every reset: the alive
mask and count, the clone, split, prune and dropped counts, the capacity;
the iterations of every round, resize, reset and SH step. Held at every
iteration (alive rows): the Adam step counts, `denom` and `max_radii2d` bit
for bit; the parameters within their learning rate times the steps taken
(`LR`); the Adam moments relative to their field's largest value
(`MOMENT_RTOL`); `grad_accum` likewise (`STAT_RTOL`); the loss within
`LOSS_RTOL`.

Why the parameter tolerances are wide: Adam divides each moment by the
root of its second moment, so a gradient that is zero up to rounding in
both loops (the rotation of an isotropic gaussian) moves its parameter by
up to the learning rate per step, in a direction set by the rounding. The
two packages round differently: XLA on the CPU fuses `C0 * f + 0.5` of
the SH colour into one multiply-add and torch does not, so a channel whose
colour is 0 exactly at the init (an SfM point with a 0 byte) is clamped
(colour -7.4e-9, no gradient) in the JAX loop and not in the port's (colour
0, gradient passes). A parameter's tolerance is therefore twice its
learning rate times the steps taken; the statistics, the moments and the
loss are held much tighter.

Two cases: `fast` (tier 1, ~25 s) reaches densify rounds with clones,
splits and prunes, a capacity growth, an opacity reset, the world-size
prune after it and the first SH step; `full` (slow, ~70 s) runs the whole
shrunk schedule: every SH step, two resets and the end of densification.
Each prints a table of the events side by side and, per field, the first
iteration where the two loops part (or "held").
Run it by hand with
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_loop_parity.py -m slow -s`.
"""

from __future__ import annotations

import builtins
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gsplat_tpu import config as jcfg
from gsplat_tpu import model as jmodel
from gsplat_tpu.core import sh as jsh
from gsplat_tpu.train import loop as jloop
from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch import model as tmodel
from gsplat_tpu_torch.scripts import colmap_proxy as cp
from gsplat_tpu_torch.scripts import make_fixtures as tfix
from gsplat_tpu_torch.train import loop as tloop

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
CAPACITY0 = 256  # the first capacity: the first densify round outgrows it
SEED = 0
F0 = float(np.asarray(jsh.rgb_to_sh(jnp.zeros((), jnp.float32))))  # a colour of 0 at the init


@dataclasses.dataclass(frozen=True)
class Case:
    iterations: tuple  # the loops' iteration numbers, in order
    opt: dict  # OptimizationConfig fields
    sh_degree: int
    max_per_tile: int  # the JAX jnp blend's per-tile slots (tile_overflow must stay 0)


def _seq(*spans):
    return tuple(i for a, b in spans for i in builtins.range(a, b + 1))


CASES = {
    # densify at 2, 4, 6, 1000, 1002; reset at 5 (and 1000); the world-size
    # prune from 6 on; SH 0 -> 1 at 1000
    "fast": Case(
        iterations=_seq((1, 6), (1000, 1003)),
        opt=dict(densify_from_iter=1, densification_interval=2, opacity_reset_interval=5,
                 densify_until_iter=1003, densify_grad_threshold=1e-3, percent_dense=0.05, opacity_lr=0.25,
                 position_lr_max_steps=4000),
        sh_degree=1, max_per_tile=512),
    # densify every 2 iterations until 3004; resets at 1003 and 2006, the
    # world-size prune after the first; SH 0 -> 1 -> 2 -> 3 at 1000, 2000, 3000
    "full": Case(
        iterations=_seq((1, 8), (1000, 1008), (2000, 2008), (3000, 3008)),
        opt=dict(densify_from_iter=1, densification_interval=2, opacity_reset_interval=1003,
                 densify_until_iter=3004, densify_grad_threshold=1e-3, percent_dense=0.05, opacity_lr=0.25,
                 position_lr_max_steps=4000),
        sh_degree=3, max_per_tile=1024),
}

# Each parameter's learning rate (xyz: the schedule's largest,
# `xyz_lr_max`). A parameter may move by up to its learning rate per step in
# either loop where its gradient is rounding, so it is held within twice its
# learning rate times the steps taken.
LR = {"xyz": None, "features_dc": 0.0025, "features_rest": 0.0025 / 20, "scaling": 0.005,
      "rotation": 0.001, "opacity": 0.25}
# A moment is held relative to the largest of its field (the SH
# coefficients' off their colour channels at or under 0, `frozen_channels`).
MOMENT_RTOL = {"xyz": 1e-2, "features_dc": 0.05, "features_rest": 0.05, "scaling": 0.05,
               "rotation": 0.05, "opacity": 0.05}
# grad_accum sums the gradient norms of the round's views, and the two
# renders part by the parameters' rounding-driven steps (the full case
# reaches 1.1e-2 of its field's largest value at the reset of 1003)
STAT_RTOL = 5e-2
LOSS_RTOL = 1e-3


class Renumbered:
    """A stand-in for `range` in a loop module: the loop's own call,
    `range(first + 1, last + 1)`, yields the chosen iteration numbers;
    every other call is the builtin."""

    def __init__(self, iterations):
        self.iterations = tuple(iterations)
        self.current = 0

    def __call__(self, *args):
        if args == (1, self.iterations[-1] + 1):
            return self._walk()
        return builtins.range(*args)

    def _walk(self):
        for it in self.iterations:
            self.current = it
            yield it


def _np_state_jax(state):
    s = jax.device_get(state)
    out = {"alive": np.asarray(s.alive), "counts": np.asarray(s.adam_counts)}
    for f in FIELDS:
        out[f] = np.asarray(getattr(s.params, f))
        out["m_" + f] = np.asarray(getattr(s.adam_m, f))
        out["v_" + f] = np.asarray(getattr(s.adam_v, f))
    out.update({k: np.asarray(v) for k, v in s.stats.items()})
    return out


def _np_state_torch(state):
    out = {"alive": state.alive.numpy().copy(), "counts": state.adam_counts.numpy().copy()}
    for f in FIELDS:
        out[f] = state.params[f].detach().numpy().copy()
        out["m_" + f] = state.adam_m[f].numpy().copy()
        out["v_" + f] = state.adam_v[f].numpy().copy()
    out.update({k: v.numpy().copy() for k, v in state.stats.items()})
    return out


class Run:
    """What one loop did: events in order, the state after each iteration,
    the loss of each iteration."""

    def __init__(self, iterations):
        self.range = Renumbered(iterations)
        self.events = []  # (iteration, kind, details)
        self.states = {}
        self.loss = {}

    def event(self, kind, **details):
        self.events.append((self.range.current, kind, details))


def _instrument(monkeypatch, mod, run, is_jax, draws):
    """Wrap the names `mod` (a loop module) calls, recording into `run`."""
    monkeypatch.setattr(mod, "range", run.range, raising=False)
    init = jmodel.init_from_pcd if is_jax else tmodel.init_from_pcd
    monkeypatch.setattr(mod, "init_from_pcd",
                        lambda p, c, **kw: init(p, c, **{**kw, "capacity": CAPACITY0}))

    make_train_step = mod.make_train_step

    def train_step_for(opt, settings, **kw):
        run.event("sh_degree", degree=settings.sh_degree)
        return make_train_step(opt, settings, **kw)

    monkeypatch.setattr(mod, "make_train_step", train_step_for)

    resize = mod.resize_train_state

    def resize_recorded(state, new_capacity):
        run.event("resize", capacity=int(new_capacity))
        return resize(state, new_capacity)

    monkeypatch.setattr(mod, "resize_train_state", resize_recorded)

    reset = mod.opacity_reset_step

    def reset_recorded(state):
        out = reset(state)
        run.event("reset", alive=int(np.asarray(out.alive).sum()))
        run.states[("reset", run.range.current)] = (_np_state_jax if is_jax else
                                                    _np_state_torch)(out)
        return out

    monkeypatch.setattr(mod, "opacity_reset_step", reset_recorded)

    make_densify = mod.make_densify_step

    def densify_for(opt):
        step = make_densify(opt)

        def densify_recorded(state, extent, max_screen_size):
            if is_jax:
                c = state.params.capacity
                _, sub = jax.random.split(state.rng)
                key_a, key_b = jax.random.split(sub)
                draws.append(np.stack([np.asarray(jax.random.normal(k, (c, 3)))
                                       for k in (key_a, key_b)]))
                out, info = step(state, extent, max_screen_size)
            else:
                c = state.capacity
                normals = draws[sum(e[1] == "densify" for e in run.events)]
                # the JAX draws line up row for row only at equal capacities
                assert normals.shape[1] == c, (normals.shape, c)
                out, info = step(state, extent, max_screen_size,
                                 normals=torch.from_numpy(normals))
            run.event("densify", capacity=c, size_prune=bool(max_screen_size),
                      **{k: int(v) for k, v in info.items()})
            run.states[("densify", run.range.current)] = (_np_state_jax if is_jax else
                                                          _np_state_torch)(out)
            return out, info

        return densify_recorded

    monkeypatch.setattr(mod, "make_densify_step", densify_for)


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    """The gaussian-GT scene, one copy for each package (the first read of a
    COLMAP scene writes `sparse/0/points3D.ply`, which later reads prefer)."""
    root = tmp_path_factory.mktemp("loop_parity")
    src = str(root / "scene")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tfix.make_colmap_gaussian_scene(src, **cp.SMALL_RECIPE, device="cpu")
    finally:
        torch.set_num_threads(n)
    os.remove(os.path.join(src, "sparse", "0", "points3D.ply"))
    out = {}
    for name in ("jax", "port"):
        out[name] = str(root / name)
        shutil.copytree(src, out[name])
    return out


def run_both(monkeypatch, scene_dirs, case: Case):
    """Train both loops on `case`; returns (jax Run, port Run)."""
    last = case.iterations[-1]
    opt = dict(case.opt, iterations=last)
    draws = []
    runs = {}
    for name, mod, cfg, is_jax in (("jax", jloop, jcfg, True), ("port", tloop, tcfg, False)):
        run = runs[name] = Run(case.iterations)
        _instrument(monkeypatch, mod, run, is_jax, draws)

        def on_iteration(it, state, metrics, run=run, is_jax=is_jax):
            run.loss[it] = float(metrics["loss"])
            run.states[it] = (_np_state_jax if is_jax else _np_state_torch)(state)
            if is_jax:
                assert int(metrics["instance_overflow"]) == 0, it
                assert int(metrics["tile_overflow"]) == 0, it

        model_cfg = cfg.ModelConfig(source_path=scene_dirs[name], eval=True,
                                    sh_degree=case.sh_degree)
        kw = dict(testing_iterations=(), saving_iterations=(), quiet=True,
                  on_iteration=on_iteration, seed=SEED)
        if is_jax:
            pipe = cfg.PipelineConfig(backend="jnp", instance_capacity=1 << 14,
                                      max_per_tile=case.max_per_tile, packet_dtype="float32")
            mod.train(model_cfg, cfg.OptimizationConfig(**opt), pipe, **kw)
        else:
            n = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                mod.train(model_cfg, cfg.OptimizationConfig(**opt),
                          cfg.PipelineConfig(packet_dtype="float32"), device="cpu", **kw)
            finally:
                torch.set_num_threads(n)
        monkeypatch.undo()
    return runs["jax"], runs["port"]


def frozen_channels(jax_state, port_state):
    """(C, 3) bool: the colour channels at or under 0 in either loop (band 0
    at or under `rgb_to_sh(0)`), where the clamp stops the SH gradient in
    one loop and may pass it in the other (see the docstring)."""
    return ((jax_state["features_dc"][:, 0, :] <= F0)
            | (port_state["features_dc"][:, 0, :] <= F0))


def field_error(want, got, alive, frozen=None):
    """Max abs difference over the alive rows, the `frozen` colour channels
    left out of an SH field ((C, K, 3) arrays)."""
    assert want.shape == got.shape
    want, got = want.astype(np.float64), got.astype(np.float64)
    if frozen is not None and want.ndim == 3 and want.shape[0] == alive.shape[0]:
        keep = np.broadcast_to((alive[:, None] & ~frozen)[:, None, :], want.shape)
        want, got = want[keep], got[keep]
    elif want.ndim and want.shape[0] == alive.shape[0]:
        want, got = want[alive], got[alive]
    if not want.size:
        return 0.0
    return float(np.max(np.abs(want - got)))


def compare(case: Case, jrun: Run, trun: Run, xyz_lr_max: float):
    """(first parting per field, worst errors): every recorded state of
    both runs, alive masks bit for bit, fields within their tolerances."""
    lr = dict(LR, xyz=xyz_lr_max)
    parted = {}  # field -> (first key where out of tolerance, error, bound)
    worst = {}
    n_frozen = 0
    for step, key in enumerate(case.iterations, start=1):
        keys = [k for k in jrun.states if k == key or (isinstance(k, tuple) and k[1] == key)]
        for k in keys:
            a, b = jrun.states[k], trun.states[k]
            assert a["alive"].shape == b["alive"].shape, (k, "capacity")
            np.testing.assert_array_equal(a["alive"], b["alive"], err_msg=f"alive mask at {k}")
            alive = a["alive"]
            frozen = frozen_channels(a, b)
            n_frozen = max(n_frozen, int(frozen[alive].sum()))
            for f in a:
                if f == "alive":
                    continue
                moments = f[:2] in ("m_", "v_")
                err = field_error(a[f], b[f], alive, frozen if moments else None)
                base = f[2:] if moments else f
                if f in ("counts", "denom", "max_radii2d"):
                    bound = 0.0
                elif f == "grad_accum":
                    bound = STAT_RTOL * float(np.max(np.abs(a[f][alive]), initial=1e-12))
                elif moments:
                    # a moment follows its gradient: held relative to its own scale
                    scale = float(np.max(np.abs(a[f][alive]), initial=0.0))
                    bound = MOMENT_RTOL[base] * scale + 1e-12
                else:
                    bound = 2.0 * lr[f] * step
                worst[f] = max(worst.get(f, 0.0), err / bound if bound else err)
                if err > bound and f not in parted:
                    parted[f] = (k, err, bound)
    worst["frozen colour channels (most at once)"] = n_frozen
    return parted, worst


def assert_events_equal(jrun: Run, trun: Run):
    """Every densify round, resize, reset and SH step at the same iteration,
    with the same counts, bit for bit."""
    assert jrun.events == trun.events, _event_diff(jrun.events, trun.events)


def _event_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"event {i}: jax {x} port {y}"
    return f"jax {len(a)} events, port {len(b)}"


def loss_parting(jrun: Run, trun: Run):
    """The first iteration whose losses differ beyond LOSS_RTOL, or None."""
    assert sorted(jrun.loss) == sorted(trun.loss)
    for it in sorted(jrun.loss):
        if abs(jrun.loss[it] - trun.loss[it]) > LOSS_RTOL * abs(jrun.loss[it]):
            return it, jrun.loss[it], trun.loss[it]
    return None


def xyz_lr_max(scene_dir, case: Case):
    """The largest position LR of the run (the schedule peaks at its first
    iteration, scaled by the scene's camera extent)."""
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.utils.general import expon_lr_func

    opt = tcfg.OptimizationConfig(**dict(case.opt, iterations=case.iterations[-1]))
    extent = float(load_scene(scene_dir, "cpu").cameras_extent)
    sched = expon_lr_func(opt.position_lr_init * extent, opt.position_lr_final * extent,
                          lr_delay_mult=opt.position_lr_delay_mult,
                          max_steps=opt.position_lr_max_steps)
    return max(sched(i) for i in case.iterations)


def check_case(monkeypatch, scene_dirs, name):
    case = CASES[name]
    jrun, trun = run_both(monkeypatch, scene_dirs, case)
    densify = [e for e in jrun.events if e[1] == "densify"]
    parted, worst = compare(case, jrun, trun, xyz_lr_max(scene_dirs["port"], case))
    print(report(jrun, trun, parted, worst))
    assert_events_equal(jrun, trun)
    assert not parted, parted
    assert loss_parting(jrun, trun) is None
    return jrun, densify


def report(jrun, trun, parted, worst):
    """The table `check_case` prints: each event of the JAX run beside the
    port's, then each field's first parting (or "held") and its worst error
    over its tolerance."""
    lines = ["iteration | event | jax | port"]
    for i, e in enumerate(jrun.events):
        other = trun.events[i] if i < len(trun.events) else None
        lines.append(f"{e[0]} | {e[1]} | {e[2]} | "
                     f"{'same' if other == e else other}")
    lines.append("field | first parting (iteration: abs err > bound) | worst err / bound")
    for f in sorted(worst):
        if f.startswith("frozen"):
            lines.append(f"{f} | {worst[f]} | (left out of the SH moments)")
            continue
        p = parted.get(f)
        lines.append(f"{f} | {'held' if p is None else f'{p[0]}: {p[1]:.3g} > {p[2]:.3g}'}"
                     f" | {worst[f]:.3g}")
    lp = loss_parting(jrun, trun)
    lines.append(f"loss | {'held' if lp is None else lp} | rtol {LOSS_RTOL}")
    return "\n".join(lines)


def test_loops_agree_through_densify_growth_reset_and_first_sh_step(monkeypatch, scene_dirs):
    jrun, densify = check_case(monkeypatch, scene_dirs, "fast")
    kinds = {e[1] for e in jrun.events}
    assert {"densify", "resize", "reset", "sh_degree"} <= kinds
    assert sum(e[2]["n_cloned"] for e in densify) > 0
    assert sum(e[2]["n_split"] for e in densify) > 0
    assert sum(e[2]["n_pruned"] for e in densify) > 0
    assert any(e[2]["size_prune"] for e in densify)
    assert [e[2]["degree"] for e in jrun.events if e[1] == "sh_degree"] == [0, 1]


@pytest.mark.slow
def test_loops_agree_through_the_whole_shrunk_schedule(monkeypatch, scene_dirs):
    jrun, densify = check_case(monkeypatch, scene_dirs, "full")
    assert [e[2]["degree"] for e in jrun.events if e[1] == "sh_degree"] == [0, 1, 2, 3]
    assert sum(e[1] == "reset" for e in jrun.events) >= 2
    assert any(e[1] == "resize" for e in jrun.events)
    assert densify[-1][0] < CASES["full"].opt["densify_until_iter"] <= CASES["full"].iterations[-1]
    assert sum(e[2]["n_pruned"] for e in densify if e[2]["size_prune"]) > 0
