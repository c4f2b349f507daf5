"""Checkpoints and resume of the port's training loop, on the CPU.

- save/load round trip bit for bit, the generator's state captured when
  the write is submitted (a densify round between the submit and the
  worker's copy must not change what is written); the file holds no class
  reference, and a file that names another class is refused;
- the rolling checkpoint, written on the worker thread and flushed at the
  end (as `tests/test_train_loop.py:193-250` checks for the JAX loop);
- resume: the first iteration, the SH degree the ramp would have reached
  and the capacity controller built at the checkpoint's capacity;
- a `gsplat_tpu` checkpoint read without JAX, bit for bit what
  `gsplat_tpu.train.loop.load_checkpoint` reads;
- the port loop and the JAX loop (backend "jnp"), each resumed from its own
  checkpoint of the same carried-across state: per-iteration losses within
  rtol 1e-5 (the one-step tolerance of `tests/test_torch_train_step.py:154`).
"""

import dataclasses
import io
import os
import pickle
import threading

import numpy as np
import pytest
import torch

from gsplat_tpu.config import ModelConfig as JModel
from gsplat_tpu.config import OptimizationConfig as JOpt
from gsplat_tpu.config import PipelineConfig as JPipe
from gsplat_tpu_torch import convert
from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gsplat_tpu_torch.synthetic import tiny_scene
from gsplat_tpu_torch.train import loop
from gsplat_tpu_torch.train.resize import resize_train_state
from gsplat_tpu_torch.train.step import init_train_state, make_densify_step
from tests.test_torch_train_loop import one_torch_thread, small_scene  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """No event files here (`tests/test_torch_eval.py` checks them): where
    tensorflow is installed, tensorboard's writer imports it, which takes
    many seconds on the CPU."""
    monkeypatch.setattr(loop, "_summary_writer", lambda model_path: None)


def assert_trees_equal(got, want, where=""):
    """Nested dicts of arrays and scalars equal, arrays bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8), err_msg=where)
    else:
        assert got == want, where


def globals_of(path):
    """The (module, name) pairs a pickle file refers to."""
    found = set()

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            found.add((module, name))
            return super().find_class(module, name)

    with open(path, "rb") as f:
        Recording(f).load()
    return found


def port_state(capacity=1024, n=700):
    params, alive, _ = tiny_scene(n=n, capacity=capacity, sh_degree=1, device="cpu")
    state = init_train_state({k: getattr(params, k).detach() for k in convert.PARAM_FIELDS},
                             alive, num_images=3, seed=5)
    torch.randn(7, generator=state.rng)  # a generator that has drawn
    stats = {k: v + torch.rand(v.shape, generator=torch.Generator().manual_seed(1)).to(v.dtype)
             for k, v in state.stats.items()}
    return dataclasses.replace(state, stats=stats, step=17)


def test_save_load_round_trip_with_the_generator_taken_at_submit(tmp_path, monkeypatch):
    state = port_state()
    want = convert.train_state_to_numpy(state)
    # the synchronous save writes the same contents
    sync = str(tmp_path / "chkpnt40.pkl")
    loop.save_checkpoint(sync, state, 40)
    assert_trees_equal(convert.read_checkpoint(sync), {"state": want, "iteration": 40})

    gate = threading.Event()
    to_numpy = loop.tree_to_numpy

    def gated(tree):  # the worker waits until the densify round has run
        assert gate.wait(timeout=60)
        return to_numpy(tree)

    monkeypatch.setattr(loop, "tree_to_numpy", gated)
    path = str(tmp_path / "rolling_chkpnt.pkl")
    writer = loop.CheckpointWriter()
    try:
        writer.submit(path, state, 40)
        densified, _ = make_densify_step(OptimizationConfig())(state, 5.0, 0)
        assert not np.array_equal(state.rng.get_state().numpy(), want["rng_state"])
        gate.set()
        writer.flush()
    finally:
        writer.close()
    assert not os.path.exists(path + ".tmp")

    blob = convert.read_checkpoint(path)
    assert blob["iteration"] == 40
    assert_trees_equal(blob["state"], want)
    assert {m for m, _ in globals_of(path)} <= {"numpy", "numpy._core.numeric",
                                                "numpy.core.numeric", "numpy._core.multiarray",
                                                "numpy.core.multiarray"}

    loaded, it = loop.load_checkpoint(path, "cpu")
    assert it == 40 and loaded.step == 17
    assert_trees_equal(convert.train_state_to_numpy(loaded), want)
    # the restored generator continues the submitted one's sequence
    ref = torch.Generator().manual_seed(0)
    ref.set_state(torch.from_numpy(want["rng_state"]))
    assert torch.equal(torch.randn(5, generator=loaded.rng), torch.randn(5, generator=ref))
    del densified


def test_a_checkpoint_naming_another_class_is_refused(tmp_path):
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"state": io.BytesIO(b""), "iteration": 1}))
    with pytest.raises(pickle.UnpicklingError, match="_io.BytesIO"):
        convert.read_checkpoint(str(path))


def small_cfg(scene, tmp_path, **kw):
    return ModelConfig(source_path=scene, model_path=str(tmp_path / "m"),
                       white_background=True, eval=True, sh_degree=1, **kw)


def test_rolling_checkpoint_flushed_at_the_end_and_resume(small_scene, tmp_path):
    cfg = small_cfg(small_scene, tmp_path)
    opt = OptimizationConfig(iterations=8, densify_from_iter=100)
    pipe = PipelineConfig(capacity=1024)
    state8, _, _ = loop.train(cfg, opt, pipe, testing_iterations=(), saving_iterations=(),
                              quiet=True, checkpoint_every=4, device="cpu")
    rolling = os.path.join(cfg.model_path, "rolling_chkpnt.pkl")
    loaded, it = loop.load_checkpoint(rolling, "cpu")
    assert it == 8  # flushed at the end, so it holds the last multiple of 4
    assert_trees_equal(convert.train_state_to_numpy(loaded),
                       convert.train_state_to_numpy(state8))

    # resume for 4 more iterations: the params keep training
    seen = []
    state12, _, _ = loop.train(cfg, dataclasses.replace(opt, iterations=12), pipe,
                               testing_iterations=(), saving_iterations=(), quiet=True,
                               start_checkpoint=rolling, device="cpu",
                               on_iteration=lambda i, s, m: seen.append(i))
    assert seen == [9, 10, 11, 12] and state12.step == state8.step + 4
    assert not torch.equal(state12.params["xyz"], state8.params["xyz"])


def test_resume_restores_iteration_sh_degree_and_controller_capacity(small_scene, tmp_path,
                                                                     monkeypatch):
    """A checkpoint at iteration 2000 of a state resized to 8192 rows: the
    run resumes at 2001 with SH degree min(2, 1) = 1, and the capacity
    controller starts at 8192 rows, not at the init cloud's 4096."""
    cfg = small_cfg(small_scene, tmp_path)
    state = resize_train_state(port_state(capacity=4096, n=400), 8192)
    path = str(tmp_path / "chkpnt2000.pkl")
    loop.save_checkpoint(path, state, 2000)

    degrees, capacities = [], []
    make_step = loop.make_train_step

    def recording_step(opt, settings, **kw):
        degrees.append(settings.sh_degree)
        return make_step(opt, settings, **kw)

    class RecordingController(loop.CapacityController):
        def __init__(self, capacity, **kw):
            capacities.append(capacity)
            super().__init__(capacity, **kw)

    monkeypatch.setattr(loop, "make_train_step", recording_step)
    monkeypatch.setattr(loop, "CapacityController", RecordingController)
    seen = []
    out, _, _ = loop.train(cfg, OptimizationConfig(iterations=2002, densify_from_iter=10**6),
                           PipelineConfig(capacity=0), testing_iterations=(),
                           saving_iterations=(), quiet=True, start_checkpoint=path,
                           device="cpu", on_iteration=lambda i, s, m: seen.append(i))
    assert seen == [2001, 2002]
    assert degrees == [1] and capacities == [8192] and out.capacity == 8192


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX `TrainState` initialised from the small scene's cloud (SH 1,
    1024 rows) and pickled by `gsplat_tpu.train.loop.save_checkpoint` at
    iteration 1000."""
    import gsplat_tpu.train.loop as jloop
    from gsplat_tpu.model import init_from_pcd as j_init
    from gsplat_tpu.train.step import init_train_state as j_state

    rng = np.random.default_rng(3)
    pts = (rng.random((400, 3)) * 2.6 - 1.3).astype(np.float32)
    params, alive = j_init(pts, rng.random((400, 3)).astype(np.float32), max_sh_degree=1,
                           capacity=1024)
    state = j_state(params, alive, num_images=3, seed=2)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "chkpnt1000.pkl")
    jloop.save_checkpoint(path, state, 1000)
    return path


def test_jax_checkpoint_reads_without_jax_bit_for_bit(jax_checkpoint):
    import gsplat_tpu.train.loop as jloop

    jstate, jit = jloop.load_checkpoint(jax_checkpoint)
    tstate, tit = convert.train_state_from_jax_checkpoint(jax_checkpoint, "cpu")
    assert tit == jit == 1000 and tstate.step == int(jstate.step)
    got = convert.train_state_to_numpy(tstate)
    for name in ("params", "adam_m", "adam_v"):
        for f in convert.PARAM_FIELDS:
            assert_trees_equal(got[name][f], np.asarray(getattr(getattr(jstate, name), f)),
                               f"{name}.{f}")
    for name in ("alive", "adam_counts", "exposure", "exp_m", "exp_v", "exp_step"):
        assert_trees_equal(got[name], np.asarray(getattr(jstate, name)), name)
    assert_trees_equal(got["stats"], {k: np.asarray(v) for k, v in jstate.stats.items()})


def test_resumed_port_and_jax_loops_match(jax_checkpoint, small_scene, tmp_path):
    """Each loop resumes from its own checkpoint of one state at iteration
    1000 (SH degree caught up to 1) and trains 3 iterations on the same
    views in the same order, with float32 packets (the JAX "jnp" backend
    has no hybrid ones): losses within rtol 1e-5. The port resumed from the
    JAX file itself gives the same losses as from its own checkpoint."""
    import gsplat_tpu.train.loop as jloop

    port_ckpt = str(tmp_path / "port_chkpnt1000.pkl")
    state, it = convert.train_state_from_jax_checkpoint(jax_checkpoint, "cpu")
    loop.save_checkpoint(port_ckpt, state, it)

    def losses_of(train, cfg, opt, pipe, start, **kw):
        out = {}
        train(cfg, opt, pipe, testing_iterations=(), saving_iterations=(), quiet=True,
              start_checkpoint=start, log_every=1,
              on_iteration=lambda i, s, m: out.__setitem__(i, float(m["loss"])), **kw)
        return out

    kw = dict(source_path=small_scene, white_background=True, eval=True, sh_degree=1)
    jl = losses_of(jloop.train, JModel(**kw), JOpt(iterations=1003, densify_from_iter=10**6),
                   JPipe(backend="jnp", instance_capacity=1 << 14, max_per_tile=1024,
                         capacity=1024, packet_dtype="float32"), jax_checkpoint)
    tl = losses_of(loop.train, ModelConfig(**kw),
                   OptimizationConfig(iterations=1003, densify_from_iter=10**6),
                   PipelineConfig(capacity=1024, packet_dtype="float32"), port_ckpt,
                   device="cpu")
    assert sorted(jl) == sorted(tl) == [1001, 1002, 1003]
    np.testing.assert_allclose([tl[i] for i in sorted(tl)], [jl[i] for i in sorted(jl)],
                               rtol=1e-5)
    # `start_checkpoint` also takes the JAX file itself: the same run
    direct = losses_of(loop.train, ModelConfig(**kw),
                       OptimizationConfig(iterations=1003, densify_from_iter=10**6),
                       PipelineConfig(capacity=1024, packet_dtype="float32"), jax_checkpoint,
                       device="cpu")
    assert direct == tl
