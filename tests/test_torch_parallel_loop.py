"""The training loop and the CLIs under `--mesh`, on the CPU (gloo ranks
spawned as processes, one intra-op thread each).

- `train()` with `--mesh 2x1` on 2 ranks runs 6 iterations of the
  `mini_blender` scene (512 points) through a densify round (at 3) and a
  checkpoint (at 4); its state equals a single-process run of the same
  iterations at the train-step tolerances of `tests/test_parallel.py`
  (loss rtol 1e-5, params atol 2e-5, `grad_accum` atol 1e-5; the alive
  mask and the step exactly), and so does its checkpoint.
- The mesh checkpoint resumes in one process and the single-process
  checkpoint on the mesh: the two resumed runs agree at those tolerances.
- The train CLI and the render CLI under `--mesh 1x2` (the 48 px scene's
  3 tile rows padded to 4, over 2 bands) write a model and the renders.
- `blend_mode="oit"` under `--mesh` is refused.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gsplat_tpu_torch.convert import PARAM_FIELDS, read_checkpoint, train_state_to_numpy
from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.parallel import comm

ITERS = 6
OPT = dict(iterations=ITERS, densify_from_iter=1, densification_interval=3,
           densify_until_iter=5, densify_grad_threshold=1e-9)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_scene(mini_blender, tmp_path):
    """A copy of the fixture with its own 512-point cloud."""
    src = tmp_path / "scene"
    shutil.copytree(mini_blender, src, ignore=shutil.ignore_patterns("points3d.ply"))
    rng = np.random.default_rng(0)
    ply_io.write_point_cloud(str(src / "points3d.ply"), rng.random((512, 3)) * 2.6 - 1.3,
                             rng.random((512, 3)) * 255)
    return str(src)


def _train(scene, model, mesh="", start_checkpoint=None, blend_mode="sorted"):
    """`train()` on the CPU; the state as numpy."""
    from gsplat_tpu_torch.train import loop

    state, _, _ = loop.train(
        ModelConfig(source_path=scene, model_path=model, sh_degree=1),
        OptimizationConfig(**OPT),
        PipelineConfig(mesh=mesh, blend_mode=blend_mode),
        testing_iterations=(), saving_iterations=(), checkpoint_iterations=(4,),
        start_checkpoint=start_checkpoint, quiet=True, device="cpu", dist_backend="gloo")
    return train_state_to_numpy(state)


def _train_rank(*args):
    """`_train` in a spawned rank, without tensorboard (rank 0 would import
    it: ~15 s where tensorflow is installed)."""
    from gsplat_tpu_torch.train import loop

    loop._summary_writer = lambda path: None
    return _train(*args)


def assert_states_close(a, b):
    np.testing.assert_array_equal(a["alive"], b["alive"])
    assert a["step"] == b["step"]
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(a["params"][f], b["params"][f], atol=2e-5, err_msg=f)
    np.testing.assert_allclose(a["stats"]["grad_accum"], b["stats"]["grad_accum"], atol=1e-5)


def test_torch_mesh_train_matches_one_process_and_resumes_both_ways(small_scene, tmp_path,
                                                                    monkeypatch):
    from gsplat_tpu_torch.train import loop

    monkeypatch.setattr(loop, "_summary_writer", lambda path: None)
    single = _train(small_scene, str(tmp_path / "single"))
    mesh = comm.run_ranks(_train_rank, 2, "gloo",
                          args=(small_scene, str(tmp_path / "mesh"), "2x1"), threads=1,
                          timeout=300)
    assert mesh[0]["params"]["xyz"].shape[0] == single["params"]["xyz"].shape[0]
    for st in mesh:  # every rank returns the whole state
        assert_states_close(st, single)
    ckpt = {k: read_checkpoint(str(tmp_path / k / "chkpnt4.pkl")) for k in ("single", "mesh")}
    assert ckpt["single"]["iteration"] == ckpt["mesh"]["iteration"] == 4
    assert_states_close(ckpt["mesh"]["state"], ckpt["single"]["state"])
    assert int(ckpt["single"]["state"]["alive"].sum()) > 512  # the densify round grew it

    # the mesh's checkpoint in one process, the single one on the mesh
    resumed_single = _train(small_scene, str(tmp_path / "r1"),
                            start_checkpoint=str(tmp_path / "mesh" / "chkpnt4.pkl"))
    resumed_mesh = comm.run_ranks(
        _train_rank, 2, "gloo", args=(small_scene, str(tmp_path / "r2"), "2x1",
                                      str(tmp_path / "single" / "chkpnt4.pkl")),
        threads=1, timeout=300)
    assert resumed_single["step"] == ITERS - 4 + ckpt["single"]["state"]["step"]
    assert_states_close(resumed_mesh[0], resumed_single)


def _cli(scene, model):
    """The train CLI, then the render CLI, under `--mesh 1x2` (two bands)."""
    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.cli import train as train_cli
    from gsplat_tpu_torch.train import loop

    loop._summary_writer = lambda path: None
    rc = train_cli.main(["-s", scene, "-m", model, "--sh_degree", "1", "--iterations", "4",
                         "--densify_from_iter", "1", "--densification_interval", "2",
                         "--densify_grad_threshold", "1e-9", "--mesh", "1x2", "--device", "cpu",
                         "--dist_backend", "gloo", "--quiet", "--disable_viewer"])
    rc2 = render_cli.main(["-m", model, "-s", scene, "--mesh", "1x2", "--device", "cpu",
                           "--dist_backend", "gloo", "--quiet", "--skip_test"])
    return rc, rc2


def test_torch_cli_mesh_trains_and_renders(small_scene, tmp_path):
    from PIL import Image

    from gsplat_tpu_torch.io.snapshot import load_snapshot

    model = str(tmp_path / "model")
    assert comm.run_ranks(_cli, 2, "gloo", args=(small_scene, model), threads=1,
                          timeout=300) == [(0, 0), (0, 0)]
    _, alive, it, _ = load_snapshot(model, device="cpu")
    assert it == 4 and int(alive.sum()) > 512
    pngs = sorted(os.listdir(os.path.join(model, "train", "ours_4", "renders")))
    assert len(pngs) == 6  # without --eval the 3 test frames train too
    img = np.asarray(Image.open(os.path.join(model, "train", "ours_4", "renders", pngs[0])))
    assert img.shape == (48, 48, 3) and img.std() > 0


def test_torch_mesh_refuses_oit(small_scene, tmp_path):
    with pytest.raises(ValueError, match="OIT is refused under --mesh"):
        _train(small_scene, str(tmp_path / "m"), mesh="2x1", blend_mode="oit")
