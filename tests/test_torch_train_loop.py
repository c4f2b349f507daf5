"""The port's training loop and CLI on the CPU, end to end.

`python -m gsplat_tpu_torch.cli.train` runs three iterations (a densify
round and an opacity reset forced into them by its flags) on the
`mini_blender` fixture with a 512-point cloud on `--device cpu`. The
snapshot it saves loads in the JAX package's `load_snapshot` with the same
values the port's own loader gives, and the port's render CLI renders it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from gsplat_tpu.io.snapshot import load_snapshot as j_load_snapshot
from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.data import ply as ply_io
from gsplat_tpu_torch.io.snapshot import load_snapshot as t_load_snapshot


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests: the tier-1 run shares the
    CPU between six test workers, and small ops that each start eight
    threads there mostly wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_scene(mini_blender, tmp_path):
    """A copy of the fixture with its own 512-point cloud (the Blender
    reader's default is 100,000 random points)."""
    src = tmp_path / "scene"
    shutil.copytree(mini_blender, src, ignore=shutil.ignore_patterns("points3d.ply"))
    rng = np.random.default_rng(0)
    ply_io.write_point_cloud(str(src / "points3d.ply"), rng.random((512, 3)) * 2.6 - 1.3,
                             rng.random((512, 3)) * 255)
    return str(src)


def test_train_cli_three_iterations_saves_a_model_both_packages_read(small_scene, tmp_path):
    from gsplat_tpu_torch.cli import render as render_cli
    from gsplat_tpu_torch.cli import train as train_cli

    model = str(tmp_path / "model")
    rc = train_cli.main([
        "-s", small_scene, "-m", model, "-w", "--eval", "--sh_degree", "1",
        "--iterations", "3", "--densify_from_iter", "1", "--densification_interval", "2",
        "--opacity_reset_interval", "3", "--densify_grad_threshold", "1e-9",
        "--log_every", "1", "--device", "cpu", "--quiet", "--disable_viewer",
    ])
    assert rc == 0
    for f in ("cfg_args", "input.ply", "cameras.json", "exposure.json"):
        assert os.path.exists(os.path.join(model, f)), f

    jp, ja, jit, _ = j_load_snapshot(model)
    tp, ta, tit, _ = t_load_snapshot(model, device="cpu")
    assert jit == tit == 3
    n = int(np.asarray(ja).sum())
    assert n == int(ta.sum()) > 512  # the densify round at iteration 2 added rows
    for f in PARAM_FIELDS:
        want = np.asarray(getattr(jp, f))[:n]
        got = getattr(tp, f).detach().numpy()[:n]
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert np.isfinite(got).all(), f
    # the opacity reset at iteration 3 clamped every opacity to <= 0.01
    assert (1.0 / (1.0 + np.exp(-np.asarray(jp.opacity)[:n])) <= 0.0100001).all()

    assert render_cli.main(["-m", model, "-s", small_scene, "--device", "cpu", "--quiet"]) == 0
    renders = os.path.join(model, "test", "ours_3", "renders")
    assert len(os.listdir(renders)) == 3


def test_train_loop_loss_falls_and_refuses_unported_options(small_scene, tmp_path):
    from gsplat_tpu_torch.train.loop import train

    cfg = ModelConfig(source_path=small_scene, model_path=str(tmp_path / "m"),
                      white_background=True, sh_degree=1)
    opt = OptimizationConfig(iterations=12, densify_from_iter=100)
    state, scene, results = train(cfg, opt, PipelineConfig(), saving_iterations=(),
                                  quiet=True, log_every=1, device="cpu")
    losses = [results["loss"][i] for i in sorted(results["loss"])]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert state.step == 12 and all(torch.isfinite(v).all() for v in state.params.values())
    # checkpoints (`tests/test_torch_checkpoint.py`) and the multi-device
    # path (`tests/test_torch_parallel_loop.py`) are ported; OIT is refused
    # under a mesh, before any process group is joined
    with pytest.raises(ValueError, match="OIT is refused under --mesh"):
        train(cfg, opt, PipelineConfig(mesh="2x2", blend_mode="oit"), quiet=True, device="cpu")
