"""The port's evaluation sweep, tensorboard events and the train CLI's
checkpoint, profile and viewer flags, on the CPU.

- `evaluate_test` against the JAX package's (backend "jnp", float32) on
  one state carried across and the same views: mean L1 and PSNR at rtol
  1e-5; a train view's ground truth is the pixel cache's own tensor;
- a training run with a model dir writes tensorboard events with the JAX
  loop's tags, and `results["test"]`/`results["train"]` at the
  `testing_iterations`;
- `python -m gsplat_tpu_torch.cli.train` with `--checkpoint_every`,
  `--profile_steps` and `--test_iterations` writes the rolling checkpoint
  and a chrome trace; the same command resumed from the rolling checkpoint
  prints the test PSNR; a viewer port already taken disables the viewer
  and training goes on.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gsplat_tpu_torch.train import loop
from tests.test_torch_train_loop import one_torch_thread, small_scene  # noqa: F401 (fixtures)

JAX_TAGS = {
    "scalars": {"test/loss_viewpoint - l1_loss", "test/loss_viewpoint - psnr",
                "train/loss_viewpoint - l1_loss", "train/loss_viewpoint - psnr",
                "train_loss_patches/l1_loss", "train_loss_patches/total_loss", "iter_time",
                "total_points"},
    "histograms": {"scene/opacity_histogram"},
}


def test_evaluate_test_matches_jax(small_scene):
    import jax.numpy as jnp

    import gsplat_tpu.train.loop as jloop
    from gsplat_tpu.core.types import make_render_settings as j_settings
    from gsplat_tpu.data.scene import Scene as JScene
    from gsplat_tpu.model import init_from_pcd as j_init
    from gsplat_tpu.train.step import init_train_state as j_state
    from gsplat_tpu_torch.convert import train_state_from_numpy
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data.scene import Scene
    from tests.test_torch_train_step import jax_state_to_numpy

    jscene = JScene(small_scene, eval=True, white_background=True)
    params, alive = j_init(jscene.info.points, jscene.info.colors, max_sh_degree=1,
                           capacity=1024)
    jstate = j_state(params, alive, num_images=3)
    js = j_settings(sh_degree=1, backend="jnp", instance_capacity=1 << 14, max_per_tile=1024)
    tscene = Scene(small_scene, eval=True, white_background=True, device="cpu")
    tstate = train_state_from_numpy(jax_state_to_numpy(jstate), "cpu")
    pixels = loop.PixelCache(torch.device("cpu"))
    bg = [1.0, 1.0, 1.0]
    for split in ("test", "train"):
        jcams = getattr(jscene, f"get_{split}_cameras")()
        tcams = getattr(tscene, f"get_{split}_cameras")()
        want = jloop.evaluate_test(jstate, jcams, js, jnp.asarray(bg))
        got = loop.evaluate_test(tstate, tcams, make_render_settings(sh_degree=1), bg, pixels)
        np.testing.assert_allclose(got["l1"], want["l1"], rtol=1e-5, err_msg=split)
        np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5, err_msg=split)
    assert loop.evaluate_test(tstate, [], make_render_settings(sh_degree=1), bg, pixels) is None
    # a view trained on is evaluated on the pixel cache's own upload; a
    # view only evaluated is uploaded once
    pixels = loop.PixelCache(torch.device("cpu"))
    cam, test_cam = tscene.get_train_cameras()[0], tscene.get_test_cameras()[0]
    gt = pixels.get(cam)[0]
    assert pixels.gt(cam) is gt
    assert pixels.gt(test_cam) is pixels.gt(test_cam)


def test_training_writes_tensorboard_events_with_the_jax_tags(small_scene, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg = ModelConfig(source_path=small_scene, model_path=str(tmp_path / "m"),
                      white_background=True, eval=True, sh_degree=1)
    _, _, results = loop.train(cfg, OptimizationConfig(iterations=4, densify_from_iter=100),
                               PipelineConfig(), testing_iterations=(4,), saving_iterations=(),
                               quiet=True, log_every=2, device="cpu")
    assert set(results["test"]) == set(results["train"]) == {4}
    assert np.isfinite(results["test"][4]["psnr"]) and results["train"][4]["l1"] > 0
    acc = EventAccumulator(cfg.model_path)
    acc.Reload()
    tags = acc.Tags()
    assert set(tags["scalars"]) == JAX_TAGS["scalars"]
    assert set(tags["histograms"]) == JAX_TAGS["histograms"]
    assert [e.step for e in acc.Scalars("total_points")] == [2, 4]
    assert acc.Scalars("test/loss_viewpoint - psnr")[0].value == pytest.approx(
        results["test"][4]["psnr"])


def test_train_cli_checkpoints_profiles_and_resumes(small_scene, tmp_path, capsys):
    from gsplat_tpu_torch.cli import train as train_cli

    model = str(tmp_path / "model")
    base = ["-s", small_scene, "-m", model, "-w", "--eval", "--sh_degree", "1",
            "--densify_from_iter", "100", "--device", "cpu", "--quiet"]
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    try:
        rc = train_cli.main(base + ["--iterations", "6", "--checkpoint_every", "3",
                                    "--profile_steps", "2", "--test_iterations", "6",
                                    "--port", str(taken.getsockname()[1])])
    finally:
        taken.close()
    assert rc == 0
    out, err = capsys.readouterr()
    assert "[viewer] disabled" in err and "test PSNR" in out
    # the trace's stage report: two steps, each stage of the step and the counter
    assert "2 calls;" in out and "step/prepare" in out and "counter instances:" in out
    with open(os.path.join(model, "profile", "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and "aten::" in n for n in names)
    rolling = os.path.join(model, "rolling_chkpnt.pkl")
    assert loop.load_checkpoint(rolling, "cpu")[1] == 6

    rc = train_cli.main(base + ["--iterations", "8", "--test_iterations", "8",
                                "--start_checkpoint", rolling, "--disable_viewer"])
    assert rc == 0
    out, _ = capsys.readouterr()
    assert f"Resumed from {rolling} at iteration 6" in out
    assert "iter 8: test PSNR" in out
