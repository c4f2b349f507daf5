"""The port's supervisor, full-eval harness and COLMAP convert CLIs on the
CPU, with their child commands observed rather than run on a scene.

- `cli/train_supervised.py` (the counterpart of
  `scripts/train_supervised.py`): a child that exits non-zero after writing
  the rolling checkpoint is relaunched with `--start_checkpoint` at it, a
  child that stalls is killed and relaunched, and a child that completes
  ends the run; the child is `python -m gsplat_tpu_torch.cli.train`;
- `cli/full_eval.py` runs the port's supervisor, render and metrics CLIs
  with `--device` passed through;
- `cli/convert.py` issues the top-level `convert.py`'s COLMAP and
  ImageMagick commands.
"""

import os
import subprocess
import sys

import pytest

from gsplat_tpu_torch.cli import convert as convert_cli
from gsplat_tpu_torch.cli import full_eval
from gsplat_tpu_torch.cli import train_supervised as sup


def test_supervisor_resumes_after_a_crash_and_a_stall(tmp_path, monkeypatch):
    model = str(tmp_path / "model")
    rolling = os.path.join(model, "rolling_chkpnt.pkl")
    launched = []
    # attempt 1 writes the rolling checkpoint and fails; attempt 2 hangs
    # silently; attempt 3 completes
    scripts = [
        f"open({rolling!r}, 'w').write('x'); print('it 10'); raise SystemExit(3)",
        "import time; time.sleep(60)",
        "print('done')",
    ]

    def fake_run_once(args, log_f):
        launched.append(args)
        return subprocess.Popen([sys.executable, "-c", scripts[len(launched) - 1]],
                                stdout=log_f, stderr=subprocess.STDOUT, start_new_session=True)

    monkeypatch.setattr(sup, "run_once", fake_run_once)
    monkeypatch.setattr(sup, "POLL_S", 0.1)
    monkeypatch.setattr(sup, "RESTART_PAUSE_S", 0.0)
    rc = sup.main(["--stall_timeout", "1", "--startup_grace", "1", "--checkpoint_every", "7",
                   "--", "-s", "scene", "-m", model])
    assert rc == 0 and len(launched) == 3
    assert launched[0] == ["-s", "scene", "-m", model, "--checkpoint_every", "7"]
    for args in launched[1:]:
        assert args[-2:] == ["--start_checkpoint", rolling]
    log = open(os.path.join(model, "train_supervised.log")).read()
    assert "STALL" in log and "attempt 3" in log and "done" in log


def test_supervisor_launches_the_port_train_cli(tmp_path, monkeypatch):
    seen = {}

    class FakePopen:
        def __init__(self, cmd, env, **kw):
            seen.update(cmd=cmd, env=env)

    monkeypatch.setattr(sup.subprocess, "Popen", FakePopen)
    sup.run_once(["-s", "x"], None)
    assert seen["cmd"][1:] == ["-m", "gsplat_tpu_torch.cli.train", "-s", "x"]
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == sup.PACKAGE_ROOT
    assert os.path.isdir(os.path.join(sup.PACKAGE_ROOT, "gsplat_tpu_torch"))


def test_full_eval_drives_the_port_clis(tmp_path, monkeypatch):
    cmds = []
    monkeypatch.setattr(full_eval, "run", lambda cmd: cmds.append(cmd) or 0)
    out = str(tmp_path / "eval")
    assert full_eval.main(["-ns", "/data/nerf", "--scenes", "lego", "--output_path", out,
                           "--iterations", "9000", "--device", "cpu"]) == 0
    modules = [c[2] for c in cmds]
    assert modules == ["gsplat_tpu_torch.cli.train_supervised", "gsplat_tpu_torch.cli.render",
                       "gsplat_tpu_torch.cli.render", "gsplat_tpu_torch.cli.metrics"]
    for c in cmds:
        assert c[-2:] == ["--device", "cpu"]
    train = cmds[0]
    assert train[train.index("--") + 1:][:4] == ["-s", "/data/nerf/lego", "-w", "-m"]
    assert ["--test_iterations", "7000", "9000"] == train[train.index("--test_iterations"):][:3]
    assert [c[c.index("--iteration") + 1] for c in cmds[1:3]] == ["7000", "9000"]
    assert cmds[3][3:5] == ["-m", os.path.join(out, "lego")]
    assert os.path.exists(os.path.join(out, "timing.txt"))


@pytest.mark.parametrize("flags,want", [
    ([], ["feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"]),
    (["--skip_matching"], ["image_undistorter"]),
])
def test_convert_issues_the_colmap_commands(tmp_path, monkeypatch, flags, want):
    cmds = []
    monkeypatch.setattr(convert_cli, "run", cmds.append)
    src = tmp_path / "scene"
    (src / "sparse").mkdir(parents=True)
    (src / "sparse" / "cameras.bin").write_bytes(b"")
    assert convert_cli.main(["-s", str(src), "--no_gpu", *flags]) == 0
    assert [c.split()[1] for c in cmds] == want
    assert all("use_gpu 0" in c for c in cmds if "use_gpu" in c)
    assert (src / "sparse" / "0" / "cameras.bin").exists()
