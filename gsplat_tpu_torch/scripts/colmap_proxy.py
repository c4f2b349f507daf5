"""The COLMAP quality run: counterpart of `scripts/colmap_proxy_r5.sh` and
of the COLMAP part of `scripts/collect_r5.py`.

    python -m gsplat_tpu_torch.scripts.colmap_proxy --out DIR --seed S \\
        [--iterations 30000] [--device cuda] [-- <more train CLI arguments>]

1. Deletes `DIR/scene` and writes the gaussian-GT COLMAP scene there with
   the recipe's arguments (`RECIPE`: 4,096 GT gaussians, 2,048 SfM points,
   64 PINHOLE views at 400x304, focal 380, seed 3), its ground truth
   rendered on `--device`. A scene left by an earlier run is never reused:
   the reader prefers a `sparse/0/points3D.ply` to the bins, so a stale one
   would become the init. `DIR/model` is deleted too unless the run
   resumes (`--start_checkpoint`).
2. Trains `DIR/model` from it through the supervisor
   (`python -m gsplat_tpu_torch.cli.train_supervised --stall_timeout 900
   --checkpoint_every 500 -- -s DIR/scene -m DIR/model --eval --iterations
   N --test_iterations 1500 7000 N --save_iterations 7000 N
   --disable_viewer --seed S --device D`), its output in `DIR/model/
   train.log`. Not `--quiet`: the step time and alive counts are read
   from the log's timed lines (the port's tensorboard `iter_time` times
   one iteration in ten, and tensorboard is not installed everywhere).
   `--in_process` runs the train CLI in this process
   without the supervisor (for a caller that counts kernel launches).
   Arguments after `--` are appended to the train CLI's (a variant of the
   recipe, e.g. `-- --packet_dtype float32`; the summary names them).
3. Renders the held-out views at 7,000 and at N (`cli.render --eval
   --skip_train`), then scores every rendered iteration (`cli.metrics`):
   `DIR/model/results.json` and `per_view.json`. LPIPS is null with
   `LPIPS_status: "weights_unavailable"` unless `GSPLAT_LPIPS_WEIGHTS`
   names the weights.
4. At each saved iteration, the trained cloud's forward rate on the first
   train view (`bench.measure_render_only_trained`) and the warp cull on
   the first held-out view (`cull_report`); `--skip_report` leaves them out.
5. Writes `DIR/summary.json`, `{"model": row}` with `collect_r5.py`'s keys
   (`results`, `train_minutes`, `train_minutes_tb`,
   `steady_iter_ms_median`) and more (`collect`), and copies
   `results.json`, `per_view.json` and `cfg_args` beside it as
   `model_<name>`, as `collect_r5.py` lays out `artifacts/<tag>/`.

`--small` writes a 9-view scene of 96x64 (256 GT gaussians, 128 points)
instead: a rehearsal of the chain on the CPU (`--device cpu`) in about a
second per iteration.

A run that the card's time limit cuts resumes from its rolling
checkpoint: `--start_checkpoint DIR/model/rolling_chkpnt.pkl` keeps
`DIR/model` and regenerates the scene (bit for bit the same bins). As in
the JAX loop, the resumed run restarts the camera order.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

RECIPE = dict(n_gauss=4096, n_points=2048, n_images=64, width=400, height=304, focal=380.0,
              seed=3)
# a CPU rehearsal's scene (`--small`): the size of the CPU tests
SMALL_RECIPE = dict(n_gauss=256, n_points=128, n_images=9, width=96, height=64, focal=90.0,
                    seed=7)
ITERATIONS = 30_000
# the held-out views are also evaluated here, the length of `chip_smoke.py`'s
# short run, so that run's PSNR has a bar from the full runs
SMOKE_ITERATIONS = 1_500
SAVE_AT = 7_000  # the 7k row of the reference's tables, rendered and scored
STALL_TIMEOUT = 900
CHECKPOINT_EVERY = 500
STEADY_WINDOW = 1_000  # iterations per interval of the steady step time's median
LOG = "train.log"
COPIED = ("results.json", "per_view.json", "cfg_args")
# the directory that holds the package, so child processes import this
# checkout's package from any working directory
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def schedule(iterations: int):
    """(test iterations, save iterations) of a run of `iterations`."""
    test = sorted({i for i in (SMOKE_ITERATIONS, SAVE_AT, iterations) if i <= iterations})
    save = sorted({i for i in (SAVE_AT, iterations) if i <= iterations})
    return test, save


def generate_scene(scene_dir: str, device=None, recipe=None):
    """Delete `scene_dir` and write the recipe's scene into it."""
    from gsplat_tpu_torch.scripts.make_fixtures import make_colmap_gaussian_scene

    shutil.rmtree(scene_dir, ignore_errors=True)
    make_colmap_gaussian_scene(scene_dir, **(recipe or RECIPE), device=device)


def train_args(scene_dir, model_dir, iterations, seed, device, start_checkpoint=None,
               extra=()):
    test, save = schedule(iterations)
    args = ["-s", scene_dir, "-m", model_dir, "--eval", "--iterations", str(iterations),
            "--test_iterations", *map(str, test), "--save_iterations", *map(str, save),
            "--disable_viewer", "--seed", str(seed), "--device", str(device)]
    return (args + (["--start_checkpoint", start_checkpoint] if start_checkpoint else [])
            + list(extra))


class _Tee:
    """stdout to the terminal and to a log file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def train(scene_dir, model_dir, iterations, seed, device, start_checkpoint=None,
          in_process=False, extra=()):
    """Step 2; returns the train process's exit code. `extra` is appended
    to the train CLI's arguments."""
    os.makedirs(model_dir, exist_ok=True)
    log = os.path.join(model_dir, LOG)
    args = train_args(scene_dir, model_dir, iterations, seed, device, start_checkpoint, extra)
    if in_process:
        from gsplat_tpu_torch.cli import train as train_cli

        with open(log, "a") as f, contextlib.redirect_stdout(_Tee(sys.stdout, f)):
            return train_cli.main(args + ["--checkpoint_every", str(CHECKPOINT_EVERY)])
    path = os.pathsep.join(p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "gsplat_tpu_torch.cli.train_supervised", "--stall_timeout",
           str(STALL_TIMEOUT), "--checkpoint_every", str(CHECKPOINT_EVERY), "--log", log,
           "--", *args]
    return subprocess.run(cmd, env={**os.environ, "PYTHONPATH": path}).returncode


def render_and_score(scene_dir, model_dir, iterations, device):
    """Step 3: the held-out renders of every saved iteration, then the
    metrics of every rendered iteration."""
    from gsplat_tpu_torch.cli import metrics as metrics_cli
    from gsplat_tpu_torch.cli import render as render_cli

    for it in schedule(iterations)[1]:
        rc = render_cli.main(["-m", model_dir, "-s", scene_dir, "--eval", "--skip_train",
                              "--iteration", str(it), "--device", str(device)])
        if rc:
            return rc
    return metrics_cli.main(["-m", model_dir, "--device", str(device)])


def cull_report(model_dir, scene_dir, iteration, device=None):
    """The warp cull of K2' and K3' on a trained state: the snapshot at
    `iteration` binned on the first held-out view with float32 packets (a
    render's) and hybrid ones (a train step's).

    `cull_stats_torch` on the frame, per packet type: kept pairs outside a
    box and in a skipped warp (both must be 0), the instances whose
    `pixel_box_torch` box is the whole plane, so the cull skips no warp for
    them, and their share, and the culled share of (warp, instance) pairs
    per warp layout."""
    import torch

    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.io.snapshot import load_snapshot
    from gsplat_tpu_torch.ops import rasterize_cuda as rc
    from gsplat_tpu_torch.ops.binning import pack_bins
    from gsplat_tpu_torch.ops.projection import preprocess
    from gsplat_tpu_torch.render import grid_dims
    from gsplat_tpu_torch.scripts.make_fixtures import gt_render_settings

    dev = resolve_device(device)
    params, alive, _, _ = load_snapshot(model_dir, iteration, device=dev)
    holder = load_scene(scene_dir, dev, eval=True).get_test_cameras()[0]
    cam = holder.camera
    settings = gt_render_settings()
    gx, gy = grid_dims(cam, settings.tile)
    out = {"view": holder.image_name, "n_gauss": int(alive.sum())}
    with torch.no_grad():
        screen = preprocess(params, alive, cam, settings, gx, gy)
        for dtype in ("float32", "hybrid"):
            pb = pack_bins(screen, gx, gy, settings.tile, settings.tight_cull, packet_dtype=dtype)
            out[dtype] = rc.cull_stats_torch(pb.inst_t, pb.tile_start, pb.tile_end, gx, gy)
    return out


def trained_report(model_dir, scene_dir, iterations, device=None):
    """Step 4 at every saved iteration."""
    from gsplat_tpu_torch import bench

    return {str(it): {"render_only": bench.measure_render_only_trained(
                          model_dir, scene_dir, iteration=it, device=device),
                      "cull": cull_report(model_dir, scene_dir, it, device)}
            for it in schedule(iterations)[1]}


# --- the collector (`scripts/collect_r5.py`)

_TIMED = re.compile(r"^it\s+(\d+)\s.*\balive (\d+)\b.*\((\d+(?:\.\d+)?)s\)\s*$")
_TEST = re.compile(r"^\[ITER (\d+)\] test: L1 (\S+) PSNR (\S+)")


def wall_minutes(log_path):
    """Training wall time summed over restarts from the log's timed lines
    (`it  30000 ... (1234.5s)` restarts from 0 with each relaunch)."""
    if not os.path.exists(log_path):
        return None
    total, last = 0.0, 0.0
    with open(log_path, errors="replace") as f:
        for line in f:
            m = re.search(r"\((\d+(?:\.\d+)?)s\)\s*$", line.strip())
            if m:
                v = float(m.group(1))
                if v < last:  # relaunch reset
                    total += last
                last = v
    return round((total + last) / 60.0, 1)


def read_log(log_path, steady_from=15_000):
    """From the train log: the steady per-iteration ms past `steady_from`,
    the alive count of each timed line and the test PSNR printed at each
    test iteration.

    The timed lines' stamps are seconds since the launch, to 0.1 s, every
    `log_every` iterations; a stamp below the one before starts a new
    launch, and no interval crosses one. `steady_iter_ms_median` is the
    median over the intervals between the lines at multiples of
    `STEADY_WINDOW` (0.1 ms resolution; 10-iteration intervals would put
    it on a 10 ms grid), `steady_iter_ms_mean` their seconds over their
    iterations between every pair of consecutive lines."""
    rows, psnr, launch, last = [], {}, 0, -1.0
    if os.path.exists(log_path):
        with open(log_path, errors="replace") as f:
            for line in map(str.strip, f):
                m = _TIMED.match(line)
                if m:
                    t = float(m.group(3))
                    launch += t < last
                    last = t
                    rows.append((int(m.group(1)), int(m.group(2)), t, launch))
                m = _TEST.match(line)
                if m:
                    psnr[int(m.group(1))] = float(m.group(3))

    def intervals(lines):
        return [(i1 - i0, t1 - t0) for (i0, _, t0, l0), (i1, _, t1, l1) in zip(lines, lines[1:])
                if i0 >= steady_from and l0 == l1 and i1 > i0]

    every = intervals(rows)
    windows = intervals([r for r in rows if r[0] % STEADY_WINDOW == 0])
    return {"steady_iter_ms_median": (statistics.median(1e3 * t / i for i, t in windows)
                                      if windows else None),
            "steady_iter_ms_mean": (1e3 * sum(t for _, t in every) / sum(i for i, _ in every)
                                    if every else None),
            "alive": {it: a for it, a, _, _ in rows}, "test_psnr": psnr}


def read_results(model_dir):
    p = os.path.join(model_dir, "results.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def collect(out_dir, iterations, extra=None):
    """Step 5: `DIR/summary.json`, `{"model": row}`. The row holds
    `collect_r5.py`'s keys: `results`, `train_minutes` (the log's wall
    time), `train_minutes_tb` and `steady_iter_ms_median`.
    `train_minutes_tb` is null: the JAX collector sums tensorboard's
    `iter_time`, whose samples there each absorb a log tick of ~10
    iterations, but the port's loop times the logging iteration alone, so
    its samples cover one iteration in `log_every`. Both step times come
    from the log (`read_log`): `steady_iter_ms_median` and
    `steady_iter_ms_mean` past `steady_from` (null where the run has no
    `STEADY_WINDOW` interval there). Also `final_alive` (the log's last
    timed line), `alive` at each test and save iteration, and
    `test_psnr_log` (the loop's held-out PSNR at each test iteration, on
    float renders, where `results` scores the saved PNGs). `extra` is
    merged in."""
    model_dir = os.path.join(out_dir, "model")
    steady_from = iterations // 2  # 15,000 at the recipe's length
    log = read_log(os.path.join(model_dir, LOG), steady_from)
    row = {"results": read_results(model_dir),
           "train_minutes": wall_minutes(os.path.join(model_dir, LOG)),
           "train_minutes_tb": None, "steady_iter_ms_median": log["steady_iter_ms_median"],
           "steady_iter_ms_mean": log["steady_iter_ms_mean"], "steady_from": steady_from}
    alive = log["alive"]
    test, save = schedule(iterations)
    row.update(final_alive=alive[max(alive)] if alive else None,
               alive={str(it): alive.get(it) for it in sorted(set(test) | set(save))},
               test_psnr_log={str(it): v for it, v in sorted(log["test_psnr"].items())},
               **(extra or {}))
    summary = {"model": row}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for name in COPIED:
        src = os.path.join(model_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, f"model_{name}"))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="the COLMAP quality run on the card")
    p.add_argument("--out", required=True, help="run directory: scene/, model/, summary.json")
    p.add_argument("--seed", type=int, default=0, help="the train seed (the scene's is fixed)")
    p.add_argument("--iterations", type=int, default=ITERATIONS)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--start_checkpoint", default=None,
                   help="resume the model from this checkpoint (keeps DIR/model)")
    p.add_argument("--in_process", action="store_true",
                   help="train in this process, without the supervisor")
    p.add_argument("--skip_report", action="store_true",
                   help="no trained-cloud rate or cull counts")
    p.add_argument("--small", action="store_true",
                   help="the small scene of a CPU rehearsal (SMALL_RECIPE), not the recipe's")
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    args = p.parse_args(argv[:len(argv) - len(extra) - (1 if "--" in argv else 0)])
    recipe = SMALL_RECIPE if args.small else RECIPE

    from gsplat_tpu_torch.bench import card
    from gsplat_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    scene_dir = os.path.join(args.out, "scene")
    model_dir = os.path.join(args.out, "model")
    if not args.start_checkpoint:
        shutil.rmtree(model_dir, ignore_errors=True)
    generate_scene(scene_dir, dev, recipe)
    rc = train(scene_dir, model_dir, args.iterations, args.seed, dev, args.start_checkpoint,
               args.in_process, extra)
    if rc:
        print(f"colmap_proxy: training failed (exit {rc})", file=sys.stderr)
        return rc
    rc = render_and_score(scene_dir, model_dir, args.iterations, dev)
    if rc:
        return rc
    info = {"seed": args.seed, "iterations": args.iterations, "recipe": recipe,
            "train_args_extra": extra, "device": card(dev)}
    if not args.skip_report:
        info["trained_cloud"] = trained_report(model_dir, scene_dir, args.iterations, dev)
    summary = collect(args.out, args.iterations, info)
    print(json.dumps(summary), flush=True)
    print("COLMAP PROXY DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
