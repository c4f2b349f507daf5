"""Full evaluation harness on the card: counterpart of the top-level
`full_eval.py` (reference `full_eval.py:16-112`).

    python -m gsplat_tpu_torch.cli.full_eval -m360 <root> [-tat <root>] [-db <root>] \\
        [-ns <root>] [--output_path ./eval] [--device cuda]

Trains each scene of the 13-scene harness (MipNeRF360 x9, Tanks&Temples
x2, DeepBlending x2) and of NeRF-synthetic under the port's supervisor
(`cli/train_supervised.py`), renders its test views at 7000 and the last
iteration (`cli/render.py`) and scores them (`cli/metrics.py`), writing one
model dir per scene and `timing.txt`. `--device` (default `cuda`) goes to
each of the three CLIs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump", "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]
# the dataset the reference bundles (`nerf_synthetic/README.txt`): not part
# of its 13-scene harness
nerf_synthetic_scenes = [
    "chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship",
]


def run(cmd) -> int:
    """Run one CLI as its own process; a failure is reported and the
    harness goes on with the next scene."""
    rc = subprocess.run(cmd).returncode
    if rc != 0:
        print(f"command failed with code {rc}: {' '.join(cmd)}", file=sys.stderr)
    return rc


def cli(name):
    return [sys.executable, "-m", f"gsplat_tpu_torch.cli.{name}"]


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument(
        "--synthetic", "-ns", type=str, default=None,
        help="NeRF-synthetic root (white background, 800x800 Blender scenes)",
    )
    parser.add_argument("--scenes", nargs="+", type=str, default=None,
                        help="restrict to these scene names")
    parser.add_argument("--iterations", type=int, default=30000,
                        help="training iterations per scene (test/render at 7000 and this)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    scenes = []  # (source, images dir or None, name, white background)
    if args.mipnerf360:
        scenes += [(os.path.join(args.mipnerf360, s), "images_4", s, False)
                   for s in mipnerf360_outdoor_scenes]
        scenes += [(os.path.join(args.mipnerf360, s), "images_2", s, False)
                   for s in mipnerf360_indoor_scenes]
    if args.tanksandtemples:
        scenes += [(os.path.join(args.tanksandtemples, s), None, s, False)
                   for s in tanks_and_temples_scenes]
    if args.deepblending:
        scenes += [(os.path.join(args.deepblending, s), None, s, False)
                   for s in deep_blending_scenes]
    if args.synthetic:
        scenes += [(os.path.join(args.synthetic, s), None, s, True)
                   for s in nerf_synthetic_scenes]
    if args.scenes:
        scenes = [sc for sc in scenes if sc[2] in set(args.scenes)]
    if not scenes:
        parser.error("pass at least one of -m360 / -tat / -db / -ns dataset roots")

    os.makedirs(args.output_path, exist_ok=True)
    iters = [str(i) for i in sorted({7000, args.iterations})]
    device = ["--device", args.device]

    if not args.skip_training:
        # no --quiet: the progress lines are the stall watchdog's liveness
        # signal, beside the rolling checkpoint
        common = ["--eval", "--iterations", str(args.iterations), "--test_iterations", *iters,
                  "--save_iterations", *iters, "--disable_viewer", *device]
        start = time.time()
        for src, images, name, white in scenes:
            run(cli("train_supervised") + [
                "--stall_timeout", "900", "--checkpoint_every", "500", "--",
                "-s", src, *(["-i", images] if images else []), *(["-w"] if white else []),
                "-m", os.path.join(args.output_path, name), *common])
        with open(os.path.join(args.output_path, "timing.txt"), "w") as f:
            f.write(f"{(time.time() - start) / 60.0} minutes")

    if not args.skip_rendering:
        for src, _, name, _ in scenes:
            for it in iters:
                run(cli("render") + ["--iteration", it, "-s", src,
                                     "-m", os.path.join(args.output_path, name),
                                     "--eval", "--skip_train", *device])

    if not args.skip_metrics:
        run(cli("metrics") + ["-m", *(os.path.join(args.output_path, name)
                                      for _, _, name, _ in scenes), *device])
    return 0


if __name__ == "__main__":
    sys.exit(main())
