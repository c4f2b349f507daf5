"""The COLMAP quality run from the init the JAX row may have trained from.

    python -m gsplat_tpu_torch.scripts.stale_init --out DIR [--seed 0]
        [--iterations 30000] [--device cuda] [--small]

`scripts/colmap_proxy_r5.sh` first generated the disc-splat scene
(`make_colmap_scene`, 5,000 points, 64 views at 400x304, focal 380, seed
3) into `output/colmap_proxy_r5/scene`, and trained on it; the first read
of that scene wrote `sparse/0/points3D.ply`. The script was then changed to
write the gaussian-GT scene into the same directory without clearing it, and
the reader prefers an existing `points3D.ply` to `points3D.bin`
(`gsplat_tpu/data/readers.py:160`, `ADVICE.md` item 1). Both generators
draw `normal(0, 0.45)` first from seed 3, so the stale cloud holds the
4,096 ground-truth centres exactly (plus 904 more draws), coloured without
the ground truth's noise, where the recipe's init is 2,048 of them with
0.01 of noise.

This runs `colmap_proxy`'s chain (the scene, the supervised train CLI, the
render and metrics CLIs, the collector) with that stale `points3D.ply`
put in the scene after it is written: DIR/summary.json as `colmap_proxy`
writes it, with the init's description added. `--small` runs
`colmap_proxy.SMALL_RECIPE` and a disc-splat scene of its size (a CPU
rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from gsplat_tpu_torch.scripts import colmap_proxy as cp

# the disc-splat scene of `scripts/colmap_proxy_r5.sh` before the gaussian
# ground truth (its git history): `make_colmap_scene`'s arguments
DISC_RECIPE = dict(n_points=5000, n_images=64, width=400, height=304, focal=380.0, seed=3)


def disc_recipe_for(recipe: dict) -> dict:
    """The disc-splat scene written before `recipe`'s: the recipe's cameras
    and seed, 5,000 points (at `SMALL_RECIPE`, the recipe's point count +
    its gaussian count, a cloud that also holds every centre)."""
    if recipe is cp.RECIPE:
        return DISC_RECIPE
    return dict(n_points=recipe["n_gauss"] + recipe["n_points"], n_images=recipe["n_images"],
                width=recipe["width"], height=recipe["height"], focal=recipe["focal"],
                seed=recipe["seed"])


def stale_ply(scene_dir: str, disc: dict, device) -> int:
    """Write the disc-splat scene `disc` into a temporary directory, read it
    once (the reader writes its `points3D.ply` from its bins) and copy that
    file over `scene_dir`'s. Returns its point count."""
    from gsplat_tpu_torch.data import ply as ply_io
    from gsplat_tpu_torch.data.scene import load_scene
    from gsplat_tpu_torch.scripts.make_fixtures import make_colmap_scene

    target = os.path.join(scene_dir, "sparse", "0", "points3D.ply")
    with tempfile.TemporaryDirectory(prefix="disc_splat_") as tmp:
        make_colmap_scene(tmp, **disc)
        load_scene(tmp, device)
        shutil.copy(os.path.join(tmp, "sparse", "0", "points3D.ply"), target)
    return int(ply_io.read_point_cloud(target)[0].shape[0])


def main(argv=None):
    p = argparse.ArgumentParser(description="the COLMAP quality run from the stale init")
    p.add_argument("--out", required=True, help="run directory: scene/, model/, summary.json")
    p.add_argument("--seed", type=int, default=0, help="the train seed (the scene's is fixed)")
    p.add_argument("--iterations", type=int, default=cp.ITERATIONS)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--in_process", action="store_true",
                   help="train in this process, without the supervisor")
    p.add_argument("--small", action="store_true",
                   help="the small scene of a CPU rehearsal (SMALL_RECIPE), not the recipe's")
    args = p.parse_args(argv)
    recipe = cp.SMALL_RECIPE if args.small else cp.RECIPE

    from gsplat_tpu_torch.bench import card
    from gsplat_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    scene_dir = os.path.join(args.out, "scene")
    model_dir = os.path.join(args.out, "model")
    shutil.rmtree(model_dir, ignore_errors=True)
    cp.generate_scene(scene_dir, dev, recipe)
    disc = disc_recipe_for(recipe)
    n_init = stale_ply(scene_dir, disc, dev)
    rc = cp.train(scene_dir, model_dir, args.iterations, args.seed, dev,
                  in_process=args.in_process)
    if rc:
        print(f"stale_init: training failed (exit {rc})", file=sys.stderr)
        return rc
    rc = cp.render_and_score(scene_dir, model_dir, args.iterations, dev)
    if rc:
        return rc
    info = {"seed": args.seed, "iterations": args.iterations, "recipe": recipe,
            "init": {"points3D.ply": "the disc-splat scene's", "disc_recipe": disc,
                     "points": n_init},
            "device": card(dev)}
    summary = cp.collect(args.out, args.iterations, info)
    print(json.dumps(summary), flush=True)
    print("STALE INIT DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
