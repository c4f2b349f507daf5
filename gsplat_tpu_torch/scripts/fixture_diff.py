"""The quality run's fixture from this package held against another copy.

    python -m gsplat_tpu_torch.scripts.fixture_diff REFERENCE OUT [--device cuda]

Deletes `OUT`, writes the COLMAP quality run's scene there (`colmap_proxy.
RECIPE`: 4,096 GT gaussians, 2,048 SfM points, 64 PINHOLE views at 400x304,
focal 380, seed 3) with its ground truth rendered on `--device`, and
compares it with the scene in `REFERENCE`, e.g. one that
`scripts/make_fixtures.py`'s `make_colmap_gaussian_scene` wrote with the
same arguments. Prints one JSON object: for each file of `sparse/0`,
whether the two copies are equal byte for byte; over the PNGs of `images/`,
the largest difference in uint8 levels, the views and pixels that differ
at all and by more than one level, and per view the largest and the mean
difference.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import sys

import numpy as np
from PIL import Image


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im, np.int16)


def compare(reference: str, out: str) -> dict:
    """The two scenes' COLMAP files and ground-truth PNGs compared."""
    sparse = os.path.join("sparse", "0")
    files = sorted(os.listdir(os.path.join(reference, sparse)))
    bins = {f: os.path.exists(os.path.join(out, sparse, f)) and filecmp.cmp(
        os.path.join(reference, sparse, f), os.path.join(out, sparse, f), shallow=False)
        for f in files}
    names = sorted(os.listdir(os.path.join(reference, "images")))
    if names != sorted(os.listdir(os.path.join(out, "images"))):
        raise ValueError("the two scenes hold different images")
    per_view, differ, over_one, pixels = {}, 0, 0, 0
    for name in names:
        d = np.abs(_png(os.path.join(reference, "images", name))
                   - _png(os.path.join(out, "images", name))).max(axis=-1)
        per_view[name] = {"max": int(d.max()), "mean": float(d.mean())}
        differ += int((d > 0).sum())
        over_one += int((d > 1).sum())
        pixels += d.size
    return {"bins_equal": bins,
            "png_max_levels": max(v["max"] for v in per_view.values()),
            "views_differing": sum(v["max"] > 0 for v in per_view.values()),
            "views_over_one_level": sum(v["max"] > 1 for v in per_view.values()),
            "pixels": pixels, "pixels_differing": differ, "pixels_over_one_level": over_one,
            "per_view": per_view}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the quality run's fixture against another copy")
    p.add_argument("reference", help="a scene written with the recipe's arguments")
    p.add_argument("out", help="where this package writes its scene (deleted first)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from gsplat_tpu_torch.bench import card
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.scripts.colmap_proxy import generate_scene

    dev = resolve_device(args.device)
    generate_scene(args.out, dev)
    print(json.dumps({**compare(args.reference, args.out), "device": card(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
