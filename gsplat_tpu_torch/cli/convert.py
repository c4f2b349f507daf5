"""COLMAP preprocessing CLI: a copy of the top-level `convert.py`
(reference `convert.py:31-124`), with no device of its own.

    python -m gsplat_tpu_torch.cli.convert -s SCENE [--resize] [--no_gpu]

Feature extraction -> exhaustive matching -> mapping -> undistortion, plus
optional half/quarter/eighth-resolution image pyramids. Requires the
external `colmap` (and ImageMagick `magick` for --resize) binaries on PATH.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
from argparse import ArgumentParser


def run(cmd: str):
    rc = os.system(cmd)
    if rc != 0:
        logging.error(f"command failed with code {rc}: {cmd}")
        sys.exit(rc)


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = (
        f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    )
    magick = (
        f'"{args.magick_executable}"' if args.magick_executable else "magick"
    )
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(f"{src}/distorted/sparse", exist_ok=True)
        run(
            f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}"
        )
        run(
            f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}"
        )
        run(
            f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001"
        )

    run(
        f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP"
    )

    # move sparse/* under sparse/0 (reference `convert.py:70-80`)
    os.makedirs(f"{src}/sparse/0", exist_ok=True)
    for f in os.listdir(f"{src}/sparse"):
        if f == "0":
            continue
        shutil.move(os.path.join(src, "sparse", f), os.path.join(src, "sparse", "0", f))

    if args.resize:
        for factor, d in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
            os.makedirs(f"{src}/{d}", exist_ok=True)
            for f in os.listdir(f"{src}/images"):
                shutil.copy2(os.path.join(src, "images", f), os.path.join(src, d, f))
                run(f"{magick} mogrify -resize {factor}% {src}/{d}/{f}")
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
