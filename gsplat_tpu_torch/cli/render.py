"""Render CLI: per-view PNG dumps of a trained model, on the card.

Counterpart of the top-level `render.py` (reference `render.py:30-76`), with
the same flags and output layout, `{model}/{train,test}/ours_{iter}/
{renders,gt}/*.png`, plus `--device` (default `cuda`):

    python -m gsplat_tpu_torch.cli.render -m MODEL -s SCENE [--device cuda]

`--blend_mode oit` renders through the OIT kernels (K5'). The TPU-only
pipeline flags (`--backend`, `--instance_capacity`, `--max_per_tile`,
`--capacity`, `--exchange_capacity`) are accepted and have no effect, and so
is `--packet_dtype`: views render with float32 packets, as the top-level
`render.py` renders them. `--mesh` is refused until the multi-device slice
is ported.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def render_set(model_path, name, iteration, cameras, params, alive, settings, bg,
               use_exposure, exposures, device):
    from PIL import Image

    from gsplat_tpu_torch.render import render as render_fn

    base = os.path.join(model_path, name, f"ours_{iteration}")
    renders_dir = os.path.join(base, "renders")
    gt_dir = os.path.join(base, "gt")
    os.makedirs(renders_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)

    for idx, cam in enumerate(cameras):
        exp = None
        if use_exposure and exposures is not None:
            exp = exposures.get(cam.image_name, np.eye(3, 4, dtype=np.float32))
        with torch.inference_mode():
            out = render_fn(cam.camera, params, alive, settings, bg, exposure=exp, device=device)
        img = out["render"].cpu().numpy()
        gt = cam.image
        if use_exposure:  # reference keeps only the right half in train_test_exp mode
            img = img[:, img.shape[1] // 2 :]
            gt = gt[:, gt.shape[1] // 2 :]
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(renders_dir, f"{idx:05d}.png")
        )
        Image.fromarray((np.clip(gt, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(gt_dir, f"{idx:05d}.png")
        )


def main(argv=None):
    from gsplat_tpu_torch.config import (
        ModelConfig,
        PipelineConfig,
        add_to_parser,
        extract,
        load_cfg_args,
    )

    parser = ArgumentParser(description="gsplat_tpu_torch rendering")
    add_to_parser(parser, ModelConfig(), "Loading Parameters", fill_none=True)
    add_to_parser(parser, PipelineConfig(), "Pipeline Parameters")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = load_cfg_args(parser, argv)
    model_cfg = extract(ModelConfig, args)
    pipe_cfg = extract(PipelineConfig, args)
    if pipe_cfg.mesh:
        raise NotImplementedError("--mesh: the multi-device path is not ported yet")

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.io.snapshot import load_snapshot

    device = resolve_device(args.device)
    print(f"Rendering {model_cfg.model_path}")
    params, alive, iteration, exposures = load_snapshot(
        model_cfg.model_path, args.iteration, device=device
    )
    scene = Scene(
        model_cfg.source_path,
        model_path=None,
        images=model_cfg.images,
        depths=model_cfg.depths,
        resolution=model_cfg.resolution,
        white_background=model_cfg.white_background,
        eval=model_cfg.eval,
        train_test_exp=model_cfg.train_test_exp,
        shuffle=False,
        device=device,
    )
    settings = make_render_settings(
        sh_degree=model_cfg.sh_degree,
        antialiasing=pipe_cfg.antialiasing,
        blend_mode=getattr(pipe_cfg, "blend_mode", "sorted"),
    )
    bg = [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0]

    if not args.skip_train:
        render_set(
            model_cfg.model_path, "train", iteration, scene.get_train_cameras(),
            params, alive, settings, bg, model_cfg.train_test_exp, exposures, device,
        )
    if not args.skip_test:
        render_set(
            model_cfg.model_path, "test", iteration, scene.get_test_cameras(),
            params, alive, settings, bg, model_cfg.train_test_exp, exposures, device,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
