"""Render CLI: per-view PNG dumps of a trained model, on the card.

Counterpart of the top-level `render.py` (reference `render.py:30-76`), with
the same flags and output layout, `{model}/{train,test}/ours_{iter}/
{renders,gt}/*.png`, plus `--device` (default `cuda`):

    python -m gsplat_tpu_torch.cli.render -m MODEL -s SCENE [--device cuda]

`--blend_mode oit` renders through the OIT kernels (K5'). The TPU-only
pipeline flags (`--backend`, `--instance_capacity`, `--max_per_tile`,
`--capacity`, `--exchange_capacity`) are accepted and have no effect, and so
is `--packet_dtype`: views render with float32 packets, as the top-level
`render.py` renders them.

`--mesh GxT` renders every view over G x T ranks started by `torchrun`
(`render.py:123-133`): the gaussian rows split over G, the image's tile
rows into T bands, through the pipeline of `parallel/pipeline.py` with the
full gather; rank 0 writes the PNGs. `--dist_backend` as in the train CLI
(`gloo` when the ranks share one card). `--blend_mode oit` is refused under
`--mesh`.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def render_set(model_path, name, iteration, cameras, render_view, use_exposure, exposures,
               write=True):
    """Render `cameras` with `render_view(camera, exposure)` and, where
    `write`, save the renders and the ground truth as PNGs."""
    from PIL import Image

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
            img = render_view(cam.camera, exp).cpu().numpy()
        if not write:
            continue
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
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                        help="--mesh collectives (default: nccl on cuda, gloo on cpu)")
    args = load_cfg_args(parser, argv)
    model_cfg = extract(ModelConfig, args)
    pipe_cfg = extract(PipelineConfig, args)

    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.io.snapshot import load_snapshot
    from gsplat_tpu_torch.render import render as render_fn

    device = resolve_device(args.device)
    mesh, owns_group = None, False
    if pipe_cfg.mesh:
        from gsplat_tpu_torch.parallel import comm, sharding

        if pipe_cfg.blend_mode != "sorted":
            raise ValueError(f"--blend_mode {pipe_cfg.blend_mode}: the multi-device path blends "
                             "sorted; OIT is refused under --mesh")
        backend = args.dist_backend or comm.default_backend(device)
        owns_group = not torch.distributed.is_initialized()
        comm.init_distributed(backend)
        mesh = sharding.make_mesh(*sharding.parse_mesh(pipe_cfg.mesh), backend=backend,
                                  device=device)
        device = mesh.device
    main_rank = mesh is None or mesh.rank == 0
    if main_rank:
        print(f"Rendering {model_cfg.model_path}")
    params, alive, iteration, exposures = load_snapshot(
        model_cfg.model_path, args.iteration, device=device
    )

    def load_scene():
        return Scene(
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

    scene = load_scene() if main_rank else None
    if mesh is not None:
        torch.distributed.barrier()  # rank 0 first: a Blender scene's random init is written once
        scene = scene or load_scene()
    settings = make_render_settings(
        sh_degree=model_cfg.sh_degree,
        antialiasing=pipe_cfg.antialiasing,
        blend_mode=getattr(pipe_cfg, "blend_mode", "sorted"),
    )
    bg = [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0]

    if mesh is None:
        def render_view(camera, exposure):
            return render_fn(camera, params, alive, settings, bg, exposure=exposure,
                             device=device)["render"]
    else:
        from gsplat_tpu_torch.parallel.pipeline import make_sharded_render

        if mesh.rank == 0:
            print(f"[mesh] rendering over gauss={mesh.sizes['gauss']} x "
                  f"tile={mesh.sizes['tile']} ({mesh.backend})")
        params, alive = sharding.shard_params(
            *sharding.pad_rows(params, alive.to(device), sharding.mesh_capacity(len(alive), mesh)),
            mesh)
        renders = {}

        def render_view(camera, exposure):
            key = (camera.width, camera.height)
            if key not in renders:
                renders[key] = make_sharded_render(mesh, settings, *key)
            return renders[key](camera, params, alive, bg, exposure=exposure)["render"]

    try:
        for split, skip, cams in (("train", args.skip_train, scene.get_train_cameras),
                                  ("test", args.skip_test, scene.get_test_cameras)):
            if not skip:
                render_set(model_cfg.model_path, split, iteration, cams(), render_view,
                           model_cfg.train_test_exp, exposures, write=main_rank)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
