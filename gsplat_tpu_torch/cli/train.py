"""Training CLI on the card: counterpart of the top-level `train.py`.

    python -m gsplat_tpu_torch.cli.train -s SCENE [-m MODEL] [--iterations N] [--device cuda]

Every flag of `train.py` is accepted (the config dataclasses reflect into
flags as there), plus `--device` (default `cuda`). The model directory gets
`cfg_args`, `input.ply`, `cameras.json` and a snapshot at each
`--save_iterations` entry and at the last iteration, in the layout that
`python -m gsplat_tpu_torch.cli.render` and the JAX package read, plus
tensorboard events, `chkpnt<it>.pkl` at each `--checkpoint_iterations`
entry and `rolling_chkpnt.pkl` every `--checkpoint_every` iterations.
`--start_checkpoint` resumes from a checkpoint of either package.

`--test_iterations` evaluates the test views (and five train views) at
those iterations; the test PSNR and L1 are printed at the end.
`--profile_steps N` writes a `torch.profiler` chrome trace of iterations 3
to 2+N to `<model>/profile/trace.json` and prints its stage report
(`profiling.stage_report`: host, device and idle ms and launches per step
of each stage, `step/prepare` to `adam`, the `instances` counter, the
clock check). The SIBR viewer is served on
`--ip`/`--port` unless `--disable_viewer` is given; a port that cannot be
bound disables it and training goes on. `--debug_from` checks the loss
every step from that iteration on; `--detect_anomaly` turns on autograd's
anomaly detection.

`--mesh GxT` trains over G x T ranks, one process each, as `torchrun`
starts them:

    torchrun --nproc_per_node N -m gsplat_tpu_torch.cli.train --mesh GxT -s SCENE -m MODEL

`--dist_backend` names the collectives' backend: `nccl` (the default on
`cuda`) when every rank has a card of its own, `gloo` (the default on the
CPU) when the ranks share one card. Rank 0 writes the model directory and
prints; the viewer is off under `--mesh` (it would see one rank's rows).
`--blend_mode oit` is refused under `--mesh`.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import uuid
from argparse import ArgumentParser


def main(argv=None):
    from gsplat_tpu_torch.config import (
        ModelConfig,
        OptimizationConfig,
        PipelineConfig,
        add_to_parser,
        extract,
        save_cfg_args,
    )

    parser = ArgumentParser(description="gsplat_tpu_torch training")
    add_to_parser(parser, ModelConfig(), "Loading Parameters")
    add_to_parser(parser, OptimizationConfig(), "Optimization Parameters")
    add_to_parser(parser, PipelineConfig(), "Pipeline Parameters")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="RNG seed (camera pick order, densify split sampling)")
    parser.add_argument("--log_every", type=int, default=10)
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="write a torch.profiler chrome trace of N steps to <model>/profile")
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1,
                        help="from this iteration on, fail fast on a non-finite loss")
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                        help="--mesh collectives (default: nccl on cuda, gloo on cpu)")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    model_cfg = extract(ModelConfig, args)
    opt_cfg = extract(OptimizationConfig, args)
    pipe_cfg = extract(PipelineConfig, args)
    if not model_cfg.source_path:
        parser.error("-s/--source_path is required")

    import torch

    from gsplat_tpu_torch.train.loop import train
    from gsplat_tpu_torch.viewer.network_gui import NetworkGUI

    main_rank, owns_group = True, False
    model_path = model_cfg.model_path or os.path.join("./output", str(uuid.uuid4())[:10])
    if pipe_cfg.mesh:
        import torch.distributed as dist

        from gsplat_tpu_torch.device import resolve_device
        from gsplat_tpu_torch.parallel import comm

        args.dist_backend = args.dist_backend or comm.default_backend(
            resolve_device(args.device))
        owns_group = not dist.is_initialized()
        dev = comm.rank_device(resolve_device(args.device), args.dist_backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # NCCL's object broadcast uses the current card
        comm.init_distributed(args.dist_backend)
        main_rank = dist.get_rank() == 0
        shared = [model_path]  # every rank writes to rank 0's directory
        dist.broadcast_object_list(shared, src=0)
        model_path = shared[0]
    model_cfg = dataclasses.replace(model_cfg, model_path=model_path)
    if main_rank:
        print(f"Optimizing {model_cfg.model_path}")
        os.makedirs(model_cfg.model_path, exist_ok=True)
        save_cfg_args(model_cfg.model_path, model_cfg)

    gui_server = None
    if pipe_cfg.mesh and not args.disable_viewer:
        if main_rank:
            print("[viewer] disabled under --mesh", file=sys.stderr)
    elif not args.disable_viewer:
        try:
            gui_server = NetworkGUI(args.ip, args.port)
        except OSError as e:  # the viewer never blocks training
            print(f"[viewer] disabled: {e}", file=sys.stderr)
    hooks = [gui_server.make_training_hook(model_cfg, pipe_cfg)] if gui_server else []
    if args.profile_steps > 0 and main_rank:
        hooks.append(_profile_hook(os.path.join(model_cfg.model_path, "profile"),
                                   args.profile_steps, args.iterations, args.device))
    if args.debug_from >= 0:
        def debug_hook(iteration, state, metrics):
            if iteration >= args.debug_from:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"[debug] non-finite loss at iteration {iteration}: {loss}")

        hooks.append(debug_hook)

    def on_iteration(iteration, state, metrics):
        for hook in hooks:
            hook(iteration, state, metrics)

    try:
        with torch.autograd.set_detect_anomaly(args.detect_anomaly):
            _, _, results = train(
                model_cfg, opt_cfg, pipe_cfg,
                testing_iterations=tuple(args.test_iterations),
                saving_iterations=tuple(args.save_iterations),
                checkpoint_iterations=tuple(args.checkpoint_iterations),
                start_checkpoint=args.start_checkpoint,
                quiet=args.quiet,
                log_every=args.log_every,
                on_iteration=on_iteration if hooks else None,
                checkpoint_every=args.checkpoint_every,
                seed=args.seed,
                device=args.device,
                dist_backend=args.dist_backend,
            )
    finally:
        if gui_server:
            gui_server.close()
        if owns_group:
            torch.distributed.destroy_process_group()
    if not main_rank:
        return 0
    print("\nTraining complete.")
    for it, ev in results.get("test", {}).items():
        print(f"  iter {it}: test PSNR {ev['psnr']:.2f}  L1 {ev['l1']:.5f}")
    return 0


def _profile_hook(out_dir, steps, last_iteration, device):
    """An `on_iteration` hook that profiles iterations 3 to 2+`steps` (from
    the end of iteration 2 to the end of 2+`steps`, or of the run) with
    `torch.profiler`, writes the chrome trace to `out_dir/trace.json` and
    prints its stage report."""
    import torch
    from torch.profiler import profile

    from gsplat_tpu_torch.profiling import activities, format_report, read_trace, stage_report

    prof = None

    def hook(iteration, state, metrics):
        nonlocal prof
        if iteration == 2 and prof is None:
            prof = profile(activities=activities(device))
            prof.start()
        elif prof is not None and (iteration >= 2 + steps or iteration == last_iteration):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, "trace.json")
            prof.export_chrome_trace(path)
            prof = None
            print(f"[profile] trace written to {path}")
            print(format_report(stage_report(read_trace(path), iteration - 2)))

    return hook


if __name__ == "__main__":
    sys.exit(main())
