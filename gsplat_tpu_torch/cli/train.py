"""Training CLI on the card: counterpart of the top-level `train.py`.

    python -m gsplat_tpu_torch.cli.train -s SCENE [-m MODEL] [--iterations N] [--device cuda]

Every flag of `train.py` is accepted (the config dataclasses reflect into
flags as there), plus `--device` (default `cuda`). The model directory gets
`cfg_args`, `input.ply`, `cameras.json` and a snapshot at each
`--save_iterations` entry and at the last iteration, in the layout that
`python -m gsplat_tpu_torch.cli.render` and the JAX package read.

Not in this slice: `--mesh`, checkpoints (`--checkpoint_iterations`,
`--start_checkpoint`, `--checkpoint_every`) and `--profile_steps` are
refused; the viewer (`--ip`, `--port`) and the test evaluations
(`--test_iterations`) are skipped with a message. `--debug_from` checks
the loss every step from that iteration on; `--detect_anomaly` turns on
autograd's anomaly detection.
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
    parser.add_argument("--profile_steps", type=int, default=0)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1,
                        help="from this iteration on, fail fast on a non-finite loss")
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    model_cfg = extract(ModelConfig, args)
    opt_cfg = extract(OptimizationConfig, args)
    pipe_cfg = extract(PipelineConfig, args)
    if not model_cfg.source_path:
        parser.error("-s/--source_path is required")
    if args.profile_steps > 0:
        parser.error("--profile_steps is not ported yet (the checkpoint-and-eval slice)")
    if not model_cfg.model_path:
        model_cfg = dataclasses.replace(
            model_cfg, model_path=os.path.join("./output", str(uuid.uuid4())[:10]))
    print(f"Optimizing {model_cfg.model_path}")
    os.makedirs(model_cfg.model_path, exist_ok=True)
    save_cfg_args(model_cfg.model_path, model_cfg)
    if not args.disable_viewer:
        print("[viewer] the viewer bridge is not ported yet: training without it",
              file=sys.stderr)

    import torch

    from gsplat_tpu_torch.train.loop import train

    on_iteration = None
    if args.debug_from >= 0:
        def on_iteration(iteration, state, metrics):
            if iteration >= args.debug_from:
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"[debug] non-finite loss at iteration {iteration}: {loss}")

    with torch.autograd.set_detect_anomaly(args.detect_anomaly):
        train(
            model_cfg, opt_cfg, pipe_cfg,
            testing_iterations=tuple(args.test_iterations),
            saving_iterations=tuple(args.save_iterations),
            checkpoint_iterations=tuple(args.checkpoint_iterations),
            start_checkpoint=args.start_checkpoint,
            quiet=args.quiet,
            log_every=args.log_every,
            on_iteration=on_iteration,
            checkpoint_every=args.checkpoint_every,
            seed=args.seed,
            device=args.device,
        )
    print("\nTraining complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
