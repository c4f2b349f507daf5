"""Run one cell of the port's benchmark once and print its result line.

    python splatbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, per-layer metrics and limits are
found by name from `BENCHMARK.json` (`spec.py`). The run makes its inputs
on the card from `--seed`, warms up the cell's own shapes, drives the
program for `--seconds`, checks what the timed path produced against the
plain reference, and prints one JSON line as the last line of standard
output: `correct`, `attempted`, `failed`, `metrics` (the end-to-end
metrics with `--trace 0`, the per-layer ones with `--trace 1`), `device`,
with `--trace 1` `breakdown`, and last `checks`, each compared number with
its limit (also the last lines of standard error).

Without a card, or with fewer than the cell asks for, it exits non-zero
and prints no result. `--rehearse` runs the cell on the CPU at a tiny
size instead (the program's plain twins), and prints the line with the
CPU named as the device and no device metric.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# a library the port loads must not bring JAX in with it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from splatbench import spec  # noqa: E402

# the rehearsal's sizes: a few thousand gaussians on frames of a few tiles
REHEARSAL = {"gaussians": 3000, "train_views": 4, "train_width": 72, "train_height": 40,
             "width": 80, "height": 48, "poses": 6, "warmup_steps": 1, "warmup_frames": 2}


def rehearsal(cell):
    """The cell at the rehearsal's sizes (every other value as it is)."""
    for part in (cell.config, cell.traffic):
        for k, v in REHEARSAL.items():
            if k in part:
                part[k] = v
    return cell


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at a tiny size; no device metric")
    return p.parse_args(argv)


def execute(cell, seed, seconds, traced, device, settings=None, started=None):
    """Drive the cell once; returns the finished `drive.Run`."""
    from splatbench import drive, program

    run = drive.Run(cell, seed, seconds, traced, program.device(device),
                    STARTED if started is None else started, settings)
    cell.entry().drive(run)
    return run


def judge(run):
    """{number: {"value", "limit"}} and whether every number is within its
    limit (a number without a limit fails)."""
    checks, ok = {}, run.failed == 0
    for name, value in run.readings.items():
        limit = run.cell.limits.get(name)
        finite = value is not None and math.isfinite(value)
        checks[name] = {"value": value if finite else None, "limit": limit}
        ok = ok and finite and limit is not None and value <= limit
    return checks, ok


def card_line():
    """The card's name and power limit (a card set below its maximum power
    runs slower under load)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def layer_metrics(run):
    out = {}
    for m in run.cell.per_layer:
        value = run.cell.reader(m["name"]).read(run.layer_ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run, rehearse):
    checks, ok = judge(run)
    if rehearse:
        metrics = {}
        device = {"platform": "cpu", "kind": platform.processor() or platform.machine(),
                  "count": 1, "memory_peak_bytes": None}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                  "memory_peak_bytes": run.memory_peak_bytes}
        if run.traced:
            metrics = layer_metrics(run)
            device["busy_s"] = run.layer_ctx["trace"].busy_s
            device["window_s"] = run.layer_ctx["trace"].window_s
        else:
            metrics = {}
            for m in run.cell.end_to_end:
                if m["name"] not in run.e2e:
                    raise SystemExit(f"the run measured no {m['name']}")
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    line = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.traced and not rehearse:
        tr = run.layer_ctx["trace"]
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None):
    args = parse(argv)
    cell = spec.load(args.workload)
    if args.rehearse:
        device = "cpu"
        rehearsal(cell)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark measures the card, never the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{args.workload} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} present")
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    # the rehearsal reads no trace: the profiler's device times are the card's
    run = execute(cell, args.seed, args.seconds, bool(args.trace) and not args.rehearse, device)
    line = result(run, args.rehearse)
    from splatbench.drive import loaded_forbidden

    found = loaded_forbidden()
    if found:
        raise SystemExit(f"modules of the JAX package or JAX loaded: {found}")
    if not args.rehearse:
        print(f"card: {card_line()}", file=sys.stderr)
    if run.frame_samples:
        print(f"frame_p95_ms over {run.frame_samples} frames", file=sys.stderr)
    print(json.dumps({"detail": run.detail, "seconds": run.timing,
                      "counts": run.layer_ctx["counts"] if run.layer_ctx else None}),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
