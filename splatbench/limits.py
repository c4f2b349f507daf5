"""Read a cell's compared numbers over many seeds in one process, for
setting its limits (`limits/<cell>.json`): the program as the
configuration states it, the control (the program's own next precision
down: `--control packet_dtype=bfloat16`), and planted faults
(`faults.py`).

    python3 splatbench/limits.py --workload m360_train --seeds 1,2,3 \\
        --control-seeds 4,5,6 --faults half_batch --fault-seeds 7,8,9 --seconds 1

Prints one JSON line per run: kind, seed, readings, detail, seconds. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from splatbench import drive, faults, spec  # noqa: E402
from splatbench.run import execute, rehearsal  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control", default="packet_dtype=bfloat16")
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--rehearse", action="store_true",
                   help="on the CPU at the rehearsal's tiny sizes")
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    device = "cpu" if args.rehearse else "cuda"
    if args.rehearse:
        rehearsal(cell)
    key, value = args.control.split("=")
    runs = [("program", s, None, None) for s in args.seeds]
    runs += [("control", s, {key: value}, None) for s in args.control_seeds]
    runs += [(f, s, None, f) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for kind, seed, settings, fault in runs:
        started = time.perf_counter()
        if fault:
            with faults.PLANT[fault]():
                run = execute(cell, seed, args.seconds, False, device, settings, started)
        else:
            run = execute(cell, seed, args.seconds, False, device, settings, started)
        print(json.dumps({"kind": kind, "seed": seed, "readings": run.readings,
                          "attempted": run.attempted, "failed": run.failed,
                          "detail": run.detail, "seconds": run.timing}), flush=True)
        del run
        drive.free()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
