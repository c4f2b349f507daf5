"""Time the flagship render frame and train steps of one tree of this
repository, so that two trees (a commit and its parent) can be compared in
turns on one card.

    python gsplat_tpu_torch/scripts/step_ab.py --root <tree> [--label NAME]

Run it as a file, not with `-m`: it puts `<tree>` first on the import path
and takes `gsplat_tpu_torch` and `chip_smoke` from there, so the same
script measures any tree whose `chip_smoke.py` has `flagship_train_setup`.
On the card only. Prints one JSON line: for the render frame (float32
packets) and the sorted and OIT train steps (hybrid packets) of the
flagship scene (1,048,576 gaussians, 2,097,152 rows in training, SH 3,
1920x1080), the median host ms of 20 calls after 5 warm-up calls, and over
3 profiled calls the device ms, kernels, busy share and host-to-device
copies per call; the peak memory of the timed calls.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

WARMUP, TIMED, PROFILED = 5, 20, 3


def profile(fn):
    """Device ms, kernels, busy share and host-to-device copies per call
    over PROFILED calls (`torch.profiler`)."""
    from torch.autograd import DeviceType

    from gsplat_tpu_torch.profiling import busy_span_us, profile_calls

    prof = profile_calls(fn, PROFILED)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy, span = busy_span_us(prof)
    return {"device_ms": sum(r[1] for r in rows) / PROFILED,
            "kernels": sum(r[2] for r in rows) / PROFILED,
            "busy_share": busy / span,
            "htod_copies": sum(r[2] for r in rows if "HtoD" in r[0]) / PROFILED}


def timed(fn):
    import torch

    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(WARMUP + TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= WARMUP:
            ms.append((time.perf_counter() - t) * 1e3)
    return {"ms_median": statistics.median(ms), "ms": ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, **profile(fn)}


def measure():
    import torch

    import chip_smoke as cs
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.core.types import make_render_settings
    from gsplat_tpu_torch.device import card_line, resolve_device
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.synthetic import tiny_scene
    from gsplat_tpu_torch.train import step as ts

    device = resolve_device("cuda")
    _kernels.build_all()
    out = {"card": card_line()}
    params, alive, camera = tiny_scene(**cs.FULL, device=device)
    settings = make_render_settings(sh_degree=3, packet_dtype="float32")
    with torch.no_grad():
        out["render"] = timed(lambda: render(camera, params, alive, settings, [0.0, 0.0, 0.0],
                                             device=device))
    del params, alive
    for mode in ("sorted", "oit"):
        settings = make_render_settings(sh_degree=3, packet_dtype="hybrid", blend_mode=mode)
        state, args, opt = cs.flagship_train_setup(device, settings)
        step = ts.make_train_step(opt, settings)
        holder = [state]

        def one_step():
            holder[0], _ = step(holder[0], *args)

        out[f"train_{mode}"] = timed(one_step)
        del state, holder, args
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True, help="the tree to measure")
    p.add_argument("--label", default=None)
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    res = measure()
    print(json.dumps({"label": args.label or str(root), **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
