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
copies per call, and the launch census (`profiling.launch_census`: host
launches and device events per call, and those of either without the
other, by name), and the stage table (`profiling.stage_report`: host,
device and idle ms and launches per call of each of the program's stages,
`outside` for what no stage holds, where a tree's program marks no stage
all of it; the counters; the clock check); the peak memory of the timed
calls. For the sorted step
also the loss kernels on the step's own images (`loss_fwd`, `loss_bwd`:
mean device ms of 20 back-to-back calls after one, CUDA events) and the
device work between the render and the blend backward in one profiled
step (`loss_glue`; on trees with the composite kernels it holds Cb'):
each kernel, copy and set in device order, with its microseconds, the
operator that launched it and, in the backward, the
autograd node, split into the loss forward (launched by the step's own
thread after the render returns) and the loss backward (launched by
autograd's device thread before the blend backward).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

WARMUP, TIMED, PROFILED = 5, 20, 3


def own_profiling():
    """This script's own `gsplat_tpu_torch/profiling.py`, loaded by path, so
    every tree's profile is read (and its launches counted) the same way."""
    spec = importlib.util.spec_from_file_location(
        "step_ab_profiling", Path(__file__).resolve().parents[1] / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile(fn):
    """Device ms, kernels, busy share, host-to-device copies and the stage
    table per call over PROFILED calls (`torch.profiler`)."""
    from torch.autograd import DeviceType

    profiling = own_profiling()
    prof = profiling.profile_calls(fn, PROFILED)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    events = profiling.trace_events(prof)
    busy, span = profiling.busy_span_us(prof, events)
    return {"device_ms": sum(r[1] for r in rows) / PROFILED,
            "kernels": sum(r[2] for r in rows) / PROFILED,
            "launch_census": profiling.launch_census(events, PROFILED),
            "stage_report": profiling.stage_report(events, PROFILED),
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


def event_ms(fn, reps=20):
    """Mean device ms of `fn()` over `reps` back-to-back calls after one
    warm-up call, between two CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def loss_kernels(step_once, losses):
    """The loss kernels timed on the images one train step hands them."""
    import torch

    seen = {}
    fwd = losses.loss_fwd

    def keep(*args):
        seen["fwd"] = args
        return fwd(*args)

    keep.launches = 0  # the wrapper counts its launches on the module's name
    losses.loss_fwd = keep
    try:
        step_once()
    finally:
        losses.loss_fwd = fwd
    image, gt, lam, _, _, taps = seen["fwd"]
    image, gt = image.detach(), gt.detach()
    partials = losses.loss_fwd(image, gt, lam, True, False, taps)[3]
    one = torch.ones((), device=image.device)
    return {"size": list(image.shape),
            "loss_fwd_ms": event_ms(lambda: losses.loss_fwd(image, gt, lam, True, False, taps)),
            "loss_bwd_ms": event_ms(lambda: losses.loss_bwd(image, gt, partials, one, None, None,
                                                             lam, taps))}


def loss_glue(step_once, ts):
    """The device work of one profiled step between the render and the
    blend backward (see the module's docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    render = ts.render

    def marked(*args, **kw):
        with record_function("step_render"):
            return render(*args, **kw)

    ts.render = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_once()
            torch.cuda.synchronize()
    finally:
        ts.render = render
    with tempfile.TemporaryDirectory(prefix="step_ab_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
              if e.get("ph") == "X" and "dur" in e]
    mark = next(e for e in events if e.get("name") == "step_render")
    main_tid, render_end = mark["tid"], mark["ts"] + mark["dur"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    device = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])

    def enclosing(launch, prefix=""):
        hits = [o for o in ops if o["tid"] == launch["tid"] and o["name"].startswith(prefix)
                and o["ts"] <= launch["ts"] <= o["ts"] + o["dur"]]
        return max(hits, key=lambda o: o["ts"])["name"] if hits else None

    rows, started = [], False
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if not started:
            started = (launch is not None and launch["tid"] == main_tid
                       and launch["ts"] > render_end)
        if not started:
            continue
        if "blend_bwd_kernel" in e["name"]:
            break
        if launch is None:  # no host record: the stage of the work before it
            stage = rows[-1]["stage"] if rows else "loss"
            op = autograd = None
        else:
            stage = "loss" if launch["tid"] == main_tid else "loss_backward"
            op = enclosing(launch)
            autograd = enclosing(launch, "autograd::engine::evaluate_function")
        rows.append({"stage": stage, "us": e["dur"], "device": e["name"][:90], "op": op,
                     "autograd": autograd})
    totals = {}
    for r in rows:
        totals[r["stage"]] = totals.get(r["stage"], 0.0) + r["us"]
    return {"device_us": totals, "rows": rows}


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
        if mode == "sorted":
            from gsplat_tpu_torch.train import losses

            out["loss_kernels"] = loss_kernels(one_step, losses)
            out["loss_glue"] = loss_glue(one_step, ts)
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
