"""Device time from a `torch.profiler` trace.

The union of the device's kernel, copy and set intervals over a few
profiled calls: how long the card was busy, with no host gap between
launches counted and no interval counted twice. `python -m
gsplat_tpu_torch.bench` reports it beside each rate and `chip_smoke.py`
reads its busy shares with it, so the two cannot disagree.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch

# trace categories of the chrome trace that `torch.profiler` exports
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def interval_union(spans) -> float:
    """Total length covered by the (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def activities(device):
    """The profiler activities for work on `device`: the host's ops, and
    the card's kernels, copies and sets when it is a CUDA device."""
    from torch.profiler import ProfilerActivity

    cuda = torch.device(device).type == "cuda"
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def profile_calls(fn, calls: int):
    """Run `fn()` `calls` times under `torch.profiler` (CPU and CUDA
    activity), ending in a synchronize; returns the finished profile."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities("cuda")) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof


def trace_events(prof):
    """The complete ("X") events of a finished profile's chrome trace."""
    with tempfile.TemporaryDirectory(prefix="gsplat_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
            if e.get("ph") == "X" and "dur" in e]


def busy_span_us(prof, events=None):
    """(busy, span) in microseconds of a finished profile: `span` runs from
    the first host event to the last event's end, `busy` is the union of
    the device intervals inside it, so busy <= span."""
    events = trace_events(prof) if events is None else events

    def spans(cats):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") in cats]

    device, host = spans(DEVICE_CATS), spans(HOST_CATS)
    if not device or not host:
        raise RuntimeError("profiler trace holds no device or no host events")
    t0 = min(s for s, _ in host)
    t1 = max(e for _, e in device + host)
    busy = interval_union([(max(s, t0), min(e, t1)) for s, e in device if min(e, t1) > max(s, t0)])
    return busy, t1 - t0


def device_ms_per_call(fn, calls: int = 3) -> float:
    """The card's busy time per call of `fn()`, over `calls` profiled calls."""
    busy, _ = busy_span_us(profile_calls(fn, calls))
    return busy / 1e3 / calls


# the host calls that queue device work: kernels, copies and sets
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaMemcpy", "cudaMemset")


def launch_census(events, calls: int) -> dict:
    """Host launches against device events in a profile's trace, matched by
    correlation id: launches and device events per call, and by name the
    launches the trace holds no device event for (named by the host op that
    made them) and the device events it holds no launch for (by kernel)."""

    def corr(e):
        return e.get("args", {}).get("correlation")

    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name") in LAUNCH_CALLS]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    device_ids, launch_ids = {corr(e) for e in device}, {corr(e) for e in launches}
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def op_of(launch):
        hits = [o for o in ops if o.get("tid") == launch.get("tid")
                and o["ts"] <= launch["ts"] <= o["ts"] + o["dur"]]
        return max(hits, key=lambda o: o["ts"])["name"] if hits else launch["name"]

    def tally(names):
        out = {}
        for n in names:
            out[n] = out.get(n, 0) + 1
        return out

    return {"launched_per_call": len(launches) / calls,
            "device_events_per_call": len(device) / calls,
            "launches_without_device_event": tally(
                op_of(e) for e in launches if corr(e) not in device_ids),
            "device_events_without_launch": tally(
                e["name"][:90] for e in device if corr(e) not in launch_ids)}
