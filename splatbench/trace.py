"""Device time from a `torch.profiler` trace of a short stretch of calls.

Busy time is the union of the card's kernel, copy and set intervals, as
`gsplat_tpu_torch/profiling.py` (`interval_union`, `busy_span_us`)
measures it, copied here so that the yardstick stays fixed. The window
runs from the first host event to the last event's end.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN = "splatbench"  # the annotation around each profiled call


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


def profile(fn, calls):
    """Run `fn(i)` for i in range(calls) under the profiler, each call inside
    a `splatbench` annotation, ending in a synchronize; returns the trace's
    complete events."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            with record_function(SPAN):
                fn(i)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="splatbench_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class Trace:
    """The events of one profiled stretch, in seconds."""

    def __init__(self, events):
        self.events = events
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("cat") in HOST_CATS]
        if not self.device or not host:
            raise RuntimeError("the profiler's trace holds no device or no host events")
        self.t0 = min(float(e["ts"]) for e in host)
        self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in self.device + host)
        self.window_s = (self.t1 - self.t0) / 1e6
        self.busy_s = interval_union(self._spans(self.device)) / 1e6

    def _spans(self, events):
        return [(max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                for e in events if float(e["ts"]) + float(e["dur"]) > self.t0]

    def kernel_seconds(self, names):
        """Device seconds of the kernels whose name contains one of `names`,
        or None where the trace holds none of them."""
        hits = [e for e in self.device if e.get("cat") == "kernel"
                and any(n in e["name"] for n in names)]
        if not hits:
            return None
        return sum(float(e["dur"]) for e in hits) / 1e6

    def top_ops(self, k=10):
        """[name, seconds] of the device operations that took the most time."""
        by = {}
        for e in self.device:
            name = e["name"][:120]
            by[name] = by.get(name, 0.0) + float(e["dur"]) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """[label, seconds] of the longest gaps with no device operation, each
        labelled by the host operation that overlaps it most (the run's own
        annotation left out), or "host between operations"."""
        spans = sorted(self._spans(self.device))
        gaps, end = [], self.t0
        for s, e in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        host = [(float(o["ts"]), float(o["ts"]) + float(o["dur"]), o["name"]) for o in self.events
                if o.get("cat") in HOST_CATS and o["name"] != SPAN]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            best, label = 0.0, "host between operations"
            for hs, he, name in host:
                overlap = min(he, e) - max(hs, s)
                if overlap > best:
                    best, label = overlap, name
            out.append([label[:120], (e - s) / 1e6])
        return out
