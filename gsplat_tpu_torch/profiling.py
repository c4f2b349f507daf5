"""Device time from a `torch.profiler` trace, and the program's stages in it.

The union of the device's kernel, copy and set intervals over a few
profiled calls: how long the card was busy, with no host gap between
launches counted and no interval counted twice. `python -m
gsplat_tpu_torch.bench` reports it beside each rate and `chip_smoke.py`
reads its busy shares with it, so the two cannot disagree.

The stages: while a `torch.profiler` session records, `render`, the train
step and the backward of its autograd functions mark each stage of their
work with `span(stage)`, a `record_function` annotation named
`gs/<stage>` (`STAGES`), and `count` writes a counter as a zero-length
annotation `gs/count/<name>=<value>`. Kineto writes them into the chrome
trace beside the kernels, on the same clock. With no profiler recording,
`span` returns one shared no-op context and `count` does nothing.
`stage_report` splits a trace's calls by stage: host, device and idle ms
and launches per stage, the counters, and the clock check;

    python -m gsplat_tpu_torch.profiling <trace.json> [--calls N]

prints it for a chrome trace written by `torch.profiler` (`cli/train.py
--profile_steps` prints it after writing its trace).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import torch

# trace categories of the chrome trace that `torch.profiler` exports
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# the program's stages, in the order a train step runs them: a render runs
# `project` to `composite`; in a step on the card, autograd's device thread
# runs the `backward/` stages while the step's own thread waits in
# `backward`
RENDER_STAGES = ("project", "bin/tables", "bin/read_k", "bin/expand", "bin/sort", "bin/pack",
                 "blend", "composite")
BACKWARD_STAGES = ("backward/loss", "backward/composite", "backward/blend", "backward/reduce",
                   "backward/project")
STAGES = ("step/prepare", *RENDER_STAGES, "loss", "backward", *BACKWARD_STAGES, "step/stats",
          "adam")
COUNTERS = ("instances",)  # K, a frame's instance count, as the read of K returns it
SPAN_PREFIX = "gs/"
COUNT_PREFIX = "gs/count/"
OUTSIDE = "outside"  # the report's row for the instants no span holds

_STAGE_SET = frozenset(STAGES)
_OFF = contextlib.nullcontext()  # holds no state: one instance serves every stage


def span(stage: str):
    """The context around one stage of the program's work: while a
    profiler records, a `record_function` annotation `gs/<stage>`; else a
    shared no-op. The stages of one thread follow each other and never
    nest, so each host instant has one stage."""
    if stage not in _STAGE_SET:
        raise ValueError(f"unknown stage {stage!r}: expected one of {STAGES}")
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.autograd.profiler.record_function(SPAN_PREFIX + stage)


def count(name: str, value) -> None:
    """Write the counter `name` = int(`value`) into the trace while a
    profiler records, as a zero-length annotation `gs/count/<name>=<value>`
    (Kineto exports no arguments of a `record_function`); else nothing.
    `value` is a host number, so counting reads nothing from the card."""
    if name not in COUNTERS:
        raise ValueError(f"unknown counter {name!r}: expected one of {COUNTERS}")
    if torch.autograd._profiler_enabled():
        with torch.autograd.profiler.record_function(f"{COUNT_PREFIX}{name}={int(value)}"):
            pass


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


def read_trace(path):
    """The complete ("X") events of a chrome trace file."""
    trace = json.loads(Path(path).read_text())
    return [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
            if e.get("ph") == "X" and "dur" in e]


def trace_events(prof):
    """The complete ("X") events of a finished profile's chrome trace."""
    with tempfile.TemporaryDirectory(prefix="gsplat_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return read_trace(path)


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


def _corr(e):
    return e.get("args", {}).get("correlation")


def _launches(events):
    return [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and e.get("name") in LAUNCH_CALLS]


def stage_spans(events):
    """(start, end, stage, thread) of each stage span in the trace, in start
    order (the counters left out)."""
    out = []
    for e in events:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and name.startswith(SPAN_PREFIX)
                and not name.startswith(COUNT_PREFIX)):
            s = float(e["ts"])
            out.append((s, s + float(e["dur"]), name[len(SPAN_PREFIX):], e.get("tid")))
    return sorted(out, key=lambda sp: sp[:2])


def nested(spans):
    """(outer, inner) stage of each span that opens before the one before
    it on its thread has closed: none where the stages are flat."""
    last, out = {}, []
    for s, e, stage, tid in spans:
        if tid in last and s < last[tid][0]:
            out.append((last[tid][1], stage))
        if tid not in last or e > last[tid][0]:
            last[tid] = (e, stage)
    return out


def counters(events) -> dict:
    """{name: [value of each count, in trace order]} of the trace's counters."""
    found = []
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(COUNT_PREFIX):
            key, _, value = name[len(COUNT_PREFIX):].partition("=")
            found.append((float(e["ts"]), key, int(value)))
    out = {}
    for _, key, value in sorted(found):
        out.setdefault(key, []).append(value)
    return out


class _Owners:
    """The stage that holds each instant: of the spans open then on any host
    thread, the one that started latest (None where none is open), as a
    step function of time."""

    def __init__(self, spans):
        spans = [sp for sp in spans if sp[1] > sp[0]]  # an empty span holds no instant
        marks = sorted([(e, 0, i) for i, (_, e, _, _) in enumerate(spans)]
                       + [(s, 1, i) for i, (s, _, _, _) in enumerate(spans)])
        self.times, self.stages, live = [], [], set()
        for t, opens, i in marks:
            (live.add if opens else live.discard)(i)
            stage = spans[max(live, key=lambda j: (spans[j][0], j))][2] if live else None
            if self.times and self.times[-1] == t:
                self.stages[-1] = stage
            else:
                self.times.append(t)
                self.stages.append(stage)

    def at(self, t):
        i = bisect.bisect_right(self.times, t) - 1
        return self.stages[i] if i >= 0 else None

    def split(self, s, e):
        """[(stage, length)] of the interval [s, e], piece by piece."""
        out, i = [], bisect.bisect_right(self.times, s) - 1
        while s < e:
            end = min(self.times[i + 1], e) if i + 1 < len(self.times) else e
            out.append((self.stages[i] if i >= 0 else None, end - s))
            s, i = end, i + 1
        return out


def launch_census(events, calls: int) -> dict:
    """Host launches against device events in a profile's trace, matched by
    correlation id: launches and device events per call, and by name the
    launches the trace holds no device event for (named by the host op that
    made them) and the device events it holds no launch for (by kernel);
    and the launches per call of each stage (`stage_spans`; a launch goes
    to the stage that holds its instant, `outside` where none does)."""
    launches = _launches(events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    device_ids, launch_ids = {_corr(e) for e in device}, {_corr(e) for e in launches}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    owners = _Owners(stage_spans(events))

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
                op_of(e) for e in launches if _corr(e) not in device_ids),
            "device_events_without_launch": tally(
                e["name"][:90] for e in device if _corr(e) not in launch_ids),
            "launches_by_stage": {k: v / calls for k, v in tally(
                owners.at(float(e["ts"])) or OUTSIDE for e in launches).items()}}


def _gaps(intervals, t0, t1):
    """The parts of [t0, t1] that no (start, end) interval covers."""
    out, end = [], t0
    for s, e in sorted(intervals):
        if s >= t1:
            break
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if t1 > end:
        out.append((end, t1))
    return out


def stage_report(events, calls: int) -> dict:
    """`launch_census` with the calls split by stage: for each stage, per
    call, its spans' host ms, the device ms of the operations launched in
    it (by correlation id), its launches, and its idle ms (each instant
    of the window at which the card runs nothing goes to the stage that
    holds it, see `launch_census`); `outside` holds what no span does (its
    host ms: the window's instants with no span open). Also the counters
    and `clock_violations`, the device operations that start before their
    launch (0 where the spans and the device share one clock), with
    `clock_lead_us`, the most by which one does. Kineto maps the device's
    timestamps onto the host's clock once a session, and a session's map
    can run early by tens to hundreds of us; no operation starts before
    its launch, so the device's times are moved later by `clock_lead_us`
    before idle instants are given to stages (a map that runs late cannot
    be told from queueing and stays). The window
    runs from the first host event to the last event's end, as in
    `busy_span_us`."""
    spans = stage_spans(events)
    owners = _Owners(spans)
    launches = _launches(events)
    by_corr = {_corr(e): e for e in launches}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not host:
        raise RuntimeError("profiler trace holds no host events")
    rows = {}

    def row(stage):
        return rows.setdefault(stage or OUTSIDE, {"host_ms": 0.0, "device_ms": 0.0,
                                                  "idle_ms": 0.0, "launches": 0})

    for s, e, stage, _ in spans:
        row(stage)["host_ms"] += e - s
    for e in launches:
        row(owners.at(float(e["ts"])))["launches"] += 1
    leads = []
    for d in device:
        launch = by_corr.get(_corr(d))
        if launch is not None:
            row(owners.at(float(launch["ts"])))["device_ms"] += float(d["dur"])
            if float(d["ts"]) < float(launch["ts"]):
                leads.append(float(launch["ts"]) - float(d["ts"]))
    shift = max(leads, default=0.0)  # the device's times moved so none precedes its launch
    busy = [(float(d["ts"]) + shift, float(d["ts"]) + float(d["dur"]) + shift) for d in device]
    t0 = min(float(e["ts"]) for e in host)
    t1 = max([float(e["ts"]) + float(e["dur"]) for e in host] + [e for _, e in busy])
    for gap in _gaps(busy, t0, t1):
        for stage, length in owners.split(*gap):
            row(stage)["idle_ms"] += length
    row(None)["host_ms"] = (t1 - t0) - interval_union(
        [(max(s, t0), min(e, t1)) for s, e, _, _ in spans if min(e, t1) > max(s, t0)])
    order = {s: i for i, s in enumerate(STAGES)}
    stages = {}
    for stage in sorted(rows, key=lambda k: (k == OUTSIDE, order.get(k, len(STAGES)), k)):
        r = rows[stage]
        stages[stage] = {k: v / calls / (1.0 if k == "launches" else 1e3) for k, v in r.items()}
    return {**launch_census(events, calls), "calls": calls,
            "window_ms": (t1 - t0) / 1e3 / calls,
            "busy_ms": interval_union(busy) / 1e3 / calls, "stages": stages,
            "counters": counters(events), "clock_violations": len(leads),
            "clock_lead_us": shift}


def format_report(report) -> str:
    """`stage_report` as a table, per call."""
    lines = [f"{report['calls']} calls; per call: window {report['window_ms']:.3f} ms, "
             f"busy {report['busy_ms']:.3f} ms, launches {report['launched_per_call']:.1f}",
             f"{'stage':<20}{'host ms':>10}{'device ms':>11}{'idle ms':>10}{'launches':>10}"]
    for stage, r in report["stages"].items():
        lines.append(f"{stage:<20}{r['host_ms']:>10.3f}{r['device_ms']:>11.3f}"
                     f"{r['idle_ms']:>10.3f}{r['launches']:>10.1f}")
    for name, values in report["counters"].items():
        lines.append(f"counter {name}: {values}")
    lines.append(f"clock_violations: {report['clock_violations']} "
                 f"(lead {report['clock_lead_us']:.1f} us)")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Split the calls of a torch.profiler chrome trace "
                                            "by the program's stages.")
    p.add_argument("trace", help="a chrome trace written by torch.profiler")
    p.add_argument("--calls", type=int, default=None,
                   help="calls the trace holds (default: its `project` spans, or 1)")
    args = p.parse_args(argv)
    events = read_trace(args.trace)
    calls = args.calls or max(sum(sp[2] == "project" for sp in stage_spans(events)), 1)
    print(format_report(stage_report(events, calls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
