"""The program's stage spans in a trace, read without the program.

While a profiler records, the port marks each stage of a render or a
train step with a `record_function` annotation named `gs/<stage>`, and
each counter with a zero-length one named `gs/count/<name>=<value>`
(`gsplat_tpu_torch/profiling.py`: `span`, `count`). Kineto writes them
into the chrome trace as `user_annotation` events on the host's threads,
on the clock of the device's events. A program without spans leaves
none, and then every idle instant is outside the program.

Kineto maps the device's timestamps onto the host's clock once a profiler
session, and a session's map can run early by tens to hundreds of us. No
device operation starts before the host call that launched it, so where
some seem to, the device's times are moved later by the largest such lead
(`clock_lead`) before the idle instants are compared with the spans.
"""

from __future__ import annotations

from splatbench.trace import interval_union

SPAN_PREFIX = "gs/"
COUNT_PREFIX = "gs/count/"


def program_spans(trace):
    """(start, end) of each of the program's stage spans, on any host
    thread, clipped to the traced stretch (the counters left out)."""
    out = []
    for e in trace.events:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and name.startswith(SPAN_PREFIX)
                and not name.startswith(COUNT_PREFIX)):
            s = max(float(e["ts"]), trace.t0)
            t = min(float(e["ts"]) + float(e["dur"]), trace.t1)
            if t > s:
                out.append((s, t))
    return out


def _corr(e):
    return e.get("args", {}).get("correlation")


def clock_lead(trace):
    """The most by which a device operation starts before the host call
    that launched it (matched by correlation id), 0 where none does."""
    launched = {}
    for e in trace.events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and _corr(e) is not None:
            launched[_corr(e)] = max(launched.get(_corr(e), float(e["ts"])), float(e["ts"]))
    return max([0.0] + [launched[_corr(d)] - float(d["ts"]) for d in trace.device
                        if _corr(d) in launched])


def idle_intervals(trace):
    """The parts of the traced stretch in which the card runs nothing, the
    device's times moved later by `clock_lead`."""
    shift = clock_lead(trace)
    busy = sorted((float(d["ts"]) + shift, float(d["ts"]) + float(d["dur"]) + shift)
                  for d in trace.device)
    out, end = [], trace.t0
    for s, e in busy:
        if s >= trace.t1:
            break
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if trace.t1 > end:
        out.append((end, trace.t1))
    return out


def outside_idle_share(trace):
    """The share of the traced stretch's idle seconds in which no span of
    the program is open on any host thread (0 where the card never idles)."""
    idle = idle_intervals(trace)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return 0.0
    spans = program_spans(trace)
    inside = interval_union([(max(s, a), min(e, b)) for s, e in idle for a, b in spans
                             if min(e, b) > max(s, a)])
    return (total - inside) / total
