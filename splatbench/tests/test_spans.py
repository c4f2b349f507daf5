"""The readers of idle outside the program on made-up traces: idle inside
the program's `gs/` spans (on any host thread) is left out, the counters
are no spans, a device clock that runs early is moved to its launches, the
share scales `idle_pct`, and a trace without spans reads `idle_pct`
itself."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from splatbench import spans, spec, trace, work  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = [m for m in BENCH["per_layer"] if m["name"].startswith("outside_idle_pct.")]


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k(int)", "ts": ts, "dur": dur}


def annotation(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def made_up(with_spans=True):
    """A 1000 us stretch with kernels at [100, 300] and [600, 700]: 700 us
    idle. The main thread's `gs/project` holds [0, 200] and `gs/backward`
    [500, 900], autograd's thread `gs/backward/blend` [550, 650] and a
    counter at [320, 420]: 100 + 300 idle us inside spans, 300 outside
    ([300, 500] and [900, 1000]; the counter holds none)."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 0.0, "dur": 1000.0},
          kernel(100.0, 200.0), kernel(600.0, 100.0)]
    if with_spans:
        ev += [annotation("gs/project", 0.0, 200.0), annotation("gs/backward", 500.0, 400.0),
               annotation("gs/backward/blend", 550.0, 100.0, tid=2),
               annotation("gs/count/instances=9", 320.0, 100.0)]
    return trace.Trace(ev)


def test_idle_inside_spans_is_left_out():
    tr = made_up()
    assert sum(e - s for s, e in spans.idle_intervals(tr)) == pytest.approx(700.0)
    assert spans.outside_idle_share(tr) == pytest.approx(300.0 / 700.0)
    assert spans.outside_idle_share(made_up(with_spans=False)) == 1.0


def test_a_device_clock_that_runs_early_is_moved_to_its_launches():
    """`gs/project` holds [100, 300] of a 400 us stretch and launches at 150
    a kernel the trace puts at [60, 150], 90 us before its launch: moved to
    [150, 240], the idle outside the span is [0, 100] and [300, 400]."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 0.0, "dur": 400.0},
          annotation("gs/project", 100.0, 200.0),
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150.0, "dur": 5.0,
           "tid": 1, "args": {"correlation": 7}},
          {**kernel(60.0, 90.0), "args": {"correlation": 7}}]
    tr = trace.Trace(ev)
    assert spans.clock_lead(tr) == pytest.approx(90.0)
    assert spans.idle_intervals(tr) == [(0.0, 150.0), (240.0, 400.0)]
    assert spans.outside_idle_share(tr) == pytest.approx(200.0 / 310.0)
    assert spans.clock_lead(made_up()) == 0.0


@pytest.mark.parametrize("metric", [m["name"] for m in READERS])
def test_the_reader_scales_idle_pct_and_never_passes_it(metric):
    m = next(m for m in READERS if m["name"] == metric)
    assert m["layer"] == "device" and m["unit"] == "%" and m["better"] == "lower"
    reader = spec.load(m["workloads"][0]).reader(metric)
    for with_spans in (True, False):
        ctx = {"trace": made_up(with_spans), "calls": 1, "call_s": 0.004}
        idle = work.idle_pct(ctx)  # 300 us busy of 4 ms: 92.5%
        value = reader.read(ctx)
        assert 0.0 < value <= idle
        share = 300.0 / 700.0 if with_spans else 1.0
        assert value == pytest.approx(share * idle)
