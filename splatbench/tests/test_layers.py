"""The per-layer readers and the trace reduction on a made-up trace: busy
time is the union of device intervals, each reader finds its kernels by
name, and a reader whose kernels are absent returns nothing."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from splatbench import spec, trace, work  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KERNELS = ["project_fwd_kernel<3>", "project_bwd_kernel<3>", "emission_tables_kernel",
           "expand_instances_kernel", "sort_instances_pass<0>", "pack_instances_kernel",
           "blend_fwd_kernel", "blend_bwd_kernel", "reduce_by_gid_kernel", "loss_fwd_kernel",
           "loss_bwd_kernel", "adam_rows_kernel"]
COUNTS = {"visible": 9e5, "instances": 5e6, "live": 7e5, "pairs": 2e8, "blended": 8e7,
          "pixels": 1.09e6, "tiles": 4346, "rows": 1e6}


def events(kernels, dur=100.0):
    """One host op spanning everything; kernels back to back with 10 us gaps."""
    out = [{"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 0.0,
            "dur": (dur + 10) * len(kernels) + 10}]
    for i, name in enumerate(kernels):
        out.append({"ph": "X", "cat": "kernel", "name": f"(anonymous namespace)::{name}(int)",
                    "ts": 10 + i * (dur + 10), "dur": dur})
    return out


def test_busy_is_the_union_of_device_intervals():
    ev = events(["a", "b"]) + [{"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 50.0,
                                "dur": 100.0}]
    tr = trace.Trace(ev)
    assert tr.busy_s == pytest.approx(210e-6)
    assert tr.window_s == pytest.approx(230e-6)
    assert tr.kernel_seconds(("a(",)) == pytest.approx(100e-6)
    assert tr.kernel_seconds(("missing",)) is None
    assert tr.idle_gaps(1)[0][0] == "aten::item"
    assert [n for n, _ in tr.top_ops(2)][0] in {"copy", "(anonymous namespace)::a(int)",
                                                "(anonymous namespace)::b(int)"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_reader_reads_a_share_of_its_trace(metric):
    cell = spec.load(next(m for m in BENCH["per_layer"] if m["name"] == metric)["workloads"][0])
    reader = cell.reader(metric)
    ctx = {"trace": trace.Trace(events(KERNELS, dur=1000.0)), "calls": 1, "counts": COUNTS,
           "config": cell.config, "call_s": 0.02}
    value = reader.read(ctx)
    assert 0.0 < value < 100.0
    if "roofline" in metric:
        assert reader.read({**ctx, "trace": trace.Trace(events(["other_kernel"]))}) is None


def test_least_seconds_is_the_larger_of_bytes_and_operations():
    assert work.least_seconds(3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 67e12 * 2) == pytest.approx(2.0)


def test_idle_and_mfu_read_the_untraced_window_per_call():
    """Busy seconds per traced call against the window's seconds per call:
    the profiled stretch's own length, which the profiler's host cost
    stretches, does not enter."""
    tr = trace.Trace(events(["a", "b"], dur=1000.0))  # 2 ms busy over 2 calls
    ctx = {"trace": tr, "calls": 2, "call_s": 0.004, "counts": {"pairs": 67e6 / 11}}
    assert work.idle_pct(ctx) == pytest.approx(75.0)
    assert work.idle_pct({**ctx, "trace": trace.Trace(events(["a"], dur=5000.0))}) \
        == pytest.approx(37.5)
    assert work.mfu_pct(ctx, work.blend_fwd_ops(ctx["counts"])) == pytest.approx(
        100.0 * 67e6 / 2 / (0.004 * 67e12))
