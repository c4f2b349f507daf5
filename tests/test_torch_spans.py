"""The program's stage spans and its counter (`gsplat_tpu_torch/profiling.py`).

- With no profiler recording, `span` returns the one shared no-op and
  `count` makes no annotation; an unknown stage or counter is refused.
- Under `torch.profiler` on the CPU, a render and a train step (sorted and
  OIT blend) show each of their stages once per call, in order, and no
  stage span holds another on one thread; the `instances` counter equals
  `num_instances`. On the CPU, autograd runs the backward on the step's
  own thread, so the backward's stages stand there in place of `backward`
  (on the card they run on autograd's device thread inside it).
- `stage_report` and `launch_census`'s stage tallies on a made-up trace
  with known gaps: idle per stage, the `outside` row, the counters and a
  counted clock violation; a device clock that runs early is moved to its
  launches before idle is given to stages.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gsplat_tpu_torch import profiling as pr
from gsplat_tpu_torch.config import OptimizationConfig
from gsplat_tpu_torch.convert import PARAM_FIELDS
from gsplat_tpu_torch.core.types import make_render_settings
from gsplat_tpu_torch.render import render
from gsplat_tpu_torch.synthetic import tiny_scene
from gsplat_tpu_torch.train import step as ts

RENDER = ("project", "bin/tables", "bin/read_k", "bin/expand", "bin/sort", "bin/pack", "blend",
          "composite")
BACKWARD = ("backward/loss", "backward/composite", "backward/blend", "backward/reduce",
            "backward/project")
# a train step on the CPU, in order: the backward's stages on the step's thread
STEP_CPU = ("step/prepare", *RENDER, "loss", *BACKWARD, "step/stats", "adam")
CALLS = 2
W, H = 64, 48


def test_stages_are_the_render_and_step_stages_and_backward():
    assert pr.RENDER_STAGES == RENDER and pr.BACKWARD_STAGES == BACKWARD
    assert set(pr.STAGES) == set(STEP_CPU) | {"backward"}
    assert len(pr.STAGES) == len(set(pr.STAGES))


def test_without_a_profiler_span_is_the_shared_noop_and_count_writes_nothing(monkeypatch):
    def refused(name):
        raise AssertionError(f"an annotation {name!r} with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    for stage in pr.STAGES:
        ctx = pr.span(stage)
        assert ctx is pr._OFF
        with ctx:
            pass
    pr.count("instances", 7)
    with pytest.raises(ValueError, match="unknown stage"):
        pr.span("bin")
    with pytest.raises(ValueError, match="unknown counter"):
        pr.count("pairs", 1)


def traced(fn):
    """The complete events of a CPU profile of `fn()` called CALLS times,
    and what each call returned."""
    outs = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            outs.append(fn())
    return pr.trace_events(prof), outs


def check_calls(events, stages, num_instances):
    spans = pr.stage_spans(events)
    assert [sp[2] for sp in spans] == list(stages) * CALLS
    assert pr.nested(spans) == []
    assert pr.counters(events) == {"instances": num_instances}
    report = pr.stage_report(events, CALLS)
    assert list(report["stages"]) == [*sorted(set(stages), key=pr.STAGES.index), pr.OUTSIDE]
    assert report["clock_violations"] == 0 and report["launched_per_call"] == 0


@pytest.mark.parametrize("blend_mode", ["sorted", "oit"])
def test_a_render_shows_each_stage_once_per_call(blend_mode):
    params, alive, camera = tiny_scene(n=300, width=W, height=H, device="cpu")
    settings = make_render_settings(sh_degree=3, blend_mode=blend_mode)
    with torch.no_grad():
        events, outs = traced(lambda: render(camera, params, alive, settings, [0.0, 0.0, 0.0],
                                             device="cpu"))
    assert outs[0]["num_instances"] > 0
    check_calls(events, RENDER, [o["num_instances"] for o in outs])


@pytest.mark.parametrize("blend_mode", ["sorted", "oit"])
def test_a_train_step_shows_each_stage_once_per_call(blend_mode):
    params, alive, camera = tiny_scene(n=300, width=W, height=H, device="cpu")
    state = ts.init_train_state({k: getattr(params, k).detach().clone() for k in PARAM_FIELDS},
                                alive, num_images=1)
    settings = make_render_settings(sh_degree=3, packet_dtype="hybrid", blend_mode=blend_mode)
    step = ts.make_train_step(OptimizationConfig(), settings)
    zeros = torch.zeros((H, W))
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(0))
    args = (camera, gt, torch.ones((H, W, 1)), zeros, zeros, torch.zeros(3), 1e-3, 1e-3, 0.0, 0)
    holder = [state]

    def one():
        holder[0], metrics = step(holder[0], *args)
        return metrics

    events, outs = traced(one)
    check_calls(events, STEP_CPU, [m["num_instances"] for m in outs])


def event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_up_trace():
    """One call over [0, 500] us. Main thread (1): `project` [0, 100],
    `bin/read_k` [100, 150] with the counter in it, `backward` [150, 400];
    autograd's thread (2): `backward/blend` [200, 300]. Launches at 10
    (project), 210 (backward/blend, its kernel starting at 205: a clock
    violation), 350 (autograd's thread, in `backward`), 450 (outside).
    Busy [20, 60], [205, 260], [360, 380], [460, 470]. An empty `bin/expand`
    at 460 holds nothing."""
    ev = [event("cpu_op", "aten::empty", 0.0, 500.0),
          event("user_annotation", "gs/project", 0.0, 100.0),
          event("user_annotation", "gs/bin/read_k", 100.0, 50.0),
          event("user_annotation", "gs/count/instances=42", 120.0, 0.0),
          event("user_annotation", "gs/backward", 150.0, 250.0),
          event("user_annotation", "gs/backward/blend", 200.0, 100.0, tid=2),
          event("user_annotation", "gs/bin/expand", 460.0, 0.0)]
    for corr, (launch, start, dur, tid) in enumerate(((10.0, 20.0, 40.0, 1),
                                                      (210.0, 205.0, 55.0, 2),
                                                      (350.0, 360.0, 20.0, 2),
                                                      (450.0, 460.0, 10.0, 1))):
        ev.append(event("cuda_runtime", "cudaLaunchKernel", launch, 2.0, tid=tid, corr=corr))
        ev.append(event("kernel", f"k{corr}", start, dur, tid=7, corr=corr))
    return ev


def test_nested_names_each_span_opened_inside_another_on_its_thread():
    spans = [(0, 10, "project", 1), (2, 5, "blend", 1), (3, 4, "loss", 1), (6, 8, "adam", 1),
             (2, 9, "backward/blend", 2), (10, 12, "composite", 1)]
    assert pr.nested(spans) == [("project", "blend"), ("project", "loss"), ("project", "adam")]


def test_stage_report_splits_idle_launches_and_device_time_by_stage():
    ev = made_up_trace()
    rep = pr.stage_report(ev, 1)
    want = {  # host ms, device ms, idle ms, launches
        "project": (0.100, 0.040, 0.060, 1),
        "bin/read_k": (0.050, 0.0, 0.050, 0),
        "bin/expand": (0.0, 0.0, 0.0, 0),
        "backward": (0.250, 0.020, 0.130, 1),
        "backward/blend": (0.100, 0.055, 0.045, 1),
        pr.OUTSIDE: (0.100, 0.010, 0.090, 1),
    }
    assert list(rep["stages"]) == list(want)
    for stage, (host, device, idle, launches) in want.items():
        row = rep["stages"][stage]
        assert row["host_ms"] == pytest.approx(host), stage
        assert row["device_ms"] == pytest.approx(device), stage
        assert row["idle_ms"] == pytest.approx(idle), stage
        assert row["launches"] == launches, stage
    assert sum(r["idle_ms"] for r in rep["stages"].values()) == pytest.approx(0.5 - 0.125)
    assert rep["window_ms"] == pytest.approx(0.5) and rep["busy_ms"] == pytest.approx(0.125)
    assert rep["counters"] == {"instances": [42]}
    assert rep["clock_violations"] == 1 and rep["clock_lead_us"] == pytest.approx(5.0)
    census = pr.launch_census(ev, 2)
    assert census["launches_by_stage"] == {"project": 0.5, "backward/blend": 0.5,
                                           "backward": 0.5, pr.OUTSIDE: 0.5}
    assert census["launched_per_call"] == 2.0
    text = pr.format_report(rep)
    assert "backward/blend" in text and "clock_violations: 1" in text


def test_the_report_moves_a_device_clock_that_runs_early_to_its_launches():
    """`bin/read_k` [0, 100], `bin/expand` [100, 200]; the expand launches
    at 110 a kernel the trace puts at [65, 130], 45 us before its launch:
    moved to [110, 175], the read of K holds 100 us of idle, not 65."""
    ev = [event("cpu_op", "aten::empty", 0.0, 300.0),
          event("user_annotation", "gs/bin/read_k", 0.0, 100.0),
          event("user_annotation", "gs/bin/expand", 100.0, 100.0),
          event("cuda_runtime", "cudaLaunchKernel", 110.0, 3.0, corr=1),
          event("kernel", "expand", 65.0, 65.0, tid=7, corr=1)]
    rep = pr.stage_report(ev, 1)
    assert rep["clock_violations"] == 1 and rep["clock_lead_us"] == pytest.approx(45.0)
    idle = {stage: row["idle_ms"] for stage, row in rep["stages"].items()}
    assert idle == pytest.approx({"bin/read_k": 0.1, "bin/expand": 0.035, pr.OUTSIDE: 0.1})
    assert rep["stages"]["bin/expand"]["device_ms"] == pytest.approx(0.065)


def test_the_report_runs_on_a_written_trace(tmp_path, capsys):
    import json

    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": made_up_trace()}))
    assert pr.main([str(path)]) == 0  # one `project` span: one call
    out = capsys.readouterr().out
    assert out.startswith("1 calls;") and "counter instances: [42]" in out
