"""`BENCHMARK.json` against the form its readers expect, and the harness finding a
new configuration, mix and metric by name with no edit to a file that is
there already."""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from splatbench import spec  # noqa: E402
from splatbench.run import execute, judge  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_only_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad, bad
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("end_to_end", "per_layer", "configs", "workloads"):
        entries = [e["name"] for e in BENCH[group]]
        assert len(entries) == len(set(entries)), group


def test_text_fields_fit_on_one_line():
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_layer_metrics_moves_is_reported_by_every_cell_it_lists(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert m["moves"] in {e["name"] for e in spec.load(cell).end_to_end}, cell
    assert (ROOT / "splatbench" / "layers" / f"{metric}.py").exists()


def test_files_of_every_cell_exist_and_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert cell.chips == 1, w["name"]


def _tree(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    """Copy the benchmark, add files and entries only, and load the new cell."""
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(tmp_path / "splatbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sb = tmp_path / "splatbench"
    config = json.loads((sb / "configs" / "tandt.json").read_text())
    config["name"] = "deep_blending"
    (sb / "configs" / "deep_blending.json").write_text(json.dumps(config))
    mix = json.loads((sb / "traffic" / "render_1080p.json").read_text())
    mix.update(width=4096, height=2160)
    (sb / "traffic" / "render_4k.json").write_text(json.dumps(mix))
    (sb / "layers" / "frame_pixels.render.py").write_text(
        "def read(ctx):\n    return ctx['counts']['pixels'] / ctx['calls']\n")
    (sb / "limits" / "db_render_4k.json").write_text(json.dumps({"image_rel_rms": 1.0}))
    bench["configs"].append({"name": "deep_blending", "source": "https://example.org/paper",
                             "file": "splatbench/configs/deep_blending.json", "reduced": [],
                             "why": "a new scene"})
    bench["workloads"].append({"name": "db_render_4k", "config": "deep_blending",
                               "traffic": "render_4k", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:  # the render cells' end-to-end metrics
        if "render_fps" == m["name"] or "frame_p95_ms" == m["name"]:
            m["workloads"].append("db_render_4k")
    bench["per_layer"].append({"name": "frame_pixels.render", "unit": "px", "better": "higher",
                               "source": "program_counter", "layer": "render frame",
                               "moves": "render_fps", "workloads": ["db_render_4k"]})
    cell = spec.load("db_render_4k", root=tmp_path, bench=bench)
    assert cell.config["name"] == "deep_blending"
    assert cell.traffic["width"] == 4096 and cell.limits == {"image_rel_rms": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["frame_pixels.render"]
    assert cell.entry().__file__ == str(sb / "entries" / "render.py")
    reader = cell.reader("frame_pixels.render")
    assert reader.read({"counts": {"pixels": 10}, "calls": 2}) == 5
    assert {m["name"] for m in cell.end_to_end} >= {"render_fps", "setup_s"}
    assert all(_tree(sb)[k] == v for k, v in before.items())


def test_a_mix_that_drives_the_program_anew_brings_its_own_driver(tmp_path):
    """A mix whose `entry` names a new driver file runs through the harness
    with no edit to any file that is there: the driver is found by name."""
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(tmp_path / "splatbench")
    sb = tmp_path / "splatbench"
    (sb / "entries" / "densify_cadence.py").write_text(
        "def drive(run):\n"
        "    run.setup_done()\n"
        "    run.attempted = run.mix['steps']\n"
        "    run.e2e['train_step_ms'] = 1.0\n"
        "    run.readings = {'count_gap': 0}\n")
    (sb / "traffic" / "train_densify.json").write_text(
        json.dumps({"entry": "densify_cadence", "steps": 7}))
    (sb / "limits" / "tandt_densify.json").write_text(json.dumps({"count_gap": 0}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tandt_densify", "config": "tandt",
                               "traffic": "train_densify", "chips": 1, "why": "a new mix"})
    cell = spec.load("tandt_densify", root=tmp_path, bench=bench)
    run = execute(cell, 2**33 + 5, 0.1, False, "cpu")
    assert run.attempted == 7 and run.e2e["train_step_ms"] == 1.0
    assert judge(run)[1]
    assert all(_tree(sb)[k] == v for k, v in before.items())
