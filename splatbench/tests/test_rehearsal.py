"""No card, no numbers: the rehearsal on the CPU prints the result line
with the CPU named and no device metric; a measurement run without a card
exits non-zero and prints nothing; neither loads JAX or the JAX package.
Every cell rehearses, each under the faults it can have, and the check
then comes out not correct."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from splatbench import faults, spec  # noqa: E402
from splatbench.run import execute, judge, rehearsal  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|gsplat_tpu)(\s|\.|$)", re.M)


def run_py(*args):
    return subprocess.run([sys.executable, "splatbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_the_rehearsal_prints_the_result_line_and_no_device_metric():
    res = run_py("--workload", "tandt_render", "--seed", str(2**33 + 1), "--seconds", "0.3",
                 "--trace", "0", "--rehearse")
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu" and line["metrics"] == {}
    assert line["attempted"] > 0
    assert set(line["checks"]) == {"image_rel_rms", "image_max_abs"}
    assert res.stderr.strip().splitlines()[-1].startswith("check image_max_abs")


def test_a_measurement_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    res = run_py("--workload", "m360_train", "--seed", "3", "--seconds", "1", "--trace", "0")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_no_module_of_jax_or_the_jax_package_is_imported():
    for path in (ROOT / "splatbench").rglob("*.py"):
        if "tests" not in path.parts:
            assert not FORBIDDEN.search(path.read_text()), path
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', 'm360_train', '--seed', '5',"
            " '--seconds', '0.2', '--rehearse'];\n"
            "try:\n    runpy.run_path('splatbench/run.py', run_name='__main__')\n"
            "except SystemExit as e:\n    assert not e.code, e.code\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "gsplat_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "gsplat_tpu"}


def rehearse(cell_name, seed):
    """The cell at the rehearsal's sizes on the CPU, with float32 packets: on
    a few thousand pixels the hybrid packets' rounding reads above the
    limits set at the cell's own size, so only the exact packets show that
    the fault, and nothing else, fails the check."""
    cell = rehearsal(spec.load(cell_name))
    return execute(cell, seed, 0.3, False, "cpu", {"packet_dtype": "float32"})


@pytest.mark.parametrize("cell_name", CELLS)
def test_each_cell_rehearses_within_its_limits(cell_name):
    _, ok = judge(rehearse(cell_name, 2**32 + 17))
    assert ok


@pytest.mark.parametrize("cell_name,fault", [
    (c, f) for c in CELLS
    for f in (faults.TRAIN if spec.load(c).traffic["entry"] == "train_step" else faults.RENDER)])
def test_each_fault_the_cell_can_have_is_not_correct(cell_name, fault):
    with faults.PLANT[fault]():
        checks, ok = judge(rehearse(cell_name, 2**32 + 17))
    assert not ok, checks


def test_a_train_mix_states_its_targets_depth_term_and_exposure():
    """The mix's data, not the driver, sets the alpha mask, the inverse depth
    target and its mask, the depth weight and the exposure; the reference
    follows each, the exposure as a leaf of its own."""
    cell = rehearsal(spec.load("tandt_train"))
    cell.traffic.update(use_exposure=True, depth_weight=0.1, targets={
        "alpha_mask": [0.5, 1.0], "inverse_depth": [0.1, 0.5], "depth_mask": [0.0, 1.0]})
    run = execute(cell, 2**32 + 17, 0.3, False, "cpu", {"packet_dtype": "float32"})
    checks, ok = judge(run)
    assert ok, checks
    assert run.detail["ref_change"]["exposure"] > 0 and "exposure" in run.detail["grad_norms"]
    plain = execute(rehearsal(spec.load("tandt_train")), 2**32 + 17, 0.3, False, "cpu",
                    {"packet_dtype": "float32"})
    assert run.detail["ref_losses"][0] != plain.detail["ref_losses"][0]
