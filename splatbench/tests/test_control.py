"""The control, on the card at each cell's own size: the program with its
next precision down (all-bfloat16 packets in place of the configuration's
hybrid ones) has to come out not correct on three seeds, and the half
batch fault on the train cells too. Skips without a card.

    python -m pytest splatbench/tests/test_control.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from splatbench import drive, faults, spec  # noqa: E402
from splatbench.run import execute, judge  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    yield
    drive.free()


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(card, cell_name):
    cell = spec.load(cell_name)
    for seed in SEEDS:
        run = execute(cell, seed, 1.0, False, "cuda", {"packet_dtype": "bfloat16"})
        checks, ok = judge(run)
        assert not ok, (seed, checks)
        del run
        drive.free()


@pytest.mark.parametrize("cell_name", [c for c in CELLS
                                       if spec.load(c).traffic["entry"] == "train_step"])
def test_half_the_batch_is_not_correct(card, cell_name):
    cell = spec.load(cell_name)
    for seed in SEEDS:
        with faults.half_batch():
            run = execute(cell, seed, 0.5, False, "cuda")
        checks, ok = judge(run)
        assert not ok, (seed, checks)
        del run
        drive.free()
