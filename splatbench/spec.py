"""A cell of `BENCHMARK.json`, resolved to its files by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name that
`BENCHMARK.json` gives it, so a later change adds a cell, a mix or a metric
by adding files and entries:

- `configs/<config>.json` (the path in `configs[].file`): the scene;
- `traffic/<traffic>.json`: the mix, data whose `"entry"` names its
  driver, `entries/<entry>.py` (`drive(run)`; shared parts in `drive.py`);
- `layers/<metric>.py`: the reader of one per-layer metric (`read(ctx)`);
- `limits/<workload>.json`: the limit of each number the cell's check
  compares.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # and with --trace 1
    root: Path

    def reader(self, metric: str):
        """The module of `layers/<metric>.py`."""
        return _module(self.root / "splatbench" / "layers" / f"{metric}.py", "layer")

    def entry(self):
        """The module of `entries/<entry>.py`, the driver the mix names."""
        return _module(self.root / "splatbench" / "entries" / f"{self.traffic['entry']}.py",
                       "entry")


def _module(path: Path, kind: str):
    if not path.exists():
        raise SystemExit(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"splatbench_{kind}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lists(metric, cell, default):
    """Whether `cell` reports `metric`: the cells its `workloads` key lists,
    or by `default` without that key."""
    return cell in metric["workloads"] if "workloads" in metric else default


def load(workload: str, root: Path = HERE.parent, bench=None) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json (or of the dict `bench`)."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((root / "splatbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = root / "splatbench" / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _lists(m, workload, True)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _lists(m, workload, m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer, root)
