"""Finds everything of a cell by name, from ``BENCHMARK.json`` and files.

A cell names a configuration (``configs/<file>`` as the manifest gives it)
and a traffic mix (``traffic/<name>.json``).  Each metric is a reader in
``metrics/<name>.py`` with ``read(run) -> float | None``.  Adding a cell,
a configuration, a mix or a metric adds files and manifest entries; no
code here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = "h100bench"


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]  # the manifest's entries this cell reports
    per_layer: List[Dict]
    root: Path

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end


def load_manifest(root: Path) -> Dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: run from the root of a checkout")
    return json.loads(path.read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    # without a workloads key a per-layer metric goes with its end-to-end one
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, root)


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, run, trace: bool) -> Dict[str, Dict]:
    """``{name: {"value", "unit"}}`` of every metric the cell reports that
    found something to read."""
    out: Dict[str, Dict] = {}
    for m in cell.metrics(trace):
        value: Optional[float] = reader(cell.root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
