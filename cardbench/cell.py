"""A cell, found by name: its entry in `BENCHMARK.json`, its configuration
(`configs/<name>.json`) and its traffic mix (`traffic/<name>.json`), and the
per-layer metric readers (`metrics/<name>.py`) that it reports."""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

__all__ = ["Cell", "load_cell", "ROOT", "HERE"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]    # this cell's end-to-end metrics
    per_layer: list[dict]     # this cell's per-layer metrics

    def reader(self, metric: str):
        """The `read(record)` function of a per-layer metric."""
        return importlib.import_module(f"cardbench.metrics.{metric}").read


def load_cell(workload: str, *, bench: dict | None = None) -> Cell:
    """The cell named `workload` in BENCHMARK.json (or in `bench`)."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"cardbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    # every cell reports every end-to-end metric; a per-layer metric
    # without `workloads` is reported in every cell
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=list(bench["end_to_end"]),
                per_layer=per_layer)
