"""Everything a run reads by name: the cell in ``BENCHMARK.json``, its
configuration, traffic, limits, entry and metric readers."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from types import ModuleType

from rxbench import frame

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: frame.Config
    traffic: dict
    limits: dict  # number compared -> its limit
    entry: ModuleType
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _metrics(entries: list[dict], cell: str) -> list[Metric]:
    out = []
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append(Metric(m["name"], m["unit"], importlib.import_module(f"rxbench.metrics.{m['name']}")))
    return out


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_cell(workload: str, traffic_override: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, everything loaded.
    ``traffic_override`` replaces keys of the traffic file (the tests run
    cells at a size the CPU holds)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    traffic = load_traffic(w["traffic"])
    traffic.update(traffic_override or {})
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]
    return Cell(
        name=workload, chips=int(w["chips"]), config=frame.load_config(w["config"]),
        traffic=traffic, limits=limits,
        entry=importlib.import_module(f"rxbench.entries.{traffic['entry']}"),
        end_to_end=_metrics(bench["end_to_end"], workload),
        per_layer=_metrics(bench["per_layer"], workload),
    )
