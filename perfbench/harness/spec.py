"""Find a cell's configuration, traffic, limits and metrics by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configuration and traffic, and the metrics with the cells that report
them.  Everything else is a file of its own under ``perfbench/``:

  configs/<config>.json      the deployment: grid, values, precision,
                             preconditioner, generator
  traffic/<traffic>.json     the mix: right-hand sides, iterations a set
  limits/<cell>.json         each compared number's limit and readings
  metrics/<metric>.py        one reader, ``read(run) -> float | None``
  generators/<family>.py     one module per matrix family, ``build``

A later cell, mix or metric is new files plus entries in BENCHMARK.json.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(*parts) -> Dict:
    with open(os.path.join(PERFBENCH, *parts)) as f:
        return json.load(f)


def load_benchmark(path: str = BENCHMARK) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` with every file it names loaded; KeyError for a
    cell BENCHMARK.json does not list."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json("configs", w["config"] + ".json"),
        traffic=_json("traffic", w["traffic"] + ".json"),
        limits=_json("limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def _module(kind: str, name: str):
    path = os.path.join(PERFBENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} module {path}")
    mod_name = "perfbench_" + kind + "_" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def generator(family: str):
    """The module of ``generators/<family>.py`` (its ``build(config)``)."""
    return _module("generators", family)
