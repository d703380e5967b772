"""Finding a cell's files by name.

A cell `<config>.<mix>` of BENCHMARK.json is run from files found by
name alone, so that a later change adds a configuration, a traffic mix,
a cell's limits or a per-layer metric as new files and edits none:
- configs/<config>.json: the network, its weights' and calibration's
  seeds, the CKKS scheme and the ring it selects;
- traffic/<mix>.json: how images arrive;
- limits/<cell>.json: each number that decides `correct`, with its limit
  and the readings it was set from;
- metrics/<metric>.py: the reader of one per-layer metric, a function
  `read(run)` that returns the value or None when the run holds nothing
  for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list            # metric entries of BENCHMARK.json
    per_layer: list


def _json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise LookupError(f"no {what} file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def _named(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise LookupError(f"not a {what} name: {name!r}")
    return name


def config(name: str, base: str = HERE) -> dict:
    """configs/<name>.json under `base` (the tests keep a cut
    configuration of their own)."""
    return _json(os.path.join(base, "configs",
                              f"{_named(name, 'configuration')}.json"),
                 "configuration")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic",
                              f"{_named(name, 'traffic')}.json"), "traffic")


def limits(cell: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{_named(cell, 'cell')}.json"),
                 "limits")


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", f"{_named(metric, 'metric')}.py")
    if not os.path.isfile(path):
        raise LookupError(f"no reader {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        "fhebench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"), "benchmark")


def load(cell: str) -> Cell:
    """The cell named `cell` of BENCHMARK.json, with its files."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise LookupError(f"no workload {cell!r} in BENCHMARK.json")
    return Cell(cell, entry["chips"], config(entry["config"]),
                traffic(entry["traffic"]), limits(cell),
                bench["end_to_end"], bench["per_layer"])
