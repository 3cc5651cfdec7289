"""Find everything that belongs to one cell by the names in BENCHMARK.json.

For a workload ``W`` with configuration ``C`` and traffic ``T``:

- ``BENCHMARK.json``'s entry for ``C`` names its file (``configs/C.json``);
  the module beside it (``configs/C.py``) makes the weights, builds the
  program from them and gives the plain reference;
- ``traffic/T.json``: the traffic's parameters, among them the driver
  (``drivers/<driver>.py``: the loop that drives the program's entry and
  judges what it produced);
- ``cells/W.json``: the limits of the numbers the cell's ``correct``
  compares;
- ``metrics/<metric>.py``: one reader per metric: an end-to-end one reads
  what the driver recorded in the window, a per-layer one the trace.

A new cell, configuration, traffic mix or metric is new files and new
entries in BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def load_module(path: str, name: Optional[str] = None):
    """Import the Python file at ``path`` (its name may hold dots or
    dashes) as a fresh module."""
    name = name or "bench_plugin_" + "".join(ch if ch.isalnum() else "_" for ch in os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    name: str
    chips: int
    config: Dict[str, Any]  # the configuration file
    system: Any  # the configuration's module
    traffic: Dict[str, Any]
    driver: Any
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]  # this cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]  # this cell's per-layer metrics
    readers: Dict[str, Any]  # metric name -> reader module, end-to-end and per-layer


def _reports(metric: Dict[str, Any], workload: str, end_to_end_names) -> bool:
    """Whether a cell reports ``metric``: its ``workloads`` list names the
    cell; without one, every cell that reports the end-to-end metric it
    moves (an end-to-end metric without a list is in every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end_names


def load_cell(workload: str, benchmark_path: Optional[str] = None) -> Cell:
    """The cell ``workload`` of the BENCHMARK.json at ``benchmark_path``
    (default: this checkout's), its files under ``bench_port/`` beside it."""
    root = os.path.dirname(os.path.abspath(benchmark_path)) if benchmark_path else REPO_DIR
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "bench_port")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg_path = os.path.join(root, cfg_entry["file"])
    traffic = _read_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=_read_json(cfg_path),
        system=load_module(os.path.splitext(cfg_path)[0] + ".py"),
        traffic=traffic,
        driver=load_module(os.path.join(bench_dir, "drivers", f"{traffic['driver']}.py")),
        limits=_read_json(os.path.join(bench_dir, "cells", f"{workload}.json"))["limits"],
        end_to_end=e2e,
        per_layer=per_layer,
        readers={m["name"]: load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"))
                 for m in e2e + per_layer},
    )
