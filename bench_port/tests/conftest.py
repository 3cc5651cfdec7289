"""CPU tests of the benchmark harness: ``python -m pytest bench_port/tests -q``
from the repository's root. They put ``bench_port/`` and the repository
on the path, keep the port's capacity cache in a temporary directory, and
build tiny cells from files in a copy of the benchmark (``tiny/``)."""

import json
import os
import shutil
import sys
import tempfile

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
TINY_DIR = os.path.join(BENCH_DIR, "tests", "tiny")
for p in (REPO_DIR, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("SCULPTMATE_CAP_CACHE", tempfile.mkdtemp(prefix="bench_capcache_"))


def add_tiny_cells(root: str) -> str:
    """Copy BENCHMARK.json and bench_port/ to ``root`` and add the tiny
    cells there from files alone: a configuration file and its module,
    two traffic files, two cells' limits and BENCHMARK.json entries.
    Returns the copy's BENCHMARK.json path."""
    b = os.path.join(root, "bench_port")
    shutil.copytree(BENCH_DIR, b, ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(TINY_DIR, "cells.json")) as f:
        tiny = json.load(f)
    shutil.copy(os.path.join(TINY_DIR, "tiny-lean.json"), os.path.join(b, "configs", "tiny-lean.json"))
    shutil.copy(os.path.join(b, "configs", "triposr-lean.py"), os.path.join(b, "configs", "tiny-lean.py"))
    for name in ("tiny-photo", "tiny-farm-rgba2"):
        shutil.copy(os.path.join(TINY_DIR, f"{name}.json"), os.path.join(b, "traffic", f"{name}.json"))
    for cell, limits in tiny["limits"].items():
        with open(os.path.join(b, "cells", f"{cell}.json"), "w") as f:
            json.dump({"limits": limits}, f)
    bench["configs"].append(tiny["config"])
    bench["workloads"] += tiny["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell, like in tiny["like"].items():
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return add_tiny_cells(str(tmp_path_factory.mktemp("bench")))
