"""Run one cell of the benchmark of ``sculptmate_tpu_torch`` once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The run finds the cell's files by the names in
BENCHMARK.json (``harness/cell.py``), makes the weights and inputs from the
seed, builds the program, warms up the cell's own shapes (set-up; the
seconds the plain reference spends there on the iso-level are left out of
``setup_s``), then drives the program's entry for ``--seconds`` (the
window, under the profiler with ``--trace 1``). Once the window has closed
it reads the memory peak, frees the program, and holds a seeded sample of
what the window produced against the plain reference (``correct``). The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``,
then ``checks``: each number compared, with its limit. The same numbers
are the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 1 and prints no result; likewise if JAX or the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start_perf() -> float:
    """This process's start on the ``perf_counter`` clock (from /proc; the
    module's first line where that is not there)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start_perf()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
# build and kernel caches at fixed paths inside the checkout, set before
# anything imports torch
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(BENCH_DIR, "_cache", _sub)
os.environ["USE_FLAX"] = "0"
# one process with few host threads, the same in every run
HOST_THREADS = 4
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)
# the port's persisted buffer capacities (runtime/capacity_cache.py): a
# fixed directory of the checkout, emptied at the start of every run, so
# that a run's capacity retries follow from its own seed and not from the
# last asset of the run before it
CAPACITY_DIR = os.path.join(BENCH_DIR, "_cache", "capacity")
sys.path.insert(0, BENCH_DIR)
if REPO_DIR not in sys.path:
    sys.path.insert(1, REPO_DIR)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "sculptmate_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Context:
    """What a driver gets: the cell, the seed, the device, and a place to
    keep the program, the weights and what the window produced."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.system, self.traffic = cell.config, cell.system, cell.traffic
        self.reference_s = 0.0  # the plain reference's seconds inside set-up

    def log(self, msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(workload: str, seed: int, seconds: float, trace: bool, require_cuda: bool = True,
        benchmark_path=None, device=None) -> dict:
    """One run of a cell -> the result line as a dict (raises on a fault).
    ``require_cuda=False`` and ``device`` let the tests drive it on the CPU."""
    import torch

    from harness.cell import load_cell

    cell = load_cell(workload, benchmark_path)
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise SystemExit(f"bench_port: {workload} needs {cell.chips} CUDA card(s), found {n}")
        device = torch.device("cuda", 0)
    device = torch.device(device or "cpu")
    ctx = Context(cell, seed, device)
    cell.driver.setup(ctx)
    setup_s = time.perf_counter() - PROCESS_START - ctx.reference_s
    ctx.log(f"setup {setup_s:.3f} s (the reference's {ctx.reference_s:.3f} s left out)")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=activities)
        prof.start()
    stats = cell.driver.window(ctx, seconds)
    if prof is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stats.update(setup_s=setup_s, memory_peak_bytes=peak)
    ctx.program = None  # the program's state is freed before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                     "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                     "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if trace:
        from harness.trace import from_profiler

        t = from_profiler(prof, stats)
        del prof
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(t, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = t.breakdown()
    else:
        for m in cell.end_to_end:
            value = cell.readers[m["name"]].read(stats, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    verts = sorted(stats.get("verts") or [0])
    ctx.log(f"window: {stats['attempted']} attempted, {stats['failed']} failed, vertices per mesh "
            f"{verts[0]} / {verts[len(verts) // 2]} / {verts[-1]} (least / median / most)")
    readings = cell.driver.check(ctx)
    ctx.log("readings " + json.dumps(readings))
    checks = {name: {"value": readings.get(name, float("nan")), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = bool(readings.get("_sampled", 0)) and all(
        _finite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise SystemExit(f"bench_port: modules of JAX or the JAX package are loaded: {found}")
    out = {"correct": correct, "attempted": stats["attempted"], "failed": stats["failed"], "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import shutil

    import torch

    shutil.rmtree(CAPACITY_DIR, ignore_errors=True)
    os.environ["SCULPTMATE_CAP_CACHE"] = CAPACITY_DIR
    torch.set_num_threads(HOST_THREADS)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
