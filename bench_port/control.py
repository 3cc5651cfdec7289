"""Readings of the control of a cell: the plain reference put in the
program's place one precision step below the configuration's (float8
e4m3 for the bfloat16 encoder and decoder, bfloat16 for the u2net), judged
by the same numbers as the program's runs, on as many photos as a run
samples. The benchmark's runs never run it.

    python3 bench_port/control.py --workload <name> --seeds 11,12,13 [--photos N]

Prints one JSON line per seed with each number, then the smallest reading
of each number over the seeds (the upper reading a limit is set below).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(1, os.path.dirname(BENCH_DIR))


def readings(workload: str, seed: int, photos: int, device: str = "cuda", benchmark_path=None) -> dict:
    import torch

    from harness.cell import load_cell
    from run import Context

    cell = load_cell(workload, benchmark_path)
    ctx = Context(cell, seed, torch.device(device))
    cell.driver.prepare(ctx)
    out = cell.driver.control(ctx, list(range(photos)))
    del ctx
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--photos", type=int, default=4)
    args = p.parse_args(argv)
    rows = []
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.photos)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": int(s), **r}), flush=True)
    print(json.dumps({"workload": args.workload, "least": {k: min(r[k] for r in rows) for k in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
