"""Serial against pipelined Lean loop of the PyTorch port, on one card.

    python3 scripts/torch_pipelined_loop.py [--root DIR] [--assets 6]

Imports ``sculptmate_tpu_torch`` from ``--root`` (default: this checkout;
point it at an unpacked older commit to compare two versions in one call),
builds the default ``TSR`` (seed 0) on the card and, on one random 512^2
cond image at 256^3 with vertex colors, times:

- serial: ``scene_codes`` -> ``extract_mesh`` on the tree's default path
  on the card, one asset after another (median seconds per asset);
- pipelined: ``scene_codes`` + ``extract_mesh_async`` with three assets in
  flight, the oldest waited on (``extract_mesh_wait``) after each dispatch,
  as ``bench.py:bench_lean`` drives the JAX package (seconds per asset over
  the steady loop);
- packed: ``scene_codes`` -> ``extract_mesh(mode="packed")``, one asset
  after another (median seconds per asset).

The threshold is the 99th percentile of the image's 64^3 grid. Prints the
card line and one JSON line. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--assets", type=int, default=6)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from sculptmate_tpu_torch.ops.density_grid import query_density_grid
    from sculptmate_tpu_torch.systems.tsr import TSR

    if not torch.cuda.is_available():
        print("torch_pipelined_loop: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    tsr = TSR(device="cuda")
    image = np.random.default_rng(0).random((1, 512, 512, 3)).astype(np.float32)
    codes = tsr.scene_codes(image)
    d64 = query_density_grid(codes[0], tsr.decoder_weights(), tsr.grid_spec(64, tsr.extract_dtype))
    threshold = float(torch.quantile(d64.flatten().float(), 0.99))
    kw = dict(has_vertex_color=True, resolution=256, threshold=threshold)

    verts = len(tsr.extract_mesh(tsr.scene_codes(image), **kw)[0][0])  # warm-up, learns the capacity
    serial = []
    for _ in range(args.assets):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsr.extract_mesh(tsr.scene_codes(image), **kw)
        serial.append(time.perf_counter() - t0)

    def dispatch():
        return tsr.extract_mesh_async(tsr.scene_codes(image)[0], **kw)

    inflight = [dispatch(), dispatch()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.assets):
        inflight.append(dispatch())
        tsr.extract_mesh_wait(inflight.pop(0))
    pipelined = (time.perf_counter() - t0) / args.assets
    for h in inflight:
        tsr.extract_mesh_wait(h)
    tsr.extract_mesh(tsr.scene_codes(image), mode="packed", **kw)  # warm-up, learns the capacities
    packed = []
    for _ in range(args.assets):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsr.extract_mesh(tsr.scene_codes(image), mode="packed", **kw)
        packed.append(time.perf_counter() - t0)
    print(card)
    print(json.dumps({"root": args.root, "verts": verts, "serial_sec_per_asset": float(np.median(serial)),
                      "serial_runs": [round(t, 4) for t in serial], "pipelined_sec_per_asset": pipelined,
                      "packed_sec_per_asset": float(np.median(packed)), "packed_runs": [round(t, 4) for t in packed]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
