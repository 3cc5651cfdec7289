"""The smoke's multi-device phase alone, over every visible card.

    python3 scripts/multi_device_check.py

Builds the kernels, the full-width Lean and SF3D models (seed 0, the SF3D
modulations randomised) and their scenes as ``chip_smoke.py`` does, then
runs ``chip_smoke.multi_device_path`` on a mesh of four shards over the
visible cards (``chip_smoke.mesh_devices``: one card four times, or one
card each where there are four): the 512^3 sharded extraction against the
whole lattice, and the Lean and SF3D farms over (dp 2, tp 2). Prints the
card line, the phase's lines and the launches; exits non-zero when a check
fails. Needs a CUDA card.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("multi_device_check: no CUDA device available", file=sys.stderr)
        return 1
    cs.phase_environment()
    from sculptmate_tpu_torch.frontend.matting import U2NetMatting
    from sculptmate_tpu_torch.ops.density_grid import query_density_grid
    from sculptmate_tpu_torch.pipelines.generate import Fast3DGenerator, TripoGenerator

    gen, fast = TripoGenerator(), Fast3DGenerator()
    if gen.initiate_model(device="cuda") != 0 or fast.initiate_model(device="cuda") != 0:
        raise RuntimeError("initiate_model failed")
    with torch.no_grad():
        cs.randomize_modulations(fast.model, torch.Generator(device="cuda").manual_seed(0))
    scene, lean = cs.sf3d_scene(fast), cs.lean_scene(gen.model)
    tsr = gen.model
    # the serving path's threshold: the 99th percentile of a 64^3 grid
    codes = tsr.scene_codes(np.random.default_rng(0).random((1, 512, 512, 3)).astype(np.float32))
    d64 = query_density_grid(codes[0], tsr.decoder_weights(), tsr.grid_spec(64, tsr.extract_dtype))
    threshold = float(torch.quantile(d64.flatten().float(), 0.99))
    multi = cs.multi_device_path(tsr, fast.model, lean, scene, U2NetMatting(seed=0), threshold)
    print(json.dumps({"multi_device_check": [str(d) for d in cs.mesh_devices()],
                      "launches": {k: v for k, v in multi.items() if k != "extraction_sec"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
