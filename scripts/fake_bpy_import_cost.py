"""Host cost of the add-on's scene import under the fake bpy.

    python3 scripts/fake_bpy_import_cost.py [--verts 60000] [--faces 120000]

Times ``sculptmate_tpu_torch.addon.blender_io.import_mesh`` with
``tests/fake_bpy.py`` installed as bpy, once with vertex colors (the Lean
path's import) and once with UVs and two 512^2 images (the Pro path's),
on a random mesh of the given size, and prints one JSON line with the
seconds and microseconds per face. The import sets colors and UVs one
loop at a time, as the JAX package's does; this is its host cost.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--verts", type=int, default=60000)
    ap.add_argument("--faces", type=int, default=120000)
    args = ap.parse_args(argv)
    import fake_bpy

    fake_bpy.install()
    from sculptmate_tpu_torch.addon import blender_io

    rng = np.random.default_rng(0)
    verts = rng.random((args.verts, 3)).astype(np.float32)
    faces = rng.integers(0, args.verts, (args.faces, 3))
    colors = rng.random((args.verts, 3)).astype(np.float32)
    t0 = time.perf_counter()
    blender_io.import_mesh(verts, faces, vertex_colors=colors, name="lean")
    lean = time.perf_counter() - t0
    uvs = rng.random((args.verts, 2)).astype(np.float32)
    tex = {k: rng.random((512, 512, 3)).astype(np.float32) for k in ("albedo", "bump")}
    t0 = time.perf_counter()
    blender_io.import_mesh(verts, faces, uvs=uvs, textures=tex, roughness=0.5, metallic=0.0, name="pro")
    pro = time.perf_counter() - t0
    print(json.dumps({"verts": args.verts, "faces": args.faces, "lean_colors_sec": lean,
                      "lean_us_per_face": 1e6 * lean / args.faces, "pro_uvs_images_sec": pro,
                      "pro_us_per_face": 1e6 * pro / args.faces}))


if __name__ == "__main__":
    main()
