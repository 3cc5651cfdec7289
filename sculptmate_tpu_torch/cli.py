"""Command line: image in, mesh out, on the port.

Counterpart of ``sculptmate_tpu/cli.py``'s ``generate`` for the Lean
model:

    python -m sculptmate_tpu_torch.cli generate input.png -o out.glb [--device cpu]

The image is matted on the host (``frontend.remove`` with the u2net
session, on ``--device``), cropped and framed (``preprocess_image``), then
encoded and extracted by the TSR; the mesh is written as GLB or OBJ and one
JSON line reports its size and the timings. Weights come from
``$SCULPTMATE_CHECKPOINTS`` (``u2net.onnx``) where present, else they are
random from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from sculptmate_tpu_torch.systems.tsr import TSR


def _cmd_generate(args: argparse.Namespace) -> int:
    import numpy as np
    from PIL import Image, ImageOps

    from sculptmate_tpu_torch.frontend.matting import default_session
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_image
    from sculptmate_tpu_torch.io import write_glb, write_obj

    t0 = time.time()
    # EXIF re-orientation at decode (bg.py:128-138); remove() repeats it harmlessly
    img = ImageOps.exif_transpose(Image.open(args.image)).convert("RGBA")
    ratio = args.ratio if args.ratio is not None else 0.75  # the reference's Lean ratio
    if args.remove_bg:
        processed = preprocess_image(img, ratio=ratio, session=default_session(args.device))
        if processed is None:
            print("[sculptmate] foreground too small after matting", file=sys.stderr)
            return 1
    else:
        processed = img.convert("RGB")

    arr = np.asarray(processed, dtype=np.float32)[None, ..., :3] / 255.0
    tsr = TSR(seed=args.seed, device=args.device)
    codes = tsr.scene_codes(arr)
    t1 = time.time()
    verts, faces, colors = tsr.extract_mesh(
        codes, has_vertex_color=args.texture, resolution=args.resolution, threshold=args.threshold
    )[0]
    t2 = time.time()
    if len(verts) == 0:
        print("[sculptmate] empty mesh (no density above threshold)", file=sys.stderr)
        return 2

    out = args.output
    if out.endswith(".obj"):
        write_obj(out, verts, faces, vertex_colors=colors)
    else:
        write_glb(out, verts, faces, vertex_colors=colors)
    t3 = time.time()
    print(json.dumps({
        "output": out,
        "verts": int(len(verts)),
        "faces": int(len(faces)),
        "encode_s": round(t1 - t0, 3),
        "extract_s": round(t2 - t1, 3),
        "total_s": round(t3 - t0, 3),
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sculptmate_tpu_torch.cli", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="image -> 3D mesh (Lean model)")
    g.add_argument("image")
    g.add_argument("-o", "--output", default="mesh.glb", help=".glb or .obj")
    g.add_argument("--resolution", type=int, default=256, help="marching cubes resolution")
    g.add_argument("--threshold", type=float, default=25.0)
    g.add_argument("--ratio", type=float, default=None, help="foreground framing ratio (default 0.75)")
    g.add_argument("--texture", action="store_true", help="vertex colors")
    g.add_argument("--no-remove-bg", dest="remove_bg", action="store_false")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.set_defaults(func=_cmd_generate)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
