"""Command line: image in, mesh out, on the port.

Counterpart of ``sculptmate_tpu/cli.py``'s ``generate``, ``decimate``,
``render`` and ``convert``:

    python -m sculptmate_tpu_torch.cli generate input.png -o out.glb [--model lean|fast] [--device cpu]
    python -m sculptmate_tpu_torch.cli decimate in.obj out.obj --ratio 0.5
    python -m sculptmate_tpu_torch.cli render input.png -o view_{}.png [--n-views 8] [--size 256] [--device cpu]
    python -m sculptmate_tpu_torch.cli convert model.safetensors sf3d.pt

``generate`` mattes the image on the host (``frontend.remove`` with the u2net
session, on ``--device``) and crops and frames it (``preprocess_image``:
ratio 0.75 and RGB for the Lean model, 0.85 and RGBA for SF3D, as the
reference's panel does); then TSR encodes and extracts it (Lean), or SF3D's
``run_image`` makes a mesh with normals and UVs, baked with its albedo,
normal and metallic-roughness textures under ``--texture`` (fast). The mesh
is written as GLB (with the textures) or OBJ and one JSON line reports its
size and the timings; ``--simplify-faces N`` decimates the Lean mesh to
about N faces (dropping its colors), ``--bake-resolution`` sizes SF3D's
maps. ``render`` writes spherical novel views of the Lean model's scene as
PNGs (``io/png.py``). ``convert`` turns a reference checkpoint (``.ckpt``,
``.safetensors`` or ``.onnx``) into the port's state dict (``torch.save``;
the JAX package writes orbax trees instead). Weights come from ``$SCULPTMATE_CHECKPOINTS`` (``u2net.onnx``)
where present, else they are random from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from sculptmate_tpu_torch.systems.sf3d import SF3D
from sculptmate_tpu_torch.systems.tsr import TSR


def _cmd_generate(args: argparse.Namespace) -> int:
    import numpy as np
    from PIL import Image, ImageOps

    from sculptmate_tpu_torch.frontend.matting import default_session
    from sculptmate_tpu_torch.frontend.preprocess import preprocess_image
    from sculptmate_tpu_torch.io import write_glb, write_obj

    fast = args.model == "fast"
    t0 = time.time()
    # EXIF re-orientation at decode (bg.py:128-138); remove() repeats it harmlessly
    img = ImageOps.exif_transpose(Image.open(args.image)).convert("RGBA")
    # the reference's ratios: 0.75 lean, 0.85 and alpha for fast (GUIPanel.py:158-160)
    ratio = args.ratio if args.ratio is not None else (0.85 if fast else 0.75)
    if args.remove_bg:
        processed = preprocess_image(img, ratio=ratio, use_alpha=fast, session=default_session(args.device))
        if processed is None:
            print("[sculptmate] foreground too small after matting", file=sys.stderr)
            return 1
    else:
        processed = img.convert("RGBA" if fast else "RGB")
    arr = np.asarray(processed, dtype=np.float32)[None] / 255.0

    extra = {}
    if fast:
        sf3d = SF3D(seed=args.seed, device=args.device)
        t1 = time.time()
        mesh = sf3d.run_image(
            arr,
            bake_resolution=args.bake_resolution,
            vertex_simplification_factor=args.vertex_simplification,
            enable_texture=args.texture,
            threshold=args.threshold,
        )
        t2 = time.time()
        if mesh is None:
            print("[sculptmate] empty mesh (no density above threshold)", file=sys.stderr)
            return 2
        verts, faces, colors = mesh["verts"], mesh["faces"], None
        extra = {"normals": mesh["normals"], "uvs": mesh["uvs"]}
        if mesh["texture_pngs"] is not None:
            extra["textures"] = mesh["texture_pngs"]
    else:
        tsr = TSR(seed=args.seed, device=args.device)
        codes = tsr.scene_codes(arr[..., :3])
        t1 = time.time()
        verts, faces, colors = tsr.extract_mesh(
            codes, has_vertex_color=args.texture, resolution=args.resolution,
            threshold=25.0 if args.threshold is None else args.threshold,
        )[0]
        if args.simplify_faces and len(faces) > args.simplify_faces:
            from sculptmate_tpu_torch.geometry.decimate import decimate

            verts, faces = decimate(verts, faces, target_ratio=args.simplify_faces / len(faces))
            colors = None  # the vertices changed: their colors would need a new query
        t2 = time.time()
        if len(verts) == 0:
            print("[sculptmate] empty mesh (no density above threshold)", file=sys.stderr)
            return 2

    out = args.output
    if out.endswith(".obj"):
        write_obj(out, verts, faces, vertex_colors=colors, uvs=extra.get("uvs"))
    else:
        write_glb(out, verts, faces, vertex_colors=colors, **extra)
    t3 = time.time()
    print(json.dumps({
        "output": out,
        "model": args.model,
        "verts": int(len(verts)),
        "faces": int(len(faces)),
        "encode_s": round(t1 - t0, 3),
        "extract_s": round(t2 - t1, 3),
        "total_s": round(t3 - t0, 3),
    }))
    return 0


def _cmd_decimate(args: argparse.Namespace) -> int:
    """Quadric decimation of an OBJ (the reference's ``mesh_simplify.py``
    offline tool)."""
    from sculptmate_tpu_torch.geometry.decimate import decimate
    from sculptmate_tpu_torch.io import read_obj, write_obj

    t0 = time.time()
    verts, faces = read_obj(args.input)
    v2, f2 = decimate(verts, faces, target_ratio=args.ratio, aggressiveness=args.aggressiveness)
    write_obj(args.output, v2, f2)
    print(json.dumps({
        "input_faces": int(len(faces)),
        "output_faces": int(len(f2)),
        "removed_pct": round(100 * (1 - len(f2) / max(len(faces), 1)), 1),
        "seconds": round(time.time() - t0, 2),
    }))
    return 0


def _cmd_render(args: argparse.Namespace) -> int:
    """Spherical novel views of the Lean model's scene (the reference's
    volume-render path, ``nerf_renderer.py:93-172``), one PNG per view."""
    import numpy as np
    from PIL import Image, ImageOps

    from sculptmate_tpu_torch.io.png import write_png

    img = ImageOps.exif_transpose(Image.open(args.image)).convert("RGB")
    arr = np.asarray(img, dtype=np.float32)[None] / 255.0
    tsr = TSR(seed=args.seed, device=args.device)
    codes = tsr.scene_codes(arr)
    views = tsr.render_views(codes, n_views=args.n_views, height=args.size, width=args.size)[0]
    for i, view in enumerate(views):
        write_png(args.output.replace("{}", str(i)), (np.clip(view, 0, 1) * 255).astype(np.uint8))
    print(json.dumps({"views": len(views), "pattern": args.output}))
    return 0


def _cmd_convert(args: argparse.Namespace) -> int:
    """A reference checkpoint (TripoSR ``model.ckpt``, SF3D
    ``model.safetensors`` or ``u2net.onnx``) -> the port's state dict,
    written with ``torch.save``."""
    import torch

    from sculptmate_tpu_torch.runtime import checkpoint as ck

    src = args.input
    if src.endswith(".ckpt"):
        sd = torch.load(src, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    elif src.endswith(".safetensors"):
        sd = ck.load_sf3d_state_dict(src)
    elif src.endswith(".onnx"):
        sd = ck.u2net_state_dict_from_onnx(src)
    else:
        print(f"[sculptmate] unknown checkpoint format: {src}", file=sys.stderr)
        return 1
    torch.save(sd, args.output)
    print(json.dumps({"input": src, "output": args.output}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sculptmate_tpu_torch.cli", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="image -> 3D mesh")
    g.add_argument("image")
    g.add_argument("-o", "--output", default="mesh.glb", help=".glb or .obj")
    g.add_argument("--model", choices=["lean", "fast"], default="lean")
    g.add_argument("--resolution", type=int, default=256, help="marching cubes resolution (lean)")
    g.add_argument("--threshold", type=float, default=None,
                   help="iso-level (default 25 lean, the config's 10 fast)")
    g.add_argument("--ratio", type=float, default=None, help="foreground framing ratio (default 0.75 lean / 0.85 fast)")
    g.add_argument("--texture", action="store_true",
                   help="vertex colors (lean); baked albedo, normal and metallic-roughness textures (fast)")
    g.add_argument("--bake-resolution", type=int, default=512, help="texture size of the baked maps (fast)")
    g.add_argument("--simplify-faces", type=int, default=0, help="decimate the lean mesh to ~N faces (e.g. 20000)")
    g.add_argument("--vertex-simplification", default="high", choices=["high", "medium", "low"])
    g.add_argument("--no-remove-bg", dest="remove_bg", action="store_false")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.set_defaults(func=_cmd_generate)

    r = sub.add_parser("render", help="render spherical novel views (lean model)")
    r.add_argument("image")
    r.add_argument("-o", "--output", default="view_{}.png", help="pattern with {}")
    r.add_argument("--n-views", type=int, default=8)
    r.add_argument("--size", type=int, default=256)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    r.set_defaults(func=_cmd_render)

    d = sub.add_parser("decimate", help="quadric mesh decimation (OBJ in/out)")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--ratio", type=float, default=0.5, help="target face ratio")
    d.add_argument("--aggressiveness", type=float, default=7.0)
    d.set_defaults(func=_cmd_decimate)

    c = sub.add_parser("convert", help="reference checkpoint -> the port's state dict (torch.save)")
    c.add_argument("input", help="model.ckpt | model.safetensors | u2net.onnx")
    c.add_argument("output", help="output file, read back with torch.load")
    c.set_defaults(func=_cmd_convert)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
