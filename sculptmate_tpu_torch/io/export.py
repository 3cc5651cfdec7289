"""Mesh export: OBJ and GLB writers.

The reference hands meshes straight to Blender via ``bpy``
(``tsr/system.py:127-169``, ``sf3d/system.py:530-598``); outside Blender this
framework writes standard OBJ (positions, optional vertex colors as xyzrgb
extension, optional UVs) and a minimal valid glTF-binary with positions,
normals, UVs, vertex colors, and an optional baked PBR texture set.
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Dict, Optional

import numpy as np


def write_obj(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
) -> None:
    """verts (V,3) float, faces (F,3) int (0-based), colors (V,3) in [0,1]."""
    with open(path, "w") as f:
        f.write("# sculptmate_tpu_torch export\n")
        if vertex_colors is not None:
            for v, c in zip(verts, vertex_colors):
                f.write(
                    f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n"
                )
        else:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if uvs is not None:
            for t in uvs:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
            for tri in faces:
                a, b, c = tri + 1
                f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
        else:
            for tri in faces:
                a, b, c = tri + 1
                f.write(f"f {a} {b} {c}\n")


def read_obj(path: str):
    """Minimal OBJ reader (positions + triangle faces; polygons are fan-
    triangulated). Counterpart of ``mesh_simplify.py:519-606``'s loader."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((4 - len(b) % 4) % 4)


def write_glb(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    normals: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
    vertex_colors: Optional[np.ndarray] = None,
    textures: Optional[Dict[str, bytes]] = None,
) -> None:
    """Minimal glTF 2.0 binary writer.

    ``textures``: optional dict with PNG byte blobs keyed by
    'baseColor' / 'normal' / 'metallicRoughness'.
    """
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.uint32)

    buffers = []
    buffer_views = []
    accessors = []
    offset = 0

    def add_view(data: bytes, target: Optional[int]) -> int:
        nonlocal offset
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        buffers.append(_pad4(data))
        offset += len(_pad4(data))
        return len(buffer_views) - 1

    def add_accessor(view: int, comp_type: int, count: int, type_: str, minmax=None) -> int:
        acc = {
            "bufferView": view,
            "componentType": comp_type,
            "count": count,
            "type": type_,
        }
        if minmax is not None:
            acc["min"], acc["max"] = minmax
        accessors.append(acc)
        return len(accessors) - 1

    FLOAT, UINT = 5126, 5125
    ARRAY_BUF, ELEM_BUF = 34962, 34963

    if len(verts) == 0:
        raise ValueError("cannot export an empty mesh to GLB")
    pos_view = add_view(verts.tobytes(), ARRAY_BUF)
    pos_acc = add_accessor(
        pos_view,
        FLOAT,
        len(verts),
        "VEC3",
        (verts.min(0).tolist(), verts.max(0).tolist()),
    )
    idx_view = add_view(faces.tobytes(), ELEM_BUF)
    idx_acc = add_accessor(idx_view, UINT, faces.size, "SCALAR")

    attributes = {"POSITION": pos_acc}
    if normals is not None:
        nrm = np.ascontiguousarray(normals, dtype=np.float32)
        attributes["NORMAL"] = add_accessor(
            add_view(nrm.tobytes(), ARRAY_BUF), FLOAT, len(nrm), "VEC3"
        )
    if uvs is not None:
        uv = np.ascontiguousarray(uvs, dtype=np.float32)
        attributes["TEXCOORD_0"] = add_accessor(
            add_view(uv.tobytes(), ARRAY_BUF), FLOAT, len(uv), "VEC2"
        )
    if vertex_colors is not None:
        col = np.ascontiguousarray(vertex_colors, dtype=np.float32)
        if col.shape[1] == 3:
            col = np.concatenate([col, np.ones((len(col), 1), np.float32)], axis=1)
        attributes["COLOR_0"] = add_accessor(
            add_view(col.tobytes(), ARRAY_BUF), FLOAT, len(col), "VEC4"
        )

    images = []
    gltf_textures = []
    samplers = [{"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}]
    material: Dict = {"pbrMetallicRoughness": {}, "name": "material"}
    if textures:
        def add_texture(png: bytes) -> int:
            view = add_view(png, None)
            images.append({"bufferView": view, "mimeType": "image/png"})
            gltf_textures.append({"sampler": 0, "source": len(images) - 1})
            return len(gltf_textures) - 1

        if "baseColor" in textures:
            material["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": add_texture(textures["baseColor"])
            }
        if "metallicRoughness" in textures:
            material["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
                "index": add_texture(textures["metallicRoughness"])
            }
        if "normal" in textures:
            material["normalTexture"] = {"index": add_texture(textures["normal"])}

    primitive = {"attributes": attributes, "indices": idx_acc, "mode": 4}
    if textures:
        primitive["material"] = 0

    gltf = {
        "asset": {"version": "2.0", "generator": "sculptmate_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "mesh"}],
        "meshes": [{"primitives": [primitive]}],
        "bufferViews": buffer_views,
        "accessors": accessors,
        "buffers": [{"byteLength": offset}],
    }
    if textures:
        gltf["materials"] = [material]
        gltf["images"] = images
        gltf["textures"] = gltf_textures
        gltf["samplers"] = samplers

    bin_chunk = b"".join(buffers)
    json_chunk = _pad4(json.dumps(gltf).encode(), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
