"""Blender scene import: mesh + materials.

A copy of ``sculptmate_tpu/addon/blender_io.py``. It replaces
``tsr/system.py:127-169`` (vertex-color mesh + Principled BSDF) and
``sf3d/system.py:530-598`` (UV layer + baked PBR textures). ``import_mesh``
runs only inside Blender (it imports ``bpy``). Vertex colors and UVs are
set one loop at a time, as the JAX package sets them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def import_mesh(
    verts,
    faces,
    vertex_colors: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
    textures: Optional[Dict[str, np.ndarray]] = None,
    roughness: Optional[float] = None,
    metallic: Optional[float] = None,
    name: str = "GeneratedMesh",
):
    import bpy

    mesh_data = bpy.data.meshes.new(name=name)
    mesh_data.from_pydata([tuple(v) for v in verts], [], [tuple(f) for f in faces])
    obj = bpy.data.objects.new(name=name, object_data=mesh_data)
    bpy.context.collection.objects.link(obj)

    mat = bpy.data.materials.new(name=f"{name}_Material")
    mat.use_nodes = True
    mesh_data.materials.append(mat)
    nodes = mat.node_tree.nodes
    links = mat.node_tree.links
    nodes.clear()
    output_node = nodes.new(type="ShaderNodeOutputMaterial")
    bsdf = nodes.new(type="ShaderNodeBsdfPrincipled")
    links.new(bsdf.outputs["BSDF"], output_node.inputs["Surface"])

    if vertex_colors is not None:
        vc = np.asarray(vertex_colors)
        if vc.shape[1] == 3:
            vc = np.concatenate([vc, np.ones((len(vc), 1))], axis=1)
        layer_name = f"{name}_VC"
        mesh_data.vertex_colors.new(name=layer_name)
        layer = mesh_data.vertex_colors[layer_name]
        for poly in mesh_data.polygons:
            for li in poly.loop_indices:
                layer.data[li].color = vc[mesh_data.loops[li].vertex_index]
        vc_node = nodes.new(type="ShaderNodeVertexColor")
        vc_node.layer_name = layer_name
        links.new(vc_node.outputs["Color"], bsdf.inputs["Base Color"])
        bsdf.inputs["Roughness"].default_value = 1.0
        bsdf.inputs["IOR"].default_value = 1.0

    if uvs is not None:
        mesh_data.uv_layers.new(name="UVMap")
        uv_layer = mesh_data.uv_layers.active.data
        uvs = np.asarray(uvs)
        for i, loop in enumerate(mesh_data.loops):
            uv_layer[i].uv = tuple(uvs[loop.vertex_index])

    if textures:
        def add_image_node(key, label, non_color=False):
            arr = textures.get(key)
            if arr is None:
                return None
            arr = np.asarray(arr)
            h, w = arr.shape[:2]
            img = bpy.data.images.new(label, width=w, height=h)
            rgba = np.ones((h, w, 4), np.float32)
            rgba[..., : arr.shape[-1]] = arr
            img.pixels = np.flip(rgba, axis=0).ravel().tolist()
            node = nodes.new("ShaderNodeTexImage")
            node.image = img
            if non_color:
                img.colorspace_settings.name = "Non-Color"
            return node

        base = add_image_node("albedo", "BaseColor")
        if base is not None:
            links.new(base.outputs["Color"], bsdf.inputs["Base Color"])
        bump = add_image_node("bump", "Bump", non_color=True)
        if bump is not None:
            nm = nodes.new("ShaderNodeNormalMap")
            links.new(bump.outputs["Color"], nm.inputs["Color"])
            links.new(nm.outputs["Normal"], bsdf.inputs["Normal"])

    if roughness is not None:
        bsdf.inputs["Roughness"].default_value = float(roughness)
    if metallic is not None:
        bsdf.inputs["Metallic"].default_value = float(metallic)
    return obj
