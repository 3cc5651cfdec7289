"""Mesh export: OBJ and GLB writers."""

from sculptmate_tpu_torch.io.export import read_obj, write_glb, write_obj  # noqa: F401
