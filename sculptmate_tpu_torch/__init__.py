"""SculptMate in PyTorch and CUDA for NVIDIA Hopper: a port of the JAX
package ``sculptmate_tpu``, which stays the reference.

The package mirrors the JAX package's layout (``ops``, ``models``,
``frontend``, ``geometry``, ``systems``, ``parallel``, ``runtime``,
``pipelines``, ``io``, and the Blender add-on ``addon``), imports no JAX
and nothing of the JAX package, and runs its kernels (``csrc/*.cu``) on the
card. Importing it builds and starts nothing; ``addon.panel`` and
``addon.preferences`` import ``bpy``, so they import only inside Blender.
"""
