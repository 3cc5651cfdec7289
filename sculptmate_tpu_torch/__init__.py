"""SculptMate in PyTorch and CUDA for NVIDIA Hopper: a port of the JAX
package ``sculptmate_tpu``, which stays the reference.

The package mirrors the JAX package's layout (``ops``, ``models``,
``geometry``, ``systems``, ``runtime``, ``pipelines``, ``io``), imports no JAX
and nothing of the JAX package, and runs its kernels (``csrc/*.cu``) on the
card. Importing it builds and starts nothing.
"""
