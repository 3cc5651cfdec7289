"""Device marching cubes and tets, their host decoders, and the host mesh
helpers (decimation, remeshing, UV unwrap).

Exports ``MCResult`` and ``marching_cubes_host`` as the JAX package's
``geometry`` does. Its third export, the function ``marching_cubes``, stays
in its module: under the package that name is the submodule
``geometry.marching_cubes``, which the port's code imports as such.
"""

from sculptmate_tpu_torch.geometry.marching_cubes import MCResult, marching_cubes_host  # noqa: F401
