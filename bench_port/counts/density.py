"""The density lattice: an MLP over the R^3 lattice points of a triplane
(``chip_smoke.py:check_density``, kernel K2's yardstick).

- operations: R^3 (L 2 W^2 + 2 W), the L hidden W x W layers and the one
  density channel of the output layer at every point (the factorised first
  layer's three R^2 products are left out: a lower bound);
- bytes: the three R^2 x W first-layer partials in bfloat16 read once, the
  L hidden layers' weights once, the R^3 float32 densities written once.
"""

from counts import bound_s


def flops(R: int, layers: int = 8, width: int = 64) -> float:
    return float(R ** 3 * (layers * 2 * width * width + 2 * width))


def nbytes(R: int, layers: int = 8, width: int = 64) -> float:
    return float(3 * R * R * width * 2 + layers * width * width * 2 + R ** 3 * 4)


def lattice_bound_s(config: dict, R: int) -> float:
    d = config["decoder"]
    layers, width = d["n_hidden_layers"] - 1, d["n_neurons"]
    return bound_s(flops(R, layers, width), nbytes(R, layers, width))
