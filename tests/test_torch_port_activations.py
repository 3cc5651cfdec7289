"""Port parity of the activation registry: every name of
``sculptmate_tpu.ops.activations``'s registry through both packages'
``get_activation`` on the same seeded numpy input (CPU, f32), values and
gradients within 1e-6 relative (2e-6 absolute near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sculptmate_tpu.ops import activations as jact
from sculptmate_tpu_torch.ops import activations as tact

NAMES = sorted(jact._REGISTRY)
RTOL, ATOL = 1e-6, 2e-6


def _input(name):
    """(4, 3, 5, 6) N(0, 2) values, with a few past the trunc_exp gradient's
    clamp at +-15 and a few at both ends of lin2srgb's branch at 0.0031308;
    channels on axis 1 for ``normalize_channel_first``, on the last axis
    for ``normalize_channel_last``."""
    x = 2.0 * np.random.default_rng(sum(map(ord, name))).standard_normal((4, 3, 5, 6)).astype(np.float32)
    x.flat[:4] = [16.5, -17.0, 15.25, -15.5]
    x.flat[4:8] = [0.003, 0.0032, 0.5, 1.5]
    return x


def test_the_port_has_every_jax_name():
    assert set(tact._REGISTRY) == set(jact._REGISTRY)
    assert tact.get_activation(None) is not None
    with pytest.raises(ValueError, match="Unknown activation"):
        tact.get_activation("not_an_activation")


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_jax(name):
    x = _input(name)
    ref = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    got = tact.get_activation(name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_activation_gradient_matches_jax(name):
    """The gradient of sum(f(x) * w), w seeded: JAX's custom gradient for
    trunc_exp (the exponent clamped to [-15, 15]), autodiff for the rest.
    Inputs past the clamp keep the trunc_exp gradients apart from exp's."""
    x = _input(name)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    fj = jact.get_activation(name)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(fj(v) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tact.get_activation(name)(xt) * torch.from_numpy(w)).sum().backward()
    got = xt.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if name in ("trunc_exp", "shifted_trunc_exp"):
        shift = 1.0 if name.startswith("shifted") else 0.0
        big = np.abs(x - shift) > 15
        assert big.any() and np.allclose(got[big], w[big] * np.exp(np.clip(x[big] - shift, -15, 15)), rtol=RTOL)
