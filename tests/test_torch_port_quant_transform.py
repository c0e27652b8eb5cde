"""The one-step transform under each int8 mode, the port's against the JAX
package's: the tiny UNet with a (64, 256) VAE (whose 256-channel convs pass
the shape gate; "int8_all" also quantizes every other QConv and QDense), the
same weights and image, f32 on both sides.

Why the bound is loose, and what holds the port to JAX instead: the two
packages' f32 activations differ by ~1e-6 (summation order). Where one sits
at a rounding edge of x / scale, one code flips — one quantization step at
that element — and every quantizer after it sees inputs that differ by up to
a step, so more codes flip from there: a cascade. It is a property of the
quantized program, not of the port: a 1e-7 perturbation of the input moves
the port's own int8 output by 0.027 (max abs) and 0.0047 (mean), as much as
the port differs from JAX (0.034, 0.0048) and about as much as the mode moves
the output (0.054, 0.0062). So a max-abs bound cannot also be smaller than
the mode's effect. The test holds instead:

* max |port − JAX| < TRANSFORM_TOL (a bound of the cascade; [0, 1] images);
* the change each mode makes to the output (mode − none) in the port
  correlates with the JAX package's above MIN_EFFECT_CORR (measured
  0.71-0.75): wrong gating, scales or layouts change other elements by other
  amounts and decorrelate it;
* each mode moves the output by far more than the unquantized bound.
"""
import numpy as np
import pytest

from torch_port_common import quant_transform_world
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

NONE_TOL = 1e-3        # test_torch_port_pipeline's bound of the f32 transform
TRANSFORM_TOL = 0.1    # measured 0.034 (int8), 0.038 (int8_all)
MIN_EFFECT_CORR = 0.5
MODES = ("none", "int8", "int8_all")


@pytest.fixture(scope="module")
def world():
    return quant_transform_world(MODES)


def check_quantized_mode(world, mode):
    """The three properties of the module docstring for ``mode``."""
    (ref, got), (jnone, tnone) = world["out"][mode], world["out"]["none"]
    assert got.shape == ref.shape == (1, 64, 64, 3) and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err < TRANSFORM_TOL, err
    jeff, teff = (ref - jnone).ravel(), (got - tnone).ravel()
    corr = float(np.corrcoef(jeff, teff)[0, 1])
    assert corr > MIN_EFFECT_CORR, corr
    assert min(np.abs(jeff).max(), np.abs(teff).max()) > 10 * NONE_TOL


def test_unquantized_transform_matches_jax(world):
    ref, got = world["out"]["none"]
    assert float(np.abs(got - ref).max()) < NONE_TOL


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_quantized_transform_matches_jax(world, mode):
    check_quantized_mode(world, mode)
