"""Static calibration: ``calibrate_static_scales`` of the port against the
JAX package's (the same keys, the amaxes within SCALE_RTOL at the first site
and CASCADE_RTOL after it) on the one-step transform (the tiny UNet with a (64, 256) VAE,
f32, the same weights and image), and the JAX package's scales installed in
the port reproducing its ``"int8_static"`` transform (the criteria of
``test_torch_port_quant_transform.py``: a code that flips where the two
packages' f32 activations straddle a rounding edge cascades).
"""
import pytest

from test_torch_port_quant_transform import check_quantized_mode
from torch_port_common import GATED_VAE_SITES, quant_transform_world
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

# The first site's amax is of activations that differ only by summation
# order. Record mode quantizes as it goes, so every later site's input
# carries the flip cascade of the sites before it (module docstring of
# test_torch_port_quant_transform.py): measured up to 7.6e-3 relative.
SCALE_RTOL = 1e-5
CASCADE_RTOL = 2e-2


@pytest.fixture(scope="module")
def world():
    return quant_transform_world(("none", "int8_static"), calibrate=True)


def test_calibrated_scales_match_jax(world):
    jscales, tscales = world["jscales"], world["tscales"]
    assert sorted(tscales) == sorted(jscales) and len(jscales) == GATED_VAE_SITES
    first = next(iter(tscales))  # the port's dict is in the order of the calls
    assert first == "encoder/down_1_resnet_0/conv2"
    assert abs(tscales[first] - jscales[first]) <= SCALE_RTOL * jscales[first]
    for k, v in jscales.items():
        assert isinstance(tscales[k], float)
        assert abs(tscales[k] - v) <= CASCADE_RTOL * abs(v), (k, tscales[k], v)


def test_jax_scales_reproduce_the_static_transform(world):
    check_quantized_mode(world, "int8_static")
