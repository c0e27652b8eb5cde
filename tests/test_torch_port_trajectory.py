"""The stage-1 forward pass, ``trajectory_features``, of the port against the
JAX package's, on the CPU at the tiny configs in f32, from the same weights
and the JAX package's own Laplace noise (drawn from its keys along its own
``split`` sequence): 1e-4 absolute (decodes in [-1, 1]; only the order of
sums differs, through the UNet and the VAE decoder)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldiffusion_tpu.diffusion import pipeline as jpipe
from ldiffusion_tpu_torch.diffusion import pipeline as tpipe
from torch_port_common import jax_laplace_noise, jax_random_components
from torch_port_common import stage1_data as _data
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

TRAJ_TOL = 1e-4


@pytest.fixture(scope="module")
def jc():
    return jax_random_components()


def test_trajectory_features_match_jax_with_its_noise(jc):
    images, _ = _data()
    key = jax.random.key(1)
    traj, rgb = jax.jit(lambda p, x: jpipe.trajectory_features(jc, p, x, key, 5, remat=False))(
        jc.params, jnp.asarray(images))
    noise = jax_laplace_noise(key, 6, (2, 32, 32, 4))  # PLMS: 5 steps visit 6 timesteps
    comps = tpipe.SDComponents.from_flax(jc.params, device="cpu")
    with torch.no_grad():
        ptraj, prgb = tpipe.trajectory_features(comps, torch.from_numpy(images),
                                                torch.from_numpy(noise), 5)
    assert ptraj.shape == (2, 64, 64, 6) and prgb.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ptraj.numpy(), np.asarray(traj), atol=TRAJ_TOL)
    np.testing.assert_allclose(prgb.numpy(), np.asarray(rgb), atol=TRAJ_TOL)
