"""The port's stage-1 trainer lowers its loss over steps on a fixed batch, on
the CPU at the tiny configs in f32, from the JAX components' weights (the
port's counterpart of the slow-marked JAX ``test_warmup_loss_decreases``)."""
import numpy as np
import pytest
import torch

from torch_port_common import jax_random_components, stage1_vgg_params
from torch_port_common import port_stage1_trainer as _port_trainer
from torch_port_common import stage1_data as _data
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jc():
    return jax_random_components()


@pytest.fixture(scope="module")
def jax_vgg_params():
    return stage1_vgg_params()


def test_loss_decreases_over_fixed_key_steps(jc, jax_vgg_params):
    """The port's counterpart of the slow-marked JAX test_warmup_loss_decreases
    (tests/test_convergence.py:81-117): 12 steps on one batch with one fixed
    draw of noise and indices, lr 1e-3."""
    trainer = _port_trainer(jc, jax_vgg_params, num_inference_steps=5, batch_size=2,
                            learning_rate=1e-3)
    images, labels = (torch.from_numpy(a) for a in _data(seed=1))
    labels = labels.long()
    noise, indices = trainer.draw(images, labels)
    losses = []
    for _ in range(12):
        loss, _ = trainer.loss_and_grads(images, labels, noise, indices)
        trainer.apply_update()
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
