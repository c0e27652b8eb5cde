"""Random-number helpers (counterpart of ``ldiffusion_tpu/core/prng.py``;
reference ``ldiffusion.py:235-236``, ``segmentor.py:344``): Laplace noise
from an explicit ``torch.Generator``, and a fresh generator derived from a
seed and (epoch, step, ...) indices, the stand-in for ``jax.random.fold_in``.
A torch generator cannot reproduce a JAX key's stream; both packages draw
Laplace(0, scale) by the same inverse CDF."""
from __future__ import annotations

import torch

from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise

_MIX = 0x9E3779B97F4A7C15  # the 64-bit golden-ratio constant (splitmix64)
_MASK = (1 << 64) - 1


def laplace(generator: torch.Generator, shape, scale, dtype=torch.float32, device=None):
    """Laplace(0, ``scale``) noise of ``shape`` (``torch.distributions.Laplace(0,
    scale).sample(shape)``); ``scale`` is a number or a tensor broadcastable
    to ``shape`` (per-timestep sqrt(1 - alpha_bar_t))."""
    noise = laplace_noise(shape, generator, device=device, dtype=dtype)
    return noise * torch.as_tensor(scale, dtype=dtype, device=noise.device)


def _splitmix(x: int) -> int:
    x = (x + _MIX) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def fold_in_step(seed: int, *indices: int, device=None) -> torch.Generator:
    """A generator seeded from ``seed`` and each index in turn (a splitmix64
    mix, so nearby (epoch, step) pairs give unrelated streams), without
    touching any other generator's state."""
    s = int(seed) & _MASK
    for i in indices:
        s = _splitmix(s ^ (int(i) & _MASK))
    return torch.Generator(device=device or "cpu").manual_seed(s)
