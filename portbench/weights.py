"""Seeded weights and seeds, made by the benchmark for the program and for
the reference alike.

Every tensor of rank ≥ 2 of a module is drawn N(0, 1/fan_in) (flax's
lecun-normal scale, which keeps SD-v1.5's activations in range at its full
depth), every other weight is 1 and every bias 0. The draws are one
``torch.randn`` per module on the device from a ``torch.Generator`` seeded
from ``--seed``; the names and shapes come from the reference's modules,
which carry the published state-dict names the program's modules load.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

# one seed of each kind a run draws from: the weights, the inputs, the
# trainer's generator, fold k of the segmentor (FOLD + k)
WEIGHTS, INPUTS, TRAINER, FOLD = 1, 2, 3, 16


def sub_seed(seed: int, kind: int) -> int:
    """A 63-bit seed for one kind of draw, from the run's ``--seed`` (any
    whole number ≥ 0)."""
    return int(np.random.SeedSequence([int(seed), kind]).generate_state(1, np.uint64)[0] >> 1)


def seeded_state(module: nn.Module, generator: torch.Generator, device,
                 dtype=torch.float32) -> dict:
    """A state dict for ``module`` (which may live on the meta device): one
    normal draw for all its tensors of rank ≥ 2, scaled per tensor by
    1/sqrt(fan_in); rank-1 weights 1, biases 0; in ``dtype``."""
    params = list(module.named_parameters())
    total = sum(p.numel() for _, p in params if p.dim() >= 2)
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    state, off = {}, 0
    for name, p in params:
        if name.endswith("bias"):
            state[name] = torch.zeros(p.shape, device=device, dtype=dtype)
        elif p.dim() == 1:
            state[name] = torch.ones(p.shape, device=device, dtype=dtype)
        else:
            w = flat[off:off + p.numel()].view(p.shape)
            state[name] = w.mul_(1.0 / math.sqrt(p[0].numel())).to(dtype)
            off += p.numel()
    return state
