"""The segmentor's optimizers that ``torch.optim`` cannot run inside a
captured step (``core/graphs.py``): Adan, and SGD with Nesterov momentum at a
learning rate held on the device.

Adan, adaptive Nesterov momentum (Xie et al., arXiv:2208.06677), as a
``torch.optim.Optimizer`` (counterpart of ``ldiffusion_tpu/core/optim.py:33-90``;
reference ``nnUNetTrainerAdan.py:7-19`` trains with ``adan_pytorch.Adan``).

``BETAS`` follow adan_pytorch: the weights of the new sample in each EMA
(0.02, 0.08, 0.01; the paper's (0.98, 0.92, 0.99)), bias-corrected
by 1/(1 − (1 − b)^k); the weight decay is decoupled:

    diff_k = g_k − g_{k−1}            (0 on the first step)
    m_k = (1 − b1) m + b1 g_k
    v_k = (1 − b2) v + b2 diff_k
    n_k = (1 − b3) n + b3 (g_k + (1 − b2) diff_k)²
    u_k = (m̂_k + (1 − b2) v̂_k) / (sqrt(n̂_k) + eps)
    θ_{k+1} = (θ_k − lr u_k) / (1 + lr wd)

The trainer clips the gradients (``clip_grad_norm_``) before ``step``, as the
JAX chain puts ``clip_by_global_norm`` in front of ``adan``.

``SGDNesterov`` is ``torch.optim.SGD(momentum, nesterov=True, weight_decay)``
(optax's ``add_decayed_weights`` → ``sgd(nesterov=True)``): with the decay
coupled, d = g + wd θ, b ← μ b + d, θ ← θ − lr (d + μ b). torch's SGD reads a
tensor learning rate as a host number (``.item()``), which a capture cannot
hold.

Both run over each group's parameters with ``torch._foreach_*`` ops, and a
group's ``lr`` may be a 0-d device tensor (the trainer's captured step reads
it at every replay) as well as a float. Adan's step count and bias
corrections live on the device, and its first step's zero difference is
arithmetic (JAX's ``first = state.count == 0``). Every parameter of a group
steps every time; one without a gradient takes a zero gradient, as optax
updates every leaf of the tree.
"""
from __future__ import annotations

import torch

BETAS = (0.02, 0.08, 0.01)
EPS = 1e-8
ADAN_BUFFERS = ("m", "v", "n", "prev_grad")


def _grads(params) -> list:
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in params]


class Adan(torch.optim.Optimizer):
    """Per parameter: ``step`` (a 0-d float32 device tensor, the same count
    for every parameter of a group) and the buffers ``ADAN_BUFFERS``."""

    def __init__(self, params, lr, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adan takes no closure")
        b1, b2, b3 = BETAS
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = _grads(params)
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    for k in ADAN_BUFFERS:
                        st[k] = torch.zeros_like(p)
            m, v, n, prev = ([st[k] for st in states] for k in ADAN_BUFFERS)
            count = states[0]["step"]
            diff = torch._foreach_sub(grads, prev)
            torch._foreach_mul_(diff, count.clamp(max=1.0))  # 0 on the first step
            torch._foreach_add_([st["step"] for st in states], 1.0)
            torch._foreach_mul_(m, 1 - b1)
            torch._foreach_add_(m, grads, alpha=b1)
            torch._foreach_mul_(v, 1 - b2)
            torch._foreach_add_(v, diff, alpha=b2)
            sq = torch._foreach_add(grads, diff, alpha=1 - b2)
            torch._foreach_mul_(sq, sq)
            torch._foreach_mul_(n, 1 - b3)
            torch._foreach_add_(n, sq, alpha=b3)
            c1, c2, c3 = (1.0 - torch.pow(1.0 - b, count) for b in BETAS)
            u = torch._foreach_div(m, c1)
            vh = torch._foreach_mul(v, 1 - b2)
            torch._foreach_div_(vh, c2)
            torch._foreach_add_(u, vh)
            den = torch._foreach_div(n, c3)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(u, den)
            lr, wd = group["lr"], group["weight_decay"]
            torch._foreach_mul_(u, lr)
            torch._foreach_sub_(params, u)
            torch._foreach_div_(params, 1.0 + lr * wd)
            torch._foreach_copy_(prev, grads)


class SGDNesterov(torch.optim.Optimizer):
    """Per parameter: ``momentum_buffer`` (zeros before the first step, where
    torch's SGD starts it at d: μ·0 + d is d)."""

    def __init__(self, params, lr, momentum: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGDNesterov takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            bufs = []
            for p in params:
                st = self.state[p]
                if not st:
                    st["momentum_buffer"] = torch.zeros_like(p)
                bufs.append(st["momentum_buffer"])
            mu = group["momentum"]
            d = torch._foreach_add(_grads(params), params, alpha=group["weight_decay"])
            torch._foreach_mul_(bufs, mu)
            torch._foreach_add_(bufs, d)
            torch._foreach_add_(d, bufs, alpha=mu)
            torch._foreach_mul_(d, group["lr"])
            torch._foreach_sub_(params, d)
