"""Adan, adaptive Nesterov momentum (Xie et al., arXiv:2208.06677), as a
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
"""
from __future__ import annotations

import torch

BETAS = (0.02, 0.08, 0.01)
EPS = 1e-8


class Adan(torch.optim.Optimizer):
    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adan takes no closure")
        for group in self.param_groups:
            b1, b2, b3 = BETAS
            lr, eps, wd = group["lr"], EPS, group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("m", "v", "n", "prev_grad"):
                        st[k] = torch.zeros_like(p)
                diff = g - st["prev_grad"] if st["step"] else torch.zeros_like(g)
                st["step"] += 1
                k = st["step"]
                st["m"].mul_(1 - b1).add_(g, alpha=b1)
                st["v"].mul_(1 - b2).add_(diff, alpha=b2)
                st["n"].mul_(1 - b3).add_((g + (1 - b2) * diff) ** 2, alpha=b3)
                c1, c2, c3 = (1 - (1 - b1) ** k, 1 - (1 - b2) ** k, 1 - (1 - b3) ** k)
                u = (st["m"] / c1 + (1 - b2) * st["v"] / c2) / ((st["n"] / c3).sqrt() + eps)
                p.sub_(lr * u).div_(1.0 + lr * wd)
                st["prev_grad"].copy_(g)
