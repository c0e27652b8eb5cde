"""GroupNorm (+SiLU): the hand-written CUDA kernel and its plain version.

Counterpart of ``ldiffusion_tpu/ops/groupnorm.py``. Its three Pallas kernels
(``_gn_kernel`` :82, ``_gn_stats_kernel`` :147, ``_gn_apply_kernel`` :168)
become one two-pass CUDA kernel, ``csrc/groupnorm.cu``, used for every
GroupNorm on CUDA, small maps and large (its header says how and what bounds
it). ``plain_groupnorm_silu`` is ``_xla_groupnorm_silu`` in PyTorch: the CPU
path and the reference the kernel is held against on the card.

Under autograd, ``groupnorm_silu_trainable`` runs the kernel forward and
differentiates through ``plain_groupnorm_silu``, as the JAX package's
``_gn_bwd`` (:319-323) takes the XLA form's vjp.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ldiffusion_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# stats-pass CTAs per call (split over the batch) and the least rows each reads
_TARGET_CTAS = 1024
_MIN_ROWS = 16


def _stats_to_affine(s_c, ss_c, n_spatial: int, groups: int, c: int, scale, bias,
                     eps: float):
    """(B, C) channel sums / sums of squares → per-(B, C) (mul, add); the
    variance is the single-pass E[x²]−E[x]², clamped at 0."""
    b = s_c.shape[0]
    n = n_spatial * (c // groups)
    s_g = s_c.reshape(b, groups, c // groups).sum(dim=2)
    ss_g = ss_c.reshape(b, groups, c // groups).sum(dim=2)
    mean_g = s_g / n
    var_g = torch.clamp(ss_g / n - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // groups, dim=1)
    rstd_c = rstd_g.repeat_interleave(c // groups, dim=1)
    mul = rstd_c * scale[None, :].to(s_c.dtype)
    add = bias[None, :].to(s_c.dtype) - mean_c * mul
    return mul, add


def plain_groupnorm_silu(x, scale, bias, groups: int, eps: float, silu: bool):
    """x: (B, H, W, C). f32 math (f64 for f64 input), output in x's dtype."""
    b, h, w, c = x.shape
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    s_c = xf.sum(dim=(1, 2))
    ss_c = (xf * xf).sum(dim=(1, 2))
    mul, add = _stats_to_affine(s_c, ss_c, h * w, groups, c, scale, bias, eps)
    y = xf * mul[:, None, None, :] + add[:, None, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def stats_chunks(batch: int, hw: int):
    """(n_chunks, rows_per_chunk) of the stats pass: about ``_TARGET_CTAS``
    CTAs in all, each reading at least ``_MIN_ROWS`` spatial rows."""
    n = max(1, min(_TARGET_CTAS // batch, -(-hw // _MIN_ROWS)))
    rows = -(-hw // n)
    return -(-hw // rows), rows


@functools.cache
def _kernel_fn():
    fn = _build.library("groupnorm").ldt_groupnorm_silu
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def groupnorm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                   silu: bool = True):
    """x: (B, H, W, C); scale/bias: (C,). GroupNorm [+ SiLU]. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises (also
    where autograd would need the output's gradient)."""
    if x.device.type == "cpu":
        return plain_groupnorm_silu(x, scale, bias, groups, eps, silu)
    _build.refuse_grad("groupnorm_silu", x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"groupnorm_silu takes a float32/bfloat16 (B, H, W, C) tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"groupnorm_silu: {c} channels not divisible by {groups} groups")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu: x must be contiguous NHWC")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu: scale/bias must be ({c},)")
    n_chunks, rows = stats_chunks(b, h * w)
    y = torch.empty_like(x)
    partial = torch.empty((2, b, n_chunks, c), device=x.device, dtype=torch.float32)
    affine = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                           partial[0].data_ptr(), partial[1].data_ptr(),
                           affine[0].data_ptr(), affine[1].data_ptr(),
                           b, h * w, c, groups, n_chunks, rows, float(eps), int(silu),
                           _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "groupnorm_silu launch")
    groupnorm_silu.launches += 1
    return y


groupnorm_silu.launches = 0


class _GroupNormSiLU(torch.autograd.Function):
    """Kernel forward; backward by autograd through ``plain_groupnorm_silu``,
    recomputed from the saved input."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, silu)
        return groupnorm_silu(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        wanted = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            y = plain_groupnorm_silu(*inputs, *ctx.args)
        grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], dy))
        return (*(next(grads) if w else None for w in wanted), None, None, None)


def groupnorm_silu_trainable(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                             silu: bool = True):
    """``groupnorm_silu`` with a gradient for x, scale and bias."""
    return _GroupNormSiLU.apply(x, scale, bias, groups, eps, silu)
