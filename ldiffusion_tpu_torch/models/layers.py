"""Building blocks of the SD v1.5 VAE and UNet (counterpart of
``ldiffusion_tpu/models/layers.py``).

Modules take NCHW tensors (channels_last in memory on the card, where cuDNN
prefers it) and carry diffusers' state-dict names, so ``models/convert.py``
maps them to and from the JAX package's flax trees. Quirks of the reference
kept on purpose: GroupNorm eps 1e-6 in Transformer2D / VAEAttention, LayerNorm
eps 1e-5, exact-erf GEGLU, ``[cos | sin]`` timestep embedding, the VAE
downsample's asymmetric (0, 1) padding.

GroupNorm and long self-attention go through ``ops/`` (the CUDA kernels on
the card, the plain versions on the CPU); everything else is plain PyTorch.
``QConv`` / ``QDense`` are ``nn.Conv2d`` / ``nn.Linear`` (same state-dict
names) with the int8 W8A8 forward of ``ops/quant.py`` under its modes; they
sit where the JAX package has its QConv / QDense.
Where autograd needs a gradient (training), they go through the ops'
``autograd.Function``s; under ``no_grad``/``inference_mode`` the inference
path runs the kernels directly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ldiffusion_tpu_torch.ops._build import needs_grad
from ldiffusion_tpu_torch.ops.attention import dot_product_attention
from ldiffusion_tpu_torch.ops.groupnorm import groupnorm_silu, groupnorm_silu_trainable
from ldiffusion_tpu_torch.ops.quant import (
    GATED_MODES,
    _sym_quant,
    conv_shape_gate,
    int8_conv,
    int8_matmul,
    quant_mode,
)
from ldiffusion_tpu_torch.ops.resize import upsample_nearest_2x


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation in place, drawn on the parameters' device: every
    weight of rank ≥ 2 (conv, linear, embedding) N(0, 1/fan_in) — flax's
    lecun-normal scale — norm weights 1 and biases 0."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            w = torch.randn(p.shape, generator=generator, device=p.device)
            p.copy_(w / math.sqrt(p[0].numel()))
    return module


def _weight_stamp(w) -> tuple:
    """What changes when a weight does: its storage (a cast, a move or a new
    ``.data`` makes another), its in-place version counter (an optimizer
    step, ``copy_``, ``load_state_dict``), its dtype and device."""
    return (w.untyped_storage()._cdata, w.storage_offset(), w._version, w.dtype, w.device)


class Int8Weight:
    """The int8 codes and f32 scales of a ``QConv`` / ``QDense`` weight,
    quantized from the f32 weight, and the f32 bias: the JAX QConv / QDense
    keep f32 params, quantize the kernel and add the bias in f32
    (``ldiffusion_tpu/ops/quant.py:int8_conv``), whatever dtype they compute
    in. ``quantize_weight`` takes them while the weight is f32
    (``cast_keeping_int8_weights`` calls it before a cast down, and keeps
    them in host memory, so a model that never runs an int8 mode holds no
    codes on the card); ``int8_weight`` hands them to the int8 forward, on
    the weight's device from its first call on. A weight that changed
    since it was quantized is quantized again when it is f32; when it is not,
    the int8 forward raises: it never quantizes a bf16 copy in place of the
    f32 weight. They are plain attributes, outside ``state_dict``."""

    _quant_dims: tuple = ()
    _wq = None      # ((int8 codes, f32 scales), f32 bias or None), from the f32 params
    _wstamp = None  # _weight_stamp of the weight the codes stand for

    def quantize_weight(self) -> None:
        w = self.weight
        if w.dtype != torch.float32:
            raise RuntimeError(f"{type(self).__name__}: the weight is {w.dtype}; the int8 codes "
                               "are taken from the f32 weight, as the JAX package does")
        with torch.no_grad():
            bias = None if self.bias is None else self.bias.detach().float().clone()
            self._wq = (_sym_quant(w.detach(), dims=self._quant_dims), bias)
        self._wstamp = _weight_stamp(w)

    def _move_int8_weight(self, dev) -> None:
        (codes, scales), bias = self._wq
        self._wq = ((codes.to(dev), scales.to(dev)), None if bias is None else bias.to(dev))

    def restamp_int8_weight(self) -> None:
        """After a cast or a move of a quantized weight: the codes stand for
        the new tensor, and wait in host memory for the first int8 forward."""
        if self._wq is not None:
            self._move_int8_weight("cpu")
            self._wstamp = _weight_stamp(self.weight)

    def int8_weight(self):
        """((codes, scales), f32 bias or None) of the f32 weight, on the
        weight's device."""
        if self._wq is None or self._wstamp != _weight_stamp(self.weight):
            if self.weight.dtype != torch.float32:
                raise RuntimeError(
                    f"{type(self).__name__}: its {self.weight.dtype} weight was not quantized "
                    "from f32 weights, or changed since: quantize the module from its f32 "
                    "weights (models.layers.cast_keeping_int8_weights) before casting it down")
            self.quantize_weight()
        if self._wq[0][0].device != self.weight.device:
            self._move_int8_weight(self.weight.device)
        return self._wq


class QConv(Int8Weight, nn.Conv2d):
    """``nn.Conv2d`` with the int8 forward of ``ops/quant.py``: under
    ``"int8"``, ``"int8_record"`` and ``"int8_static"`` when (Cin, Cout)
    passes ``conv_shape_gate``, under ``"int8_all"`` always; otherwise
    ``nn.Conv2d``'s forward. ``site``: the call site's key for static
    calibration, the JAX module's flax path (``name_quant_sites``). The
    weight's codes and scales are the f32 weight's (``Int8Weight``), also
    when the module computes in bf16, so they equal the JAX QConv's."""

    site: Optional[str] = None
    _quant_dims = (1, 2, 3)

    def forward(self, x):
        mode = quant_mode()
        if mode == "int8_all" or (mode in GATED_MODES and
                                  conv_shape_gate(self.in_channels, self.out_channels)):
            site = None
            if mode in ("int8_record", "int8_static"):
                if self.site is None:
                    raise RuntimeError("QConv: no site key for static calibration; build the "
                                       "model through a class that names its sites")
                site = self.site
            ph, pw = self.padding
            wq, bias = self.int8_weight()
            return int8_conv(x, self.weight, self.stride, ((ph, ph), (pw, pw)), bias,
                             out_dtype=self.weight.dtype, site=site, weight_q=wq)
        return super().forward(x)


class QDense(Int8Weight, nn.Linear):
    """``nn.Linear`` with the int8 forward of ``ops/quant.py`` under
    ``"int8_all"`` only (the JAX package measured its matmuls at ~1.0× under
    int8 and quantizes them only in that ablation mode); the weight's codes
    are the f32 weight's, as ``QConv``'s."""

    _quant_dims = (1,)

    def forward(self, x):
        if quant_mode() == "int8_all":
            wq, bias = self.int8_weight()
            return int8_matmul(x, self.weight, bias, out_dtype=self.weight.dtype, weight_q=wq)
        return super().forward(x)


def cast_keeping_int8_weights(module: nn.Module, device=None, dtype=None,
                              memory_format=None) -> nn.Module:
    """``module.to(device, dtype, memory_format)`` that first quantizes every
    f32 ``QConv`` / ``QDense`` weight it casts to another dtype, so an int8
    forward after the cast uses the f32 weight's codes and scales (what the
    JAX package's f32 params give); returns the module."""
    qs = [m for m in module.modules() if isinstance(m, Int8Weight)]
    if dtype is not None and dtype != torch.float32:
        for m in qs:
            if m.weight.dtype == torch.float32:
                m.quantize_weight()
    if memory_format is None:
        module.to(device=device, dtype=dtype)
    else:
        module.to(device=device, dtype=dtype, memory_format=memory_format)
    for m in qs:
        m.restamp_int8_weight()
    return module


def name_quant_sites(model: nn.Module, rows) -> nn.Module:
    """Give each ``QConv`` of ``model`` its site key: the flax path that
    ``models/convert.py``'s ``rows`` pair with its torch name, which is the
    JAX QConv's ``scope.path`` — so scales calibrated by either package
    apply in the other."""
    modules = dict(model.named_modules())
    for torch_prefix, flax_path, _ in rows:
        m = modules.get(torch_prefix)
        if isinstance(m, QConv):
            m.site = flax_path
    return model


def to_nhwc(x):
    """NCHW → NHWC (free for a channels_last tensor)."""
    return x.permute(0, 2, 3, 1)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


class FusedGroupNormSiLU(nn.Module):
    """GroupNorm [→ SiLU] through ``ops.groupnorm.groupnorm_silu``; parameters
    are ``weight``/``bias`` as in ``nn.GroupNorm``."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        op = groupnorm_silu_trainable if needs_grad(x, self.weight, self.bias) else groupnorm_silu
        y = op(to_nhwc(x).contiguous(), self.weight, self.bias, self.groups, self.eps, self.silu)
        return to_nchw(y)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, diffusers flip_sin_to_cos=True, shift 0:
    ``[cos | sin]``, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimeEmbedding(nn.Module):
    """Linear → SiLU → Linear (SD: 320 → 1280 → 1280)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(nn.Module):
    """GN→SiLU→Conv3x3 [+time] →GN→SiLU→Conv3x3 with a 1x1 skip when the
    channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-5,
                 groups: int = 32, temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = FusedGroupNormSiLU(in_channels, groups, eps)
        self.conv1 = QConv(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = FusedGroupNormSiLU(out_channels, groups, eps)
        self.conv2 = QConv(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = QConv(in_channels, out_channels, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return h + residual


class Downsample(nn.Module):
    """Stride-2 3x3 conv: symmetric pad 1 in the UNet, (0, 1) in the VAE encoder."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = QConv(channels, channels, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            # zeros raise no amax and quantize to 0, so under int8 this equals
            # the JAX package's padding of the int8 tensor (H, W ≠ 15)
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = QConv(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(to_nchw(upsample_nearest_2x(to_nhwc(x))))


class Attention(nn.Module):
    """Multi-head attention over (B, S, C) tokens: self when ``context`` is
    None, else cross."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, bias: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = QDense(query_dim, inner, bias=bias)
        self.to_k = QDense(context_dim or query_dim, inner, bias=bias)
        self.to_v = QDense(context_dim or query_dim, inner, bias=bias)
        self.to_out = nn.ModuleList([QDense(inner, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(context).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).view(b, sk, self.heads, self.head_dim)
        out = dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, sq, self.heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QDense(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf, as diffusers' GEGLU


class FeedForward(nn.Module):
    """GEGLU feed-forward dim → 4·dim (gated) → dim; ``net.1`` is diffusers'
    dropout slot, parameter-free."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), QDense(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    """LN→self-attn→LN→cross-attn→LN→GEGLU-FF, all residual (LN eps 1e-5)."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN (eps 1e-6, no SiLU) → 1x1 conv in → blocks → 1x1 conv out + residual."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, groups: int = 32):
        super().__init__()
        self.norm = FusedGroupNormSiLU(channels, groups, 1e-6, silu=False)
        self.proj_in = QConv(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(channels, heads, head_dim, context_dim) for _ in range(depth)])
        self.proj_out = QConv(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        x = to_nhwc(x).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context)
        x = to_nchw(x.reshape(b, h, w, c))
        return self.proj_out(x) + residual


class VAEAttention(nn.Module):
    """The VAE mid-block's single-head attention: GN → q/k/v → out, residual."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = FusedGroupNormSiLU(channels, groups, 1e-6, silu=False)
        self.to_q = QDense(channels, channels)
        self.to_k = QDense(channels, channels)
        self.to_v = QDense(channels, channels)
        self.to_out = nn.ModuleList([QDense(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = to_nhwc(self.group_norm(x)).reshape(b, h * w, c)
        q = self.to_q(y)[:, :, None, :]
        k = self.to_k(y)[:, :, None, :]
        v = self.to_v(y)[:, :, None, :]
        out = dot_product_attention(q, k, v).reshape(b, h * w, c)
        out = self.to_out[0](out).reshape(b, h, w, c)
        return to_nchw(out) + x
