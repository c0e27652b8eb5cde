"""W8A8 int8 convolution and matmul (counterpart of ``ldiffusion_tpu/ops/quant.py``).

Symmetric quantization with the JAX module's arithmetic, step for step:
weights per output channel (max|w| / 127), activations per tensor — a
dynamic amax on a ::4 spatial view × 1.1, the exact amax while recording, or
a calibrated constant under ``"int8_static"``. The int8 product accumulates
in int32 through ``torch._int_mm`` (a convolution as an explicit im2col over
the int8 tensor); the accumulator is rescaled in f32 by ``sx * sw``, the
bias added in f32, then cast to the layer's dtype. The int8 codes and scales
equal the JAX package's for the same f32 input, and int32 sums are exact, so
only the f32 epilogue's rounding can differ.

Layout is the port's own: NCHW activations, OIHW conv weights, ``nn.Linear``
weights (out, in). The mode is module state read at every forward, as in
the JAX package; ``models/layers.py``'s ``QConv`` / ``QDense`` read it.

There is no float fallback: a failed ``torch._int_mm`` raises. CUDA's
``_int_mm`` takes M > 16 and K, N multiples of 8; other shapes are padded
with zero rows and columns, which leaves the sums unchanged.

INFERENCE-ONLY, as in the JAX package: rounding has no gradient, so a
quantized forward whose weight requires grad under grad mode raises
(``refuse_grad``). The trainers never set the mode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ldiffusion_tpu_torch.ops._build import refuse_grad

MODES = ("none", "int8", "int8_all", "int8_record", "int8_static")
# modes that quantize the QConvs the shape gate passes ("int8_all" takes all)
GATED_MODES = ("int8", "int8_record", "int8_static")
_MODE = "none"

# Activation amax on a ::AMAX_SUBSAMPLE spatial view, times AMAX_MARGIN.
AMAX_SUBSAMPLE = 4
AMAX_MARGIN = 1.1

# {site key -> calibrated amax (float)}, read under "int8_static".
_STATIC_AMAX: dict = {}
# {site key -> exact amax (0-dim f32 tensor)}, written under "int8_record".
_RECORDED: dict = {}


def set_quant_mode(mode: str) -> None:
    global _MODE
    if mode not in MODES:
        raise ValueError(f"quant mode {mode!r} is not one of {MODES}")
    _MODE = mode


def quant_mode() -> str:
    return _MODE


def set_static_amax(scales) -> None:
    """Install calibrated per-site activation amaxes (``None`` clears)."""
    _STATIC_AMAX.clear()
    if scales:
        _STATIC_AMAX.update(scales)


def static_amax() -> dict:
    return dict(_STATIC_AMAX)


def calibrate_static_scales(fn, *args) -> dict:
    """Run ``fn(*args)`` once under ``"int8_record"`` and return the exact
    activation amax of every gated site it hit, ``{site: float}``. Record
    mode quantizes like ``"int8"`` with the exact amax. The previous mode is
    restored, also when ``fn`` raises."""
    prev = _MODE
    _RECORDED.clear()
    set_quant_mode("int8_record")
    try:
        with torch.no_grad():
            fn(*args)
        return {k: float(v) for k, v in _RECORDED.items()}
    finally:
        set_quant_mode(prev)
        _RECORDED.clear()


def record_quant_sites(fn, *args) -> list:
    """Sorted keys of the gated sites ``fn(*args)`` hits. Eager PyTorch has
    no trace to read them from, so ``fn`` runs once under ``"int8_record"``.
    To enumerate the sites without computing anything, as ``jax.eval_shape``
    does, call it under ``torch._subclasses.fake_tensor.FakeTensorMode`` with
    the modules built inside that mode (fake CPU tensors take the ops'
    plain versions, which have no data to read)."""
    prev = _MODE
    _RECORDED.clear()
    set_quant_mode("int8_record")
    try:
        with torch.no_grad():
            fn(*args)
        return sorted(_RECORDED)
    finally:
        set_quant_mode(prev)
        _RECORDED.clear()


def conv_shape_gate(cin: int, cout: int) -> bool:
    """The JAX package's gate, unchanged (its win table was measured on a
    TPU v5e): quantize when the narrow side is at least 384 deep, or exactly
    256. A different gate would quantize different layers."""
    m = min(cin, cout)
    return m >= 384 or m == 256


def _div127(amax):
    """``max(amax, 1e-8) / 127`` in f32, as a true division on every device
    (CUDA turns a division by a host scalar into a product by its inverse)."""
    a = amax.clamp_min(1e-8)
    return a / torch.full_like(a, 127.0)


def _quantize(xf, scale):
    """round-half-even(x / scale) clipped to ±127, as int8."""
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def _sym_quant(x, dims):
    """(q, scale) with x ≈ q * scale; ``dims`` are the reduced dims of the
    amax (one scale for each coordinate of the others, kept as size-1 dims)."""
    xf = x.float()
    scale = _div127(xf.abs().amax(dim=dims, keepdim=True))
    return _quantize(xf, scale), scale


def _act_quant_subsampled(x):
    """Per-tensor quantization with the amax of a ::4 view of H and W (NCHW,
    when both are ≥ 16) × 1.1; values above it clip at ±127."""
    if x.dim() == 4 and x.shape[2] >= 4 * AMAX_SUBSAMPLE and x.shape[3] >= 4 * AMAX_SUBSAMPLE:
        view = x[:, :, ::AMAX_SUBSAMPLE, ::AMAX_SUBSAMPLE]
    else:
        view = x
    scale = _div127(view.float().abs().amax() * AMAX_MARGIN)
    return _quantize(x.float(), scale), scale


def _act_quant(x, site=None):
    """The activation's (q, scale) under the current mode: the exact amax,
    recorded, under ``"int8_record"``; the calibrated constant
    ``max(amax · 1.1, 1e-8) / 127`` (Python double, then f32) under
    ``"int8_static"`` for a calibrated site; else the dynamic estimate."""
    if site is not None and _MODE == "int8_record":
        xf = x.float()
        amax = xf.abs().amax()
        _RECORDED[site] = amax
        scale = _div127(amax)
        return _quantize(xf, scale), scale
    if site is not None and _MODE == "int8_static" and site in _STATIC_AMAX:
        # filled in on the device: no host-to-device copy in a captured program
        scale = torch.full((), max(_STATIC_AMAX[site] * AMAX_MARGIN, 1e-8) / 127.0,
                           dtype=torch.float32, device=x.device)
        return _quantize(x.float(), scale), scale
    return _act_quant_subsampled(x)


def _pad_to(t, dim: int, multiple: int, minimum: int = 0):
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, minimum)
    if want == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, want - n]
    return F.pad(t, pad)


def int_mm(a, b):
    """(M, K) int8 × (K, N) int8 → (M, N) int32 through ``torch._int_mm``,
    zero-padded where CUDA's shape rules need it (M > 16, K and N multiples
    of 8); ``b`` is best handed in column-major, a transposed (N, K)."""
    m, n = a.shape[0], b.shape[1]
    if a.is_cuda and (m <= 16 or a.shape[1] % 8 or n % 8):
        a = _pad_to(_pad_to(a, 0, 1, minimum=17), 1, 8)
        b = _pad_to(_pad_to(b.t(), 0, 8), 1, 8).t()
        return torch._int_mm(a.contiguous(), b)[:m, :n]
    return torch._int_mm(a, b)


def im2col(xq, kernel_size, stride, padding):
    """NCHW int8 → (B·Ho·Wo, kh·kw·Cin) int8: the kh·kw shifted (strided)
    slices of the zero-padded NHWC tensor, side by side along channels.
    ``padding``: ((lo, hi), (lo, hi)) for H and W. Returns (cols, (B, Ho, Wo))."""
    kh, kw = kernel_size
    sh, sw = stride
    (pt, pb), (pl, pr) = padding
    x = xq.permute(0, 2, 3, 1)  # free for a channels_last input
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    b, hp, wp, c = x.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    if kh == kw == 1 and sh == sw == 1:
        return x.reshape(b * ho * wo, c), (b, ho, wo)
    cols = torch.cat([x[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw, :]
                      for i in range(kh) for j in range(kw)], dim=3)
    return cols.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def weight_cols(wq):
    """OIHW int8 → (kh·kw·Cin, Cout), column-major (im2col's column order)."""
    o = wq.shape[0]
    return wq.permute(0, 2, 3, 1).reshape(o, -1).t()


def int8_conv_acc(xq, wq, stride, padding):
    """The int32 accumulator of the int8 convolution, NCHW (channels_last)."""
    cols, (b, ho, wo) = im2col(xq, wq.shape[2:], stride, padding)
    acc = int_mm(cols, weight_cols(wq))
    return acc.view(b, ho, wo, -1).permute(0, 3, 1, 2)


def dequantize(acc, sx, sw, bias, out_dtype):
    """int32 ``acc`` → f32 · (sx · sw), + bias in f32, cast to ``out_dtype``;
    ``sw`` and ``bias`` come shaped to broadcast over ``acc``."""
    out = acc.float() * (sx.reshape(()) * sw)
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _padding_pairs(padding):
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple(tuple(p) for p in padding)


def int8_conv(x, weight, stride=(1, 1), padding=0, bias=None, out_dtype=torch.bfloat16,
              site=None, weight_q=None):
    """NCHW × OIHW int8 convolution with the f32 rescale.

    x: (B, Cin, H, W) float; weight: (Cout, Cin, kh, kw) float; padding: an
    int or ((lo, hi), (lo, hi)) for H and W. Activations per tensor (see
    ``_act_quant``; ``site`` names the calibrated call site), weights per
    output channel: ``weight_q`` (codes, scales) when the caller quantized
    the weight already (``QConv``: once, from its f32 weight), else
    ``weight`` is quantized here. Returns (B, Cout, Ho, Wo) in ``out_dtype``."""
    refuse_grad("int8_conv", weight, *(() if bias is None else (bias,)))
    int8_conv.launches += 1
    xq, sx = _act_quant(x, site)
    wq, sw = weight_q if weight_q is not None else _sym_quant(weight, dims=(1, 2, 3))
    acc = int8_conv_acc(xq, wq, tuple(stride), _padding_pairs(padding))
    return dequantize(acc, sx, sw.reshape(1, -1, 1, 1),
                      None if bias is None else bias.reshape(1, -1, 1, 1), out_dtype)


int8_conv.launches = 0


def int8_matmul(x, weight, bias=None, out_dtype=torch.bfloat16, weight_q=None):
    """(..., K) × ``nn.Linear`` weight (N, K) int8 matmul with the f32
    rescale: x per tensor (exact amax), the weight per output row
    (``weight_q``, (codes, scales), when quantized already)."""
    refuse_grad("int8_matmul", weight, *(() if bias is None else (bias,)))
    int8_matmul.launches += 1
    xq, sx = _sym_quant(x, dims=tuple(range(x.dim())))
    wq, sw = weight_q if weight_q is not None else _sym_quant(weight, dims=(1,))
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq.t())
    out = dequantize(acc, sx, sw.reshape(1, -1), bias, out_dtype)
    return out.reshape(*x.shape[:-1], weight.shape[0])


int8_matmul.launches = 0
