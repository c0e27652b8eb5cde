"""Attention: the hand-written flash-attention kernels and their plain versions.

Counterpart of ``ldiffusion_tpu/ops/attention.py``. The TPU package routes
long self-attention to Pallas kernels: two forwards (``_flash_kernel`` :41,
``_flash_kvgrid_kernel`` :102), a forward that also writes the logsumexp
(``_flash_kernel_lse`` :180) and the flash backward (``_flash_bwd_kernel``
:245). Here one forward serves the first three (the logsumexp is an optional
output), by one of three routes that ``fwd_route`` picks from the head dim,
the dtype and the pointers' alignment: ``"wgmma"`` (``csrc/flash_fwd_wgmma.cu``,
TMA and wgmma: bf16 with d % 8 == 0), ``"mma"`` (``flash_fwd_mma`` in
``csrc/flash_attention.cu``: the other bf16 shapes, which TMA cannot address)
and ``"f32"`` (``flash_fwd_f32``, same file). The backward has the same three
routes, which ``bwd_route`` picks: ``"wgmma"`` (``csrc/flash_bwd_wgmma.cu``:
bf16 with d % 8 == 0 up to d = 160), ``"mma"`` and ``"f32"``
(``csrc/flash_attention_bwd.cu``). The sources' headers say how and what
bounds them. ``plain_attention``, ``plain_attention_lse`` and
``plain_attention_bwd`` are the same functions in PyTorch: the CPU path and
the reference the kernels are held against on the card.

Routing (``dot_product_attention``): attention over at least ``FLASH_MIN_KV``
keys goes to the kernels — every spatial self-attention of the UNet from
1024 tokens up and the VAE mid-block's. Short attention stays plain, as the
JAX package leaves it to XLA: the 5-token text cross-attention, and the
UNet's 256-token and shorter self-attention. Where autograd needs a gradient,
long attention runs through an ``autograd.Function``: ``_FlashTrainable`` (the
forward with logsumexp, then the flash backward) for head dims the backward
takes, ``_FlashPlainBackward`` (the forward, then a plain recomputed backward)
above them — the VAE's single-head d = 512, as the JAX package keeps the XLA
vjp for its kvgrid kernel (:416-422).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ldiffusion_tpu_torch.ops import _build

# the JAX auto routing sends sk >= 512 to Pallas (ops/attention.py:446)
FLASH_MIN_KV = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The backward keeps the rows of dK and dV it owns in f32 registers, d/2 a
# thread each (16 rows a warp in the mma.sync kernels, 64 a warpgroup in the
# wgmma kernel): d = 160 (SD-v1.5's widest UNet head) is the widest that stays
# within the registers a thread has. Its tiles must also fit a block's shared
# memory.
BWD_MAX_HEAD_DIM = 160
SMEM_PER_BLOCK = 232448  # H100, bytes of dynamic shared memory a block may use
_BWD_TILES = (1, 2, 3, 4, 5, 6, 8, 10)  # compiled 16-column tile counts
FWD_ROUTES = ("wgmma", "mma", "f32")
BWD_ROUTES = FWD_ROUTES
WGMMA_MAX_HEAD_DIM = 512


def _compute_dtype(t):
    """f32 for bf16/f32 inputs, the input's own type where it is wider."""
    return torch.promote_types(t.dtype, torch.float32)


def plain_attention(q, k, v, scale: float):
    """(B, S, H, D) softmax(q kᵀ · scale) v: f32 logits and softmax, the
    probabilities cast to the input dtype before the product with v."""
    ct = _compute_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
    probs = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def plain_attention_lse(q, k, v, scale: float):
    """``plain_attention`` and the logsumexp of each query row's scaled
    logits, (B, H, Sq) in f32: ``_flash_attention_bhsd_lse`` in PyTorch."""
    ct = _compute_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def attention_delta(o, do):
    """Δ = rowsum(dO ∘ O), (B, H, Sq), in f32 (or wider): the JAX package's
    ``jnp.sum(g * out, axis=-1)`` outside its backward kernel (:395)."""
    ct = _compute_dtype(o)
    return (do.to(ct) * o.to(ct)).sum(-1).transpose(1, 2)


def plain_attention_bwd(q, k, v, o, do, lse, scale: float):
    """(dq, dk, dv) from probabilities recomputed as exp(S·scale − lse):
    ``_flash_bwd_kernel`` in PyTorch. P and dS are rounded to the input dtype
    before their products, as the kernel rounds them; dS is formed from the
    unrounded P."""
    ct = _compute_dtype(q)
    qf, kf, vf, dof = (t.to(ct) for t in (q, k, v, do))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None].to(ct))
    delta = attention_delta(o, do)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(ct), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).to(ct)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _fwd_fn():
    fn = _build.library("flash_attention").ldt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_fn():
    fn = _build.library("flash_fwd_wgmma").ldt_flash_attention_fwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwd_route(d: int, dtype, aligned: bool) -> str:
    """The forward kernel that takes head dim ``d`` (the C dispatchers' rule):
    ``"wgmma"`` for bf16 with d % 8 == 0 (TMA's 16-byte strides), d <= 512 and
    16-byte-aligned q/k/v; ``"mma"`` for the other bf16 shapes; ``"f32"`` for
    float32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {dtype}")
    if aligned and d % 8 == 0 and 8 <= d <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    return "mma"


def wgmma_config(d: int) -> dict:
    """The compiled configuration of the ``"wgmma"`` route at head dim ``d``
    (``Cfg`` in csrc/flash_fwd_wgmma.cu): padded head dim, swizzle bytes,
    query rows and keys per tile, K/V stages and dynamic shared memory."""
    split = d > 256
    dp = (384 if d <= 384 else 512) if split else -(-d // 16) * 16
    sw = 128 if dp % 64 == 0 else 64 if dp % 32 == 0 else 32
    bq = 64 if split else 128
    bk = 32 if split else 128 if dp <= 80 else 64
    fixed = 1024 + bq * dp * 2 + 256  # alignment slack, Q, barriers
    tile = bk * dp * 2
    stages = min(4, (SMEM_PER_BLOCK - fixed) // (2 * tile))
    return {"dp": dp, "swizzle": sw, "split": split, "rows": bq, "keys": bk, "stages": stages,
            "smem": fixed + stages * 2 * tile}


@functools.cache
def _bwd_fn():
    fn = _build.library("flash_attention_bwd").ldt_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_qkv(what: str, q, k, v, max_d: int):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if d > max_d:
        raise ValueError(f"{what}: head dim {d} > {max_d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous (B, S, H, D)")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v on different devices")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_fwd(what: str, q, k, v, scale: float, lse, route=None):
    """Launch the forward by ``route`` (``fwd_route``'s choice when None) and
    return (out, route). A route that does not take the shape raises."""
    _build.refuse_grad(what, q, k, v)
    _check_qkv(what, q, k, v, 512)
    b, sq, h, d = q.shape
    if route is None:
        route = fwd_route(d, q.dtype, _aligned(q, k, v))
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, sq, k.shape[1], d, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            err = _wgmma_fn()(*args, stream)
        elif route in ("mma", "f32") and route == fwd_route(d, q.dtype, False):
            err = _fwd_fn()(*args, _DTYPES[q.dtype], stream)
        else:
            raise ValueError(f"{what}: route {route!r} does not take {q.dtype} d={d}")
    _build.check(err, f"{what} launch ({route})")
    return out, route


def _count(fn, route: str) -> None:
    fn.launches += 1
    fn.launches_by_route[route] += 1


def flash_attention_fwd(q, k, v, scale: float):
    """q: (B, Sq, H, D), k/v: (B, Sk, H, D) → (B, Sq, H, D). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel of ``fwd_route`` or
    raises (also where autograd would need the output's gradient)."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, scale)
    out, route = _launch_fwd("flash_attention_fwd", q, k, v, scale, None)
    _count(flash_attention_fwd, route)
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = dict.fromkeys(FWD_ROUTES, 0)


def flash_attention_fwd_lse(q, k, v, scale: float):
    """The forward and each query row's logsumexp: (out (B, Sq, H, D),
    lse (B, H, Sq) float32). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel of ``fwd_route`` or raises."""
    if q.device.type == "cpu":
        return plain_attention_lse(q, k, v, scale)
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    out, route = _launch_fwd("flash_attention_fwd_lse", q, k, v, scale, lse)
    _count(flash_attention_fwd_lse, route)
    return out, lse


flash_attention_fwd_lse.launches = 0
flash_attention_fwd_lse.launches_by_route = dict.fromkeys(FWD_ROUTES, 0)


def bwd_tiles(d: int) -> int:
    """The 16-column tile count the backward kernels run head dim ``d`` at
    (``tiles_for`` in csrc/flash_attention_bwd.cu); 0 where d is not taken."""
    if not 1 <= d <= BWD_MAX_HEAD_DIM:
        return 0
    return next(t for t in _BWD_TILES if 16 * t >= d)


def bwd_smem_bytes(d: int, dtype) -> int:
    """Shared memory of the larger backward kernel at head dim ``d`` (the
    ``*_smem_bytes``/``*_f32_floats`` formulas of the CUDA source), or -1."""
    n = bwd_tiles(d)
    if n == 0:
        return -1
    dp = 16 * n
    if dtype == torch.bfloat16:
        rs, bq = dp + 8, 64 if n <= 5 else 32
        dkdv = (2 * 64 * rs + 2 * bq * rs + 2 * dp * (bq + 8)) * 2 + 2 * bq * 4
        dq = (2 * 64 * rs + 2 * 32 * rs + dp * 40) * 2
        return max(dkdv, dq)
    fs = 33
    dkdv = 4 * dp * fs + 2 * 32 * dp + 2 * 32 * fs + 2 * 32
    dq = 4 * dp * fs + 32 * dp + 32 * fs
    return 4 * max(dkdv, dq)


@functools.cache
def _wgmma_bwd_fn():
    fn = _build.library("flash_bwd_wgmma").ldt_flash_attention_bwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_route(d: int, dtype, aligned: bool) -> str:
    """The backward kernels that take head dim ``d`` (``fwd_route``'s rule,
    within the backward's head-dim limit): ``"wgmma"`` for bf16 with d % 8 ==
    0, d <= 160 and 16-byte-aligned q/k/v/o/dO; ``"mma"`` for the other bf16
    shapes; ``"f32"`` for float32."""
    route = fwd_route(d, dtype, aligned)
    if route == "wgmma" and d > BWD_MAX_HEAD_DIM:
        return "mma"
    return route


def wgmma_bwd_config(d: int) -> dict:
    """The compiled configuration of the backward's ``"wgmma"`` route at head
    dim ``d`` (``Cfg`` in csrc/flash_bwd_wgmma.cu): padded head dim, swizzle
    bytes, keys (dK/dV CTA) and query rows (dQ CTA) a CTA owns, rows of a
    streamed tile, ring stages and dynamic shared memory."""
    dp = -(-d // 16) * 16
    sw = 128 if dp % 64 == 0 else 64 if dp % 32 == 0 else 32
    own, tile_rows = 128, 64 if dp <= 64 else 32
    fixed = 1024 + 2 * own * dp * 2 + 256  # alignment slack, K/V or Q/dO, barriers
    stage = 2 * tile_rows * dp * 2 + 2 * tile_rows * 4  # two tiles, lse2 and Δ rows
    stages = min(4, (SMEM_PER_BLOCK - fixed) // stage)
    return {"dp": dp, "swizzle": sw, "own": own, "tile_rows": tile_rows, "stages": stages,
            "smem": fixed + stages * stage}


def flash_bwd_fits(d: int, dtype=torch.bfloat16) -> bool:
    """The routing gate of the flash backward (the Hopper counterpart of
    ``_flash_bwd_fits_pallas``): the head dim's dK/dV accumulators fit the
    registers and its tiles a block's shared memory, on the ``"mma"``/``"f32"``
    kernels (which any call can fall to: an unaligned view takes ``"mma"``)
    and, where it would take the head dim, the ``"wgmma"`` kernel."""
    if not 0 < bwd_smem_bytes(d, dtype) <= SMEM_PER_BLOCK:
        return False
    wgmma = dtype == torch.bfloat16 and bwd_route(d, dtype, True) == "wgmma"
    return not wgmma or wgmma_bwd_config(d)["smem"] <= SMEM_PER_BLOCK


def _launch_bwd(what: str, q, k, v, o, do, lse, scale: float, route=None):
    """Launch the backward by ``route`` (``bwd_route``'s choice when None) and
    return (dq, dk, dv, route). A route that does not take the shape raises.
    The ``"wgmma"`` kernel computes Δ = rowsum(dO ∘ O) in its pre-pass; for
    the others it is computed here with PyTorch, as the JAX package computes
    it outside its kernel."""
    _build.refuse_grad(what, q, k, v, o, do)
    _check_qkv(what, q, k, v, BWD_MAX_HEAD_DIM)
    b, sq, h, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"{what}: o/do must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be ({b}, {h}, {sq}) float32")
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    if route is None:
        route = bwd_route(d, q.dtype, _aligned(q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        if route == "wgmma":
            # lse·log2(e) and Δ, each (B·H, Sq rounded up to the CTA's rows)
            rows = wgmma_bwd_config(d)["own"]
            scratch = torch.empty((2, b * h, -(-sq // rows) * rows), device=q.device,
                                  dtype=torch.float32)
            err = _wgmma_bwd_fn()(*ptrs, o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                  scratch.data_ptr(), *grads, b, h, sq, k.shape[1], d,
                                  float(scale), stream)
        elif route in ("mma", "f32") and route == bwd_route(d, q.dtype, False):
            delta = attention_delta(o, do).contiguous()
            err = _bwd_fn()(*ptrs, do.data_ptr(), lse.data_ptr(), delta.data_ptr(), *grads, b, h,
                            sq, k.shape[1], d, float(scale), _DTYPES[q.dtype], stream)
        else:
            raise ValueError(f"{what}: route {route!r} does not take {q.dtype} d={d}")
    _build.check(err, f"{what} launch ({route})")
    return dq, dk, dv, route


def flash_attention_bwd(q, k, v, o, do, lse, scale: float):
    """(dq, dk, dv) of ``o = attention(q, k, v)`` for the output gradient
    ``do``, from the forward's ``lse`` (B, H, Sq). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels of ``bwd_route`` or raises."""
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, o, do, lse, scale)
    dq, dk, dv, route = _launch_bwd("flash_attention_bwd", q, k, v, o, do, lse, scale)
    _count(flash_attention_bwd, route)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


class _FlashTrainable(torch.autograd.Function):
    """The forward with logsumexp, then the flash backward (``_flash_trainable``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.to(q.dtype), lse, ctx.scale)
        return dq, dk, dv, None


class _FlashPlainBackward(torch.autograd.Function):
    """The forward kernel, then a backward recomputed through
    ``plain_attention`` (``_flash_kvgrid_trainable``), for head dims the flash
    backward does not take."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return flash_attention_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_attention(q, k, v, ctx.scale)
        return (*torch.autograd.grad(out, (q, k, v), do), None)


def dot_product_attention(q, k, v, scale=None):
    """Multi-head attention, (B, S, H, D) layout (the JAX signature)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] < FLASH_MIN_KV:
        return plain_attention(q, k, v, scale)
    if _build.needs_grad(q, k, v):
        fn = _FlashTrainable if flash_bwd_fits(q.shape[-1], q.dtype) else _FlashPlainBackward
        return fn.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)
