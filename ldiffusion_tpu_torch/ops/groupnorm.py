"""GroupNorm (+SiLU): the hand-written CUDA kernels and their plain version.

Counterpart of ``ldiffusion_tpu/ops/groupnorm.py``. Its three Pallas kernels
become two routes of ``csrc/groupnorm_sm90.cu`` (its header says how and what
bounds them), picked by ``gn_route``:

- ``"resident"`` (K3's counterpart, ``_gn_kernel`` :82): one launch. A
  thread-block cluster holds a (batch row, slice of whole groups) in shared
  memory, loaded once with TMA; the cluster's CTAs exchange group partials
  through distributed shared memory; y is written from shared memory.
  ``gn_resident_config`` mirrors the C choice of slice and cluster.
- ``"stream"`` (K4a/K4b, ``_gn_stats_kernel`` :147, ``_gn_apply_kernel``
  :168): a stats launch whose last CTA folds the chunks into mul/add, then
  an apply launch; for the maps the resident route does not take, and (in
  its scalar variant) for C·itemsize not a multiple of 16 or unaligned x.

The first, three-kernel ``csrc/groupnorm.cu`` stays reachable only through
``_launch(..., route="v1")``, as a yardstick on the same inputs; the router
never picks it. ``plain_groupnorm_silu`` is ``_xla_groupnorm_silu`` in
PyTorch: the CPU path and the reference the kernels are held against.

Under autograd, ``groupnorm_silu_trainable`` runs the kernel forward; its
backward is ``groupnorm_silu_backward``: on a card the backward kernels of
the same file by ``gn_route(..., backward=True)`` (the resident route holds
x and dy in a cluster's shared memory; the streamed route takes statistics,
partials and apply passes), on the CPU ``plain_groupnorm_silu_backward``, the
closed form of the gradient that the JAX package's ``_gn_bwd`` (:319-323)
leaves to XLA's vjp.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ldiffusion_tpu_torch.core import tracing
from ldiffusion_tpu_torch.ops import _build
from ldiffusion_tpu_torch.ops.attention import SMEM_PER_BLOCK

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("resident", "stream")

# The resident route (``resident_config`` in csrc/groupnorm_sm90.cu).
_THREADS = 256
_BOX_ROWS = 256  # TMA's largest box dimension; slices up to 256 channels
_DATA_MAX = 200 * 1024  # bytes of x a CTA holds
_CLUSTERS = (1, 2, 4, 8, 16)  # 16: a non-portable cluster size
_RESIDENT_TARGET_CTAS = 128
_MIN_CTA_ROWS = 8  # the least spatial rows a CTA is cut to
# The narrowest slice the resident route cuts where the group width allows,
# and the largest call it takes; both set from chip_smoke.py's GroupNorm rows
# on an H100 (PERF.md): 128-byte slices were as fast as 64-byte ones or
# faster at every path map (128²×320: 0.0129 against 0.0156 ms); the resident
# route led the streamed pair up to 21 MB (128²×640: 0.0360 against 0.0395
# ms) and tied it at 33.5 MB (256²×256, 32-byte slices: 0.0557 / 0.0550).
MIN_SLICE_BYTES = 128
RESIDENT_MAX_BYTES = 20 * 2 ** 20
# The streamed route: stats CTAs in all, and the least loads a thread makes.
_STREAM_CTAS = 528
_STREAM_MIN_LOADS = 8
# The first kernel (the "v1" yardstick): stats-pass CTAs per call (split over
# the batch) and the least rows each reads
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


def _itemsize(dtype) -> int:
    if dtype not in _DTYPES:
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {dtype}")
    return dtype.itemsize


def vectorised(c: int, dtype, aligned: bool) -> bool:
    """Whether x takes 16-byte accesses (and TMA's strides): 16-byte-aligned
    pointers and C·itemsize a multiple of 16. Otherwise the streamed route's
    scalar variant runs."""
    return aligned and (c * _itemsize(dtype)) % 16 == 0


def gn_resident_config(b: int, hw: int, c: int, groups: int, dtype,
                       min_slice: int = MIN_SLICE_BYTES, backward: bool = False):
    """The resident route's configuration (``resident_config`` in
    csrc/groupnorm_sm90.cu; ``backward``: the backward kernel's, which holds
    x and dy in the 200 KB), or None where it does not take the shape:
    ``groups`` a slice (the narrowest run of whole groups whose bytes are a
    multiple of 16 and at least ``min_slice``, else the whole row), CTAs a
    ``cluster`` (the smallest that fits 200 KB of x a CTA and gives at least
    128 CTAs, else the largest that fits; at least 8 rows a CTA), spatial
    ``rows`` a CTA, TMA
    ``box_rows`` and ``boxes``, and dynamic shared memory ``smem``."""
    isz = _itemsize(dtype)
    if b < 1 or b > 65535 or hw < 1 or c < 1 or groups < 1 or groups > _THREADS or \
            c % groups or (c * isz) % 16:
        return None
    cpg = c // groups
    gpc = next((d for d in range(1, groups + 1) if groups % d == 0 and
                (d * cpg * isz) % 16 == 0 and d * cpg * isz >= min_slice), groups)
    w = gpc * cpg
    if w > _BOX_ROWS:
        return None
    sb, nslice = w * isz, groups // gpc
    rg = _THREADS // (sb // 16)
    cfg = None
    cs = 1
    while cs in _CLUSTERS and (cs == 1 or cs * _MIN_CTA_ROWS <= hw):
        rpc = -(-hw // cs)
        nbox = -(-rpc // _BOX_ROWS)
        br = -(-(-(-rpc // nbox)) // 8) * 8
        data = nbox * br * sb * (2 if backward else 1)
        if data <= _DATA_MAX:
            smem = 128 + data + 16 * nbox + 4 * (2 * rg * w + 2 * w + 8 * gpc) if backward \
                else 128 + data + 8 * nbox + 4 * (2 * rg * w + 2 * max(8, gpc) + 4 * gpc)
            cfg = {"groups": gpc, "slices": nslice, "slice_bytes": sb, "cluster": cs,
                   "rows": rpc, "box_rows": br, "boxes": nbox, "smem": smem}
            if b * nslice * cs >= _RESIDENT_TARGET_CTAS:
                break
        cs *= 2
    if cfg is None or cfg["smem"] > SMEM_PER_BLOCK:
        return None
    return cfg


def gn_route(b: int, hw: int, c: int, groups: int, dtype, aligned: bool,
             backward: bool = False) -> str:
    """The route a call takes: ``"resident"`` where x takes 16-byte accesses,
    the call is at most ``RESIDENT_MAX_BYTES`` and ``gn_resident_config``
    finds a configuration (``backward``: the backward's, which holds x and
    dy; ``aligned`` then says it of both); else ``"stream"``."""
    if vectorised(c, dtype, aligned) and b * hw * c * _itemsize(dtype) <= RESIDENT_MAX_BYTES \
            and gn_resident_config(b, hw, c, groups, dtype, backward=backward) is not None:
        return "resident"
    return "stream"


def stream_chunks(b: int, hw: int, c: int, dtype, vec: bool):
    """(n_chunks, rows_per_chunk) of the streamed stats pass: about
    ``_STREAM_CTAS`` CTAs in all, each thread making at least
    ``_STREAM_MIN_LOADS`` loads."""
    nv = c * _itemsize(dtype) // 16 if vec else c
    rg = max(1, _THREADS // nv)
    n = max(1, min(_STREAM_CTAS // b, -(-hw // (rg * _STREAM_MIN_LOADS))))
    rows = -(-hw // n)
    return -(-hw // rows), rows


def stats_chunks(batch: int, hw: int):
    """(n_chunks, rows_per_chunk) of the first kernel's stats pass ("v1"): about
    ``_TARGET_CTAS`` CTAs in all, each reading at least ``_MIN_ROWS`` rows."""
    n = max(1, min(_TARGET_CTAS // batch, -(-hw // _MIN_ROWS)))
    rows = -(-hw // n)
    return -(-hw // rows), rows


@functools.cache
def _resident_fn():
    fn = _build.library("groupnorm_sm90").ldt_groupnorm_resident
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _stream_fn():
    fn = _build.library("groupnorm_sm90").ldt_groupnorm_stream
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _resident_bwd_fn():
    fn = _build.library("groupnorm_sm90").ldt_groupnorm_resident_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _stream_bwd_fn():
    fn = _build.library("groupnorm_sm90").ldt_groupnorm_stream_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _v1_fn():
    fn = _build.library("groupnorm").ldt_groupnorm_silu
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The streamed route's scratch, one a device: group partials and mul/add,
# and the per-batch-row counters the last CTA leaves at zero. Allocated (the
# counters zeroed) once and grown when a call needs more; calls use it in
# order on PyTorch's current stream. A captured CUDA graph holds the
# addresses of the workspace it ran with and replays leave its counters at
# zero as eager calls do; a workspace outgrown is kept, never freed, since a
# graph may still replay on it. Growing during a capture raises: the memory
# would come from the graph's pool.
_workspaces: dict = {}
_outgrown: list = []


def _workspace(device, b: int, n_chunks: int, groups: int, c: int):
    floats = 2 * b * n_chunks * groups + 2 * b * c
    ws = _workspaces.get(device)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < b:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"groupnorm_silu: the streamed route's workspace must grow to {floats} floats "
                f"and {b} counters during a CUDA graph capture; run the call eagerly first")
        grown = ws is not None
        if grown:
            _outgrown.append(ws)
        floats = max(floats, ws[0].numel() if grown else 0)
        counts = max(b, ws[1].numel() if grown else 0)
        ws = (torch.empty(floats, device=device, dtype=torch.float32),
              torch.zeros(counts, device=device, dtype=torch.int32))
        _workspaces[device] = ws
    f, counters = ws
    part = b * n_chunks * groups
    return f[:part], f[part:2 * part], f[2 * part:2 * part + b * c], \
        f[2 * part + b * c:2 * part + 2 * b * c], counters


def _scratch(device, sizes):
    """The backward's f32 scratch, one tensor of each size, allocated by the
    call: it keeps no counters, so nothing need outlive it (under a capture
    it comes from the graph's pool)."""
    return [torch.empty(n, device=device, dtype=torch.float32) for n in sizes]


def _launch(what: str, x, scale, bias, groups: int, eps: float, silu: bool, route=None,
            min_slice: int = MIN_SLICE_BYTES):
    """Launch by ``route`` (``gn_route``'s choice when None; ``"v1"`` is the
    first kernel, csrc/groupnorm.cu) and return (y, route). A route that does not take the shape
    raises. ``min_slice`` is the resident route's narrowest slice in bytes."""
    _build.refuse_grad(what, x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes a float32/bfloat16 (B, H, W, C) tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    hw = h * w
    if c % groups:
        raise ValueError(f"{what}: {c} channels not divisible by {groups} groups")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{what}: scale/bias must be ({c},)")
    # scale and bias are read in their own dtype (f32 or bf16): no cast launch
    sdtype = scale.dtype if scale.dtype in _DTYPES else torch.float32
    scale = scale.to(device=x.device, dtype=sdtype).contiguous()
    bias = bias.to(device=x.device, dtype=sdtype).contiguous()
    y = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0
    if route is None:
        route = gn_route(b, hw, c, groups, x.dtype, aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr())
        if route == "resident":
            err = _resident_fn()(*args, b, hw, c, groups, float(eps), int(silu),
                                 _DTYPES[x.dtype], _DTYPES[sdtype], int(min_slice), stream)
        elif route == "stream":
            vec = vectorised(c, x.dtype, aligned)
            n_chunks, rows = stream_chunks(b, hw, c, x.dtype, vec)
            psum, psq, mul, add, counters = _workspace(x.device, b, n_chunks, groups, c)
            err = _stream_fn()(*args, psum.data_ptr(), psq.data_ptr(), mul.data_ptr(),
                               add.data_ptr(), counters.data_ptr(), b, hw, c, groups, n_chunks,
                               rows, float(eps), int(silu), _DTYPES[x.dtype], _DTYPES[sdtype],
                               int(vec), stream)
        elif route == "v1":
            s32, b32 = scale.float(), bias.float()
            n_chunks, rows = stats_chunks(b, hw)
            partial = torch.empty((2, b, n_chunks, c), device=x.device, dtype=torch.float32)
            affine = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
            err = _v1_fn()(x.data_ptr(), s32.data_ptr(), b32.data_ptr(), y.data_ptr(),
                           partial[0].data_ptr(), partial[1].data_ptr(), affine[0].data_ptr(),
                           affine[1].data_ptr(), b, hw, c, groups, n_chunks, rows, float(eps),
                           int(silu), _DTYPES[x.dtype], stream)
        else:
            raise ValueError(f"{what}: unknown route {route!r}")
    _build.check(err, f"{what} launch ({route})")
    return y, route


def groupnorm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                   silu: bool = True):
    """x: (B, H, W, C); scale/bias: (C,). GroupNorm [+ SiLU]. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels of
    ``gn_route`` or raises (also where autograd would need the output's
    gradient)."""
    if x.device.type == "cpu":
        return plain_groupnorm_silu(x, scale, bias, groups, eps, silu)
    y, route = _launch("groupnorm_silu", x, scale, bias, groups, eps, silu)
    groupnorm_silu.launches += 1
    groupnorm_silu.launches_by_route[route] += 1
    return y


groupnorm_silu.launches = 0
groupnorm_silu.launches_by_route = dict.fromkeys(ROUTES, 0)


def plain_groupnorm_silu_backward(x, dy, scale, bias, groups: int, eps: float, silu: bool):
    """The gradient of ``plain_groupnorm_silu`` in closed form: (dx, dscale,
    dbias) for the output gradient ``dy``. f32 math (f64 for f64 input); dx
    in x's dtype, dscale and dbias in the parameters'. With the forward's
    statistics, xh = (x − mean)·rstd, y = xh·scale + bias, dz = dy·SiLU′(y)
    (dy without SiLU) and g = scale·dz: dx = rstd·(g − mean(g) − xh·mean(g·xh))
    over each group, the last term dropped where the variance's clamp held;
    dscale = Σ dz·xh and dbias = Σ dz over batch and space."""
    b, h, w, c = x.shape
    cpg = c // groups
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).reshape(b, h * w, groups, cpg)
    n = h * w * cpg
    mean = xf.sum(dim=(1, 3)) / n
    var = (xf * xf).sum(dim=(1, 3)) / n - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    xh = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    sc = scale.to(ct).reshape(groups, cpg)
    dz = dy.to(ct).reshape(xf.shape)
    if silu:
        y = xh * sc + bias.to(ct).reshape(groups, cpg)
        s = torch.sigmoid(y)
        dz = dz * s * (1 + y * (1 - s))
    g = sc * dz
    mean_g = g.mean(dim=(1, 3))
    mean_gx = (g * xh).mean(dim=(1, 3)) * (var >= 0)
    dx = rstd[:, None, :, None] * (g - mean_g[:, None, :, None] - xh * mean_gx[:, None, :, None])
    dscale = (dz * xh).sum(dim=(0, 1)).reshape(c)
    dbias = dz.sum(dim=(0, 1)).reshape(c)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype)


def _launch_bwd(x, dy, scale, bias, groups: int, eps: float, silu: bool, param_grads: bool,
                route=None):
    """Launch the backward by ``route`` (``gn_route(..., backward=True)``'s
    choice when None) and return (dx, dscale, dbias, route); dscale and dbias
    are None unless ``param_grads``. A route that does not take the shape
    raises."""
    what = "groupnorm_silu_backward"
    _build.refuse_grad(what, x, dy, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes a float32/bfloat16 (B, H, W, C) tensor, "
                        f"got {x.dtype} {tuple(x.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise TypeError(f"{what}: dy is {dy.dtype} {tuple(dy.shape)}, x {x.dtype} "
                        f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    hw = h * w
    if c % groups:
        raise ValueError(f"{what}: {c} channels not divisible by {groups} groups")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{what}: scale/bias must be ({c},)")
    dy = dy.contiguous()
    sdtype = scale.dtype if scale.dtype in _DTYPES else torch.float32
    sc = scale.to(device=x.device, dtype=sdtype).contiguous()
    bi = bias.to(device=x.device, dtype=sdtype).contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty(c, device=x.device, dtype=sdtype) if param_grads else None
    dbias = torch.empty(c, device=x.device, dtype=sdtype) if param_grads else None
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    if route is None:
        route = gn_route(b, hw, c, groups, x.dtype, aligned, backward=True)
    grads = (dscale.data_ptr(), dbias.data_ptr()) if param_grads else (None, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), dy.data_ptr(), sc.data_ptr(), bi.data_ptr(), dx.data_ptr())
        tail = (float(eps), int(silu), _DTYPES[x.dtype], _DTYPES[sdtype])
        if route == "resident":
            cfg = gn_resident_config(b, hw, c, groups, x.dtype, backward=True)
            pa, pb = _scratch(x.device, [b * (cfg["cluster"] if cfg else 1) * c] * 2)
            err = _resident_bwd_fn()(*args, pa.data_ptr(), pb.data_ptr(), *grads, b, hw, c,
                                     groups, *tail, stream)
        elif route == "stream":
            vec = vectorised(c, x.dtype, aligned)
            n_chunks, rows = stream_chunks(b, hw, c, x.dtype, vec)
            ws = _scratch(x.device, [b * n_chunks * groups] * 2 + [4 * b * groups] * 2
                          + [b * n_chunks * c] * 2)
            psum, psq, stat, gstat, pa, pb = (t.data_ptr() for t in ws)
            err = _stream_bwd_fn()(*args, psum, psq, stat, pa, pb, gstat, *grads, b, hw, c,
                                   groups, n_chunks, rows, *tail, int(vec), stream)
        else:
            raise ValueError(f"{what}: unknown route {route!r}")
    _build.check(err, f"{what} launch ({route})")
    if param_grads and sdtype != scale.dtype:
        dscale, dbias = dscale.to(scale.dtype), dbias.to(bias.dtype)
    return dx, dscale, dbias, route


def groupnorm_silu_backward(x, dy, scale, bias, groups: int = 32, eps: float = 1e-5,
                            silu: bool = True, param_grads: bool = True):
    """(dx, dscale, dbias) of ``groupnorm_silu`` at x for the output gradient
    dy (dscale and dbias None unless ``param_grads``). A CPU tensor takes
    ``plain_groupnorm_silu_backward``; a CUDA tensor launches the backward
    kernels of ``gn_route(..., backward=True)`` or raises."""
    if x.device.type == "cpu":
        dx, dscale, dbias = plain_groupnorm_silu_backward(x, dy, scale, bias, groups, eps, silu)
        return (dx, dscale, dbias) if param_grads else (dx, None, None)
    dx, dscale, dbias, route = _launch_bwd(x, dy, scale, bias, groups, eps, silu, param_grads)
    groupnorm_silu_backward.launches += 1
    groupnorm_silu_backward.launches_by_route[route] += 1
    tracing.count(f"groupnorm.backward.{route}")
    return dx, dscale, dbias


groupnorm_silu_backward.launches = 0
groupnorm_silu_backward.launches_by_route = dict.fromkeys(ROUTES, 0)


class _GroupNormSiLU(torch.autograd.Function):
    """Kernel forward; backward by ``groupnorm_silu_backward`` from the saved
    input (the statistics recomputed)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, silu)
        return groupnorm_silu(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        want_x, want_scale, want_bias = ctx.needs_input_grad[:3]
        dx, dscale, dbias = groupnorm_silu_backward(x, dy, scale, bias, *ctx.args,
                                                    param_grads=want_scale or want_bias)
        return (dx if want_x else None, dscale if want_scale else None,
                dbias if want_bias else None, None, None, None)


def groupnorm_silu_trainable(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                             silu: bool = True):
    """``groupnorm_silu`` with a gradient for x, scale and bias."""
    return _GroupNormSiLU.apply(x, scale, bias, groups, eps, silu)
