"""The host C++ of the segmentor's input pipeline (the port's copy of
``ldiffusion_tpu/native``: the 2D and 3D crop, the 2D affine and the 3D
Euler affine), loaded through ctypes.

``fast_patches.cpp`` is compiled with ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` at first use into ``ldiffusion_tpu_torch/_build/`` (listed in
``.gitignore``); the file name carries a hash of the source and the flags, so
an edited source is rebuilt. Each process compiles to a pid-unique temporary
file and renames it, so concurrent first uses do not interleave their writes.

There is no silent fallback: a failed build or load raises. The numpy
versions (``crop_with_pad_numpy``, ``affine_augment_batch_numpy``,
``affine_augment_batch_3d_numpy``) are the oracles the tests hold the library
against. ``launches_by_route`` counts the calls of each entry point by route
("native" or "numpy"), the 3D crop apart from the 2D one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "fast_patches.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

launches_by_route = {name: {"native": 0, "numpy": 0} for name in (
    "crop_with_pad_batch", "affine_augment_batch", "crop_with_pad_batch_3d",
    "affine_augment_batch_3d")}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def reset_routes() -> None:
    with _count_lock:
        for by_route in launches_by_route.values():
            for route in by_route:
                by_route[route] = 0


def count(name: str, route: str) -> None:
    """One call of entry point ``name`` on ``route`` (callers run in the
    trainer's train and validation prefetch threads at once)."""
    with _count_lock:
        launches_by_route[name][route] += 1


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastpatches-{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {_SRC} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if that fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.crop_with_pad_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),   # datas
                ctypes.POINTER(ctypes.c_void_p),   # segs
                ctypes.POINTER(ctypes.c_int64),    # shapes (B, nd)
                ctypes.POINTER(ctypes.c_int64),    # lbs (B, nd)
                ctypes.c_int64, ctypes.c_int64,    # B, nd
                ctypes.POINTER(ctypes.c_int64),    # patch (nd)
                ctypes.c_int64,                    # C
                ctypes.POINTER(ctypes.c_float),    # out_data
                ctypes.POINTER(ctypes.c_int16),    # out_seg
                ctypes.c_int64,                    # n_threads
            ]
            lib.crop_with_pad_batch.restype = None
            lib.affine_augment_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),   # datas
                ctypes.POINTER(ctypes.c_void_p),   # segs
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # B H W C
                ctypes.c_int64, ctypes.c_int64,    # OH, OW (center-crop output)
                ctypes.POINTER(ctypes.c_double),   # angles
                ctypes.POINTER(ctypes.c_double),   # scales
                ctypes.POINTER(ctypes.c_uint8),    # apply flags
                ctypes.POINTER(ctypes.c_float),    # out_data
                ctypes.POINTER(ctypes.c_int16),    # out_seg
                ctypes.c_int64,                    # n_threads
                ctypes.c_int64,                    # data_order (1 bilinear, 0 nearest)
            ]
            lib.affine_augment_batch.restype = None
            lib.affine_augment_batch_3d.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),   # datas
                ctypes.POINTER(ctypes.c_void_p),   # segs
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64,                    # B D H W C
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # OD OH OW
                ctypes.POINTER(ctypes.c_double),   # angles_x
                ctypes.POINTER(ctypes.c_double),   # angles_y
                ctypes.POINTER(ctypes.c_double),   # angles_z
                ctypes.POINTER(ctypes.c_double),   # scales
                ctypes.POINTER(ctypes.c_uint8),    # apply flags
                ctypes.POINTER(ctypes.c_float),    # out_data
                ctypes.POINTER(ctypes.c_int16),    # out_seg
                ctypes.c_int64,                    # n_threads
                ctypes.c_int64,                    # data_order (1 trilinear, 0 nearest)
            ]
            lib.affine_augment_batch_3d.restype = None
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crop_with_pad_batch_native(cases: Sequence[Tuple[np.ndarray, np.ndarray]],
                               lbs: np.ndarray, patch: Sequence[int]):
    """Batch crop + pad of 2D or 3D cases, one thread a case. cases: B pairs
    (data (*spatial, C) float32 C-contiguous, seg (*spatial) int16
    C-contiguous); lbs: (B, nd) lower bounds; patch: (nd), nd 2 or 3.
    Returns (data (B, *patch, C) float32, seg (B, *patch) int16)."""
    nd = len(patch)
    if nd not in (2, 3):
        raise ValueError(f"patch {tuple(patch)}: the crop takes rank 2 or 3")
    lib = load_library()
    B = len(cases)
    data_ptrs = (ctypes.c_void_p * B)()
    seg_ptrs = (ctypes.c_void_p * B)()
    shapes = np.empty((B, nd), np.int64)
    for b, (d, s) in enumerate(cases):
        if not (d.dtype == np.float32 and d.flags.c_contiguous and s.dtype == np.int16
                and s.flags.c_contiguous):
            raise ValueError("crop_with_pad_batch_native: data must be C-contiguous "
                             "float32 and seg C-contiguous int16")
        data_ptrs[b] = d.ctypes.data
        seg_ptrs[b] = s.ctypes.data
        shapes[b] = d.shape[:nd]
    lbs = np.ascontiguousarray(lbs, np.int64)
    patch_arr = np.asarray(patch, np.int64)
    C = cases[0][0].shape[-1]
    out_data = np.empty((B, *patch, C), np.float32)
    out_seg = np.empty((B, *patch), np.int16)
    lib.crop_with_pad_batch(data_ptrs, seg_ptrs, _ptr(shapes, ctypes.c_int64),
                            _ptr(lbs, ctypes.c_int64), B, nd,
                            _ptr(patch_arr, ctypes.c_int64), C,
                            _ptr(out_data, ctypes.c_float), _ptr(out_seg, ctypes.c_int16), B)
    count("crop_with_pad_batch" if nd == 2 else "crop_with_pad_batch_3d", "native")
    return out_data, out_seg


def crop_with_pad_numpy(data: np.ndarray, seg: np.ndarray, lb: Sequence[int],
                        patch: Sequence[int]):
    """One case's crop with out-of-bounds padding (0 data, -1 seg), in numpy:
    the oracle of ``crop_with_pad_batch_native``."""
    nd = len(patch)
    shape = data.shape[:nd]
    src, dst = [], []
    for ax in range(nd):
        a0, a1 = lb[ax], lb[ax] + patch[ax]
        s0 = min(max(0, a0), shape[ax])
        s1 = max(s0, min(shape[ax], a1))  # a patch wholly outside copies nothing
        src.append(slice(s0, s1))
        dst.append(slice(s0 - a0, s0 - a0 + (s1 - s0)))
    out_d = np.zeros(tuple(patch) + (data.shape[-1],), data.dtype)
    out_s = np.full(tuple(patch), -1, seg.dtype)
    out_d[tuple(dst)] = data[tuple(src)]
    out_s[tuple(dst)] = seg[tuple(src)]
    return out_d, out_s


def affine_augment_batch_native(data: np.ndarray, seg: np.ndarray, angles: np.ndarray,
                                scales: np.ndarray, apply: np.ndarray,
                                data_order: int = 1, out_size=None):
    """Host rotation + scale of a 2D batch, one thread a sample (the
    batchgenerators SpatialTransform analog): the inverse map about the patch
    centre, bilinear (``data_order=1``) or nearest data, nearest labels, zero
    outside.
    ``out_size=(OH, OW)`` computes only the centred window of the output.
    data: (B, H, W, C) float32 contiguous; seg: (B, H, W) int16 contiguous."""
    lib = load_library()
    B, H, W, C = data.shape
    OH, OW = (H, W) if out_size is None else map(int, out_size)
    if not (0 < OH <= H and 0 < OW <= W):
        raise ValueError(f"out_size {out_size} does not fit {data.shape}")
    if not (data.dtype == np.float32 and data.flags.c_contiguous and seg.dtype == np.int16
            and seg.flags.c_contiguous):
        raise ValueError("affine_augment_batch_native: data must be C-contiguous float32 "
                         "and seg C-contiguous int16")
    data_ptrs = (ctypes.c_void_p * B)(*[data.ctypes.data + b * H * W * C * 4
                                        for b in range(B)])
    seg_ptrs = (ctypes.c_void_p * B)(*[seg.ctypes.data + b * H * W * 2 for b in range(B)])
    angles = np.ascontiguousarray(angles, np.float64)
    scales = np.ascontiguousarray(scales, np.float64)
    apply = np.ascontiguousarray(apply, np.uint8)
    out_data = np.empty((B, OH, OW, C), np.float32)
    out_seg = np.empty((B, OH, OW), np.int16)
    lib.affine_augment_batch(data_ptrs, seg_ptrs, B, H, W, C, OH, OW,
                             _ptr(angles, ctypes.c_double), _ptr(scales, ctypes.c_double),
                             _ptr(apply, ctypes.c_uint8), _ptr(out_data, ctypes.c_float),
                             _ptr(out_seg, ctypes.c_int16), B, data_order)
    count("affine_augment_batch", "native")
    return out_data, out_seg


def affine_augment_batch_numpy(data, seg, angles, scales, apply, data_order: int = 1,
                               out_size=None):
    """The same math in numpy: the oracle of ``affine_augment_batch_native``."""
    B, H, W, C = data.shape
    OH, OW = (H, W) if out_size is None else map(int, out_size)
    offy, offx = (H - OH) // 2, (W - OW) // 2
    out_d = data[:, offy:offy + OH, offx:offx + OW].copy()
    out_s = seg[:, offy:offy + OH, offx:offx + OW].copy()
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = np.mgrid[:OH, :OW].astype(np.float64)
    y, x = yy + offy - cy, xx + offx - cx
    for b in range(B):
        if not apply[b]:
            continue
        cosv, sinv = np.cos(angles[b]), np.sin(angles[b])
        sy = (cosv * y + sinv * x) / scales[b] + cy
        sx = (-sinv * y + cosv * x) / scales[b] + cx
        # half away from zero, as std::llround (np.round rounds half to even)
        ry = np.trunc(sy + np.copysign(0.5, sy)).astype(np.int64)
        rx = np.trunc(sx + np.copysign(0.5, sx)).astype(np.int64)
        if data_order == 0:
            ok = (ry >= 0) & (ry < H) & (rx >= 0) & (rx < W)
            vals = data[b][np.clip(ry, 0, H - 1), np.clip(rx, 0, W - 1)]
            out_d[b] = np.where(ok[..., None], vals, 0.0).astype(np.float32)
        else:
            y0 = np.floor(sy).astype(np.int64)
            x0 = np.floor(sx).astype(np.int64)
            fy, fx = sy - y0, sx - x0
            acc = np.zeros((OH, OW, C), np.float64)
            for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                              (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
                yi, xi = y0 + dy, x0 + dx
                ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
                vals = data[b][np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
                acc += (w * ok)[..., None] * vals
            out_d[b] = acc.astype(np.float32)
        ok = (ry >= 0) & (ry < H) & (rx >= 0) & (rx < W)
        out_s[b] = np.where(ok, seg[b][np.clip(ry, 0, H - 1), np.clip(rx, 0, W - 1)],
                            0).astype(seg.dtype)
    count("affine_augment_batch", "numpy")
    return out_d, out_s


def _euler_inverse(ax, ay, az):
    """R = Rx(ax)·Ry(ay)·Rz(az) of ``affine_augment_batch_3d``, as its rows."""
    cxr, sxr, cyr, syr, czr, szr = (np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay),
                                    np.cos(az), np.sin(az))
    return ((cyr * czr, -cyr * szr, syr),
            (cxr * szr + sxr * syr * czr, cxr * czr - sxr * syr * szr, -sxr * cyr),
            (sxr * szr - cxr * syr * czr, sxr * czr + cxr * syr * szr, cxr * cyr))


def affine_augment_batch_3d_native(data: np.ndarray, seg: np.ndarray, angles_x, angles_y,
                                   angles_z, scales, apply, data_order: int = 1,
                                   out_size=None):
    """Host Euler rotation (Rx·Ry·Rz) + isotropic scale of a 3D batch about
    the volume centre, one thread a sample: trilinear (``data_order=1``) or
    nearest data, nearest labels, zero outside. ``out_size=(OD, OH, OW)``
    computes only the centred window. data: (B, D, H, W, C) float32
    contiguous; seg: (B, D, H, W) int16 contiguous."""
    lib = load_library()
    B, D, H, W, C = data.shape
    OD, OH, OW = (D, H, W) if out_size is None else map(int, out_size)
    if not (0 < OD <= D and 0 < OH <= H and 0 < OW <= W):
        raise ValueError(f"out_size {out_size} does not fit {data.shape}")
    if not (data.dtype == np.float32 and data.flags.c_contiguous and seg.dtype == np.int16
            and seg.flags.c_contiguous):
        raise ValueError("affine_augment_batch_3d_native: data must be C-contiguous float32 "
                         "and seg C-contiguous int16")
    vox = D * H * W
    data_ptrs = (ctypes.c_void_p * B)(*[data.ctypes.data + b * vox * C * 4 for b in range(B)])
    seg_ptrs = (ctypes.c_void_p * B)(*[seg.ctypes.data + b * vox * 2 for b in range(B)])
    ax, ay, az, sc = (np.ascontiguousarray(a, np.float64)
                      for a in (angles_x, angles_y, angles_z, scales))
    apply = np.ascontiguousarray(apply, np.uint8)
    out_data = np.empty((B, OD, OH, OW, C), np.float32)
    out_seg = np.empty((B, OD, OH, OW), np.int16)
    lib.affine_augment_batch_3d(data_ptrs, seg_ptrs, B, D, H, W, C, OD, OH, OW,
                                _ptr(ax, ctypes.c_double), _ptr(ay, ctypes.c_double),
                                _ptr(az, ctypes.c_double), _ptr(sc, ctypes.c_double),
                                _ptr(apply, ctypes.c_uint8), _ptr(out_data, ctypes.c_float),
                                _ptr(out_seg, ctypes.c_int16), B, data_order)
    count("affine_augment_batch_3d", "native")
    return out_data, out_seg


def affine_augment_batch_3d_numpy(data, seg, angles_x, angles_y, angles_z, scales, apply,
                                  data_order: int = 1, out_size=None):
    """The same math in numpy: the oracle of ``affine_augment_batch_3d_native``."""
    B, D, H, W, C = data.shape
    OD, OH, OW = (D, H, W) if out_size is None else map(int, out_size)
    offz, offy, offx = (D - OD) // 2, (H - OH) // 2, (W - OW) // 2
    out_d = data[:, offz:offz + OD, offy:offy + OH, offx:offx + OW].copy()
    out_s = seg[:, offz:offz + OD, offy:offy + OH, offx:offx + OW].copy()
    centre = ((D - 1) / 2.0, (H - 1) / 2.0, (W - 1) / 2.0)
    grid = np.mgrid[:OD, :OH, :OW].astype(np.float64)
    pos = [grid[a] + off - c for a, (off, c) in enumerate(zip((offz, offy, offx), centre))]
    size = (D, H, W)

    def gather(vol, idx, fill):
        ok = np.ones(idx[0].shape, bool)
        for i, n in zip(idx, size):
            ok &= (i >= 0) & (i < n)
        vals = vol[tuple(np.clip(i, 0, n - 1) for i, n in zip(idx, size))]
        return ok, vals

    for b in range(B):
        if not apply[b]:
            continue
        r = _euler_inverse(angles_x[b], angles_y[b], angles_z[b])
        src = [(r[0][a] * pos[0] + r[1][a] * pos[1] + r[2][a] * pos[2]) / scales[b] + centre[a]
               for a in range(3)]
        # half away from zero, as std::llround (np.round rounds half to even)
        near = [np.trunc(s + np.copysign(0.5, s)).astype(np.int64) for s in src]
        if data_order == 0:
            ok, vals = gather(data[b], near, 0.0)
            out_d[b] = np.where(ok[..., None], vals, 0.0).astype(np.float32)
        else:
            lo = [np.floor(s).astype(np.int64) for s in src]
            frac = [s - f for s, f in zip(src, lo)]
            acc = np.zeros((OD, OH, OW, C), np.float64)
            for corner in np.ndindex(2, 2, 2):
                w = np.ones_like(frac[0])
                for f, d in zip(frac, corner):
                    w = w * (f if d else 1.0 - f)
                ok, vals = gather(data[b], [l + d for l, d in zip(lo, corner)], 0.0)
                acc += (w * ok)[..., None] * vals
            out_d[b] = acc.astype(np.float32)
        ok, vals = gather(seg[b], near, 0)
        out_s[b] = np.where(ok, vals, 0).astype(seg.dtype)
    count("affine_augment_batch_3d", "numpy")
    return out_d, out_s
