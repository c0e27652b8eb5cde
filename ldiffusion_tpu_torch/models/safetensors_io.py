"""Reading checkpoint files into torch tensors (counterpart of
``ldiffusion_tpu/models/safetensors_io.py``), without the ``safetensors``
package.

A ``.safetensors`` file is a little-endian u64 header length, a JSON header
mapping each tensor name to ``{dtype, shape, data_offsets}``, then the raw
bytes. Every tensor keeps its stored dtype: bf16 is read as bf16, not through
float32. A ``.bin`` file is a pickled torch state dict, read with
``weights_only=True``.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor}; the tensors share one buffer holding the file's
    data section."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        count = (end - start) // dtype.itemsize
        if count == 0:
            out[name] = torch.empty(meta["shape"], dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=start).reshape(meta["shape"])
    return out


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_torch_bin(path)
