"""Safetensors files without the safetensors package.

The format: an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}} (plus an optional "__metadata__"
entry), then the raw little-endian tensor bytes. ``read_safetensors`` maps
the file (``np.memmap``, copy-on-write) and returns views of it, so a
3 GB checkpoint is not read into a second host copy; a tensor's pages are
read when it is first used. BF16 has no numpy type: its arrays hold the
bits as int16, and ``read_safetensors_torch`` reinterprets them as
``torch.bfloat16``. ``write_safetensors`` writes one tensor at a time.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

#: safetensors dtype -> (numpy dtype of the stored bits, torch dtype)
ST_DTYPES: Dict[str, Tuple[str, torch.dtype]] = {
    "F64": ("<f8", torch.float64), "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16), "BF16": ("<i2", torch.bfloat16),
    "I64": ("<i8", torch.int64), "I32": ("<i4", torch.int32),
    "I16": ("<i2", torch.int16), "I8": ("i1", torch.int8),
    "U8": ("u1", torch.uint8), "BOOL": ("?", torch.bool),
}
_TORCH_TO_ST = {t: k for k, (_, t) in ST_DTYPES.items()}
_NUMPY_TO_ST = {np.dtype(v[0]): k for k, v in ST_DTYPES.items()
                if k != "BF16"}


def _views(path):
    """(name, safetensors dtype, array view) of every tensor of a file,
    the views of one copy-on-write map of it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    for name, meta in header.items():
        if meta["dtype"] not in ST_DTYPES:
            raise ValueError(f"{path}: unsupported dtype {meta['dtype']}")
        lo, hi = meta["data_offsets"]
        arr = mm[8 + n + lo:8 + n + hi].view(ST_DTYPES[meta["dtype"]][0])
        yield name, meta["dtype"], arr.reshape(meta["shape"])


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """A safetensors file -> {name: array}, each a view of one copy-on-write
    map of the file (BF16 tensors as their int16 bits)."""
    return {name: arr for name, _, arr in _views(path)}


def read_safetensors_torch(path) -> Dict[str, torch.Tensor]:
    """The same as CPU tensors sharing the map, BF16 as torch.bfloat16."""
    out = {}
    for name, dt, arr in _views(path):
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out


def _st_dtype(value) -> str:
    if isinstance(value, torch.Tensor):
        if value.dtype not in _TORCH_TO_ST:
            raise ValueError(f"unsupported tensor dtype {value.dtype}")
        return _TORCH_TO_ST[value.dtype]
    dt = np.asarray(value).dtype
    if dt.name == "bfloat16":  # ml_dtypes
        return "BF16"
    if dt.newbyteorder("<") not in _NUMPY_TO_ST:
        raise ValueError(f"unsupported array dtype {dt}")
    return _NUMPY_TO_ST[dt.newbyteorder("<")]


def _bytes(value) -> bytes:
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    a = np.ascontiguousarray(value)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def write_safetensors(path, tensors: Mapping[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> str:
    """Write {name: torch tensor or numpy array} as a safetensors file, one
    tensor at a time (a tensor on a card is copied to the host alone); the
    header is padded with spaces to a multiple of 8 bytes."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    off = 0
    for name, value in tensors.items():
        shape = list(value.shape)
        dt = _st_dtype(value)
        itemsize = np.dtype(ST_DTYPES[dt][0]).itemsize
        n = itemsize * int(np.prod(shape, dtype=np.int64))
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for value in tensors.values():
            f.write(_bytes(value))
    return str(path)
