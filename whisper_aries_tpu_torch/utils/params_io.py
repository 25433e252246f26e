"""Safetensors files without the safetensors package.

The format: an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}} (plus an optional "__metadata__"
entry), then the raw little-endian tensor bytes. ``read_safetensors`` maps
the file (``np.memmap``, copy-on-write) and returns views of it, so a
3 GB checkpoint is not read into a second host copy; a tensor's pages are
read when it is first used. BF16 has no numpy type: its arrays hold the
bits as int16, and ``read_safetensors_torch`` reinterprets them as
``torch.bfloat16``. ``write_safetensors`` writes one tensor at a time.

The diarization nets store their weights as flat files with dotted keys
("blocks.attn.q.w", "convs.0.w"): ``flatten_params`` / ``unflatten_into``
map between those and nested parameter trees, ``load_params_into`` fills
an init-time template from a file (refusing one that lacks a key).
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


# ---------------------------------------------------------------------------
# flat dotted-key files <-> nested parameter trees (the diarization nets)
# ---------------------------------------------------------------------------


def flatten_params(params: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / lists / tuples of tensors -> {dotted.key: tensor}
    (the leaves as they are)."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix.rstrip("."): params}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_params(v, prefix=f"{prefix}{k}."))
    return out


def unflatten_into(template: Any, flat: Mapping[str, Any], prefix: str = "",
                   convert=None) -> Any:
    """Fill a ``template`` tree with the values of a flat dotted-key dict,
    each through ``convert`` (a torch tensor by default). Missing keys keep
    the template's value; extra keys are ignored."""
    convert = convert or torch.as_tensor
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}.", convert)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [unflatten_into(v, flat, f"{prefix}{i}.", convert)
               for i, v in enumerate(template)]
        return tuple(seq) if isinstance(template, tuple) else seq
    key = prefix.rstrip(".")
    return convert(flat[key]) if key in flat else template


def save_params(path, params: Any) -> str:
    """Write a parameter tree as a flat safetensors file."""
    return write_safetensors(path, flatten_params(params))


def load_params_into(template: Any, path, device="cpu") -> Any:
    """A flat safetensors file in the structure of ``template``, as f32
    tensors on ``device``. Raises FileNotFoundError for a missing file and
    ValueError when its keys do not cover the template (a half-loaded net
    would run half random)."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(str(p))
    flat = read_safetensors(p)
    missing = set(flatten_params(template)) - set(flat)
    if missing:
        raise ValueError(f"{path} is missing {len(missing)} parameter(s), "
                         f"e.g. {sorted(missing)[:3]}")
    return unflatten_into(template, flat, convert=lambda a: torch.tensor(
        np.asarray(a), dtype=torch.float32, device=device))


def default_weights_dir() -> Path:
    """The trained diarization and VAD weights that ship with the JAX
    package (whisper_aries_tpu/weights/), read by path as data."""
    return Path(__file__).resolve().parents[2] / "whisper_aries_tpu" / "weights"
