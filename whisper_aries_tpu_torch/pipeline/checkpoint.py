"""Train state and params on disk (the port of the JAX package's
pipeline/checkpoint.py).

The JAX package writes Orbax checkpoints; the port has no Orbax and keeps
its own format, with the port's safetensors writer and reader
(utils/params_io.py):

  * ``save_train_state`` / ``restore_train_state``: one directory
    ``step_{step:08d}`` a step under ``ckpt_dir``, holding
    ``params.safetensors`` (the tree's dotted keys) and, with an optimizer
    state, ``opt_state.safetensors`` ("count", "mu.<key>", "nu.<key>":
    ``pipeline/train.py::adamw_init``'s state). Values round-trip bit for
    bit; a tree of lists ("stem.0.w") comes back with lists;
  * ``export_params_safetensors``: one flat safetensors file with the JAX
    package's dotted keys (its ``_flatten``), which its loaders and the
    port's read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.utils.params_io import (
    flatten_params,
    read_safetensors,
    write_safetensors,
)


def _tree_of(params: Any) -> Any:
    """A tree, or the first copy of ``replicate_params``' list of them."""
    return params[0] if isinstance(params, list) else params


def save_train_state(ckpt_dir: str, step: int, params: Any,
                     opt_state: Optional[Dict[str, Any]] = None) -> str:
    path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(path / "params.safetensors",
                      flatten_params(_tree_of(params)))
    if opt_state is not None:
        flat = {"count": np.asarray(opt_state["count"], np.int32)}
        for part in ("mu", "nu"):
            flat.update({f"{part}.{k}": v
                         for k, v in opt_state[part].items()})
        write_safetensors(path / "opt_state.safetensors", flat)
    return str(path)


def _nest(flat: Dict[str, Any]) -> Any:
    """{dotted.key: value} -> nested dicts, a level whose keys are all
    0..n-1 as a list."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        *parts, last = key.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


def _tensors(path: Path, device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in read_safetensors(path).items()}


def restore_train_state(ckpt_dir: str, step: Optional[int] = None,
                        device="cpu") -> Tuple[int, Dict[str, Any]]:
    """(step, {"params": tree[, "opt_state": state]}) of ``step`` (None:
    the newest) under ``ckpt_dir``, the tensors on ``device``. Raises
    FileNotFoundError when there is none."""
    root = Path(ckpt_dir).absolute()
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                   if p.is_dir())
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    step = step if step is not None else steps[-1]
    path = root / f"step_{step:08d}"
    state: Dict[str, Any] = {
        "params": _nest(_tensors(path / "params.safetensors", device))}
    opt = path / "opt_state.safetensors"
    if opt.exists():
        flat = _tensors(opt, device)
        state["opt_state"] = {
            "count": int(flat.pop("count")),
            **{part: {k[len(part) + 1:]: v for k, v in flat.items()
                      if k.startswith(part + ".")} for part in ("mu", "nu")}}
    return step, state


def export_params_safetensors(params: Any, path: str) -> str:
    """Flatten a param tree into one dotted-key safetensors file."""
    return write_safetensors(path, flatten_params(_tree_of(params)))
