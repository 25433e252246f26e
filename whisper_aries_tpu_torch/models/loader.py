"""Checkpoint resolution and loading (the port of models/loader.py).

Checkpoints are plain HF-format directories (config.json +
model.safetensors + tokenizer files, optionally generation_config.json)
found on local disk only: the port has no download path. The weights are
read through the port's own safetensors reader (utils/params_io.py), a map
of the file, and converted tensor by tensor onto the device.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.utils.params_io import read_safetensors_torch

log = logging.getLogger(__name__)


def _is_checkpoint_dir(p: Path) -> bool:
    return (p / "config.json").exists() and (p / "model.safetensors").exists()


def resolve_model_dir(model_name: str, cache_dir: str = "./models"
                      ) -> Optional[Path]:
    """A local HF-format checkpoint directory for ``model_name``: the name
    as a path, then ``{cache_dir}/{name}``, ``{cache_dir}/whisper-{name}``
    and ``{cache_dir}/openai--whisper-{name}``; None when none holds
    config.json and model.safetensors."""
    candidates = [
        Path(model_name),
        Path(cache_dir) / model_name,
        Path(cache_dir) / f"whisper-{model_name}",
        Path(cache_dir) / f"openai--whisper-{model_name}",
    ]
    for c in candidates:
        if _is_checkpoint_dir(c):
            return c
    return None


def load_model(model_size: str, cache_dir: str = "./models",
               dtype: torch.dtype = torch.float32, allow_random: bool = False,
               device="cpu"
               ) -> Tuple[Dict[str, Any], W.WhisperDims, Optional[str]]:
    """(params, dims, model_dir) for ``model_size``, the params on
    ``device`` in ``dtype``.

    With a local checkpoint: the dims from config.json and the
    model.safetensors state dict converted into the layer-stacked tree.
    Without one: seeded random weights at the preset's dims when
    ``allow_random`` (model_dir None), else FileNotFoundError."""
    d = resolve_model_dir(model_size, cache_dir)
    if d is None:
        if model_size in W.PRESETS and allow_random:
            dims = W.PRESETS[model_size]
            log.warning(
                "no local checkpoint for %r under %s — using RANDOM weights "
                "(identical FLOPs; transcripts are meaningless)",
                model_size, cache_dir)
            return (W.init_params(dims, seed=0, device=device, dtype=dtype),
                    dims, None)
        raise FileNotFoundError(
            f"no local checkpoint for {model_size!r} under {cache_dir} "
            "(need config.json + model.safetensors, or pass "
            "allow_random=True for random-weight runs)")
    cfg = json.loads((d / "config.json").read_text(encoding="utf-8"))
    dims = W.dims_from_hf_config(cfg)
    sd = read_safetensors_torch(d / "model.safetensors")
    params = W.convert_hf_state_dict(sd, dims, device=device, dtype=dtype)
    log.info("loaded %s from %s (%s on %s)", model_size, d, dtype, device)
    return params, dims, str(d)


def load_alignment_heads(model_dir) -> Optional[List[Tuple[int, int]]]:
    """The checkpoint's DTW alignment heads [(layer, head), ...] from
    generation_config.json; None when absent (the word pass then uses the
    top half of the decoder layers)."""
    if model_dir is None:
        return None
    p = Path(model_dir) / "generation_config.json"
    if not p.exists():
        return None
    try:
        cfg = json.loads(p.read_text(encoding="utf-8"))
        heads = cfg.get("alignment_heads")
        if not heads:
            return None
        return [(int(l), int(h)) for l, h in heads]
    except Exception as e:
        log.warning("could not read alignment heads from %s: %s", p, e)
        return None
