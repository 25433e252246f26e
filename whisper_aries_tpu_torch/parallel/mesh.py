"""Replicas over cards: the port's counterpart of the JAX package's
parallel/mesh.py.

The JAX engine shards each batch of 30 s windows over a ``Mesh``'s
"data" axis and runs one full decode replica per device under
``shard_map``, with no collective. Here a mesh is an ordered list of
``torch.device``s, that data axis: ``replicate_params`` puts one copy of
the weights on each distinct card, ``shard_batch`` cuts a batch into the
contiguous blocks ``P("data")`` gives each device, and ``map_shards`` runs
each block's card work in its own host thread under that card's lock
(``utils/device.py::on_card``). One process, one replica a mesh entry,
no ``torch.distributed``. A device may repeat: replicas that share a card
take turns on its lock (the CPU tests run four replicas on "cpu").
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.utils.device import on_card

Mesh = List[torch.device]


def make_mesh(n_data: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D data mesh over ``devices`` (default: every visible card),
    cut to its first ``n_data`` entries when ``n_data`` > 0."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if not devs:
            raise RuntimeError("make_mesh: no CUDA card is visible; pass "
                               "devices=['cpu', ...] for CPU replicas")
    else:
        devs = [torch.device(d) for d in devices]
    if n_data and n_data > 0:
        devs = devs[:n_data]
    if not devs:
        raise ValueError("make_mesh: an empty mesh")
    return devs


@functools.lru_cache(maxsize=1)
def get_mesh() -> Mesh:
    """The process-wide default mesh over every visible card."""
    return make_mesh()


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def replicate_params(params: Any, mesh: Mesh) -> List[Any]:
    """One copy of the tree ``params`` (dicts of tensors) on each distinct
    device of ``mesh``, listed in mesh order: entries on one device share
    its copy, and a device that already holds the tree keeps it."""
    copies = {}
    for d in mesh:
        if d not in copies:
            copies[d] = _to(params, d)
    return [copies[d] for d in mesh]


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each shard of ``n`` rows: contiguous blocks of
    ceil(n / n_shards) rows, as ``P("data")`` lays out a batch padded to a
    multiple of the device count (trailing shards may be short or
    empty)."""
    per = -(-n // n_shards) if n else 0
    return [(min(n, i * per), min(n, (i + 1) * per)) for i in range(n_shards)]


def shard_batch(x: Any, mesh: Mesh) -> List[Any]:
    """``x`` (a tensor or a dict of tensors with one leading batch axis) cut
    into ``shard_bounds`` blocks, each moved to its mesh device."""
    first = x
    while isinstance(first, dict):
        first = next(iter(first.values()))
    bounds = shard_bounds(int(first.shape[0]), len(mesh))

    def cut(t, lo, hi, d):
        if isinstance(t, dict):
            return {k: cut(v, lo, hi, d) for k, v in t.items()}
        return t[lo:hi].to(d)

    return [cut(x, lo, hi, d) for (lo, hi), d in zip(bounds, mesh)]


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` (numpy array or tensor) with zeros along ``axis`` up to a
    multiple; returns (padded, n_real)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple if n else multiple
    if target == n:
        return x, n
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = target - n
        return torch.cat([x, x.new_zeros(shape)], dim=axis), n
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, target - n)
    return np.pad(x, pad_widths), n


def map_shards(mesh: Mesh, n: int,
               fn: Callable[[int, torch.device, int, int], Any]) -> List[Any]:
    """``fn(i, device, lo, hi)`` for each non-empty ``shard_bounds`` block
    of ``n`` rows, each under its device's lock (the device current in
    the thread); returns the results in mesh order, None for an empty
    shard. With one mesh entry it runs in the calling thread; else one
    thread a shard, all joined before the first error (in mesh order) is
    raised. The caller must hold no card lock a shard needs."""
    bounds = shard_bounds(n, len(mesh))
    if len(mesh) == 1:
        with on_card(mesh[0]):
            return [fn(0, mesh[0], 0, n)]
    out: List[Any] = [None] * len(mesh)
    errs: List[Optional[BaseException]] = [None] * len(mesh)

    def run(i):
        lo, hi = bounds[i]
        try:
            with on_card(mesh[i]):
                out[i] = fn(i, mesh[i], lo, hi)
        except BaseException as e:  # re-raised in the caller's thread
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,),
                                name=f"replica-{i}")
               for i, (lo, hi) in enumerate(bounds) if hi > lo]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e is not None:
            raise e
    return out


def join_shards(outs: Sequence[Optional[dict]],
                device: Optional[torch.device] = None) -> dict:
    """The shards' decode outputs (dicts of tensors, moved to ``device``,
    or of numpy arrays; None for an empty shard) as one batch's, rows in
    window order: ``steps`` the most any shard took, ``permuted`` and
    ``host_reads`` their sums, every other value concatenated on its
    leading axis."""
    outs = [o for o in outs if o is not None]
    if len(outs) == 1:
        return outs[0]
    joined = {}
    for k in outs[0]:
        vals = [o[k] for o in outs]
        if isinstance(vals[0], torch.Tensor):
            vals = [v.to(device) for v in vals]
            stack, cat = torch.stack, torch.cat
        else:
            stack, cat = np.stack, np.concatenate
        if k == "steps":
            joined[k] = stack(vals).max()
        elif k in ("permuted", "host_reads"):
            joined[k] = stack(vals).sum()
        else:
            joined[k] = cat(vals)
    return joined


# ---------------------------------------------------------------------------
# window batch sizing
# ---------------------------------------------------------------------------

#: encoder activations a window, in (frames x width) tensors of the
#: activation type: the conv stem at 2 x n_audio_ctx frames (padded input,
#: one shifted product, the sum, GELU: 4 x 2) and one layer's residents at
#: n_audio_ctx (x, LayerNorm out, q / k / v, attention out, its
#: projection, fc1 out and GELU out at 4 widths each: 15), plus the f32
#: LayerNorm (2 x 2)
ENC_TENSORS = 4 * 2 + 15 + 2 * 2


def window_bytes(dims, rows: int = 5, cache_len: int = 227,
                 kv_int8: bool = True, self_kv_int8: bool = True,
                 act_bytes: int = 2) -> int:
    """The card bytes one window of a decode batch holds at its peak, with
    activations of ``act_bytes`` (2: bf16, the card's default; 4: f32,
    compute_type "f32"):

    * its cross K/V, 2·L·H·dh·n_audio_ctx elements (int8 with one f32
      scale a position, head and layer; or the activation type);
    * the self cache of its ``rows`` decode rows (beams, or the fallback
      ladder's best_of samples) at ``cache_len`` = prompt + sample_len
      positions, int8 with an f32 scale a (row, head, position) or the
      activation type; with an int8 cache the prefill's own cache in the
      activation type and the three f32 copies alive at once while
      ``decode_layers.quantize_heads`` packs it (the cast, the rounded
      quotient, its clamped copy);
    * the encoder's activations (``ENC_TENSORS``)."""
    L, d, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    dh = d // H
    Ta = dims.n_audio_ctx
    cross = 2 * L * d * Ta * (1 if kv_int8 else act_bytes)
    if kv_int8:
        cross += 2 * L * H * Ta * 4
    elems = 2 * L * d * cache_len
    if self_kv_int8:
        per_row = elems * (1 + 4 / dh) + elems * (act_bytes + 3 * 4)
    else:
        per_row = elems * act_bytes
    enc = ENC_TENSORS * Ta * dims.n_audio_state * act_bytes
    return int(cross + rows * per_row + enc)


#: decode rows a window holds at most besides its beams: the fallback
#: ladder's best_of samples (transcribe_file's default)
LADDER_ROWS = 5
#: the batched pass's prompt: <|sot|>, language, task
PROMPT_LEN = 3


def auto_windows_per_device(model_name: str = "large-v3", beam_size: int = 5,
                            sample_len: int = 224,
                            free_bytes: Optional[int] = None,
                            self_kv_int8: Optional[bool] = None,
                            kv_int8: bool = True, dims=None,
                            mesh: Optional[Mesh] = None,
                            act_bytes: int = 2) -> int:
    """Windows a replica can decode at once: its card's free memory
    (``torch.cuda.mem_get_info``, shared by the replicas on that card; the
    least over the mesh) over ``window_bytes`` at max(beam, LADDER_ROWS)
    rows and PROMPT_LEN + ``sample_len`` positions. ``self_kv_int8`` None
    means the card's default (int8); ``act_bytes`` the activations' width
    (4 at compute_type "f32"). At least 1."""
    from whisper_aries_tpu_torch.models.whisper import PRESETS

    dims = dims or PRESETS.get(model_name, PRESETS["large-v3"])
    if free_bytes is None:
        mesh = mesh or [torch.device("cuda", torch.cuda.current_device())]
        free_bytes = min(torch.cuda.mem_get_info(d)[0] // mesh.count(d)
                         for d in set(mesh))
    per = window_bytes(dims, rows=max(beam_size, LADDER_ROWS),
                       cache_len=PROMPT_LEN + sample_len, kv_int8=kv_int8,
                       self_kv_int8=True if self_kv_int8 is None
                       else self_kv_int8, act_bytes=act_bytes)
    return max(1, int(free_bytes // per))
