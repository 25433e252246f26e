"""One decode replica a card (parallel/mesh.py)."""

from whisper_aries_tpu_torch.parallel.mesh import (
    auto_windows_per_device,
    get_mesh,
    make_mesh,
    map_shards,
    pad_to_multiple,
    replicate_params,
    shard_batch,
)

__all__ = [
    "auto_windows_per_device",
    "get_mesh",
    "make_mesh",
    "map_shards",
    "pad_to_multiple",
    "replicate_params",
    "shard_batch",
]
