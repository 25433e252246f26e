"""Speaker diarization (the port of the JAX package's diarize/)."""

from whisper_aries_tpu_torch.diarize.cluster import (
    agglomerative_cluster,
    cosine_distance_matrix,
    relabel_by_first_appearance,
)
from whisper_aries_tpu_torch.diarize.pipeline import DiarizationPipeline

__all__ = [
    "agglomerative_cluster",
    "cosine_distance_matrix",
    "relabel_by_first_appearance",
    "DiarizationPipeline",
]
