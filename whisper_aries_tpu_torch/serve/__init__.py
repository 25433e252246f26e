"""The async job server (the port of the JAX package's serve/)."""

from whisper_aries_tpu_torch.serve.jobstore import JobStatus, JobStore
from whisper_aries_tpu_torch.serve.server import create_app

__all__ = ["JobStatus", "JobStore", "create_app"]
