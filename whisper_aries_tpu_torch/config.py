"""Single typed configuration tree for every entry point (PyTorch port).

Same fields, defaults and precedence as the JAX package's config module, so a
config file or override written for one runs the other unchanged. "auto"
values resolve to the CUDA path on a card and to the plain path on the CPU.

The reference splits configuration across three ad-hoc mechanisms — an env-var
module (reference: config.py:11-38), a JSON config file with auto-written
defaults (reference: Yasmeen's code/complete_fixed_whisper.py:611-636), and
per-CLI argparse flags (reference: final_optimized_transcriber.py:618-628) —
with no defined precedence (run_pipeline even hard-codes "large-v3" at
conversation_transcriber.py:72, ignoring WHISPER_MODEL_PATH).

Here there is one dataclass tree with a strict precedence:

    defaults  <  environment variables  <  JSON config file  <  explicit kwargs/flags

Every entry point (CLI, pipeline, server) builds its config through
``load_config()`` so behaviour is consistent everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Leaf config sections
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    """Which ASR model to run and how its weights are stored."""

    #: model preset name ("tiny", "base", "small", "medium", "large-v3") or a
    #: filesystem path to a converted checkpoint directory.
    name: str = "large-v3"
    #: where converted / downloaded checkpoints live (reference caches under
    #: ./models — final_optimized_transcriber.py:172).
    cache_dir: str = "./models"
    #: weight storage dtype: "bf16" | "int8" (int8 = per-channel quantized
    #: matmuls, the CTranslate2-equivalent path; reference README.md:178).
    compute_type: str = "bf16"
    #: activation dtype used on device.
    activation_dtype: str = "bfloat16"


@dataclass
class DecodeConfig:
    """Decoding defaults.

    Values mirror the reference engine's chunk-level parameters
    (final_optimized_transcriber.py:432-441) and the benchmark-defining
    README defaults (README.md:173-187: BEAM_SIZE=5, TEMPERATURE=0.0).
    """

    language: Optional[str] = None  # None => auto-detect
    task: str = "transcribe"  # or "translate"
    beam_size: int = 1
    best_of: int = 1
    #: beam-search patience (Kasai et al.): collect round(beam_size*patience)
    #: finished hypotheses before stopping (CTranslate2/faster-whisper knob).
    patience: float = 1.0
    length_penalty: float = 1.0
    repetition_penalty: float = 1.0
    #: ban repeating n-grams of this size inside a window (CTranslate2 knob).
    no_repeat_ngram_size: int = 0
    temperature: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: float = 2.4
    log_prob_threshold: float = -1.0
    no_speech_threshold: float = 0.6
    condition_on_previous_text: bool = False
    initial_prompt: Optional[str] = None
    word_timestamps: bool = False
    max_new_tokens: int = 224
    suppress_blank: bool = True
    suppress_tokens: tuple = (-1,)  # -1 => model's default non-speech set
    #: decode without timestamp tokens (faster-whisper without_timestamps):
    #: each window becomes one segment spanning the window.
    without_timestamps: bool = False
    #: latest time (seconds) the FIRST timestamp of a window may take
    #: (openai-whisper/faster-whisper max_initial_timestamp).
    max_initial_timestamp: float = 1.0
    #: with condition_on_previous_text: drop the accumulated text context
    #: whenever a window's accepted decode used a temperature ABOVE this
    #: (faster-whisper prompt_reset_on_temperature).
    prompt_reset_on_temperature: float = 0.5
    #: re-detect the spoken language for every window and decode each with
    #: its own language token (faster-whisper multilingual).
    multilingual: bool = False
    #: punctuation merged into the FOLLOWING word during word-timestamp
    #: assembly (faster-whisper prepend_punctuations).
    prepend_punctuations: str = "\"'“¿([{-"
    #: punctuation merged into the PRECEDING word (append_punctuations).
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、"
    #: cross-attention KV cache storage: "auto" (int8 on CUDA, where the
    #: decoder-layer kernels read it; bf16 on the CPU), "int8", or "bf16".
    kv_cache_dtype: str = "auto"
    #: SELF-attention KV cache storage: "auto" (int8 where the decode steps
    #: run through the decoder-layer kernels, which quantize appended K/V
    #: in-kernel; bf16 elsewhere), "int8", or "bf16".
    self_kv_cache_dtype: str = "auto"
    #: log-mel frontend: "auto" (the mel kernel on CUDA, the FFT version
    #: on the CPU). Kept for config-file compatibility.
    mel_backend: str = "auto"
    #: encoder audio-context policy: "full" pads every window to 30 s
    #: (Whisper's training-time contract, exact faster-whisper semantics);
    #: "bucket" encodes a batch made only of windows <= 16 s at a 16 s
    #: context (T 800), as the JAX engine does.
    audio_ctx: str = "full"


@dataclass
class VadConfig:
    """VAD gating knobs (reference exposes vad_filter / vad_parameters:
    final_optimized_transcriber.py:440, complete_fixed_whisper.py:744-748)."""

    enabled: bool = True
    #: frame scorer: "auto" (learned net when weights are shipped, else the
    #: adaptive-energy detector), "learned", or "energy".
    backend: str = "auto"
    threshold: float = 0.5
    neg_threshold: Optional[float] = None
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 500
    speech_pad_ms: int = 200
    max_speech_duration_s: float = 30.0


@dataclass
class ChunkingConfig:
    """Long-audio chunk plan (reference: 3-minute chunks with 5 s overlap,
    final_optimized_transcriber.py:206-207; legacy 240 s/10 s,
    complete_fixed_whisper.py:684-686)."""

    chunk_length_minutes: float = 3.0
    overlap_seconds: float = 5.0
    #: overlap reconciliation: "drop" (final_optimized_transcriber.py:537-556)
    #: or "merge" (complete_fixed_whisper.py:880-902).
    overlap_strategy: str = "drop"


@dataclass
class ParallelConfig:
    """Device-mesh layout. Replaces the reference's worker-thread heuristics
    (final_optimized_transcriber.py:219-240) with explicit mesh axes."""

    #: number of devices along the data axis; 0 = all available.
    data_axis: int = 0
    #: windows batched per device per step.
    windows_per_device: int = 8
    #: mesh axis names.
    axis_names: tuple = ("data",)


@dataclass
class DiarizeConfig:
    """Speaker diarization (reference: pyannote/speaker-diarization-3.1,
    conversation_transcriber.py:85-98)."""

    enabled: bool = True
    model: str = "diarization-tpu-v1"
    min_speakers: Optional[int] = None
    max_speakers: Optional[int] = None
    #: None = per-backend default (0.53 for the trained embedding net,
    #: pyannote's 0.7045 for the classical mel-stats space) — see
    #: DiarizationPipeline.NEURAL_THRESHOLD.
    clustering_threshold: Optional[float] = None


@dataclass
class PipelineConfig:
    """Full-pipeline knobs (reference: conversation_transcriber.py:24-30)."""

    confidence_threshold: float = 0.7  # reference config.py:24
    output_formats: tuple = ("html", "json", "srt")  # reference config.py:23
    output_dir: str = "conversation_outputs"  # reference config.py:35
    run_llm_analysis: bool = True
    pipeline_version: str = "2.0.0-tpu"


@dataclass
class AnalyzeConfig:
    """LLM meeting analytics (reference: meeting_analyzer.py:71-84)."""

    api_key_env: str = "OPENAI_API_KEY"
    base_url: str = "https://api.openai.com/v1"
    model: str = "gpt-4o"
    max_tokens: int = 8192
    temperature: float = 0.3


@dataclass
class ServerConfig:
    """Job-queue API server (reference: api_server.py:348-364)."""

    host: str = "0.0.0.0"
    port: int = 8001
    output_root: str = "api_outputs"
    job_store_path: str = "api_jobs.json"
    max_concurrent_jobs: int = 2
    max_upload_mb: int = 2048


@dataclass
class AriesConfig:
    """Root configuration."""

    model: ModelConfig = field(default_factory=ModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    vad: VadConfig = field(default_factory=VadConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    diarize: DiarizeConfig = field(default_factory=DiarizeConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    analyze: AnalyzeConfig = field(default_factory=AnalyzeConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    hf_token: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Layered loading:  defaults < env < file < overrides
# ---------------------------------------------------------------------------

#: env-var name -> dotted config path (superset of reference config.py:11-38).
_ENV_MAP = {
    "WHISPER_MODEL_PATH": "model.name",
    "ARIES_MODEL": "model.name",
    "ARIES_MODEL_CACHE": "model.cache_dir",
    "ARIES_COMPUTE_TYPE": "model.compute_type",
    "DEFAULT_LANGUAGE": "decode.language",
    "ARIES_LANGUAGE": "decode.language",
    "ARIES_BEAM_SIZE": "decode.beam_size",
    "DEFAULT_CONFIDENCE_THRESHOLD": "pipeline.confidence_threshold",
    "DEFAULT_OUTPUT_FORMATS": "pipeline.output_formats",
    "OUTPUT_DIR": "pipeline.output_dir",
    "DIARIZATION_MODEL_NAME": "diarize.model",
    "ARIES_SERVER_PORT": "server.port",
    "HF_TOKEN": "hf_token",
    "HUGGING_FACE_HUB_TOKEN": "hf_token",
}


def _set_dotted(cfg: AriesConfig, path: str, value: Any) -> None:
    obj: Any = cfg
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    current = getattr(obj, leaf)
    # Coerce strings from env/file toward the field's existing type.
    if isinstance(value, str):
        if isinstance(current, bool):
            value = value.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int) and not isinstance(current, bool):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        elif isinstance(current, tuple):
            value = tuple(v.strip() for v in value.split(",") if v.strip())
    elif isinstance(value, list):
        value = tuple(value)
    setattr(obj, leaf, value)


def _apply_mapping(cfg: AriesConfig, mapping: dict, prefix: str = "") -> None:
    for key, val in mapping.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            _apply_mapping(cfg, val, prefix=f"{path}.")
        else:
            _set_dotted(cfg, path, val)


def load_config(
    config_file: Optional[str] = None,
    overrides: Optional[dict] = None,
    env: Optional[dict] = None,
) -> AriesConfig:
    """Build the config with precedence defaults < env < file < overrides.

    ``overrides`` uses dotted keys ("decode.beam_size") or nested dicts.
    """
    cfg = AriesConfig()
    env = dict(os.environ) if env is None else env
    for env_name, path in _ENV_MAP.items():
        if env_name in env and env[env_name] != "":
            _set_dotted(cfg, path, env[env_name])
    if config_file:
        p = Path(config_file)
        if p.exists():
            _apply_mapping(cfg, json.loads(p.read_text()))
    if overrides:
        for key, val in overrides.items():
            if isinstance(val, dict):
                _apply_mapping(cfg, val, prefix=f"{key}.")
            elif val is not None:
                _set_dotted(cfg, key, val)
    return cfg


def write_default_config(path: str = "aries_config.json",
                         cfg: Optional[AriesConfig] = None) -> str:
    """Write (and return the path of) a JSON config file with the current
    or default values; an existing file is left as it is."""
    cfg = cfg or AriesConfig()
    p = Path(path)
    if not p.exists():
        p.write_text(json.dumps(cfg.to_dict(), indent=2), encoding="utf-8")
    return str(p)


def print_config(cfg: AriesConfig) -> str:
    """Print and return a human-readable dump, ``hf_token`` masked."""
    lines = ["AriesConfig:"]
    for section_field in dataclasses.fields(cfg):
        val = getattr(cfg, section_field.name)
        if dataclasses.is_dataclass(val):
            lines.append(f"  [{section_field.name}]")
            for f2 in dataclasses.fields(val):
                lines.append(f"    {f2.name} = {getattr(val, f2.name)!r}")
        else:
            shown = "***" if section_field.name == "hf_token" and val else val
            lines.append(f"  {section_field.name} = {shown!r}")
    text = "\n".join(lines)
    print(text)
    return text
