"""Pipeline configuration for the PyTorch/CUDA port.

``Config`` is a copy of the JAX package's pipeline hyperparameters (same
fields, same reference defaults). ``TorchConfig`` takes the place of the JAX
package's ``TPUConfig`` and keeps only the knobs the port reads (the
transcription program, the audio wire, diarization), with the same
defaults; ``torch_config_from_env`` mirrors ``tpu_config_from_env`` for them
under a ``CC_TORCH_*`` prefix. ``load_environment`` reads the server's
deployment settings (``.env`` and the environment) as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    """Pipeline hyperparameters (reference back/api.py:113-135, same defaults)."""

    auth_token: Optional[str] = None
    target_sample_rate: int = 16000
    min_segment_duration: float = 0.45
    overlap_threshold: float = 0.50
    condition_on_previous_text: bool = True
    merge_gap_threshold: float = 0.50
    max_embedding_segments: int = 100
    use_vad_refinement: bool = True
    noise_reduction_amount: float = 0.50
    use_speaker_embeddings: bool = True
    temperature: float = 0.1
    max_speakers: int = 2
    min_speakers: int = 1
    whisper_model_size: str = "small.en"
    sliding_window_size: float = 0.80
    sliding_window_step: float = 0.40
    secondary_diarization_threshold: float = 0.30
    min_overlap_duration_for_separation: float = 0.50
    enhance_separated_audio: bool = True
    speaker_embedding_threshold: float = 0.40
    transcription_batch_size: int = 32
    transcribe_overlaps_individually: bool = True

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class TorchConfig:
    """Execution knobs of the port on a CUDA card."""

    # Duration buckets (seconds) that segments are padded into before batching.
    duration_buckets: tuple = (5.0, 10.0, 30.0)
    # Max decoded tokens per segment (Whisper's text context is 448).
    max_decode_tokens: int = 224
    # Cap on the temperature ladder when the caller passes a TUPLE
    # temperature; a scalar temperature is one rung (whisper semantics).
    max_fallback_attempts: int = 3
    # Samples per row on sampling rungs (temperature > 0), best kept by
    # sum_logprob / length (whisper best_of + MaximumLikelihoodRanker).
    best_of: int = 5
    # Beam width on greedy rungs; 0/1 = plain greedy. Beam search is not
    # part of this port yet, so a value > 1 raises at decode time.
    beam_size: int = 0
    # Whisper's silence skip rule (transcribe defaults).
    no_speech_threshold: float = 0.6
    logprob_threshold: float = -1.0
    # Pad every segment to whisper's full 30 s window (reference numerics).
    pad_to_full_window: bool = True
    # Cross-attention KV storage width (16, 8 or 4).
    cross_kv_bits: int = 8
    # Self-attention cache width (16 or 8).
    self_kv_bits: int = 16
    # "bfloat16" or "float32" for the matmuls.
    compute_dtype: str = "bfloat16"
    # Host->device audio wire: 0 = lossless delta bit-packing (audio/pack.py;
    # raw int16 when no delta order fits 13 bits or the native packer is
    # missing), 16 = raw int16, 8 = mu-law (audio/wire.py, lossy, opt-in).
    wire_bits: int = 0
    # Download the gated audio on a worker thread that starts at the first
    # byte access (True) or inside the load stage (False).
    host_async_download: bool = True
    # Segmentation binarization hysteresis and the AHC cosine-distance merge
    # threshold; None = the 0.5 / 0.5 / 0.7 defaults of pipeline/diarize.
    diarization_onset: Optional[float] = None
    diarization_offset: Optional[float] = None
    diarization_cluster_threshold: Optional[float] = None
    # Transcription language for multilingual models; .en models ignore it.
    language: Optional[str] = "en"


def _flag(v: str) -> bool:
    return v not in ("0", "false", "False")


def torch_config_from_env(env: Optional[dict] = None) -> TorchConfig:
    """TorchConfig with ``CC_TORCH_*`` environment overrides."""
    src = env if env is not None else os.environ
    kw = {}
    for var, field, cast in (
        ("CC_TORCH_CROSS_KV_BITS", "cross_kv_bits", int),
        ("CC_TORCH_SELF_KV_BITS", "self_kv_bits", int),
        ("CC_TORCH_WIRE_BITS", "wire_bits", int),
        ("CC_TORCH_MAX_FALLBACK", "max_fallback_attempts", int),
        ("CC_TORCH_BEST_OF", "best_of", int),
        ("CC_TORCH_BEAM_SIZE", "beam_size", int),
        ("CC_TORCH_COMPUTE_DTYPE", "compute_dtype", str),
        ("CC_TORCH_PAD_FULL_WINDOW", "pad_to_full_window", _flag),
        ("CC_TORCH_HOST_ASYNC", "host_async_download", _flag),
        ("CC_TORCH_LANGUAGE", "language",
         lambda v: None if v == "auto" else v),
    ):
        raw = src.get(var)
        if raw not in (None, ""):
            kw[field] = cast(raw)
    return TorchConfig(**kw)


def parse_env_file(path: str) -> dict:
    """Tiny .env parser: comments, blank lines, ``KEY=VALUE`` and optional
    surrounding quotes."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
                val = val[1:-1]
            out[key] = val
    return out


def load_environment() -> dict:
    """Reference back/api.py:77-92: read ``ENV_FILE`` (default ``.env``),
    overlay onto os.environ-derived settings, return the serving config."""
    env_file = os.environ.get("ENV_FILE", ".env")
    file_vars = parse_env_file(env_file)

    def get(key: str, default: str = "") -> str:
        return os.environ.get(key, file_vars.get(key, default))

    return {
        "api_host": get("API_HOST", "0.0.0.0"),
        "api_port": int(get("API_PORT", "8000")),
        "cors_origins": get("CORS_ORIGINS", "*"),
        "model_cache_dir": get("MODEL_CACHE_DIR", "./models"),
        "hf_auth_token": get("HF_AUTH_TOKEN", "") or None,
    }
