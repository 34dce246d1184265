"""The one default engine factory shared by the serve app and the warmup
CLI, so the warm-up drives exactly the engine that serves.

Keep every default (environment handling, the dev-mode branch, the model
directory) here; serve/app.py and serve/warmup.py must not grow copies."""

from __future__ import annotations

import os


def default_engine_factory():
    """The port's TranscriptionEngine on the card, built from the
    environment (``torch_config_from_env``: ``CC_TORCH_*`` knobs;
    ``WHISPER_MODEL_SIZE``, the transcriber, small.en by default), or the
    dev-backend engine on the CPU when ``CC_TPU_FAKE_MODELS=1``
    (signal-processing stand-ins: the whole pipeline runs with no weights
    and no device code)."""
    from clearconverse_tpu_torch.config import (
        Config, load_environment, torch_config_from_env)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    env = load_environment()
    if os.environ.get("CC_TPU_FAKE_MODELS") == "1":
        from clearconverse_tpu_torch.pipeline.dev_backend import DevModels
        return TranscriptionEngine(
            Config(auth_token=env["hf_auth_token"],
                   noise_reduction_amount=0.0),
            models=DevModels(), device="cpu")
    return TranscriptionEngine(
        Config(auth_token=env["hf_auth_token"],
               whisper_model_size=env["whisper_model_size"]),
        torch_config=torch_config_from_env(),
        model_dir=env["model_cache_dir"])
