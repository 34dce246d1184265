"""The port's counterpart of the root ``__graft_entry__.entry()``.

``entry()`` returns ``(forward, (model, mel, tokens))``: ``forward`` is one
full teacher-forced pass of Whisper — the encoder (kernel K2 on the card),
the cross-attention K/V and a causal prefill of the 21 prompt tokens — and
the arguments are a seeded model, one 30 s log-mel window from a numpy seed
and the token prompt of the JAX entry. The defaults are the JAX entry's:
small.en dims in bf16, on the card; ``dims``, ``dtype`` and ``device`` let a
test run it small, at f32, on the CPU. The JAX file's multi-device dry run
has no counterpart yet (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import numpy as np
import torch


def entry(dims=None, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import (
        WhisperDims, decoder_forward, init_kv_cache, model_dims,
        precompute_cross_kv, whisper_encode)

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    dims: WhisperDims = dims or model_dims("small.en")
    model = init_whisper(dims, 0, device)

    @torch.inference_mode()
    def forward(model, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Encoder + decoder prefill → logits [B, L, n_vocab] f32."""
        audio = whisper_encode(model, mel, dims, dtype)
        cross_kv = precompute_cross_kv(model, audio, dims.n_text_head)
        B, L = tokens.shape
        dev = tokens.device
        kv = init_kv_cache(dims, B, L, dtype, device=dev)
        pos = torch.arange(L, device=dev)[None, :].expand(B, L)
        k = torch.arange(L, device=dev)[None, None, None, :]
        q = torch.arange(L, device=dev)[None, None, :, None]
        causal = torch.where(k <= q, 0.0, -1e9).float()
        logits, _ = decoder_forward(model, tokens, pos, 0, kv, cross_kv,
                                    causal, None, dims, dtype)
        return logits

    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, dims.n_mels, 3000)).astype(np.float32)).to(device)
    tokens = torch.tensor([[50257] + list(range(20))], dtype=torch.long,
                          device=device)
    return forward, (model, mel, tokens)
