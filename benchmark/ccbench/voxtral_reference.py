"""Plain Voxtral Mini 3B in float32, the yardstick that decides ``correct``
for family ``voxtral``.

Written from the published model (``mistralai/Voxtral-Mini-3B-2507``: its
``config.json`` and the layer equations of HF's
``VoxtralForConditionalGeneration``) in plain PyTorch. It imports nothing
of the measured program: it reads the benchmark's weight dictionary under
HF's names (``families/voxtral.py``, the same values the program was
given) and the audio, prompt ids and tokens of the program's decode calls.
The audio tower is ``reference.py``'s Whisper encoder, read under
openai-whisper's names.

The model: Whisper large-v3's encoder; 4 consecutive frames a row into
``linear_2(gelu(linear_1(row)))``; the prompt's embeddings with the audio
rows in the places of the ``[AUDIO]`` ids; 30 pre-norm layers of RMSNorm
(eps from the config), grouped-query attention (32 query heads over 8 K/V
heads of 128, RoPE in HF's rotate-half layout, θ from the config) and the
SwiGLU MLP; a final RMSNorm and ``lm_head``. A full forward over the whole
sequence, no cache, no batching of replicas over one prefix.

Every product runs in IEEE float32 (TF32 off). ``fp8=True`` rounds both
operands of every product to float8 e4m3 (tensor-wise scales), the
precision below bf16: the control that must come out as not correct.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ccbench.reference import NEG, Ops, encode, ieee_f32, log_mel, pad_or_trim


def encoder_names(dims: dict) -> Dict[str, str]:
    """{openai-whisper name, as ``reference.encode`` reads it: HF's
    ``audio_tower`` name}."""
    out = {"encoder.conv1.weight": "audio_tower.conv1.weight",
           "encoder.conv1.bias": "audio_tower.conv1.bias",
           "encoder.conv2.weight": "audio_tower.conv2.weight",
           "encoder.conv2.bias": "audio_tower.conv2.bias",
           "encoder.pos": "audio_tower.embed_positions.weight",
           "encoder.ln_post.weight": "audio_tower.layer_norm.weight",
           "encoder.ln_post.bias": "audio_tower.layer_norm.bias"}
    for i in range(dims["audio_config"]["num_hidden_layers"]):
        o, h = f"encoder.blocks.{i}", f"audio_tower.layers.{i}"
        for a, b in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("out", "out_proj")):
            out[f"{o}.attn.{a}.weight"] = f"{h}.self_attn.{b}.weight"
            if a != "k":
                out[f"{o}.attn.{a}.bias"] = f"{h}.self_attn.{b}.bias"
        for a, b in (("attn_ln", "self_attn_layer_norm"),
                     ("mlp_ln", "final_layer_norm")):
            out[f"{o}.{a}.weight"] = f"{h}.{b}.weight"
            out[f"{o}.{a}.bias"] = f"{h}.{b}.bias"
        for a in ("fc1", "fc2"):
            out[f"{o}.mlp.{a}.weight"] = f"{h}.{a}.weight"
            out[f"{o}.mlp.{a}.bias"] = f"{h}.{a}.bias"
    return out


def audio_rows(ops: Ops, w: dict, dims: dict, audio: torch.Tensor,
               target_len: int) -> torch.Tensor:
    """[n, T] waveforms → the adapter's [n, 375, d] rows."""
    a = dims["audio_config"]
    mel = log_mel(pad_or_trim(audio.float(), target_len), a["num_mel_bins"])
    enc_w = {o: w[h] for o, h in encoder_names(dims).items()}
    feats = encode(ops, enc_w, mel,
                   {"encoder_layers": a["num_hidden_layers"],
                    "encoder_attention_heads": a["num_attention_heads"]})
    n, t, d = feats.shape
    rows = feats.reshape(n, t * d // a["intermediate_size"],
                         a["intermediate_size"])
    h = F.gelu(ops.linear(rows, w["multi_modal_projector.linear_1.weight"]))
    return ops.linear(h, w["multi_modal_projector.linear_2.weight"])


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """HF's rotate-half RoPE over the last axis of x [B, heads, L, dh]."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, device=x.device).float()
                           / dh))
    ang = positions.float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    rot = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def lm(p: str) -> str:
    return "language_model.model." + p


def decoder_logits(ops: Ops, w: dict, dims: dict, x: torch.Tensor,
                   last: int) -> torch.Tensor:
    """The decoder over embeddings x [B, L, d] with causal attention at
    positions 0..L-1 → logits [B, last, vocab] of the last ``last``
    positions."""
    t = dims["text_config"]
    B, L, _ = x.shape
    H, KV, dh = (t["num_attention_heads"], t["num_key_value_heads"],
                 t["head_dim"])
    eps, theta = t["rms_norm_eps"], t["rope_theta"]
    pos = torch.arange(L, device=x.device)
    mask = torch.where(pos[None, :] <= pos[:, None], 0.0, NEG)
    for i in range(t["num_hidden_layers"]):
        p = lm(f"layers.{i}")
        h = rms_norm(x, w[f"{p}.input_layernorm.weight"], eps)
        q = ops.linear(h, w[f"{p}.self_attn.q_proj.weight"])
        k = ops.linear(h, w[f"{p}.self_attn.k_proj.weight"])
        v = ops.linear(h, w[f"{p}.self_attn.v_proj.weight"])
        q = rope(q.view(B, L, H, dh).transpose(1, 2), pos, theta)
        k = rope(k.view(B, L, KV, dh).transpose(1, 2), pos, theta)
        v = v.view(B, L, KV, dh).transpose(1, 2)
        # Each K/V head serves H / KV query heads (HF's repeat_kv).
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        s = ops.matmul(q, k.transpose(-1, -2)) * dh ** -0.5 + mask
        o = ops.matmul(torch.softmax(s, dim=-1), v)
        o = o.transpose(1, 2).reshape(B, L, H * dh)
        x = x + ops.linear(o, w[f"{p}.self_attn.o_proj.weight"])
        h = rms_norm(x, w[f"{p}.post_attention_layernorm.weight"], eps)
        g = ops.linear(h, w[f"{p}.mlp.gate_proj.weight"])
        u = ops.linear(h, w[f"{p}.mlp.up_proj.weight"])
        x = x + ops.linear(F.silu(g) * u, w[f"{p}.mlp.down_proj.weight"])
    h = rms_norm(x[:, L - last:], w[lm("norm.weight")], eps)
    return ops.linear(h, w["language_model.lm_head.weight"])


def full_logits(ops: Ops, w: dict, dims: dict, feats: torch.Tensor,
                head: Sequence[int], tail: Sequence[int],
                tokens: torch.Tensor, last: int) -> torch.Tensor:
    """The prompt (``head`` ids, each row's adapter rows ``feats`` [n, 375,
    d], ``tail`` ids) and then ``tokens`` [n, k] through the decoder →
    logits [n, last, vocab] of the last ``last`` positions."""
    emb = w[lm("embed_tokens.weight")]
    dev = feats.device
    n = feats.shape[0]

    def ids(x):
        return emb[torch.as_tensor(list(x), device=dev)][None].expand(n, -1, -1)

    x = torch.cat([ids(head), feats, ids(tail), emb[tokens.long()]], dim=1)
    return decoder_logits(ops, w, dims, x, last)


@torch.no_grad()
def served_logprob_sums(w: dict, dims: dict, audio: torch.Tensor,
                        head: Sequence[int], tail: Sequence[int],
                        tokens: torch.Tensor, lengths: torch.Tensor,
                        rows: List[int], replicas: int,
                        suppress: Sequence[int], max_tokens: int,
                        target_len: int, fp8: bool = False,
                        row_block: int = 8) -> np.ndarray:
    """The sum of log-probabilities of the served tokens of each of
    ``rows`` (indices into the call's U·R rows), teacher-forced: a full
    forward over the prompt (``head`` ids, the row's audio, ``tail`` ids)
    and the row's served tokens.

    ``audio`` [U, T] holds the call's unique rows (row r's is r //
    ``replicas``); ``tokens`` [U·R, max_tokens] and ``lengths`` what the
    call served. A row scores its tokens up to and including the first EOS
    (all ``max_tokens`` when it has none), each with ``suppress`` filled
    with -1e9, the decode's own rule. Returns [len(rows)] float64."""
    ops = Ops(fp8)
    dev = audio.device
    V = w[lm("embed_tokens.weight")].shape[0]
    sup = torch.zeros(V, dtype=torch.bool, device=dev)
    if len(suppress):
        sup[torch.as_tensor(list(suppress), device=dev)] = True
    uniq = sorted({r // replicas for r in rows})
    out = np.zeros(len(rows), np.float64)
    with ieee_f32():
        feats = {}
        for b in range(0, len(uniq), row_block):
            us = uniq[b:b + row_block]
            got = audio_rows(ops, w, dims, audio[us], target_len)
            feats.update({u: got[j] for j, u in enumerate(us)})
        for b in range(0, len(rows), row_block):
            rs = rows[b:b + row_block]
            served = tokens[rs].long().to(dev)
            logits = full_logits(
                ops, w, dims, torch.stack([feats[r // replicas] for r in rs]),
                head, tail, served[:, :max_tokens - 1], max_tokens)
            logits = logits.masked_fill(sup, NEG)
            lp = torch.log_softmax(logits, dim=-1).gather(
                2, served[..., None])[..., 0]
            n = lengths[rs].long().to(dev)
            k = torch.arange(max_tokens, device=dev)[None, :]
            scored = k <= torch.clamp(n, max=max_tokens - 1)[:, None]
            out[b:b + len(rs)] = (lp.double() * scored).sum(1).cpu().numpy()
    return out
