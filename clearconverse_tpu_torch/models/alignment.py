"""Word-level timestamps via cross-attention alignment, in PyTorch.

The reference requests ``word_timestamps=True`` on every transcribe call
(back/api.py:1290); openai-whisper derives them by DTW over
cross-attention weights. As the JAX package's models/alignment.py:

  1. one teacher-forced decoder pass over the generated tokens gives the
     cross-attention weights of the upper half of the decoder layers,
     averaged over heads and layers → [B, T_tok, T_audio];
  2. dynamic time warping on the host aligns each row monotonically to
     audio frames;
  3. token times merge into words by the tokenizer's word pieces.

The pass uses the unquantised cross K/V (projected from the encoder output
here), not the decode's int8 head-major cache, and runs in f32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from clearconverse_tpu_torch.models.whisper import (
    Whisper, WhisperDims, _column, _mlp, _row, _split_heads, attention,
    layer_norm, tensor_parallel)
from clearconverse_tpu_torch.utils.precision import full_f32

AUDIO_FRAME_S = 0.02   # encoder frame = 2 mel hops = 20 ms
# Teacher lengths pad to one of these, as the JAX package's do.
_LEN_BUCKETS = (16, 32, 64, 128, 256, 448)


@torch.no_grad()
def cross_attention_weights(model: Whisper, tokens: torch.Tensor,
                            audio: torch.Tensor, dims: WhisperDims,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Teacher-forced pass → averaged cross-attention [B, T_tok, T_audio]
    from the upper half of the decoder layers. Causal mask −1e9; q and k
    each scaled by d_head**-0.25, whisper's scaling. On a tensor-parallel
    shard each rank attends with its own heads and the head sums meet over
    the model axis."""
    dec = model.decoder
    cdt = compute_dtype
    B, T = tokens.shape
    H = dims.n_text_head
    tp = tensor_parallel(model)
    Hl = H if tp is None else tp.heads(H)
    # Heads split over the model axis: each rank sums its own.
    split = tp is not None and tp.splits(H)
    x = dec.tok[tokens].to(cdt) + dec.pos[:T][None].to(cdt)
    ar = torch.arange(T, device=tokens.device)
    causal = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9)[None, None]
    half = dims.n_text_layer // 2
    collect = []
    for li, blk in enumerate(dec.blocks):
        h = layer_norm(x, blk.attn_ln)
        q, k, v = _column(h, [blk.attn.q, blk.attn.k, blk.attn.v], tp, H)
        x = x + _row(attention(q, k, v, causal, Hl), blk.attn.out, tp, H)

        h = layer_norm(x, blk.cross_ln)
        q, = _column(h, [blk.cross.q], tp, H)
        ck, cv = (t.to(cdt) for t in _column(audio, [blk.cross.k,
                                                     blk.cross.v], tp, H))
        scale = (q.shape[-1] // Hl) ** -0.25
        qh = _split_heads(q, Hl) * scale
        kh = _split_heads(ck, Hl) * scale
        with full_f32():
            logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
            w = torch.softmax(logits, dim=-1)
            if li >= half:                             # [B, T_tok, T_audio]
                collect.append(tp.reduce(w.sum(dim=1)) / H if split
                               else w.mean(dim=1))
            o = torch.einsum("bhqk,bkhd->bqhd", w.to(cdt).float(),
                             _split_heads(cv, Hl).float())
        x = x + _row(o.reshape(q.shape).to(cdt), blk.cross.out, tp, H)
        x = x + _mlp(layer_norm(x, blk.mlp_ln), blk.mlp, tp)
    return torch.stack(collect).mean(dim=0)


def dtw_path(attn: np.ndarray) -> List[Tuple[int, int]]:
    """Monotonic alignment through a [T_tok, T_audio] attention matrix
    (maximise summed attention; moves: diagonal, right, down). The DP runs
    over anti-diagonals; candidate order (diag, left, up) and first-max
    tie-breaking are the scalar formulation's."""
    T, F = attn.shape
    cost = np.full((T + 1, F + 1), -np.inf)
    cost[0, :] = 0.0
    back = np.zeros((T, F), np.int8)
    for d in range(2, T + F + 1):
        i0 = max(1, d - F)
        i1 = min(T, d - 1)
        if i0 > i1:
            continue
        i = np.arange(i0, i1 + 1)
        j = d - i
        diag = cost[i - 1, j - 1]
        left = cost[i, j - 1]
        up = cost[i - 1, j]
        best = np.maximum(diag, np.maximum(left, up))
        b = np.where(diag == best, 0, np.where(left == best, 1, 2))
        cost[i, j] = best + attn[i - 1, j - 1]
        back[i - 1, j - 1] = b
    path = []
    i, j = T - 1, F - 1
    while i >= 0 and j >= 0:
        path.append((i, j))
        b = back[i, j]
        if b == 0:
            i, j = i - 1, j - 1
        elif b == 1:
            j -= 1
        else:
            i -= 1
    return path[::-1]


def token_times(attn: np.ndarray, n_tokens: int,
                frame_s: float = AUDIO_FRAME_S) -> List[Tuple[float, float]]:
    """[T_tok, T_audio] attention → per-token (start, end) seconds."""
    path = dtw_path(attn[:n_tokens])
    starts: Dict[int, int] = {}
    ends: Dict[int, int] = {}
    for ti, fi in path:
        starts.setdefault(ti, fi)
        ends[ti] = fi
    return [(starts.get(t, 0) * frame_s, (ends.get(t, 0) + 1) * frame_s)
            for t in range(n_tokens)]


def word_timestamps(tokenizer, token_ids: List[int],
                    times: List[Tuple[float, float]]) -> List[Dict[str, Any]]:
    """Group token spans into words: a new word starts on a leading-space
    piece (GPT-2 BPE convention) or at the sequence start."""
    words: List[Dict[str, Any]] = []
    for tid, (t0, t1) in zip(token_ids, times):
        piece = tokenizer.decode([tid], skip_special=True)
        if not piece:
            continue
        if words and not piece.startswith(" "):
            words[-1]["word"] += piece
            words[-1]["end"] = t1
        else:
            words.append({"word": piece, "start": t0, "end": t1})
    for w in words:
        w["word"] = w["word"].strip()
    return [w for w in words if w["word"]]


def align_batch(model: Whisper, tokenizer, tokens: np.ndarray,
                lengths: np.ndarray, audio_features: torch.Tensor,
                dims: WhisperDims, sot: int = -1, prefixes=None,
                eot: int = -1) -> List[List[Dict[str, Any]]]:
    """Generated tokens → per-row word timestamp lists.

    ``prefixes`` (per-row token lists) is the conditioning openai-whisper's
    find_alignment replays: the full SOT sequence plus <|notimestamps|>,
    then the text tokens and ``eot``; a bare ``[sot]`` when only ``sot`` is
    given. Teacher lengths pad to ``_LEN_BUCKETS``."""
    B = tokens.shape[0]
    if prefixes is None:
        prefixes = [[sot]] * B
    P = max((len(p) for p in prefixes), default=1)
    max_len = int(lengths.max()) if B else 0
    pad_id = eot if eot >= 0 else (prefixes[0][0] if prefixes else 0)
    need = P + max_len + 1
    total = next((b for b in _LEN_BUCKETS if b >= need), need)
    teacher = np.full((B, total), pad_id, np.int64)
    for b in range(B):
        pre = list(prefixes[b])[-P:]
        teacher[b, P - len(pre): P] = pre
        teacher[b, P: P + lengths[b]] = tokens[b, : lengths[b]]
        if eot >= 0:
            teacher[b, P + lengths[b]] = eot
    attn = cross_attention_weights(
        model, torch.as_tensor(teacher, device=audio_features.device),
        audio_features, dims).cpu().numpy()
    out = []
    for b in range(B):
        n = int(lengths[b])
        if n == 0:
            out.append([])
            continue
        # Token i aligns with the row that PREDICTS it (query input = the
        # previous token), and the row predicting eot is aligned too, so
        # trailing audio attaches to eot: rows [P-1, P+n]; eot's span drops.
        lo = max(P - 1, 0)
        times = token_times(attn[b, lo: lo + n + 1], n + 1)[:n]
        out.append(word_timestamps(tokenizer, list(tokens[b, :n]), times))
    return out
