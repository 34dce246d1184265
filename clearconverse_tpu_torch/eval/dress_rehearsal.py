"""Full-scale checkpoint dress rehearsal for the port.

The reference downloads pretrained Whisper small.en, the pyannote
segmentation model, the speechbrain ECAPA embedder and the RE-SepFormer
triplet on first start. Without a network, every port run would otherwise
use the seeded random-init fallback, and the converter → device path would
never run at production scale. This module writes checkpoints that are real
in every respect but the trained values:

  * real dims   — ``model_dims("small.en")``, ``EcapaDims()``,
                  ``PyannetDims()``, ``SepformerDims()``;
  * real format — openai ``{size}.pt`` with its ``dims`` dict and fp16
                  tensors, pyannote's lightning ``pytorch_model.bin`` with its
                  ``state_dict`` wrapper and metadata keys, speechbrain state
                  dicts, GPT-2 ``vocab.json`` / ``merges.txt`` at 50,257
                  entries;
  * real layout — the ``model_dir`` tree ``ModelBundle.load_with_progress``
                  discovers.

The weights come from the port's seeded ``init_*`` functions (``torch``
generators; Whisper's draws are made on ``device``), so the values are not
the JAX package's dress rehearsal's; the formats are. Compute cost is that of
trained weights wherever the decode runs a fixed token budget; only the text
differs.

Usage::

    python -m clearconverse_tpu_torch.eval.dress_rehearsal --model-dir ./models
    python -m clearconverse_tpu_torch.eval.dress_rehearsal --model-dir d --tiny \
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch


def _tensorize(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def write_whisper(model_dir: str, size: str, seed: int, dims=None,
                  device="cuda") -> str:
    """openai-format ``{size}.pt``: ``{"dims": {...}, "model_state_dict":
    fp16 tensors}``, what ``whisper.load_model`` keeps in its cache."""
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import model_dims
    from clearconverse_tpu_torch.train.checkpoint import export_whisper_pt

    dims = dims or model_dims(size)
    model = init_whisper(dims, seed, device)
    return export_whisper_pt(model, dims, os.path.join(model_dir, f"{size}.pt"),
                             half=True)


def write_tokenizer(model_dir: str, n_merges: int = 50000) -> None:
    """GPT-2-format ``vocab.json`` + ``merges.txt``: 256 byte tokens,
    ``n_merges`` merged tokens and endoftext (50,257 entries at the default).

    The merges are synthetic but valid BPE: every merge's parents exist
    before it (two-symbol tokens from pairs of a 128-symbol alphabet, then
    three-symbol extensions), so ``load_tokenizer`` builds rank tables of
    the real assets' size and shape."""
    from clearconverse_tpu_torch.models.tokenizer import _byte_unicode_map

    b2u = _byte_unicode_map()
    base = [b2u[b] for b in range(256)]
    vocab = {tok: i for i, tok in enumerate(base)}
    merges = []
    alpha = base[94:222]  # 128 symbols clear of the specials' spellings
    two_char = []
    for a in alpha:
        for b in alpha:
            if len(merges) >= n_merges:
                break
            merges.append((a, b))
            two_char.append(a + b)
            vocab[a + b] = len(vocab)
        if len(merges) >= n_merges:
            break
    i = 0
    while len(merges) < n_merges:
        t2 = two_char[i % len(two_char)]
        c = alpha[(i // len(two_char)) % len(alpha)]
        tok = t2 + c
        if tok not in vocab:
            merges.append((t2, c))
            vocab[tok] = len(vocab)
        i += 1
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(model_dir, "vocab.json"), "w",
              encoding="utf-8") as fh:
        json.dump(vocab, fh, ensure_ascii=False)
    with open(os.path.join(model_dir, "merges.txt"), "w",
              encoding="utf-8") as fh:
        fh.write("#version: 0.2\n")
        for a, b in merges:
            fh.write(f"{a} {b}\n")


def write_ecapa(model_dir: str, seed: int, dims=None, device="cuda") -> str:
    """speechbrain layout: a raw state dict at
    ``embedding/embedding_model.ckpt``."""
    from clearconverse_tpu_torch.models.ecapa import (
        EcapaDims, ecapa_to_state_dict, init_ecapa)
    params = init_ecapa(dims or EcapaDims(), seed, device)
    d = os.path.join(model_dir, "embedding")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "embedding_model.ckpt")
    torch.save(_tensorize(ecapa_to_state_dict(params)), path)
    return path


def write_pyannet(model_dir: str, seed: int, dims=None, device="cuda",
                  params=None) -> str:
    """pyannote layout: a lightning checkpoint (``state_dict`` wrapper and
    the metadata keys of real 3.x files) at ``segmentation/pytorch_model.bin``.
    ``params`` (the port's PyanNet weights at ``dims``) replaces the seeded
    init, e.g. the crafted frequency-selective weights."""
    from clearconverse_tpu_torch.models.pyannet import (
        PyannetDims, init_pyannet, pyannet_to_state_dict)
    dims = dims or PyannetDims()
    if params is None:
        params = init_pyannet(dims, seed, device)
    d = os.path.join(model_dir, "segmentation")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "pytorch_model.bin")
    torch.save({
        "pytorch-lightning_version": "2.0.0",
        "hyper_parameters": {"sincnet": {"stride": dims.sinc_stride}},
        "state_dict": _tensorize(pyannet_to_state_dict(params)),
    }, path)
    return path


def write_sepformer(model_dir: str, seed: int, dims=None,
                    device="cuda") -> str:
    """The speechbrain triplet at ``resepformer-ft/{encoder,masknet,decoder}
    .ckpt``: the ``Sepformer`` module's submodules carry the triplet's
    names, so each file is one submodule's state dict."""
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    model = init_sepformer(dims or SepformerDims(), seed, device)
    d = os.path.join(model_dir, "resepformer-ft")
    os.makedirs(d, exist_ok=True)
    for name, sub in (("encoder.ckpt", model.encoder),
                      ("masknet.ckpt", model.masknet),
                      ("decoder.ckpt", model.decoder)):
        torch.save({k: v.detach().float().cpu().contiguous()
                    for k, v in sub.state_dict().items()},
                   os.path.join(d, name))
    return d


# Tiny dims: the real formats and layout at test size (the JAX package's).
_TINY_WHISPER = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500,
                     n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                     n_text_ctx=448, n_text_state=64, n_text_head=2,
                     n_text_layer=1)
_TINY_ECAPA = dict(n_mels=24, channels=32, mfa_channels=48,
                   attention_channels=16, embedding_dim=16, res2net_scale=4)
_TINY_PN = dict(sinc_filters=8, conv_channels=8, lstm_hidden=8,
                lstm_layers=1, linear_dims=(8,))
_TINY_SEP = dict(enc_channels=16, d_model=16, n_heads=2, chunk_size=20,
                 n_repeats=1, n_intra_layers=1, n_inter_layers=1)


def populate(model_dir: str, size: str = "small.en", seed: int = 0,
             tiny: bool = False, skip: tuple = (),
             device="cuda") -> Dict[str, str]:
    """Write all four families and the tokenizer assets into ``model_dir``
    (whisper seed ``seed``, ECAPA ``seed + 1``, PyanNet ``seed + 2``,
    RE-SepFormer ``seed + 3``). ``tiny=True`` keeps formats and layout but
    shrinks the dims; families named in ``skip`` are left out. Returns
    {family: path}."""
    from clearconverse_tpu_torch.models.ecapa import EcapaDims
    from clearconverse_tpu_torch.models.pyannet import PyannetDims
    from clearconverse_tpu_torch.models.resepformer import SepformerDims
    from clearconverse_tpu_torch.models.whisper import WhisperDims

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dress_rehearsal: no CUDA device is available; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    os.makedirs(model_dir, exist_ok=True)
    out: Dict[str, str] = {}
    if "whisper" not in skip:
        out["whisper"] = write_whisper(
            model_dir, size, seed,
            WhisperDims(**_TINY_WHISPER) if tiny else None, device)
    if "tokenizer" not in skip:
        write_tokenizer(model_dir, 300 if tiny else 50000)
        out["tokenizer"] = os.path.join(model_dir, "vocab.json")
    if "ecapa" not in skip:
        out["ecapa"] = write_ecapa(
            model_dir, seed + 1, EcapaDims(**_TINY_ECAPA) if tiny else None,
            device)
    if "pyannet" not in skip:
        out["pyannet"] = write_pyannet(
            model_dir, seed + 2, PyannetDims(**_TINY_PN) if tiny else None,
            device)
    if "sepformer" not in skip:
        out["sepformer"] = write_sepformer(
            model_dir, seed + 3, SepformerDims(**_TINY_SEP) if tiny else None,
            device)
    return out


def path_bytes(path: str) -> int:
    """A file's size, or the summed sizes of a directory's files."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model-dir", default="./models")
    ap.add_argument("--size", default="small.en")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny dims, real formats (tests and development)")
    ap.add_argument("--skip", default="",
                    help="comma list: whisper,tokenizer,ecapa,pyannet,sepformer")
    ap.add_argument("--device", default="cuda",
                    help="where the seeded weights are drawn (cuda or cpu)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    paths = populate(args.model_dir, args.size, args.seed, args.tiny,
                     tuple(s for s in args.skip.split(",") if s), args.device)
    for fam, p in sorted(paths.items()):
        print(f"{fam:10s} {p}  {path_bytes(p) / 1e6:.1f} MB")
    print(f"written in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
