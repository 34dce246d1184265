"""Fine-tune CLI: train Whisper on (wav, txt) pairs and export the
reference-compatible whisper-ft overlay.

    python -m clearconverse_tpu_torch.train --data_dir pairs/ --steps 100 \
           --model small.en --export models/

``--data_dir`` holds ``name.wav`` + ``name.txt`` pairs; each pair becomes a
(mel, tokens) example (byte-fallback tokenizer unless vocab files are in the
model dir). The flags, defaults, batch draws and printed lines are the JAX
package's (``python -m clearconverse_tpu.train``), plus ``--device``: the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="clearconverse-finetune")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--model", default="small.en")
    ap.add_argument("--model_dir", default="./models")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--max_tokens", type=int, default=128)
    ap.add_argument("--language", default="en",
                    help="dataset language code (multilingual models: "
                    "sets the <|lang|> prompt token inference will use)")
    ap.add_argument("--export", help="export whisper-ft overlay to this dir")
    ap.add_argument("--checkpoint", help="training checkpoint file "
                    "(torch.save of params, optimizer state and step)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute forward activations in the backward "
                    "pass (torch.utils.checkpoint): ~1/3 more FLOPs for the "
                    "activation memory back")
    ap.add_argument("--accum_steps", type=int, default=1,
                    help="gradient accumulation microbatches per update "
                    "(exact: unnormalized sums divide by the global token "
                    "count); --batch must divide evenly")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model mesh; only 1x1 is ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from clearconverse_tpu_torch.audio.decode import load_audio
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    from clearconverse_tpu_torch.models.convert import init_whisper, load_whisper
    from clearconverse_tpu_torch.models.tokenizer import load_tokenizer
    from clearconverse_tpu_torch.train.finetune import (
        default_optimizer, init_train_state, make_train_step,
        trainable_whisper)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training on a device mesh is not ported "
            "yet: ROADMAP.md queue 1, item 9")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")

    model, dims = load_whisper(args.model_dir, args.model, device)
    if model is None:
        print("no base checkpoint found; training from random init")
        model = init_whisper(dims, 0, device)
    model = trainable_whisper(model)
    tok = load_tokenizer(args.model_dir, english=args.model.endswith(".en"))
    sp = tok.specials
    # Train on the prompt prefix inference uses (bundle._prompt_batch): bare
    # [sot] for .en models, [sot, <|lang|>, <|transcribe|>] for multilingual
    # ones, each followed by <|notimestamps|>.
    if sp.english_only:
        prefix = [sp.sot, sp.no_timestamps]
    else:
        prefix = list(sp.sot_sequence(sp.language_token(args.language))) \
            + [sp.no_timestamps]

    # The dataset: mel [N, n_mels, 3000] on the device (kernel K1 for a
    # CUDA tensor); tokens = [prefix, text..., eot].
    mels, token_lists = [], []
    for name in sorted(os.listdir(args.data_dir)):
        if not name.endswith(".wav"):
            continue
        txt = os.path.join(args.data_dir, name[:-4] + ".txt")
        if not os.path.exists(txt):
            continue
        wave, _ = load_audio(os.path.join(args.data_dir, name), denoise=False,
                             device=device)
        mels.append(log_mel_auto(pad_or_trim(wave[None], 30 * 16000),
                                 dims.n_mels)[0])
        with open(txt, encoding="utf-8") as fh:
            text = fh.read().strip()
        token_lists.append(prefix + tok.encode(text)[
            : args.max_tokens - len(prefix) - 1] + [sp.eot])
    if not mels:
        print("no (wav, txt) pairs found")
        return 1
    print(f"{len(mels)} training pairs")

    L = args.max_tokens
    data_mel = torch.stack(mels)
    data_tok = np.full((len(mels), L), sp.eot, np.int64)
    data_mask = np.zeros((len(mels), L), np.float32)
    for i, ids in enumerate(token_lists):
        data_tok[i, : len(ids)] = ids
        data_mask[i, : len(ids) - 1] = 1.0

    state = init_train_state(model, default_optimizer(model.parameters(),
                                                      lr=args.lr))
    step_fn = make_train_step(dims, remat=args.remat,
                              accum_steps=args.accum_steps)

    rng = np.random.default_rng(0)
    for it in range(args.steps):
        pick = rng.integers(0, len(mels), args.batch)
        batch = {
            "mel": data_mel[torch.from_numpy(pick).to(device)],
            "tokens": torch.from_numpy(data_tok[pick]).to(device),
            "targets": torch.from_numpy(
                np.roll(data_tok[pick], -1, axis=1)).to(device),
            "loss_mask": torch.from_numpy(data_mask[pick]).to(device),
        }
        metrics = step_fn(state, batch)
        if it % 10 == 0 or it == args.steps - 1:
            print(f"step {it}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}")

    if args.checkpoint:
        from clearconverse_tpu_torch.train.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, state.model, state.optimizer,
                        state.step)
        print(f"checkpoint → {args.checkpoint}")
    if args.export:
        from clearconverse_tpu_torch.train.checkpoint import export_whisper_ft
        path = export_whisper_ft(state.model, args.export)
        print(f"whisper-ft overlay → {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
