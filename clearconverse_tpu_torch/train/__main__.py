"""Fine-tune CLI: train Whisper on (wav, txt) pairs and export the
reference-compatible whisper-ft overlay.

    python -m clearconverse_tpu_torch.train --data_dir pairs/ --steps 100 \
           --model small.en --export models/

``--data_dir`` holds ``name.wav`` + ``name.txt`` pairs; each pair becomes a
(mel, tokens) example (byte-fallback tokenizer unless vocab files are in the
model dir). The flags, defaults, batch draws and printed lines are the JAX
package's (``python -m clearconverse_tpu.train``), plus ``--device``: the
card unless ``--device cpu``.

``--mesh dxm`` trains on a (data, model) mesh of ranks, one process each:

    torchrun --nproc-per-node 8 -m clearconverse_tpu_torch.train \
        --mesh 4x2 --data_dir pairs/ --export models/

Each rank reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and runs on its
own card (``--device cpu``: CPU ranks over gloo); a process group that a
launcher already made is used as it is. Rank 0 alone prints and writes the
checkpoint and the overlay, both of the whole model.
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
                    help="data x model mesh, e.g. 4x2 (under torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed

    from clearconverse_tpu_torch.audio.decode import load_audio
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    from clearconverse_tpu_torch.models.convert import init_whisper, load_whisper
    from clearconverse_tpu_torch.models.tokenizer import load_tokenizer
    from clearconverse_tpu_torch.parallel.sharding import (
        gather_split, shard_whisper, unshard_whisper)
    from clearconverse_tpu_torch.train.finetune import (
        default_optimizer, init_train_state, make_train_step,
        trainable_whisper)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    d, m = (int(v) for v in args.mesh.split("x"))
    mesh, owned = None, False
    if d * m > 1:
        mesh, device, owned = _join_mesh(d, m, device)
        if not mesh.member:
            if owned:
                torch.distributed.destroy_process_group()
            return 0
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    model, dims = load_whisper(args.model_dir, args.model, device)
    if model is None:
        say("no base checkpoint found; training from random init")
        model = init_whisper(dims, 0, device)
    model = trainable_whisper(model)
    if mesh is not None:
        model = shard_whisper(model, mesh)
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
        say("no (wav, txt) pairs found")
        return 1
    say(f"{len(mels)} training pairs")

    L = args.max_tokens
    data_mel = torch.stack(mels)
    data_tok = np.full((len(mels), L), sp.eot, np.int64)
    data_mask = np.zeros((len(mels), L), np.float32)
    for i, ids in enumerate(token_lists):
        data_tok[i, : len(ids)] = ids
        data_mask[i, : len(ids) - 1] = 1.0

    state = init_train_state(model, default_optimizer(model.parameters(),
                                                      lr=args.lr))
    step_fn = make_train_step(dims, mesh=mesh, remat=args.remat,
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
            say(f"step {it}: loss={float(metrics['loss']):.4f} "
                f"acc={float(metrics['accuracy']):.3f}")

    # On a mesh the whole model (and its optimizer moments) is gathered
    # over the model axis on every rank; rank 0 writes it.
    trained, opt_state = state.model, state.optimizer.state_dict()
    if mesh is not None and (args.checkpoint or args.export):
        trained = unshard_whisper(state.model, mesh)
        names = [n for n, _ in state.model.named_parameters()]
        opt_state["state"] = {
            i: {k: (gather_split(names[i], v, mesh)
                    if k in ("exp_avg", "exp_avg_sq") else v)
                for k, v in moments.items()}
            for i, moments in opt_state["state"].items()}
    if args.checkpoint and lead:
        from clearconverse_tpu_torch.train.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, trained, opt_state, state.step)
        say(f"checkpoint → {args.checkpoint}")
    if args.export and lead:
        from clearconverse_tpu_torch.train.checkpoint import export_whisper_ft
        path = export_whisper_ft(trained, args.export)
        say(f"whisper-ft overlay → {path}")
    if owned:
        torch.distributed.destroy_process_group()
    return 0


def _join_mesh(d: int, m: int, device):
    """This rank's ``d × m`` mesh: from the process group a launcher made,
    or a new one from torchrun's environment (``owned``). Returns (mesh,
    this rank's device, owned). Raises when the world is too small; warns
    when ranks are left idle."""
    import torch
    import torch.distributed as dist

    from clearconverse_tpu_torch.parallel.mesh import (
        build_mesh, init_process_group)

    owned = not dist.is_initialized()
    if owned:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--mesh {d}x{m} runs one process per rank: start it with "
                f"torchrun --nproc-per-node {d * m} -m "
                "clearconverse_tpu_torch.train ...")
        world = int(os.environ["WORLD_SIZE"])
        devices = ["cpu"] * world if device.type == "cpu" else None
        device = init_process_group(devices)
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if world < d * m:
        raise RuntimeError(f"--mesh {d}x{m} needs {d * m} ranks, the world "
                           f"has {world}")
    if d * m < world and dist.get_rank() == 0:
        print(f"WARNING: --mesh {d}x{m} uses {d * m} of {world} ranks "
              f"({world - d * m} idle); use --mesh with data*model="
              f"{world} to train on all of them")
    return build_mesh(d, m, devices=[device] * world), device, owned


if __name__ == "__main__":
    raise SystemExit(main())
