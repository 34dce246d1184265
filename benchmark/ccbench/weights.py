"""Weights made from ``--seed``, the same values for both sides: Whisper,
PyanNet and ECAPA.

The benchmark lists the tensors of a Whisper of the configuration's widths
under openai-whisper's names (``encoder.blocks.0.attn.q.weight``, ...),
draws them on the card from one ``torch.Generator`` in one call, and
rounds each to the type it is served in: layer norms in float32, every
other tensor in bfloat16. ``fill_module`` copies them into the program's
module by name; the reference reads the same dictionary, widened to
float32.

Draws: matmul and convolution weights normal with std fan_in^-0.5,
biases normal with std 0.02, layer-norm gains 1 + N(0, 0.1^2) and offsets
N(0, 0.02^2), token and text-position embeddings std d^-0.5, and the
encoder's fixed sinusoid table, as openai-whisper builds it.

The speaker models are listed the same way under the names of the
program's weight trees (``pyannet_spec``, ``ecapa_spec``), drawn from
streams of their own and served in float32: weights std fan_in^-0.5,
biases std 0.02, norm gains 1 + N(0, 0.1^2), batch-norm running means
N(0, 0.1^2) and variances exp(N(0, 0.2^2)), and SincNet's band edges at
their mel-spaced initial values. ``fill_tree`` writes them over the
program's own draw.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# (name, shape, kind); kind picks the draw and the served type.
Spec = List[Tuple[str, Tuple[int, ...], str]]

# Each model draws from a stream of its own.
STREAM = {"whisper": 0, "pyannet": 1 << 40, "ecapa": 2 << 40}


def whisper_spec(dims: dict) -> Spec:
    d_a, d_t = dims["d_model"], dims["d_model"]
    f_a, f_t = dims["encoder_ffn_dim"], dims["decoder_ffn_dim"]
    spec: Spec = [
        ("encoder.conv1.weight", (d_a, dims["num_mel_bins"], 3), "conv"),
        ("encoder.conv1.bias", (d_a,), "bias"),
        ("encoder.conv2.weight", (d_a, d_a, 3), "conv"),
        ("encoder.conv2.bias", (d_a,), "bias"),
        ("encoder.pos", (dims["max_source_positions"], d_a), "sinusoid"),
    ]

    def block(p: str, d: int, f: int, cross: bool):
        parts = [("attn", "attn_ln")] + ([("cross", "cross_ln")] if cross else [])
        for att, ln in parts:
            spec.extend([(f"{p}.{ln}.weight", (d,), "ln_gain"),
                         (f"{p}.{ln}.bias", (d,), "ln_bias"),
                         (f"{p}.{att}.q.weight", (d, d), "linear"),
                         (f"{p}.{att}.q.bias", (d,), "bias"),
                         (f"{p}.{att}.k.weight", (d, d), "linear"),
                         (f"{p}.{att}.v.weight", (d, d), "linear"),
                         (f"{p}.{att}.v.bias", (d,), "bias"),
                         (f"{p}.{att}.out.weight", (d, d), "linear"),
                         (f"{p}.{att}.out.bias", (d,), "bias")])
        spec.extend([(f"{p}.mlp_ln.weight", (d,), "ln_gain"),
                     (f"{p}.mlp_ln.bias", (d,), "ln_bias"),
                     (f"{p}.mlp.fc1.weight", (f, d), "linear"),
                     (f"{p}.mlp.fc1.bias", (f,), "bias"),
                     (f"{p}.mlp.fc2.weight", (d, f), "linear"),
                     (f"{p}.mlp.fc2.bias", (d,), "bias")])

    for i in range(dims["encoder_layers"]):
        block(f"encoder.blocks.{i}", d_a, f_a, False)
    spec.extend([("encoder.ln_post.weight", (d_a,), "ln_gain"),
                 ("encoder.ln_post.bias", (d_a,), "ln_bias"),
                 ("decoder.tok", (dims["vocab_size"], d_t), "embed"),
                 ("decoder.pos", (dims["max_target_positions"], d_t), "embed")])
    for i in range(dims["decoder_layers"]):
        block(f"decoder.blocks.{i}", d_t, f_t, True)
    spec.extend([("decoder.ln.weight", (d_t,), "ln_gain"),
                 ("decoder.ln.bias", (d_t,), "ln_bias")])
    return spec


def pyannet_spec(d: dict) -> Spec:
    """pyannote's PyanNet at the widths ``d`` (the configuration's
    ``pyannet``): SincNet (band edges, instance norms, two convolutions),
    a bidirectional LSTM in torch's layout, the linear stack [in, out] and
    the powerset classifier."""
    S, C, K = d["sinc_filters"], d["conv_channels"], d["conv_kernel"]
    H = d["lstm_hidden"]
    spec: Spec = [("sincnet.wav_norm.g", (1,), "ln_gain"),
                  ("sincnet.wav_norm.b", (1,), "ln_bias"),
                  ("sincnet.low_hz", (S // 2,), "sinc_low"),
                  ("sincnet.band_hz", (S // 2,), "sinc_band"),
                  ("sincnet.norm0.g", (S,), "ln_gain"),
                  ("sincnet.norm0.b", (S,), "ln_bias")]
    c_in = S
    for i in (1, 2):
        spec.extend([(f"sincnet.conv{i}.w", (C, c_in, K), "conv"),
                     (f"sincnet.conv{i}.b", (C,), "bias"),
                     (f"sincnet.norm{i}.g", (C,), "ln_gain"),
                     (f"sincnet.norm{i}.b", (C,), "ln_bias")])
        c_in = C
    n_in = C
    for li in range(d["lstm_layers"]):
        for sfx in ("", "_reverse"):
            spec.extend([(f"lstm.weight_ih_l{li}{sfx}", (4 * H, n_in), "linear"),
                         (f"lstm.weight_hh_l{li}{sfx}", (4 * H, H), "linear"),
                         (f"lstm.bias_ih_l{li}{sfx}", (4 * H,), "bias"),
                         (f"lstm.bias_hh_l{li}{sfx}", (4 * H,), "bias")])
        n_in = 2 * H
    for i, ld in enumerate(d["linear_dims"]):
        spec.extend([(f"linear.{i}.w", (n_in, ld), "linear_io"),
                     (f"linear.{i}.b", (ld,), "bias")])
        n_in = ld
    spec.extend([("classifier.w", (n_in, d["n_classes"]), "linear_io"),
                 ("classifier.b", (d["n_classes"],), "bias")])
    return spec


def ecapa_spec(d: dict) -> Spec:
    """speechbrain's ECAPA-TDNN at the widths ``d`` (the configuration's
    ``ecapa``): convolutions [out, in, k] with biases, batch norms with
    running statistics, three SE-Res2Net blocks, aggregation, attentive
    statistics pooling and the embedding layer."""
    C, M, A = d["channels"], d["mfa_channels"], d["attention_channels"]
    spec: Spec = []

    def conv(name, k, c_in, c_out):
        spec.extend([(f"{name}.w", (c_out, c_in, k), "conv"),
                     (f"{name}.b", (c_out,), "bias")])

    def bn(name, c):
        spec.extend([(f"{name}.g", (c,), "ln_gain"), (f"{name}.b", (c,), "ln_bias"),
                     (f"{name}.mean", (c,), "bn_mean"),
                     (f"{name}.var", (c,), "bn_var")])

    conv("conv1", 5, d["n_mels"], C)
    bn("bn1", C)
    width = C // d["res2net_scale"]
    for i in range(len(d["dilations"])):
        p = f"blocks.{i}"
        conv(f"{p}.conv_in", 1, C, C)
        bn(f"{p}.bn_in", C)
        for j in range(d["res2net_scale"] - 1):
            conv(f"{p}.res2.{j}", 3, width, width)
        for j in range(d["res2net_scale"] - 1):
            bn(f"{p}.res2_bn.{j}", width)
        conv(f"{p}.conv_out", 1, C, C)
        bn(f"{p}.bn_out", C)
        conv(f"{p}.se.fc1", 1, C, A)
        conv(f"{p}.se.fc2", 1, A, C)
    conv("mfa", 1, 3 * C, M)
    bn("mfa_bn", M)
    conv("asp.conv1", 1, 3 * M, A)
    bn("asp.bn1", A)
    conv("asp.conv2", 1, A, M)
    bn("asp_bn", 2 * M)
    conv("fc", 1, 2 * M, d["embedding_dim"])
    return spec


def sinc_bands(n_bands: int, sr: int = 16000):
    """ParamSincFB's initial band edges: mel-spaced (HTK) over [30 Hz,
    sr/2 - 100 Hz]; returns (low_hz, band_hz)."""
    mel = np.linspace(2595.0 * np.log10(1 + 30.0 / 700),
                      2595.0 * np.log10(1 + (sr / 2 - 100.0) / 700), n_bands + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """openai-whisper's encoder position table (max timescale 10000)."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def served_dtype(kind: str) -> torch.dtype:
    return torch.float32 if kind.startswith("ln_") else torch.bfloat16


def make_weights(spec: Spec, seed: int, device, model: str = "whisper",
                 served=served_dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor in its served type} from one normal draw of every
    element, from ``model``'s own stream. Seeds above 64 bits are folded
    in."""
    gen = torch.Generator(device=device).manual_seed(
        (seed + STREAM[model]) % (1 << 63))
    total = sum(math.prod(shape) for _, shape, _ in spec)
    draw = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        z = draw[at: at + n].view(shape)
        at += n
        if kind == "linear":
            v = z * shape[1] ** -0.5
        elif kind == "linear_io":
            v = z * shape[0] ** -0.5
        elif kind == "conv":
            v = z * (shape[1] * shape[2]) ** -0.5
        elif kind == "bias" or kind == "ln_bias":
            v = z * 0.02
        elif kind == "ln_gain":
            v = 1.0 + 0.1 * z
        elif kind == "embed":
            v = z * shape[1] ** -0.5
        elif kind == "bn_mean":
            v = 0.1 * z
        elif kind == "bn_var":
            v = torch.exp(0.2 * z)
        elif kind == "sinusoid":
            v = torch.from_numpy(sinusoids(*shape)).to(device)
        elif kind in ("sinc_low", "sinc_band"):
            v = torch.from_numpy(sinc_bands(shape[0])[kind == "sinc_band"]).to(device)
        else:
            raise ValueError(f"unknown tensor kind {kind!r}")
        out[name] = v.to(served(kind))
    del draw
    return out


def fill_module(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy every tensor into the program's module parameter of that name;
    the two name sets must be equal, so nothing keeps the program's own
    draw."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) ^ set(weights))
    if missing:
        raise RuntimeError(f"weight names differ from the program's: {missing[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise RuntimeError(f"{name}: program {tuple(p.shape)}, "
                                   f"benchmark {tuple(w.shape)}")
            p.copy_(w)


def f32(kind: str) -> torch.dtype:
    return torch.float32


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{dotted name: tensor} of a tree of dicts, lists, modules and
    tensors (the program's speaker-model weights)."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    if isinstance(tree, torch.nn.Module):
        return {f"{prefix}.{n}": p for n, p in tree.named_parameters()}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def fill_tree(tree, weights: Dict[str, torch.Tensor]) -> None:
    """``fill_module`` for a tree of the program's speaker-model weights."""
    params = flat(tree)
    missing = sorted(set(params) ^ set(weights))
    if missing:
        raise RuntimeError(f"weight names differ from the program's: {missing[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise RuntimeError(f"{name}: program {tuple(p.shape)}, "
                                   f"benchmark {tuple(w.shape)}")
            p.copy_(w)


def speaker_weights(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"pyannet": ..., "ecapa": ...}, each {name: float32 tensor}."""
    return {"pyannet": make_weights(pyannet_spec(config["pyannet"]), seed,
                                    device, "pyannet", f32),
            "ecapa": make_weights(ecapa_spec(config["ecapa"]), seed, device,
                                  "ecapa", f32)}


def reference_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The same draw, widened to float32 for the reference."""
    return {k: v.float() for k, v in make_weights(spec, seed, device).items()}
