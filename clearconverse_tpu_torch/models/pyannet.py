"""PyanNet speaker segmentation in PyTorch.

The role of the reference's pyannote pipelines (VAD, back/api.py:776-781;
segmentation inside speaker-diarization-3.1, back/api.py:783-792): waveform
chunk → per-frame speaker-activity scores. pyannote's PyanNet: a learnable
SincNet band-pass frontend (stride 10, a 3× max-pool after each of three
conv stages → frame hop 270 samples) → a 2-layer BiLSTM → a linear stack →
a powerset classifier (7 classes: ≤3 speakers, ≤2 at once).

Weights are a tree of tensors with the JAX package's structure
(``pyannet_from_jax_params`` carries the JAX pytree over; conv weights turn
to torch's [out, in, k]); the BiLSTM is one ``nn.LSTM`` (a cuDNN call on the
card) built from the JAX layout: gates i, f, g, o, ``weight_ih = w_ih.T``,
``weight_hh = w_hh.T``, ``bias_ih = b``, ``bias_hh = 0``. The forward runs
in IEEE f32 (TF32 off), as the JAX reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clearconverse_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class PyannetDims:
    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 2
    linear_dims: Tuple[int, ...] = (128, 128)
    n_classes: int = 7           # powerset(3 speakers, ≤2 simultaneous)
    powerset: bool = True
    sample_rate: int = 16000

    @property
    def frame_hop(self) -> int:
        return self.sinc_stride * self.pool ** 3

    @property
    def frame_hop_seconds(self) -> float:
        return self.frame_hop / self.sample_rate


# Powerset class → speaker members for (3 speakers, ≤2 simultaneous).
POWERSET_CLASSES: List[Tuple[int, ...]] = [
    (), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2)]


def init_pyannet_params(seed: int, dims: PyannetDims = PyannetDims()
                        ) -> Dict[str, Any]:
    """Seeded random init in the JAX package's layout and distributions
    (normal weights scaled by fan-in^-0.5, zero biases, unit norms, the
    ParamSincFB band init), as numpy. The draws come from a CPU
    ``torch.Generator``, so one seed gives the same weights on every
    device (not the JAX package's numbers)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).numpy()

    def lin(n_in, n_out):
        return {"w": normal((n_in, n_out), n_in ** -0.5),
                "b": np.zeros((n_out,), np.float32)}

    def lstm(n_in, hidden):
        s = (n_in + hidden) ** -0.5
        return {"w_ih": normal((n_in, 4 * hidden), s),
                "w_hh": normal((hidden, 4 * hidden), s),
                "b": np.zeros((4 * hidden,), np.float32)}

    def norm(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}

    # ParamSincFB init: HTK-mel-spaced band edges over [30 Hz, sr/2 - 100
    # Hz], one parameter row per cos/sin filter pair.
    cutoff = dims.sinc_filters // 2
    mel = np.linspace(2595.0 * np.log10(1 + 30.0 / 700),
                      2595.0 * np.log10(1 + (dims.sample_rate / 2 - 100.0) / 700),
                      cutoff + 1)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1)
    K, S, C = dims.conv_kernel, dims.sinc_filters, dims.conv_channels
    p: Dict[str, Any] = {
        "sincnet": {
            "wav_norm": norm(1),
            "low_hz": hz[:-1].astype(np.float32),
            "band_hz": np.diff(hz).astype(np.float32),
            "norm0": norm(S),
            "conv1": {"w": normal((K, S, C), (K * S) ** -0.5),
                      "b": np.zeros((C,), np.float32)},
            "norm1": norm(C),
            "conv2": {"w": normal((K, C, C), (K * C) ** -0.5),
                      "b": np.zeros((C,), np.float32)},
            "norm2": norm(C),
        },
        "lstm": [],
        "linear": [],
    }
    n_in = C
    for _ in range(dims.lstm_layers):
        p["lstm"].append({"fwd": lstm(n_in, dims.lstm_hidden),
                          "bwd": lstm(n_in, dims.lstm_hidden)})
        n_in = 2 * dims.lstm_hidden
    for ld in dims.linear_dims:
        p["linear"].append(lin(n_in, ld))
        n_in = ld
    p["classifier"] = lin(n_in, dims.n_classes)
    return p


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), np.float32)).to(device)


@torch.no_grad()
def pyannet_from_jax_params(tree: Dict[str, Any], dims: PyannetDims,
                            device="cuda") -> Dict[str, Any]:
    """The JAX package's PyanNet pytree (numpy leaves) → the port's weights
    on ``device``: conv ``w`` [k, in, out] → [out, in, k], linear ``w``
    stays [in, out], and the BiLSTM stack becomes one ``nn.LSTM``."""
    sn = tree["sincnet"]

    def norm(p):
        return {"g": _t(p["g"], device), "b": _t(p["b"], device)}

    def conv(p):
        return {"w": _t(np.transpose(np.asarray(p["w"]), (2, 1, 0)), device),
                "b": _t(p["b"], device)}

    H = dims.lstm_hidden
    lstm = nn.LSTM(dims.conv_channels, H, num_layers=len(tree["lstm"]),
                   bidirectional=True, batch_first=True)
    for li, layer in enumerate(tree["lstm"]):
        for suffix, half in (("", "fwd"), ("_reverse", "bwd")):
            d = layer[half]
            getattr(lstm, f"weight_ih_l{li}{suffix}").copy_(
                _t(np.asarray(d["w_ih"]).T, "cpu"))
            getattr(lstm, f"weight_hh_l{li}{suffix}").copy_(
                _t(np.asarray(d["w_hh"]).T, "cpu"))
            getattr(lstm, f"bias_ih_l{li}{suffix}").copy_(_t(d["b"], "cpu"))
            getattr(lstm, f"bias_hh_l{li}{suffix}").zero_()
    lstm = lstm.to(device).eval()
    return {
        "sincnet": {
            "wav_norm": norm(sn["wav_norm"]),
            "low_hz": _t(sn["low_hz"], device),
            "band_hz": _t(sn["band_hz"], device),
            "norm0": norm(sn["norm0"]),
            "conv1": conv(sn["conv1"]), "norm1": norm(sn["norm1"]),
            "conv2": conv(sn["conv2"]), "norm2": norm(sn["norm2"]),
        },
        "lstm": lstm,
        "linear": [{"w": _t(p["w"], device), "b": _t(p["b"], device)}
                   for p in tree["linear"]],
        "classifier": {"w": _t(tree["classifier"]["w"], device),
                       "b": _t(tree["classifier"]["b"], device)},
    }


def init_pyannet(dims: PyannetDims = PyannetDims(), seed: int = 0,
                 device="cuda") -> Dict[str, Any]:
    """``init_pyannet_params`` placed on ``device``."""
    return pyannet_from_jax_params(init_pyannet_params(seed, dims), dims,
                                   device)


# ------------------------------------------------------------------ sincnet

def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor, kernel: int,
                 sr: int, min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0) -> torch.Tensor:
    """Learnable analytic band-pass bank [2*nb, 1, kernel] (torch conv
    layout) with asteroid ``ParamSincFB`` semantics: each of the nb bands
    emits a cos-phase and a sin-phase filter, interleaved (cos0, sin0, cos1,
    sin1, ...), so converted checkpoints keep their channel order."""
    low = min_low_hz + torch.abs(low_hz)
    high = torch.clamp(low + min_band_hz + torch.abs(band_hz), min_low_hz,
                       sr / 2)
    band = (high - low)[None, :]                                # [1, nb]

    n = (kernel - 1) // 2
    dev = low_hz.device
    t = (torch.arange(-n, 0, dtype=torch.float32, device=dev) / sr)[:, None]
    # np.hamming(kernel)[:n]: the symmetric window (denominator kernel-1).
    window = 0.54 - 0.46 * torch.cos(
        2 * np.pi * torch.arange(kernel, dtype=torch.float32, device=dev)
        / (kernel - 1))[:n, None]
    two_pi_t = 2 * np.pi * t
    ft_low = low[None, :] * two_pi_t                            # [n, nb]
    ft_high = high[None, :] * two_pi_t
    cos_left = (torch.sin(ft_high) - torch.sin(ft_low)) / (two_pi_t / 2) * window
    cos_filt = torch.cat([cos_left, 2 * band, cos_left.flip(0)], 0) / (2 * band)
    sin_left = (torch.cos(ft_low) - torch.cos(ft_high)) / (two_pi_t / 2) * window
    sin_filt = torch.cat([sin_left, torch.zeros_like(band),
                          -sin_left.flip(0)], 0) / (2 * band)
    filt = torch.stack([cos_filt, sin_filt], dim=-1)            # [K, nb, 2]
    return filt.reshape(kernel, -1).T[:, None, :]               # [2nb, 1, K]


def _instance_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   eps: float = 1e-5) -> torch.Tensor:
    """[B, C, T] per-(instance, channel) normalization over time."""
    mean = x.mean(dim=2, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=2, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * p["g"][None, :, None]
            + p["b"][None, :, None])


def sincnet_forward(p: Dict[str, Any], audio: torch.Tensor,
                    dims: PyannetDims) -> torch.Tensor:
    """[B, T] waveform → [B, frames, conv_channels]."""
    x = _instance_norm(audio[:, None, :], p["wav_norm"])        # [B,1,T]
    filt = sinc_filters(p["low_hz"], p["band_hz"], dims.sinc_kernel,
                        dims.sample_rate)
    x = torch.abs(F.conv1d(x, filt, stride=dims.sinc_stride))
    x = F.leaky_relu(_instance_norm(F.max_pool1d(x, dims.pool), p["norm0"]))
    for conv, norm in (("conv1", "norm1"), ("conv2", "norm2")):
        x = F.conv1d(x, p[conv]["w"], p[conv]["b"])
        x = F.leaky_relu(_instance_norm(F.max_pool1d(x, dims.pool), p[norm]))
    return x.transpose(1, 2)


@torch.no_grad()
def pyannet_forward(params: Dict[str, Any], audio: torch.Tensor,
                    dims: PyannetDims = PyannetDims()) -> torch.Tensor:
    """[B, T] waveform → [B, frames, n_classes] scores: log-probabilities
    in powerset mode, sigmoid probabilities otherwise."""
    with full_f32():
        x = sincnet_forward(params["sincnet"], audio.to(torch.float32), dims)
        x, _ = params["lstm"](x)
        for lin in params["linear"]:
            x = F.leaky_relu(x @ lin["w"] + lin["b"])
        x = x @ params["classifier"]["w"] + params["classifier"]["b"]
    if dims.powerset:
        return F.log_softmax(x, dim=-1)
    return torch.sigmoid(x)


def powerset_to_multilabel(log_probs: torch.Tensor,
                           n_speakers: int = 3) -> torch.Tensor:
    """[B, F, 7] powerset log-probs → [B, F, n_speakers] activity probs."""
    probs = torch.exp(log_probs)
    cols = []
    for spk in range(n_speakers):
        members = [i for i, cls in enumerate(POWERSET_CLASSES) if spk in cls]
        cols.append(probs[..., members].sum(dim=-1))
    return torch.stack(cols, dim=-1)


# ------------------------------------------------------------ checkpoints

def convert_pyannote_pyannet(sd: Dict[str, Any]) -> Dict[str, Any]:
    """pyannote PyanNet lightning state dict → the JAX package's pytree
    layout, numpy leaves (keys like ``sincnet.conv1d.0.filterbank.low_hz_``,
    ``lstm.weight_ih_l0``, ``linear.0.weight``, ``classifier.weight``).
    pyannote 3.x nests the band parameters at ``.filterbank.``; the bare
    spelling of older exports is accepted too."""
    def np_(k):
        v = sd[k]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    def sinc_param(name):
        nested = f"sincnet.conv1d.0.filterbank.{name}"
        return np_(nested if nested in sd else f"sincnet.conv1d.0.{name}")

    p: Dict[str, Any] = {
        "sincnet": {
            "wav_norm": {"g": np_("sincnet.wav_norm1d.weight"),
                         "b": np_("sincnet.wav_norm1d.bias")},
            "low_hz": sinc_param("low_hz_").reshape(-1),
            "band_hz": sinc_param("band_hz_").reshape(-1),
            "norm0": {"g": np_("sincnet.norm1d.0.weight"),
                      "b": np_("sincnet.norm1d.0.bias")},
            "conv1": {"w": np_("sincnet.conv1d.1.weight").transpose(2, 1, 0),
                      "b": np_("sincnet.conv1d.1.bias")},
            "norm1": {"g": np_("sincnet.norm1d.1.weight"),
                      "b": np_("sincnet.norm1d.1.bias")},
            "conv2": {"w": np_("sincnet.conv1d.2.weight").transpose(2, 1, 0),
                      "b": np_("sincnet.conv1d.2.bias")},
            "norm2": {"g": np_("sincnet.norm1d.2.weight"),
                      "b": np_("sincnet.norm1d.2.bias")},
        },
        "lstm": [],
        "linear": [],
    }
    li = 0
    while f"lstm.weight_ih_l{li}" in sd:
        def one(suffix):
            return {
                "w_ih": np_(f"lstm.weight_ih_l{li}{suffix}").T,
                "w_hh": np_(f"lstm.weight_hh_l{li}{suffix}").T,
                "b": (np_(f"lstm.bias_ih_l{li}{suffix}")
                      + np_(f"lstm.bias_hh_l{li}{suffix}")),
            }
        p["lstm"].append({"fwd": one(""), "bwd": one("_reverse")})
        li += 1
    i = 0
    while f"linear.{i}.weight" in sd:
        p["linear"].append({"w": np_(f"linear.{i}.weight").T,
                            "b": np_(f"linear.{i}.bias")})
        i += 1
    p["classifier"] = {"w": np_("classifier.weight").T,
                       "b": np_("classifier.bias")}
    return p


def pyannet_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's PyanNet weights (``pyannet_from_jax_params``) → pyannote's
    lightning state-dict names as f32 numpy arrays: the exact inverse of
    ``convert_pyannote_pyannet``. The ``nn.LSTM`` already carries pyannote's
    per-direction names (``weight_ih_l{i}``, ``..._reverse``) and the i, f,
    g, o gate order; the converter sums the two biases, so the whole bias
    goes to ``bias_ih`` and ``bias_hh`` is zero, as the JAX writer does. The
    band parameters take pyannote 3.x's ``.filterbank.`` nesting, [nb, 1]."""
    sn = params["sincnet"]

    def a(v):
        return np.ascontiguousarray(v.detach().cpu().numpy(), np.float32)

    sd: Dict[str, np.ndarray] = {
        "sincnet.wav_norm1d.weight": a(sn["wav_norm"]["g"]),
        "sincnet.wav_norm1d.bias": a(sn["wav_norm"]["b"]),
        "sincnet.conv1d.0.filterbank.low_hz_": a(sn["low_hz"].reshape(-1, 1)),
        "sincnet.conv1d.0.filterbank.band_hz_": a(sn["band_hz"].reshape(-1, 1)),
    }
    for i in range(3):
        sd[f"sincnet.norm1d.{i}.weight"] = a(sn[f"norm{i}"]["g"])
        sd[f"sincnet.norm1d.{i}.bias"] = a(sn[f"norm{i}"]["b"])
    for i in (1, 2):
        sd[f"sincnet.conv1d.{i}.weight"] = a(sn[f"conv{i}"]["w"])
        sd[f"sincnet.conv1d.{i}.bias"] = a(sn[f"conv{i}"]["b"])
    sd["classifier.weight"] = a(params["classifier"]["w"].T)
    sd["classifier.bias"] = a(params["classifier"]["b"])
    lstm = params["lstm"]
    for li in range(lstm.num_layers):
        for suffix in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{li}{suffix}"] = a(
                getattr(lstm, f"weight_ih_l{li}{suffix}"))
            sd[f"lstm.weight_hh_l{li}{suffix}"] = a(
                getattr(lstm, f"weight_hh_l{li}{suffix}"))
            bias = a(getattr(lstm, f"bias_ih_l{li}{suffix}")
                     + getattr(lstm, f"bias_hh_l{li}{suffix}"))
            sd[f"lstm.bias_ih_l{li}{suffix}"] = bias
            sd[f"lstm.bias_hh_l{li}{suffix}"] = np.zeros_like(bias)
    for i, lin in enumerate(params["linear"]):
        sd[f"linear.{i}.weight"] = a(lin["w"].T)
        sd[f"linear.{i}.bias"] = a(lin["b"])
    return sd


def infer_pyannet_dims(params: Dict[str, Any],
                       fallback: PyannetDims = PyannetDims()) -> PyannetDims:
    """Dims recoverable from a converted pytree's shapes; the sinc kernel,
    stride and pool (absent from the weights) come from ``fallback``."""
    sn = params["sincnet"]
    return dataclasses.replace(
        fallback,
        # Each band parameter row emits a cos/sin filter pair.
        sinc_filters=2 * int(np.shape(sn["low_hz"])[0]),
        conv_kernel=int(np.shape(sn["conv1"]["w"])[0]),
        conv_channels=int(np.shape(sn["conv1"]["w"])[2]),
        lstm_hidden=int(np.shape(params["lstm"][0]["fwd"]["w_hh"])[0]),
        lstm_layers=len(params["lstm"]),
        linear_dims=tuple(int(np.shape(lin["w"])[1])
                          for lin in params["linear"]),
        n_classes=int(np.shape(params["classifier"]["w"])[1]),
    )
