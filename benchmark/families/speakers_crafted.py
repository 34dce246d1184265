"""Family ``speakers_crafted``: the program's PyanNet and ECAPA-TDNN, as
family ``speakers`` checks them (``families/speakers.py``: its recorder,
readings, faults and widths, and ``ccbench/speaker_reference.py``), with
PyanNet's weights crafted so that it hears the two voices of the overlap
traffic apart.

Seeded PyanNet weights collapse every frame to one powerset class, so a
run with them never reaches the overlap path. The crafted weights, at the
configuration's PyanNet widths, are the arithmetic of the program's
``pipeline/dev_backend.craft_pyannet_freq_params`` carried to any depth:
SincNet's band 0 on 200-450 Hz (the low voice), band 1 on 1500-2500 Hz
(the high voice), the other bands parked at 6 kHz; both convolutions
centre-tap identities; every LSTM layer a pass-through of its input's
first channels (input and output gates open, forget gate shut, the cell
input twice the input); the first linear layer the mean of the two
directions, the others identities; the classifier maps band 0 to class
(0,), band 1 to (1,), both to (0, 1), with a bias to silence. ECAPA is
drawn from the seed as in ``speakers``. The weights are the same for
both sides of the check, served in float32.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict

import numpy as np
import torch

from ccbench.weights import ecapa_spec, f32, make_weights, pyannet_spec


def _sibling(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"ccbench_families_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_speakers = _sibling("speakers")

STREAM = _speakers.STREAM
FAULTS = _speakers.FAULTS
dims, program_dims = _speakers.dims, _speakers.program_dims
fill, recorder = _speakers.fill, _speakers.recorder


def crafted_pyannet(d: dict) -> Dict[str, np.ndarray]:
    """The frequency-selective PyanNet at the widths ``d`` under the names
    of ``ccbench.weights.pyannet_spec``."""
    S, C, K = d["sinc_filters"], d["conv_channels"], d["conv_kernel"]
    H, lin = d["lstm_hidden"], list(d["linear_dims"])
    nb = S // 2
    if nb < 2 or C < 4 or H < 4 or min(lin) < 4:
        raise ValueError(f"PyanNet widths too small to craft: {d}")
    low_hz = np.full((nb,), 5950.0, np.float32)   # park unused bands at 6 kHz
    band_hz = np.full((nb,), 950.0, np.float32)
    low_hz[0], band_hz[0] = 150.0, 200.0          # band 0: 200-450 Hz
    low_hz[1], band_hz[1] = 1450.0, 950.0         # band 1: 1500-2500 Hz
    w: Dict[str, np.ndarray] = {
        "sincnet.wav_norm.g": np.ones(1, np.float32),
        "sincnet.wav_norm.b": np.zeros(1, np.float32),
        "sincnet.low_hz": low_hz, "sincnet.band_hz": band_hz}
    w["sincnet.norm0.g"] = np.ones(S, np.float32)
    w["sincnet.norm0.b"] = np.zeros(S, np.float32)
    c_in = S
    for i in (1, 2):
        conv = np.zeros((C, c_in, K), np.float32)         # [out, in, k]
        for c in range(min(c_in, C)):
            conv[c, c, K // 2] = 1.0
        w[f"sincnet.conv{i}.w"] = conv
        w[f"sincnet.conv{i}.b"] = np.zeros(C, np.float32)
        w[f"sincnet.norm{i}.g"] = np.ones(C, np.float32)
        w[f"sincnet.norm{i}.b"] = np.zeros(C, np.float32)
        c_in = C
    n_in = C
    for li in range(d["lstm_layers"]):
        w_ih = np.zeros((4 * H, n_in), np.float32)        # gates i, f, g, o
        for c in range(min(n_in, H)):
            w_ih[2 * H + c, c] = 2.0
        b = np.zeros(4 * H, np.float32)
        b[0:H], b[H:2 * H], b[3 * H:] = 10.0, -10.0, 10.0
        for sfx in ("", "_reverse"):
            w[f"lstm.weight_ih_l{li}{sfx}"] = w_ih
            w[f"lstm.weight_hh_l{li}{sfx}"] = np.zeros((4 * H, H), np.float32)
            w[f"lstm.bias_ih_l{li}{sfx}"] = b
            w[f"lstm.bias_hh_l{li}{sfx}"] = np.zeros(4 * H, np.float32)
        n_in = 2 * H
    for i, ld in enumerate(lin):
        m = np.zeros((n_in, ld), np.float32)              # [in, out]
        if i == 0:               # the mean of the two directions
            for c in range(min(H, ld)):
                m[c, c] = m[H + c, c] = 0.5
        else:
            for c in range(min(n_in, ld)):
                m[c, c] = 1.0
        w[f"linear.{i}.w"], w[f"linear.{i}.b"] = m, np.zeros(ld, np.float32)
        n_in = ld
    # Powerset order: [(), (0,), (1,), (2,), (0,1), (0,2), (1,2)].
    cls = np.zeros((n_in, d["n_classes"]), np.float32)
    cls[0, 1] = cls[1, 1] = 4.0                           # band 0 → (0,)
    cls[2, 2] = cls[3, 2] = 4.0                           # band 1 → (1,)
    cls[0:4, 4] = 3.0                                     # both → (0, 1)
    cls_b = np.zeros(d["n_classes"], np.float32)
    cls_b[0] = 2.0                                        # silence: ()
    w["classifier.w"], w["classifier.b"] = cls, cls_b
    names = {n for n, _, _ in pyannet_spec(d)}
    if set(w) != names:
        raise RuntimeError(f"crafted names differ: {sorted(set(w) ^ names)}")
    return w


def draw(dims: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The crafted PyanNet and the seed's ECAPA, float32 on ``device``."""
    return {"pyannet": {k: torch.from_numpy(v).to(device) for k, v in
                        crafted_pyannet(dims["pyannet"]).items()},
            "ecapa": make_weights(ecapa_spec(dims["ecapa"]), seed, device,
                                  "ecapa", f32)}


def readings(recorder, dims: dict, seed: int, device, control: bool) -> dict:
    """The kept calls against ``speakers``' references, on these weights
    made anew."""
    s = _speakers.speaker_readings(recorder.kept("pyannet"),
                                   recorder.kept("ecapa"), dims,
                                   draw(dims, seed, device), control)
    return {"numbers": s["numbers"], "control": s["control"],
            "counts": {"seg_rows": s["seg_rows"],
                       "embed_rows": s["embed_rows"]}}
