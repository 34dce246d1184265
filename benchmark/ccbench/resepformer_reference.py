"""The plain float32 RE-SepFormer that family ``resepformer`` holds the
program's separator against: speechbrain's ``resepformer-wsj02mix``
(``lobes/models/resepformer.py``, recipe ``resepformer.yaml``) written out
step by step from its equations, one span at a time at its own length, with
no batching and no masks. It imports nothing of the port.

``dims`` is a configuration's ``resepformer`` section (the recipe's names);
``weights`` is ``{name: tensor}`` under the program's parameter names
(``masknet.model.seg_model.0.mdl.layers.0.self_att.att.in_proj_weight``,
...). Matmuls and convolutions run in IEEE float32 (TF32 off); ``tf32=True``
runs the same at TF32, one precision below, for the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

EPS_LN = 1e-6      # speechbrain's transformer LayerNorm
EPS_GLN = 1e-8     # GlobalLayerNorm (dual_path.EPS)


@contextlib.contextmanager
def precision(tf32: bool):
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def positional(length: int, d: int) -> torch.Tensor:
    """speechbrain's ``PositionalEncoding``: [length, d], built in float32
    on the CPU, sin on even channels and cos on odd."""
    pe = torch.zeros(length, d)
    positions = torch.arange(0, length).unsqueeze(1).float()
    denominator = torch.exp(torch.arange(0, d, 2).float()
                            * -(math.log(10000.0) / d))
    pe[:, 0::2] = torch.sin(positions * denominator)
    pe[:, 1::2] = torch.cos(positions * denominator)
    return pe


def _layer_norm(x, w, pre):
    return F.layer_norm(x, (x.shape[-1],), w[pre + ".weight"],
                        w[pre + ".bias"], EPS_LN)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], pre: str,
          dims: dict) -> torch.Tensor:
    """``SBTransformerBlock_wnormandskip`` on [batch, time, N]: positions
    added, ``num_layers`` pre-norm encoder layers, the final LayerNorm, gLN
    over channels and time of each batch element, the skip."""
    d, heads = dims["out_channels"], dims["nhead"]
    src = x + positional(x.shape[1], d).to(x.device)
    for j in range(dims["num_layers"]):
        p = f"{pre}.mdl.layers.{j}"
        s1 = _layer_norm(src, w, p + ".norm1.norm").transpose(0, 1)
        att, _ = F.multi_head_attention_forward(
            s1, s1, s1, d, heads,
            w[p + ".self_att.att.in_proj_weight"],
            w[p + ".self_att.att.in_proj_bias"], None, None, False, 0.0,
            w[p + ".self_att.att.out_proj.weight"],
            w[p + ".self_att.att.out_proj.bias"], training=False,
            need_weights=True)
        src = src + att.transpose(0, 1)
        s2 = _layer_norm(src, w, p + ".norm2.norm")
        hid = torch.relu(F.linear(s2, w[p + ".pos_ffn.ffn.0.weight"],
                                  w[p + ".pos_ffn.ffn.0.bias"]))
        src = src + F.linear(hid, w[p + ".pos_ffn.ffn.3.weight"],
                             w[p + ".pos_ffn.ffn.3.bias"])
    out = _layer_norm(src, w, pre + ".mdl.norm.norm").permute(0, 2, 1)
    mean = torch.mean(out, (1, 2), keepdim=True)
    var = torch.mean((out - mean) ** 2, (1, 2), keepdim=True)
    out = (w[pre + ".norm.weight"] * (out - mean) / torch.sqrt(var + EPS_GLN)
           + w[pre + ".norm.bias"])
    return out.permute(0, 2, 1) + x


def separate_one(w: Dict[str, torch.Tensor], dims: dict, mix: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """One mixture [T] at its own length → its sources [T, num_spks]."""
    T = mix.shape[0]
    N, K = dims["N_encoder_out"], dims["segment_size"]
    L, stride, spks = dims["kernel_size"], dims["kernel_stride"], dims["num_spks"]
    if T < L:
        return torch.zeros((T, spks), device=mix.device)
    with precision(tf32), torch.no_grad():
        mix_w = torch.relu(F.conv1d(mix.float()[None, None, :],
                                    w["encoder.conv1d.weight"], stride=stride))
        # ResourceEfficientSeparator: [1, N, T'] → [1, T', N].
        inp = mix_w.permute(0, 2, 1)
        _, Tp, _ = inp.shape
        rest = K - Tp % K
        inp = F.pad(inp, (0, 0, 0, rest))
        seg = inp.reshape(-1, K, N)                    # [S, K, N]
        hc = torch.zeros(seg.shape[0], 1, N, device=mix.device)
        pre = "masknet.model"
        for i in range(dims["layer"]):
            seg = block(seg + hc, w, f"{pre}.seg_model.{i}", dims)
            if i < dims["layer"] - 1:
                hc = seg.mean(1).unsqueeze(0)          # [1, S, N]
                hc = block(hc, w, f"{pre}.mem_model.{i}", dims).permute(1, 0, 2)
        out = seg.reshape(1, -1, N)[:, :Tp, :].transpose(1, 2)
        out = F.prelu(out, w[pre + ".output_fc.0.weight"])
        out = F.conv1d(out, w[pre + ".output_fc.1.weight"],
                       w[pre + ".output_fc.1.bias"]).transpose(1, 2)
        masks = torch.relu(out.reshape(1, Tp, N, spks)).unbind(dim=3)
        srcs = []
        for m in masks:
            y = F.conv_transpose1d(mix_w * m.permute(0, 2, 1),
                                   w["decoder.conv_tr.weight"], stride=stride)
            y = y[0, 0, :T]
            srcs.append(F.pad(y, (0, T - y.shape[0])))
    return torch.stack(srcs, dim=-1)


def parameter_count(dims: dict) -> int:
    """The published layout's parameters, from its equations."""
    N, d, f = dims["N_encoder_out"], dims["out_channels"], dims["d_ffn"]
    layer = (3 * d * d + 3 * d) + (d * d + d) + (d * f + f + f * d + d) + 4 * d
    blk = dims["num_layers"] * layer + 2 * d + 2 * d
    masknet = (2 * dims["layer"] - 1) * blk + 1 + (N * dims["num_spks"] * N
                                                   + N * dims["num_spks"])
    return masknet + 2 * N * dims["kernel_size"]
