"""Whisper checkpoints → the port's ``Whisper`` module, on the device once.

* ``load_whisper`` reads what the JAX package's loader reads: an openai
  ``.pt`` (``{"dims": …, "model_state_dict": …}``, fp16 upcast), HF
  ``WhisperForConditionalGeneration`` names, the reference's
  ``whisper/{size}.pt`` cache layout and the ``whisper-ft/`` overlay.
* ``whisper_from_jax_params`` is the weight bridge from the JAX package's
  Whisper param pytree (numpy leaves; linear ``w`` ``[in, out]``, conv ``w``
  ``[k, Cin, Cout]``) to the port's module. The checkpoint converters below
  build that same pytree from a state dict, so every weight goes through
  this one bridge.
* ``init_whisper`` is a seeded random init for runs without a checkpoint.

Weights are placed on the target device once, at load; nothing re-uploads
them per call.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clearconverse_tpu_torch.models.whisper import (
    Whisper, WhisperDims, empty_whisper, model_dims, sinusoids)

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ the bridge

def whisper_from_jax_params(tree: Mapping[str, Any], dims: WhisperDims,
                            device="cuda",
                            dtype: torch.dtype = torch.float32) -> Whisper:
    """The JAX package's Whisper param pytree → the port's ``Whisper`` on
    ``device`` (matmul weights in ``dtype``, layer norms in f32)."""
    model = empty_whisper(dims, device, dtype)

    def put(param, arr):
        param.copy_(torch.from_numpy(np.array(arr, np.float32)))

    def lin(mod, p):
        put(mod.weight, np.asarray(p["w"]).T)
        if mod.bias is not None:
            if "b" in p:
                put(mod.bias, p["b"])
            else:
                mod.bias.zero_()

    def ln(mod, p):
        put(mod.weight, p["g"])
        put(mod.bias, p["b"])

    def block(blk, p):
        ln(blk.attn_ln, p["attn_ln"])
        ln(blk.mlp_ln, p["mlp_ln"])
        for name in ("q", "k", "v", "out"):
            lin(getattr(blk.attn, name), p["attn"][name])
            if "cross" in p:
                lin(getattr(blk.cross, name), p["cross"][name])
        lin(blk.mlp.fc1, p["mlp"]["fc1"])
        lin(blk.mlp.fc2, p["mlp"]["fc2"])
        if "cross_ln" in p:
            ln(blk.cross_ln, p["cross_ln"])

    enc_p, dec_p = tree["encoder"], tree["decoder"]
    enc, dec = model.encoder, model.decoder
    for conv, p in ((enc.conv1, enc_p["conv1"]), (enc.conv2, enc_p["conv2"])):
        put(conv.weight, np.transpose(np.asarray(p["w"]), (2, 1, 0)))
        put(conv.bias, p["b"])
    put(enc.pos, enc_p["pos"])
    for blk, p in zip(enc.blocks, enc_p["blocks"]):
        block(blk, p)
    ln(enc.ln_post, enc_p["ln_post"])
    put(dec.tok, dec_p["tok"])
    put(dec.pos, dec_p["pos"])
    for blk, p in zip(dec.blocks, dec_p["blocks"]):
        block(blk, p)
    ln(dec.ln, dec_p["ln"])
    return model


def init_whisper(dims: WhisperDims, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32) -> Whisper:
    """Seeded random init with the JAX package's distributions (normal
    weights scaled by fan-in^-0.5, zero biases, unit layer norms, the fixed
    sinusoid encoder table). The draws come from a torch generator on
    ``device``, so they are not the JAX package's numbers."""
    model = empty_whisper(dims, device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(param, scale):
        param.copy_(torch.randn(param.shape, generator=gen, device=device)
                    * scale)

    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            normal(m.weight, m.weight[0].numel() ** -0.5)   # fan-in
        if isinstance(m, (nn.LayerNorm, nn.Linear, nn.Conv1d)) \
                and m.bias is not None:
            m.bias.zero_()
    model.encoder.pos.copy_(torch.from_numpy(sinusoids(*model.encoder.pos.shape)))
    normal(model.decoder.tok, dims.n_text_state ** -0.5)
    normal(model.decoder.pos, dims.n_text_state ** -0.5)
    return model


# ------------------------------------------------------- state dict → pytree

def _np(t) -> np.ndarray:
    """torch tensor / array-like → float32 numpy (host); fp16/bf16 upcast
    (openai-whisper ``.pt`` files store fp16). Integer tensors pass."""
    if hasattr(t, "detach"):
        t = t.detach().cpu()
        if t.dtype in (torch.float16, torch.bfloat16):
            t = t.float()
        t = t.numpy()
    a = np.asarray(t)
    if a.dtype == np.float16:
        a = a.astype(np.float32)
    return a


def _lin(sd: Mapping, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    p = {"w": _np(sd[f"{prefix}.weight"]).T}  # torch [out,in] → [in,out]
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"g": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def convert_whisper_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Auto-detects openai-whisper vs HF naming → the Whisper param pytree."""
    keys = set(sd.keys())
    if any(k.startswith("model.") for k in keys):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
        keys = set(sd.keys())
    if "encoder.conv1.weight" in keys and "encoder.layers.0.self_attn.q_proj.weight" in keys:
        return _convert_hf(sd)
    return _convert_openai(sd)


def _count(sd: Mapping, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def _convert_openai(sd: Mapping[str, Any]) -> Dict[str, Any]:
    def block(side: str, i: int, cross: bool) -> Dict[str, Any]:
        pre = f"{side}.blocks.{i}"
        p = {
            "attn_ln": _ln(sd, f"{pre}.attn_ln"),
            "attn": {"q": _lin(sd, f"{pre}.attn.query"),
                     "k": _lin(sd, f"{pre}.attn.key", bias=False),
                     "v": _lin(sd, f"{pre}.attn.value"),
                     "out": _lin(sd, f"{pre}.attn.out")},
            "mlp_ln": _ln(sd, f"{pre}.mlp_ln"),
            "mlp": {"fc1": _lin(sd, f"{pre}.mlp.0"), "fc2": _lin(sd, f"{pre}.mlp.2")},
        }
        if cross:
            p["cross_ln"] = _ln(sd, f"{pre}.cross_attn_ln")
            p["cross"] = {"q": _lin(sd, f"{pre}.cross_attn.query"),
                          "k": _lin(sd, f"{pre}.cross_attn.key", bias=False),
                          "v": _lin(sd, f"{pre}.cross_attn.value"),
                          "out": _lin(sd, f"{pre}.cross_attn.out")}
        return p

    n_enc = _count(sd, r"encoder\.blocks\.(\d+)\.")
    n_dec = _count(sd, r"decoder\.blocks\.(\d+)\.")
    return {
        "encoder": {
            # torch conv1d [out,in,k] → [k,in,out]
            "conv1": {"w": _np(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
                      "b": _np(sd["encoder.conv1.bias"])},
            "conv2": {"w": _np(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
                      "b": _np(sd["encoder.conv2.bias"])},
            "pos": _np(sd["encoder.positional_embedding"]),
            "blocks": [block("encoder", i, False) for i in range(n_enc)],
            "ln_post": _ln(sd, "encoder.ln_post"),
        },
        "decoder": {
            "tok": _np(sd["decoder.token_embedding.weight"]),
            "pos": _np(sd["decoder.positional_embedding"]),
            "blocks": [block("decoder", i, True) for i in range(n_dec)],
            "ln": _ln(sd, "decoder.ln"),
        },
    }


def _convert_hf(sd: Mapping[str, Any]) -> Dict[str, Any]:
    def attn(pre: str) -> Dict[str, Any]:
        return {"q": _lin(sd, f"{pre}.q_proj"),
                "k": _lin(sd, f"{pre}.k_proj", bias=False),
                "v": _lin(sd, f"{pre}.v_proj"),
                "out": _lin(sd, f"{pre}.out_proj")}

    def block(side: str, i: int, cross: bool) -> Dict[str, Any]:
        pre = f"{side}.layers.{i}"
        p = {
            "attn_ln": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "attn": attn(f"{pre}.self_attn"),
            "mlp_ln": _ln(sd, f"{pre}.final_layer_norm"),
            "mlp": {"fc1": _lin(sd, f"{pre}.fc1"), "fc2": _lin(sd, f"{pre}.fc2")},
        }
        if cross:
            p["cross_ln"] = _ln(sd, f"{pre}.encoder_attn_layer_norm")
            p["cross"] = attn(f"{pre}.encoder_attn")
        return p

    n_enc = _count(sd, r"encoder\.layers\.(\d+)\.")
    n_dec = _count(sd, r"decoder\.layers\.(\d+)\.")
    return {
        "encoder": {
            "conv1": {"w": _np(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
                      "b": _np(sd["encoder.conv1.bias"])},
            "conv2": {"w": _np(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
                      "b": _np(sd["encoder.conv2.bias"])},
            "pos": _np(sd["encoder.embed_positions.weight"]),
            "blocks": [block("encoder", i, False) for i in range(n_enc)],
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "tok": _np(sd["decoder.embed_tokens.weight"]),
            "pos": _np(sd["decoder.embed_positions.weight"]),
            "blocks": [block("decoder", i, True) for i in range(n_dec)],
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }


# ------------------------------------------------------------------ loading

def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """``.pt``/``.bin`` (torch pickle) or ``.safetensors`` → flat dict, with
    half-precision tensors upcast to f32 (the speaker converters take bare
    arrays)."""
    if path.endswith(".safetensors"):
        from clearconverse_tpu_torch.utils.safetensors import load_file
        return {k: (v.astype(np.float32) if v.dtype == np.float16 else v)
                for k, v in load_file(path).items()}
    return {k: (v.float() if isinstance(v, torch.Tensor)
                and v.dtype in (torch.float16, torch.bfloat16) else v)
            for k, v in _strip_wrappers(_load_raw_torch(path)).items()}


def _dims_from_dict(d: Any) -> Optional[WhisperDims]:
    """openai ``.pt`` checkpoints carry a ``dims`` entry whose field names
    match WhisperDims exactly; accept a mapping or an object with a
    ``__dict__``. None if any field is missing."""
    if not isinstance(d, Mapping):
        d = getattr(d, "__dict__", None)
        if not isinstance(d, Mapping):
            return None
    fields = {f.name for f in dataclasses.fields(WhisperDims)}
    try:
        vals = {k: int(v) for k, v in d.items() if k in fields}
    except (TypeError, ValueError):
        return None
    if fields - set(vals):
        return None
    return WhisperDims(**vals)


def infer_whisper_dims(params: Dict[str, Any],
                       fallback: WhisperDims) -> WhisperDims:
    """Dims recoverable from a param pytree's shapes; the head counts (in
    no weight shape) come from ``fallback``."""
    enc, dec = params["encoder"], params["decoder"]
    return dataclasses.replace(
        fallback,
        n_mels=int(np.shape(enc["conv1"]["w"])[1]),
        n_audio_state=int(np.shape(enc["conv1"]["w"])[2]),
        n_audio_ctx=int(np.shape(enc["pos"])[0]),
        n_audio_layer=len(enc["blocks"]),
        n_vocab=int(np.shape(dec["tok"])[0]),
        n_text_state=int(np.shape(dec["tok"])[1]),
        n_text_ctx=int(np.shape(dec["pos"])[0]),
        n_text_layer=len(dec["blocks"]),
    )


def load_whisper_params(model_dir: str, model_size: str = "small.en"
                        ) -> Tuple[Optional[Dict[str, Any]], WhisperDims]:
    """The reference's checkpoint discovery (back/api.py:657-703): a base
    ``{model_dir}/{size}.pt`` (or ``{model_dir}/whisper/{size}.pt``) and an
    optional ``{model_dir}/whisper-ft/model.safetensors|model.pt`` overlay →
    (param pytree, dims), or (None, table dims) without a checkpoint.

    Dims follow openai-whisper's ``load_model``: the ``.pt``'s ``dims`` dict
    supplies the head counts, every shape-recoverable field comes from the
    final weights, and the ``model_size`` table is the fallback."""
    table_dims = model_dims(model_size)
    base = os.path.join(model_dir, f"{model_size}.pt")
    if not os.path.exists(base):
        nested = os.path.join(model_dir, "whisper", f"{model_size}.pt")
        if os.path.exists(nested):
            base = nested
    params = None
    ckpt_dims: Optional[WhisperDims] = None
    if os.path.exists(base):
        obj = _load_raw_torch(base)
        if isinstance(obj, dict) and "dims" in obj:
            ckpt_dims = _dims_from_dict(obj["dims"])
        params = convert_whisper_state_dict(_strip_wrappers(obj))
    for name in ("model.safetensors", "model.pt"):
        ft = os.path.join(model_dir, "whisper-ft", name)
        if not os.path.exists(ft):
            continue
        try:
            if name.endswith(".pt"):
                obj = _load_raw_torch(ft)
                ft_dims = (_dims_from_dict(obj["dims"])
                           if isinstance(obj, dict) and "dims" in obj else None)
                params = convert_whisper_state_dict(_strip_wrappers(obj))
                ckpt_dims = ft_dims or ckpt_dims
            else:
                params = convert_whisper_state_dict(load_torch_state_dict(ft))
            break
        except Exception as exc:  # noqa: BLE001 — ft → base fallback (back/api.py:694-703)
            logger.warning("whisper-ft overlay %s unreadable (%s); "
                           "keeping the base checkpoint", ft, exc)
    if params is None:
        return None, table_dims
    dims = infer_whisper_dims(params, ckpt_dims or table_dims)
    if dims != table_dims:
        logger.warning("whisper checkpoint dims differ from the %r table "
                       "entry (%s vs %s); using the checkpoint's",
                       model_size, dims, table_dims)
    return params, dims


def load_whisper(model_dir: str, model_size: str = "small.en", device="cuda",
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[Optional[Whisper], WhisperDims]:
    """``load_whisper_params`` → (``Whisper`` on ``device``, dims), or
    (None, table dims) when ``model_dir`` holds no checkpoint."""
    params, dims = load_whisper_params(model_dir, model_size)
    if params is None:
        return None, dims
    return whisper_from_jax_params(params, dims, device, dtype), dims


def _load_raw_torch(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError, ImportError):
        return _load_torch_tolerant(path)


def _load_torch_tolerant(path: str):
    """Load a pickle whose metadata names classes this box cannot import.

    pyannote's ``pytorch_model.bin`` is a lightning checkpoint: besides the
    plain tensors of ``state_dict`` it pickles pyannote.audio and omegaconf
    objects, and without those packages ``torch.load`` raises before the
    tensors are reachable. This unpickler puts an inert stub in place of
    every class it cannot import."""
    import pickle
    import types

    class _Stub:
        """Absorbs any construction protocol (NEWOBJ args, REDUCE calls,
        BUILD state) of an unimportable class."""

        def __init__(self, *a, **k):
            pass

        def __call__(self, *a, **k):
            return self

        def __setstate__(self, state):
            # A dict state becomes attributes, so a stubbed dims object
            # still answers _dims_from_dict's __dict__ probe.
            if isinstance(state, dict):
                self.__dict__.update(state)
            else:
                object.__setattr__(self, "_state", state)

    class _TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ModuleNotFoundError, AttributeError, ImportError):
                return type(str(name), (_Stub,), {"__module__": str(module)})

    # torch.load's own unpickler subclasses pickle_module.Unpickler and
    # defers unknown classes to this find_class.
    shim = types.ModuleType("cc_tolerant_pickle")
    shim.Unpickler = _TolerantUnpickler
    shim.load = lambda f, **kw: _TolerantUnpickler(f, **kw).load()
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=shim)


def _strip_wrappers(obj):
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


# ------------------------------------------------------------------ Voxtral

def voxtral_hf_names(dims) -> Dict[str, str]:
    """{HF ``VoxtralForConditionalGeneration`` name: the port's ``Voxtral``
    parameter name} at ``dims`` (``models/voxtral.VoxtralDims``). The
    language model's names are given with ``language_model.model.``;
    ``load_voxtral_state_dict`` also takes them without the ``model.``."""
    out = {"audio_tower.conv1.weight": "encoder.conv1.weight",
           "audio_tower.conv1.bias": "encoder.conv1.bias",
           "audio_tower.conv2.weight": "encoder.conv2.weight",
           "audio_tower.conv2.bias": "encoder.conv2.bias",
           "audio_tower.embed_positions.weight": "encoder.pos",
           "audio_tower.layer_norm.weight": "encoder.ln_post.weight",
           "audio_tower.layer_norm.bias": "encoder.ln_post.bias",
           "multi_modal_projector.linear_1.weight": "adapter.linear_1.weight",
           "multi_modal_projector.linear_2.weight": "adapter.linear_2.weight",
           "language_model.model.embed_tokens.weight": "decoder.tok",
           "language_model.model.norm.weight": "decoder.norm.weight",
           "language_model.lm_head.weight": "decoder.lm_head.weight"}
    for i in range(dims.n_audio_layer):
        hf, pt = f"audio_tower.layers.{i}", f"encoder.blocks.{i}"
        for a, b in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                     ("out_proj", "out")):
            out[f"{hf}.self_attn.{a}.weight"] = f"{pt}.attn.{b}.weight"
            if a != "k_proj":
                out[f"{hf}.self_attn.{a}.bias"] = f"{pt}.attn.{b}.bias"
        for a, b in (("self_attn_layer_norm", "attn_ln"),
                     ("final_layer_norm", "mlp_ln")):
            out[f"{hf}.{a}.weight"] = f"{pt}.{b}.weight"
            out[f"{hf}.{a}.bias"] = f"{pt}.{b}.bias"
        for a in ("fc1", "fc2"):
            out[f"{hf}.{a}.weight"] = f"{pt}.mlp.{a}.weight"
            out[f"{hf}.{a}.bias"] = f"{pt}.mlp.{a}.bias"
    for i in range(dims.n_layer):
        hf, pt = f"language_model.model.layers.{i}", f"decoder.layers.{i}"
        for a, b in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                     ("o_proj", "o")):
            out[f"{hf}.self_attn.{a}.weight"] = f"{pt}.attn.{b}.weight"
        for a in ("gate", "up", "down"):
            out[f"{hf}.mlp.{a}_proj.weight"] = f"{pt}.mlp.{a}.weight"
        out[f"{hf}.input_layernorm.weight"] = f"{pt}.attn_norm.weight"
        out[f"{hf}.post_attention_layernorm.weight"] = f"{pt}.mlp_norm.weight"
    return out


def load_voxtral_state_dict(model: nn.Module, sd: Mapping[str, Any]) -> None:
    """Copies every tensor of an HF Voxtral state dict into ``model`` (a
    ``models/voxtral.Voxtral``), each cast to its parameter's type; the
    names must cover every parameter once. ``language_model.layers...``
    (without ``model.``) is read as ``language_model.model.layers...``."""
    names = voxtral_hf_names(model.dims)

    def canon(k: str) -> str:
        if k.startswith("language_model.") and k not in names:
            alt = "language_model.model." + k[len("language_model."):]
            if alt in names:
                return alt
        return k

    sd = {canon(k): v for k, v in sd.items()}
    missing = sorted(set(names) - set(sd))
    extra = sorted(set(sd) - set(names))
    if missing or extra:
        raise KeyError(f"Voxtral state dict: missing {missing[:6]}, "
                       f"unexpected {extra[:6]}")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for hf, pt in names.items():
            p = params[pt]
            v = sd[hf]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{hf}: {tuple(v.shape)} where the model "
                                 f"holds {tuple(p.shape)}")
            p.copy_(v.to(device=p.device, dtype=p.dtype))


def load_voxtral(model_dir: str, name: str, dims, device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
    """``{model_dir}/{name}/`` holding HF Voxtral ``*.safetensors`` (one
    file or shards; Mistral's ``consolidated.safetensors`` is not read) →
    ``models/voxtral.Voxtral`` on ``device``; None without such files."""
    from clearconverse_tpu_torch.models.voxtral import empty_voxtral
    from clearconverse_tpu_torch.utils.safetensors import load_file
    folder = os.path.join(model_dir, name)
    files = sorted(f for f in (os.listdir(folder) if os.path.isdir(folder)
                               else [])
                   if f.endswith(".safetensors")
                   and not f.startswith("consolidated"))
    if not files:
        return None
    sd: Dict[str, Any] = {}
    for f in files:
        sd.update(load_file(os.path.join(folder, f)))
    model = empty_voxtral(dims, device, dtype)
    load_voxtral_state_dict(model, sd)
    return model
