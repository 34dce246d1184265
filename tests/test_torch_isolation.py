"""The PyTorch port stands alone: no file of clearconverse_tpu_torch/ (nor
chip_smoke.py) imports jax or the JAX package, and a tiny transcription,
the engine's default pass on one short file, one separation, the server's,
the bench's, the eval package's and the entry's imports, and a tiny
dress-rehearsal set written and loaded back run in a process where both are
refused at import."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(p for p in (ROOT / "clearconverse_tpu_torch").rglob("*.py")
               if "_build" not in p.parts) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    # Exact names or dotted prefixes: "clearconverse_tpu_torch" also starts
    # with "clearconverse_tpu" and must not match.
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "clearconverse_tpu"))


def test_forbidden_matches_names_exactly():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("clearconverse_tpu.models.whisper")
    assert not _forbidden("clearconverse_tpu_torch.models.whisper")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_SCRIPT = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == r or name.startswith(r + ".")
                   for r in ("jax", "jaxlib", "clearconverse_tpu")):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle, StoreBatch

    dims = WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                       n_text_state=64, n_text_head=2, n_text_layer=1)
    b = ModelBundle(torch_config=TorchConfig(max_decode_tokens=4, best_of=2),
                    device="cpu")
    b._whisper = (init_whisper(dims, 0, "cpu"), dims,
                  ByteFallbackTokenizer())
    b._loaded = True
    audio = np.random.default_rng(0).standard_normal((2, 16000)) * 0.1
    texts = b.transcribe_batch(audio.astype(np.float32), ["", "hi"],
                               temperature=0.1)
    store = b.make_store(audio.astype(np.float32), 16000)
    texts += b.transcribe_batch(StoreBatch(store, [1], [0], [16000], 16000),
                                [""], temperature=0.0)
    assert len(texts) == 3

    # The engine's default pass on one short file: load and gate, PyanNet
    # segmentation (the crafted weights), ECAPA diarization and profiles,
    # the decode wavefront.
    import os, tempfile
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params, synth_conversation)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    edims = EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                      attention_channels=16, embedding_dim=16,
                      res2net_scale=4)
    b._ecapa, b._ecapa_dims = init_ecapa(edims, 1, "cpu"), edims
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(device="cpu")
    path = os.path.join(tempfile.mkdtemp(), "short.wav")
    write_wav(path, synth_conversation()[: 9 * 16000], 16000)
    eng = TranscriptionEngine(torch_config=b.torch_config, models=b)
    res, = eng.process_files([path])
    assert res is not None and res["segments"], res

    # One RE-SepFormer separation through the bundle, and the server's
    # module graph (which needs no ``requests`` until a URL is fetched).
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    b._sepformer = init_sepformer(
        SepformerDims(enc_channels=16, d_model=16, n_heads=2, chunk_size=20,
                      n_repeats=1, n_intra_layers=1, n_inter_layers=1),
        0, "cpu")
    sep = b.separate_batch(audio[:, :8000].astype(np.float32))
    assert sep.shape == (2, 8000, 2), sep.shape
    import clearconverse_tpu_torch.serve.app  # noqa: F401
    assert "requests" not in sys.modules

    # The bench, the eval package, the parity recipe and the entry, and a
    # tiny dress-rehearsal set written on the CPU and loaded back.
    import clearconverse_tpu_torch.bench  # noqa: F401
    import clearconverse_tpu_torch.eval  # noqa: F401
    import clearconverse_tpu_torch.eval.parity  # noqa: F401
    import clearconverse_tpu_torch.entry  # noqa: F401
    from clearconverse_tpu_torch.eval import dress_rehearsal
    model_dir = tempfile.mkdtemp()
    assert dress_rehearsal.main(["--model-dir", model_dir, "--tiny",
                                 "--device", "cpu"]) == 0
    loaded = ModelBundle(torch_config=TorchConfig(), model_dir=model_dir,
                         device="cpu")
    assert loaded.load_with_progress()
    assert set(loaded.load_source.values()) == {"checkpoint", "BPETokenizer"}
    leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m == "clearconverse_tpu" or m.startswith("clearconverse_tpu.")]
    assert not leaked, leaked
    print("ISOLATED-OK")
""")


def test_transcribe_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout
