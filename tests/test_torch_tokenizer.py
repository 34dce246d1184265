"""tests/test_tokenizer.py and tests/test_tokenizer_crossval.py, run over
the port's ``models/tokenizer.py``.

The port keeps its own copy of the JAX package's tokenizer. Each JAX test
file is compiled again here with its imports of
``clearconverse_tpu.models.tokenizer`` pointed at
``clearconverse_tpu_torch.models.tokenizer``, and its tests and fixtures
are collected under this module, so every scenario (special-token layout,
BPE merges, byte fallback, vocab and tiktoken files, the real GPT-2 assets
when present, and the cross-check against transformers' GPT2Tokenizer on
trained assets) holds the port's copy to the same expectations.
"""

import pathlib

import clearconverse_tpu_torch.models.tokenizer as port_tokenizer

_HERE = pathlib.Path(__file__).parent
_JAX, _PORT = "clearconverse_tpu.models.tokenizer", port_tokenizer.__name__


def _over_the_port(name: str) -> dict:
    """The namespace of tests/{name}.py with the port's tokenizer in place
    of the JAX package's."""
    path = _HERE / f"{name}.py"
    src = path.read_text(encoding="utf-8")
    assert _JAX in src, name
    ns = {"__name__": f"{__name__}.{name}", "__file__": str(path)}
    exec(compile(src.replace(_JAX, _PORT), str(path), "exec"), ns)
    return ns


def _collect(name: str) -> None:
    """Bind tests/{name}.py's tests (prefixed with its name) and fixtures
    here."""
    for key, obj in _over_the_port(name).items():
        if key.startswith("test_") and callable(obj):
            globals()[f"test_{name[len('test_'):]}__{key[len('test_'):]}"] = obj
        elif hasattr(obj, "_pytestfixturefunction") or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            assert key not in globals(), key
            globals()[key] = obj


for _name in ("test_tokenizer", "test_tokenizer_crossval"):
    _collect(_name)


def test_both_files_run_over_the_port():
    collected = [k for k in globals() if k.startswith("test_tokenizer")]
    assert any(k.startswith("test_tokenizer__") for k in collected)
    assert any(k.startswith("test_tokenizer_crossval__") for k in collected)
    assert _PORT == "clearconverse_tpu_torch.models.tokenizer"
