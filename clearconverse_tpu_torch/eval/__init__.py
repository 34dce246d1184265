"""Evaluation for the port: computed WER / DER / RTFx for the config sweep
(``python -m clearconverse_tpu_torch.eval``), the parity recipe with its
perf levers (``eval.parity``) and the full-scale checkpoint dress rehearsal
(``eval.dress_rehearsal``). The metric modules are host code, copies of the
JAX package's."""

from clearconverse_tpu_torch.eval.wer import word_error_rate, normalize_text  # noqa: F401
from clearconverse_tpu_torch.eval.der import diarization_error_rate  # noqa: F401
