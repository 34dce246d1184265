"""Fine-tuning, in part.

For now this package holds only the Whisper export of ``train/checkpoint``:
the port's ``Whisper`` module written back to openai-whisper's state-dict
names and ``.pt`` format, which ``eval/dress_rehearsal`` uses to write
real-format checkpoints. The fine-tune step and its CLI (the JAX package's
``train/finetune.py`` and ``train/__main__.py``) are not ported yet: ROADMAP.md
queue 1, item 8.
"""
