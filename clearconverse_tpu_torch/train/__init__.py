"""Fine-tuning.

The reference only *consumes* fine-tuned checkpoints (whisper-ft /
resepformer-ft overlays, back/api.py:671-692, 727-746) and ships no trainer.
This package closes that loop on the card: a Whisper fine-tune step
(teacher forcing, AdamW after a global-norm clip, gradient accumulation,
remat), its CLI (``python -m clearconverse_tpu_torch.train``), training
checkpoints, and exports to the reference's overlay formats; on a (data,
model) mesh of ranks too (``--mesh`` under torchrun).
"""

from clearconverse_tpu_torch.train.finetune import (  # noqa: F401
    TrainState, make_train_step, whisper_loss, init_train_state)
