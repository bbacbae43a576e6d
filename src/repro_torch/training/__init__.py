"""Training of the port (the reference's `repro.training`): AdamW with
float32 master weights, the synthetic bigram data, atomic checkpoints,
int8 gradient compression with error feedback, and the train step and
loop."""
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compress import (CompressionConfig,
                                           compress_with_feedback)
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import make_train_step, train_loop
from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update)

__all__ = ["CompressionConfig", "OptConfig", "SyntheticLM", "adamw_init",
           "adamw_update", "compress_with_feedback", "latest_step",
           "make_train_step", "restore_checkpoint", "save_checkpoint",
           "train_loop"]
