"""Training of the port: AdamW, the causal-LM step, checkpoints and the
synthetic token stream (the port of ``repro/training``)."""
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.training.train_step import loss_fn, make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "loss_fn", "make_train_step"]
