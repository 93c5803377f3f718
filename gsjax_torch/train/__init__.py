"""Training: losses, learning-rate schedule, Adam, densification, the
training step and its captured windows, checkpoints and the Trainer.

Re-exports the names gsjax's train package does: the losses, Adam and
the learning-rate schedules."""

from gsjax_torch.train.loss import l1_loss, l2_loss, ssim
from gsjax_torch.train.optimizer import AdamState, adam_init, adam_update, make_lr_tree
from gsjax_torch.train.schedule import expon_lr

__all__ = [
    "l1_loss",
    "l2_loss",
    "ssim",
    "AdamState",
    "adam_init",
    "adam_update",
    "make_lr_tree",
    "expon_lr",
]
