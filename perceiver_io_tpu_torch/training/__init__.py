"""Training for the port (counterpart of ``perceiver_io_tpu/training/``): the
CLM and classification losses, ``make_optimizer`` (AdamW, Adam, Lamb, SGD; clip,
accumulation, frozen parameters) with its LR schedules, the train state,
the train step with microbatching and the non-finite skip, the eval step (both
CUDA graphs on the card), and host-sampled prefix-dropout keep sets. ``Trainer``, checkpointing, faults and metrics are
not ported yet."""

from perceiver_io_tpu_torch.training.loop import make_eval_step, make_train_step
from perceiver_io_tpu_torch.training.losses import IGNORE_INDEX, classification_loss_fn, clm_loss_fn
from perceiver_io_tpu_torch.training.optim import (
    Optimizer,
    clip_by_global_norm_,
    constant_with_warmup,
    cosine_with_warmup,
    freeze_mask,
    make_optimizer,
)
from perceiver_io_tpu_torch.training.prefix_dropout import (
    prefix_keep_count,
    sample_prefix_keep_idx,
    with_prefix_keep_idx,
)
from perceiver_io_tpu_torch.training.state import TrainState

__all__ = [
    "IGNORE_INDEX",
    "Optimizer",
    "TrainState",
    "classification_loss_fn",
    "clip_by_global_norm_",
    "clm_loss_fn",
    "constant_with_warmup",
    "cosine_with_warmup",
    "freeze_mask",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "prefix_keep_count",
    "sample_prefix_keep_idx",
    "with_prefix_keep_idx",
]
