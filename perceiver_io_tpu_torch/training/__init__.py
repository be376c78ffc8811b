"""Training for the port (counterpart of ``perceiver_io_tpu/training/``): the
CLM, classification, masked-LM and MSE losses, ``make_optimizer`` (AdamW, Adam, Lamb, SGD; clip,
accumulation, frozen parameters) with its LR schedules, the train state,
the train step with microbatching and the non-finite skip, the eval step (both
CUDA graphs on the card), host-sampled prefix-dropout keep sets, and the
``Trainer`` with torch-native checkpoints (``checkpoint.py``), the fault
ladder (``faults.py``) and the metrics log (``metrics.py``)."""

from perceiver_io_tpu_torch.training.checkpoint import (
    CheckpointManager,
    ResumePreflightError,
    config_from_dict,
    config_to_dict,
    load_config,
    load_params_into,
    load_pretrained,
    save_config,
    save_pretrained,
)
from perceiver_io_tpu_torch.training.faults import (
    DivergenceHalt,
    DivergenceSentinel,
    FetchRetriesExhausted,
    PreemptionGuard,
    QuarantineIterator,
    RetryPolicy,
    SentinelConfig,
    call_with_retry,
    fetch_retry_emitter,
)
from perceiver_io_tpu_torch.training.loop import (
    make_eval_step,
    make_train_step,
    shard_train_state,
    train_state_shardings,
)
from perceiver_io_tpu_torch.training.losses import (
    IGNORE_INDEX,
    classification_loss_fn,
    clm_loss_fn,
    masked_lm_loss_fn,
    mse_loss_fn,
)
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
from perceiver_io_tpu_torch.training.metrics import MetricsLogger
from perceiver_io_tpu_torch.training.state import TrainState
from perceiver_io_tpu_torch.training.trainer import Trainer, TrainerConfig

__all__ = [
    "CheckpointManager",
    "DivergenceHalt",
    "DivergenceSentinel",
    "FetchRetriesExhausted",
    "IGNORE_INDEX",
    "MetricsLogger",
    "PreemptionGuard",
    "QuarantineIterator",
    "ResumePreflightError",
    "RetryPolicy",
    "SentinelConfig",
    "Trainer",
    "TrainerConfig",
    "call_with_retry",
    "config_from_dict",
    "config_to_dict",
    "fetch_retry_emitter",
    "load_config",
    "load_params_into",
    "load_pretrained",
    "save_config",
    "save_pretrained",
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
    "shard_train_state",
    "train_state_shardings",
    "masked_lm_loss_fn",
    "mse_loss_fn",
    "prefix_keep_count",
    "sample_prefix_keep_idx",
    "with_prefix_keep_idx",
]
