"""The task losses (counterpart of ``perceiver_io_tpu/training/losses.py``:
``_cross_entropy``, ``classification_loss_fn``, ``masked_lm_loss_fn``,
``clm_loss_fn`` and ``mse_loss_fn``).

A loss function has the signature ``loss_fn(model, batch, generator) ->
(loss, metrics)``: the model takes the place of the JAX package's params and
a ``torch.Generator`` (or None) that of its dropout key. Batch values may be
numpy arrays or tensors; they are moved to the model's device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

IGNORE_INDEX = -100  # torch CrossEntropyLoss ignore_index parity

# the train and eval steps of a sharded state set this (global_batch_mean)
_GLOBAL_MEAN = False


@contextlib.contextmanager
def global_batch_mean():
    """Inside, every rank of the default group holds a block of one global
    batch (``parallel.mesh.shard_batch``), and the CE losses below return
    their block's share of the GLOBAL mean: the local sum of the valid
    tokens' losses over the global count of valid tokens, times the world
    size. The ranks' gradients, averaged (FSDP's reduce), are then the
    gradient of the global mean, and the ranks' losses average to it, even
    where a pad mask or ``-100`` labels give the blocks different counts
    (the JAX package's GSPMD step is one program over the global batch).
    Ranks that hold the same block (the ``seq`` axis) count it once each in
    both the count and the world size, which cancels."""
    global _GLOBAL_MEAN
    prev, _GLOBAL_MEAN = _GLOBAL_MEAN, True
    try:
        yield
    finally:
        _GLOBAL_MEAN = prev


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over labels != IGNORE_INDEX (0 when none is valid), the
    logits cast to f32 before the log-softmax (bf16 logits too, as the JAX
    package casts them). Returns (loss, num_valid). Under
    :func:`global_batch_mean` the mean is the global batch's."""
    valid = labels != IGNORE_INDEX
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    num_valid = valid.sum()
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    if not _GLOBAL_MEAN:
        return total / torch.clamp(num_valid, min=1), num_valid
    count = num_valid.clone()
    dist.all_reduce(count)
    return total / torch.clamp(count, min=1) * dist.get_world_size(), num_valid


def _on(value, device) -> Optional[torch.Tensor]:
    return None if value is None else torch.as_tensor(value, device=device)


def clm_loss_fn(max_latents: int, deterministic: bool = False) -> Callable:
    """Causal LM loss: pads are ignored, ``prefix_len = seq_len -
    max_latents``, CE over the last ``max_latents`` logits.

    Contract: the data pipeline pre-shifts targets (``input_ids = t[:, :-1]``,
    ``labels = t[:, 1:]``); this function does NOT shift. The batch's
    ``pad_mask`` key is required, its value may be None (no padding). An
    optional ``prefix_keep_idx`` (host-sampled keep set,
    ``training.prefix_dropout``) goes to the model on training forwards."""

    def loss_fn(model, batch: Dict, generator: Optional[torch.Generator] = None,
                deterministic: bool = deterministic) -> Tuple[torch.Tensor, Dict]:
        dev = model.device
        x, labels = _on(batch["input_ids"], dev).long(), _on(batch["labels"], dev).long()
        pad_mask = _on(batch["pad_mask"], dev)
        seq_len = x.shape[1]
        if seq_len < max_latents:
            raise ValueError(f"Training sequence length must be at least {max_latents} (= max_latents)")
        if pad_mask is not None:
            pad_mask = pad_mask.bool()
            labels = torch.where(pad_mask, torch.full_like(labels, IGNORE_INDEX), labels)
        keep_idx = None if deterministic else _on(batch.get("prefix_keep_idx"), dev)
        out = model(x, prefix_len=seq_len - max_latents, pad_mask=pad_mask, deterministic=deterministic,
                    prefix_keep_idx=keep_idx, generator=generator)
        logits = out.logits
        loss, _ = _cross_entropy(logits, labels[:, -logits.shape[1]:])
        return loss, {"loss": loss}

    # undeclared (None), as in the JAX package: the per-call valid-token
    # normalization weights chunks equally only without padding, so
    # make_train_step sniffs each batch's pad_mask instead
    loss_fn.uniform_weighting = None
    return loss_fn


def classification_loss_fn(deterministic: bool = False) -> Callable:
    """CE + accuracy over ``{"x" | "image" | "input_ids", "label"}`` batches
    (an optional ``pad_mask`` goes to the model; token ids go as int64);
    ``deterministic`` builds the eval variant. Per-example means: equal chunks weigh equally, so it declares
    ``uniform_weighting = True`` and ``make_train_step`` may split any
    batch."""

    def loss_fn(model, batch: Dict, generator: Optional[torch.Generator] = None,
                deterministic: bool = deterministic) -> Tuple[torch.Tensor, Dict]:
        dev = model.device
        x = _on(next(batch[k] for k in ("x", "image", "input_ids") if k in batch), dev)
        x = x.float() if x.is_floating_point() else x.long()
        y = _on(batch["label"], dev).long()
        pad_mask = _on(batch.get("pad_mask"), dev)
        logits = model(x, pad_mask=None if pad_mask is None else pad_mask.bool(), deterministic=deterministic,
                       generator=generator)
        loss, _ = _cross_entropy(logits, y)
        acc = (torch.argmax(logits, dim=-1) == y).float().mean()
        return loss, {"loss": loss, "acc": acc}

    loss_fn.uniform_weighting = True
    return loss_fn


def masked_lm_loss_fn(deterministic: bool = False) -> Callable:
    """CE over the masked positions alone: ``labels`` are ``IGNORE_INDEX``
    except where a token was masked; ``{"input_ids", "labels"}`` batches with
    an optional ``pad_mask``. Metrics: the loss and ``num_masked``, the
    count of positions it averages. It normalizes by each call's own count,
    so chunks of a batch would weigh its tokens unequally: it declares
    ``uniform_weighting = False`` and ``make_train_step`` refuses
    ``microbatch > 1``."""

    def loss_fn(model, batch: Dict, generator: Optional[torch.Generator] = None,
                deterministic: bool = deterministic) -> Tuple[torch.Tensor, Dict]:
        dev = model.device
        pad_mask = _on(batch.get("pad_mask"), dev)
        logits = model(_on(batch["input_ids"], dev).long(), pad_mask=None if pad_mask is None else pad_mask.bool(),
                       deterministic=deterministic, generator=generator)
        loss, num_masked = _cross_entropy(logits, _on(batch["labels"], dev).long())
        return loss, {"loss": loss, "num_masked": num_masked}

    loss_fn.uniform_weighting = False
    return loss_fn


def mse_loss_fn(deterministic: bool = False) -> Callable:
    """Mean squared error of the model's prediction for ``batch["x"]``
    against ``batch["y"]`` (the time-series forecaster), in f32. A plain mean
    over elements: ``uniform_weighting = True``."""

    def loss_fn(model, batch: Dict, generator: Optional[torch.Generator] = None,
                deterministic: bool = deterministic) -> Tuple[torch.Tensor, Dict]:
        dev = model.device
        pred = model(_on(batch["x"], dev).float(), deterministic=deterministic, generator=generator)
        loss = ((pred.float() - _on(batch["y"], dev).float()) ** 2).mean()
        return loss, {"loss": loss}

    loss_fn.uniform_weighting = True
    return loss_fn
