"""Long-context sequence parallelism wired into the model: the Perceiver AR
CLM with its prefix sharded over the ``seq`` mesh axis (counterpart of
``perceiver_io_tpu/parallel/long_context.py``).

Each rank of the ``seq`` group embeds and attends its block of the prefix;
the cross-attention partials meet in one ``all_reduce(MAX)`` and two
``all_reduce(SUM)`` of size O(latents) (``parallel.ring_attention``), so the
communication does not grow with the context, and no rank holds the whole
prefix's keys and values. The latent window and the self-attention stack
are replicated.

Usage::

    mesh = make_mesh(seq=n, device="cuda")        # one process per card
    fwd = make_seq_parallel_clm_forward(model, mesh, prefix_len=prefix_len)
    logits = fwd(input_ids)                       # (B, L, V) latent logits

    loss_fn = make_ring_clm_loss(model, mesh, max_latents=L)
    loss, metrics = loss_fn(model, batch, generator)

The gradient: the replicated latent stack sees every rank's upstream
gradient n-fold through the SUM whose backward is a SUM, so the exact
gradient is the parameter gradients AVERAGED over the ``seq`` group, which
a state sharded by ``training.loop.shard_train_state`` does (its FSDP plane
replicates over ``seq``); summing them, or not reducing them, is wrong.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_tpu_torch.parallel.mesh import AXIS_SEQ, axis_group, axis_size
from perceiver_io_tpu_torch.training.losses import IGNORE_INDEX, _cross_entropy


def _split_prompt(input_ids, pad_mask, prefix_len: int, check: bool = True):
    """(latent ids, prefix ids, prefix pad mask). ``check`` refuses padding
    outside the prefix (left padding only), as the JAX function does on a
    concrete mask; the ring loss passes ``check=False``, which is what JAX's
    jitted trainer route computes (its mask is a tracer there)."""
    latent_ids = input_ids[:, prefix_len:]
    prefix_ids = input_ids[:, :prefix_len]
    prefix_pad = None if pad_mask is None else pad_mask[:, :prefix_len]
    if check and pad_mask is not None and bool(pad_mask[:, prefix_len:].any()):
        raise ValueError("padding must be confined to the (left-padded) prefix")
    return latent_ids, prefix_ids, prefix_pad


def _check_prefix(prefix_len: int, seq_size: int, axis_name: str) -> None:
    if prefix_len < seq_size:
        raise ValueError(
            f"prefix_len ({prefix_len}) must be at least the '{axis_name}' axis size ({seq_size}) so every "
            "device gets a non-empty prefix block; use the dense forward for prefix-free inputs")
    if prefix_len % seq_size != 0:
        raise ValueError(f"prefix_len ({prefix_len}) must be divisible by the '{axis_name}' axis size "
                         f"({seq_size})")


def _forward(model, group, input_ids, pad_mask, prefix_len: int, generator, deterministic: bool,
             check: bool = True) -> torch.Tensor:
    """The latent logits of the global prompt ``input_ids`` (B, S): this
    rank's prefix block, the replicated latents."""
    dev = model.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if pad_mask is not None:
        pad_mask = torch.as_tensor(pad_mask, device=dev).bool()
    latent_ids, prefix_ids, prefix_pad = _split_prompt(input_ids, pad_mask, prefix_len, check)
    n, i = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    per = prefix_len // n
    block = slice(i * per, (i + 1) * per)
    return model.seq_parallel_forward(latent_ids, prefix_ids[:, block], group=group,
                                      prefix_pad_local=None if prefix_pad is None else prefix_pad[:, block],
                                      deterministic=deterministic, generator=generator)


def make_seq_parallel_clm_forward(model, mesh, *, prefix_len: int, axis_name: str = AXIS_SEQ):
    """``fn(input_ids, pad_mask=None, generator=None, deterministic=True) ->
    latent logits`` (B, L, V), the same on every rank of the axis.

    ``input_ids`` is the global (B, S) prompt; the first ``prefix_len``
    columns are split over ``axis_name`` (which must divide ``prefix_len``),
    the latent suffix is replicated. ``pad_mask`` marks left padding (the
    prefix only; padding past it raises). ``deterministic=False`` is the
    training forward (the prefix keep mask drawn from ``generator``)."""
    seq_size = axis_size(mesh, axis_name)
    _check_prefix(prefix_len, seq_size, axis_name)
    group = axis_group(mesh, axis_name)

    def fn(input_ids, pad_mask=None, generator: Optional[torch.Generator] = None, deterministic: bool = True):
        return _forward(model, group, input_ids, pad_mask, prefix_len, generator, deterministic)

    return fn


def make_seq_parallel_clm_loss(model, mesh, *, prefix_len: int, axis_name: str = AXIS_SEQ):
    """``loss(input_ids, labels, pad_mask=None, generator=None,
    deterministic=True) -> scalar``: the mean next-token CE over the latent
    positions with the prefix sharded over ``axis_name``; ``labels`` (B, L)
    are the latent positions' targets, -100 = ignore. Differentiable:
    ``loss.backward()`` on every rank, then the gradients averaged over the
    axis (see the module docstring), is the dense loss's gradient."""
    fwd = make_seq_parallel_clm_forward(model, mesh, prefix_len=prefix_len, axis_name=axis_name)

    def loss(input_ids, labels, pad_mask=None, generator=None, deterministic: bool = True):
        logits = fwd(input_ids, pad_mask, generator, deterministic)
        return _cross_entropy(logits, torch.as_tensor(labels, device=logits.device).long())[0]

    return loss


def make_ring_clm_loss(model, mesh, *, max_latents: int, axis_name: str = AXIS_SEQ):
    """The CLM loss over the sequence-parallel path, in the trainer's
    signature ``loss_fn(model, batch, generator, deterministic=False) ->
    (loss, metrics)`` over ``{"input_ids", "labels", "pad_mask"}`` batches
    (the ``--trainer.strategy=ring`` and ``seq`` route): the loss window is
    the last ``max_latents`` positions, ``prefix_len`` the batch's length
    less ``max_latents``. Padded latent labels are masked (-100), as the
    dense ``clm_loss_fn`` masks them, and a pad mask reaching into the latent
    window is taken as JAX's jitted trainer route takes it (the forward reads
    the prefix's padding alone) instead of raising. A batch's
    ``prefix_keep_idx`` is not read: the keep set is drawn in the forward.
    Under a sharded step the mean is the global batch's
    (``losses.global_batch_mean``)."""
    group = axis_group(mesh, axis_name)
    seq_size = axis_size(mesh, axis_name)

    def loss_fn(m, batch, generator: Optional[torch.Generator] = None, deterministic: bool = False):
        dev = m.device
        x = torch.as_tensor(batch["input_ids"], device=dev).long()
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        pad_mask = batch["pad_mask"]
        prefix_len = x.shape[1] - max_latents
        _check_prefix(prefix_len, seq_size, axis_name)
        lat_labels = labels[:, -max_latents:]
        if pad_mask is not None:
            pad_mask = torch.as_tensor(pad_mask, device=dev).bool()
            lat_labels = torch.where(pad_mask[:, -max_latents:], torch.full_like(lat_labels, IGNORE_INDEX),
                                     lat_labels)
        logits = _forward(m, group, x, pad_mask, prefix_len, generator, deterministic, check=False)
        loss, _ = _cross_entropy(logits, lat_labels)
        return loss, {"loss": loss}

    # the per-call valid-token normalization (as clm_loss_fn's)
    loss_fn.uniform_weighting = None
    return loss_fn
