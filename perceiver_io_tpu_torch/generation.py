"""Autoregressive generation with KV caches and a sliding window (counterpart
of ``perceiver_io_tpu/generation.py``): sampling, the host-driven decode
pair :func:`make_decode_fns`, :func:`generate`, and the batched paged decode
step the serving engine drives (:func:`make_paged_step_fn`).

Windows follow the JAX package's roll-free discipline: the caches get
``max_new_tokens`` slots of slack, and "truncate the oldest" masks the
expired slot through start counters instead of shifting the buffers.

Sampling randomness: JAX's key chain cannot be reproduced with
``torch.Generator``, so the port has its own contract. Every emitted token of
a row takes exactly ONE uniform draw, ``torch.rand((1,), generator=g)`` from
that row's CPU generator, mapped through the inverse CDF of the filtered
softmax. A request decoded in a batched engine slot and the same request
decoded alone therefore draw the same numbers. Greedy decoding draws nothing.
The paged step draws on the host before its body runs and hands the draws to
the device in a fixed buffer, so that its body (a CUDA graph on the card)
never touches the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch

from perceiver_io_tpu_torch.core.cache import KVCache
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
from perceiver_io_tpu_torch.device import DeviceLike, check_same_device, resolve_device
from perceiver_io_tpu_torch.graphs import Graph, warm_up

# one generator for every row of a batch, or one per row (None = idle row)
Generators = Union[torch.Generator, Sequence[Optional[torch.Generator]]]


@dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def _shift_left_if_full(cache: KVCache) -> KVCache:
    """Drop the oldest slot when the cache is full (the fixed-capacity analog
    of the reference's ``[:, -max_len+1:]`` truncation)."""
    if cache.length < cache.capacity:
        return cache
    return KVCache(torch.roll(cache.k, -1, dims=1), torch.roll(cache.v, -1, dims=1), cache.length - 1)


def _filtered_logits(logits: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """The f32 temperature/top-k/top-p-filtered logits :func:`_sample` draws
    from (filtered entries are ``-inf``)."""
    logits = logits.float() / max(config.temperature, 1e-6)
    if config.top_k is not None:
        top_k = min(config.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if config.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # number of tokens needed to reach top_p mass (at least 1); V when the
        # f32 mass of all V stays below top_p (top_p > 1, or a sum that ends
        # at 0.99999994), where the last entry's logit keeps every entry, as
        # the JAX function's out-of-range take keeps them all
        cutoff_idx = torch.sum(cum < config.top_p, dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff_logit = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff_logit, float("-inf"))
    return logits


def _draw_uniforms(generators: Generators, n_rows: int) -> torch.Tensor:
    """One uniform per row (CPU f32): ``n_rows`` draws from one shared
    generator, or one draw from each row's own generator (0 for idle rows,
    which draw nothing)."""
    if isinstance(generators, torch.Generator):
        return torch.rand((n_rows,), generator=generators)
    if len(generators) != n_rows:
        raise ValueError(f"{len(generators)} generators for {n_rows} rows")
    return torch.cat([
        torch.zeros(1) if g is None else torch.rand((1,), generator=g) for g in generators
    ])


def _sample_at(logits: torch.Tensor, config: GenerationConfig, u: Optional[torch.Tensor]) -> torch.Tensor:
    """Next-token ids (B,) from (B, V) logits: argmax, or the inverse CDF of
    the filtered softmax at the uniforms ``u`` (B,) on the logits' device."""
    if not config.do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filtered_logits(logits, config), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    # first index whose cumulative mass exceeds u * total: never a
    # zero-probability (filtered) entry
    idx = torch.searchsorted(cdf, (u[:, None] * cdf[:, -1:]).contiguous(), right=True)[:, 0]
    return idx.clamp_(max=logits.shape[-1] - 1)


def _sample(logits: torch.Tensor, config: GenerationConfig, generators: Generators) -> torch.Tensor:
    """:func:`_sample_at` at one uniform draw per row from ``generators``
    (none for greedy decoding)."""
    u = _draw_uniforms(generators, logits.shape[0]).to(logits.device) if config.do_sample else None
    return _sample_at(logits, config, u)


def _require_pads_in_prefix(pad_mask: Optional[torch.Tensor], prefix_len: int) -> None:
    """Left padding must not reach into the latent region: the latent
    self-attention stack carries no pad mask (reference semantics)."""
    if pad_mask is None:
        return
    max_pads = int(pad_mask.sum(dim=1).max())
    if max_pads > prefix_len:
        raise ValueError(
            f"left padding ({max_pads} tokens) reaches into the latent region "
            f"(prefix_len={prefix_len}); lower num_latents or shorten the padding"
        )


def _validate_window(mcfg, seq_len: int, num_latents: int) -> int:
    """Window validation (the reference error contract). Returns the prefix
    length."""
    if not 0 < seq_len <= mcfg.max_seq_len:
        raise ValueError(f"Input sequence length out of valid range [1..{mcfg.max_seq_len}]")
    if not 0 < num_latents <= mcfg.max_latents:
        raise ValueError(f"num_latents={num_latents} out of valid range [1..{mcfg.max_latents}]")
    num_latents = min(seq_len, num_latents)
    prefix_len = seq_len - num_latents
    max_prefix_len = mcfg.max_seq_len - mcfg.max_latents
    if prefix_len > max_prefix_len:
        num_latents_min = num_latents + prefix_len - max_prefix_len
        raise ValueError(
            f"For given sequence of length={seq_len}, num_latents must "
            f"be in range [{num_latents_min}..{mcfg.max_latents}]"
        )
    return prefix_len


def _model_device(model, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    check_same_device(dev, model.device, "the model")
    return model.device


def _finish_sample(sampled: torch.Tensor, done: torch.Tensor, config: GenerationConfig):
    """EOS freezing: finished rows emit ``pad_token_id`` from then on."""
    if config.eos_token_id is not None:
        sampled = torch.where(done, torch.full_like(sampled, config.pad_token_id), sampled)
        done = done | (sampled == config.eos_token_id)
    return sampled, done


def _decode_step_body(model, config: GenerationConfig, state: dict):
    """One decode step over the contiguous caches, shared by
    :func:`make_decode_fns` and :func:`generate`: slide the windows when full
    (expired slots masked through the start counters, host ints here), apply
    the model on the last token, sample, freeze finished rows."""
    mcfg = model.config
    cache = state["cache"]
    ca_cache, sa_cache = cache[0], cache[1]
    ca_start, sa_start = state["ca_start"], state["sa_start"]
    if ca_cache.length - ca_start >= mcfg.max_seq_len:
        ca_start += 1
    if sa_cache.length - sa_start >= mcfg.max_latents:
        sa_start += 1
    dev = state["token"].device
    ca_idx = torch.arange(ca_cache.capacity, device=dev)[None, :]
    sa_idx = torch.arange(sa_cache.capacity, device=dev)[None, :]
    out = model(
        state["token"][:, None], prefix_len=0,
        pad_mask=state["pad_slots"] | (ca_idx < ca_start), kv_cache=cache, decode=True,
        sa_pad_mask=sa_idx < sa_start, pos_shift=state["pos_shift"],
    )
    sampled = _sample(out.logits[:, -1], config, state["generator"])
    sampled, done = _finish_sample(sampled, state["done"], config)
    new_state = dict(state, cache=out.kv_cache, ca_start=ca_start, sa_start=sa_start,
                     token=sampled, done=done)
    return new_state, sampled


def make_decode_fns(model, num_latents: int = 1, config: Optional[GenerationConfig] = None,
                    cache_dtype: torch.dtype = torch.float32, *, device: DeviceLike = "cuda"):
    """The host-driven decode pair ``(prefill, step)``.

    - ``prefill(input_ids, pad_mask=None, generator=None) -> (first_token,
      state)``: validation, cache allocation (``max_new_tokens`` of slack),
      the prompt pass, the first sample. ``input_ids`` (B, S) may be a numpy
      array; ``generator`` is one CPU ``torch.Generator`` for the batch
      (seeded 0 when None).
    - ``step(state) -> (state, token)``: one decode step.

    ``cache_dtype`` is the contiguous caches' dtype (f32 by default, as in
    the JAX package, whatever the model's compute dtype). The model must
    live on ``device``; asking for CUDA without a card raises.
    """
    config = config or GenerationConfig()
    if config.max_new_tokens < 1:
        raise ValueError("decode fns require max_new_tokens >= 1")
    dev = _model_device(model, device)
    mcfg = model.config

    def prefill(input_ids, pad_mask=None, generator: Optional[torch.Generator] = None):
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        input_ids = torch.as_tensor(input_ids, device=dev).long()
        b, seq_len = input_ids.shape
        prefix_len = _validate_window(mcfg, seq_len, num_latents)
        if pad_mask is None:
            pad_mask = torch.zeros((b, seq_len), dtype=torch.bool, device=dev)
        pad_mask = torch.as_tensor(pad_mask, device=dev).bool()
        _require_pads_in_prefix(pad_mask, prefix_len)
        ca_capacity = seq_len + config.max_new_tokens
        sa_capacity = num_latents + config.max_new_tokens
        cache = CausalSequenceModel.init_cache(mcfg, b, ca_capacity, sa_capacity, cache_dtype, dev)
        pos_shift = pad_mask.sum(dim=1, keepdim=True)
        pad_slots = torch.zeros((b, ca_capacity), dtype=torch.bool, device=dev)
        pad_slots[:, :seq_len] = pad_mask
        out = model(input_ids, prefix_len=prefix_len, pad_mask=pad_mask, kv_cache=cache)
        next_token = _sample(out.logits[:, -1], config, generator)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        if config.eos_token_id is not None:
            done = next_token == config.eos_token_id
        state = {
            "cache": out.kv_cache,
            "ca_start": 0,
            "sa_start": 0,
            "token": next_token,
            "generator": generator,
            "done": done,
            "pad_slots": pad_slots,
            "pos_shift": pos_shift,
        }
        return next_token, state

    def step(state: dict):
        return _decode_step_body(model, config, state)

    return prefill, step


def generate(model, input_ids, num_latents: int = 1, pad_mask=None,
             config: Optional[GenerationConfig] = None, generator: Optional[torch.Generator] = None,
             cache_dtype: torch.dtype = torch.float32, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """Generate ``config.max_new_tokens`` continuation tokens for a
    left-padded prompt ``input_ids`` (B, S); returns (B, S + max_new_tokens)
    including the prompt."""
    config = config or GenerationConfig()
    dev = _model_device(model, device)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if config.max_new_tokens <= 0:
        return input_ids
    prefill, step = make_decode_fns(model, num_latents, config, cache_dtype, device=device)
    token, state = prefill(input_ids, pad_mask, generator)
    tokens: List[torch.Tensor] = [token]
    for _ in range(config.max_new_tokens - 1):
        state, token = step(state)
        tokens.append(token)
    return torch.cat([input_ids, torch.stack(tokens, dim=1)], dim=1)


def _paged_decode_step_body(model, config: GenerationConfig, state: dict):
    """One BATCHED decode step over paged caches: the engine analog of
    :func:`_decode_step_body` with every window counter, length, generator
    and done flag per slot. Total over all slots: idle slots decode into the
    scratch page and the host discards their samples.

    ``state`` keys: ``cache`` (paged CA + per-layer paged SA), ``ca_start`` /
    ``sa_start`` (S,) int32, ``token`` (S,), ``uniforms`` (S,) f32 (this
    step's draws when sampling, see :class:`_UniformStage`), ``generators``
    (list of S CPU generators, None for idle slots; read by the host only),
    ``done`` (S,) bool, ``pad_slots`` (S, ca_capacity) bool, ``pos_shift``
    (S, 1).

    The body runs on the device alone (no host sync, no host draw), and it
    writes the next state into the tensors it read: ``token``, ``done``,
    ``ca_start``, ``sa_start`` and every pool's ``length``, so a CUDA graph
    of it replays on the same state. Returns ``(state, tokens)``, ``tokens``
    being ``state["token"]``."""
    mcfg = model.config
    cache = state["cache"]
    ca_cache, sa_cache = cache[0], cache[1]
    ca_start = state["ca_start"] + ((ca_cache.length - state["ca_start"]) >= mcfg.max_seq_len).int()
    sa_start = state["sa_start"] + ((sa_cache.length - state["sa_start"]) >= mcfg.max_latents).int()
    dev = state["token"].device
    ca_idx = torch.arange(ca_cache.capacity, device=dev)[None, :]
    sa_idx = torch.arange(sa_cache.capacity, device=dev)[None, :]
    out = model(
        state["token"][:, None], prefix_len=0,
        pad_mask=state["pad_slots"] | (ca_idx < ca_start[:, None]), kv_cache=cache, decode=True,
        sa_pad_mask=sa_idx < sa_start[:, None], pos_shift=state["pos_shift"],
    )
    sampled = _sample_at(out.logits[:, -1], config, state["uniforms"])
    sampled, done = _finish_sample(sampled, state["done"], config)
    for pool, advanced in zip(cache, out.kv_cache):
        pool.length.copy_(advanced.length)
    state["ca_start"].copy_(ca_start)
    state["sa_start"].copy_(sa_start)
    state["token"].copy_(sampled)
    state["done"].copy_(done)
    return state, state["token"]


class _UniformStage:
    """The host half of a sampled paged step: one uniform per slot from its
    own CPU generator (0 for idle slots), staged in pinned memory on the
    card's machine and copied into the state's fixed ``uniforms`` buffer
    ahead of the step. Greedy decoding draws nothing."""

    def __init__(self, config: GenerationConfig, device: torch.device):
        self.config = config
        self._host: Optional[torch.Tensor] = None
        self._copied = torch.cuda.Event() if device.type == "cuda" else None

    def __call__(self, state: dict) -> None:
        if not self.config.do_sample:
            return
        u = _draw_uniforms(state["generators"], state["uniforms"].shape[0])
        if self._copied is None:
            state["uniforms"].copy_(u)
            return
        if self._host is None:
            self._host = torch.empty(u.shape, dtype=u.dtype, pin_memory=True)
        self._copied.synchronize()  # the last step's copy has read the staging buffer
        self._host.copy_(u)
        state["uniforms"].copy_(self._host, non_blocking=True)
        self._copied.record()


def _state_tensors(state: dict) -> tuple:
    """The addresses of every tensor a paged step reads or writes."""
    tensors = [t for pool in state["cache"] for t in (pool.k, pool.v, pool.page_table, pool.length)]
    tensors += [state[k] for k in ("ca_start", "sa_start", "token", "uniforms", "done", "pad_slots", "pos_shift")]
    return tuple(t.data_ptr() for t in tensors)


class _GraphedPagedStep:
    """The paged step on the card: the first call runs the body once on a
    side stream (the warm-up: a real step) and captures it into a CUDA graph
    on that state's tensors; every later call stages the draws and replays.
    A call with another state raises."""

    def __init__(self, model, config: GenerationConfig):
        self.model, self.config = model, config
        self.stage = _UniformStage(config, model.device)
        self.graph: Optional[Graph] = None
        self._bound = None
        self._stream = torch.cuda.Stream(model.device)

    def __call__(self, state: dict):
        self.stage(state)
        if self.graph is None:
            out = warm_up(lambda: _paged_decode_step_body(self.model, self.config, state), self._stream)
            self.graph = Graph(lambda: _paged_decode_step_body(self.model, self.config, state)[1],
                               "the paged decode step", self._stream)
            self._bound = _state_tensors(state)
            return out
        if _state_tensors(state) != self._bound:
            raise ValueError("this paged step is captured on another state's tensors: a state's tensors "
                             "are written in place, never replaced (core.cache.commit_prefill_)")
        return state, self.graph.replay()


def make_paged_step_fn(model, config: Optional[GenerationConfig] = None, *, device: DeviceLike = "cuda"):
    """The batched engine's decode step ``step(state) -> (state, tokens)``
    over a paged-cache state (see :func:`_paged_decode_step_body`); the
    state's tensors are written in place. ``serving.engine`` builds the
    state and owns the join/retire loop.

    On the card the step is a CUDA graph, as the JAX package jits it: its
    first call is a real step that also captures the graph on that state's
    tensors, and later calls replay it. On the CPU, where the caller asked
    for the CPU, it runs the body eagerly. The host draws each step's
    uniforms before the body runs (one per active slot, as before)."""
    config = config or GenerationConfig()
    dev = _model_device(model, device)
    if dev.type == "cuda":
        return _GraphedPagedStep(model, config)
    stage = _UniformStage(config, dev)

    def step(state: dict):
        stage(state)
        return _paged_decode_step_body(model, config, state)

    return step
