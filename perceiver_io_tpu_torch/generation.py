"""Autoregressive generation with KV caches and a sliding window (counterpart
of ``perceiver_io_tpu/generation.py``): sampling, the host-driven decode
pair :func:`make_decode_fns` (its prefill alone: :func:`make_prefill_fn`),
:func:`generate` and its many-call form :func:`make_generate_fn`, the
batched paged decode step the serving engine drives
(:func:`make_paged_step_fn`), the engine's shared-prefix prefill
(:func:`make_shared_prefill_fn`) and its resume seam
(:func:`advance_generator`), speculative self-drafting decode (the drafter
:func:`make_drafter`, the pair :func:`make_speculative_decode_fns` and the
engine's span step :func:`make_speculative_paged_step_fn`),
:func:`beam_search`, and the serving measurement wrapper
:func:`make_instrumented_generate_fn` with its cancellation seam
(:class:`GenerationAborted`, :class:`GenerationDeadlineExceeded`) and
:class:`GenerationStats`.

Every decode entry point takes ``cache_dtype`` (f32, bf16 or int8 caches,
``core.cache``) and ``weight_dtype`` (None, or ``torch.int8``: the decode
step on int8 weights, :class:`_Int8Weights`), as the JAX package's do.

Windows follow the JAX package's roll-free discipline: the caches get
``max_new_tokens`` slots of slack, and "truncate the oldest" masks the
expired slot through start counters instead of shifting the buffers. The
speculative paths and beam search do not slide the CA window (they refuse a
geometry that would); beam search slides its SA windows by rolling them.

Sampling randomness: JAX's key chain cannot be reproduced with
``torch.Generator``, so the port has its own contract. Every emitted token of
a row takes exactly ONE uniform draw, ``torch.rand((1,), generator=g)`` from
that row's CPU generator, mapped through the inverse CDF of the filtered
softmax. A request decoded in a batched engine slot and the same request
decoded alone therefore draw the same numbers. Greedy decoding draws nothing.
So a generator's position is the count of tokens it has sampled: a request
resumed after ``n`` tokens draws on from :func:`advance_generator`'s ``n``
draws, as JAX's ``advance_rng_chain`` splits its key ``n`` times.
Both steps (the pair's and the engine's, one body: :func:`_decode_step_body`)
draw on the host before the body runs and hand the draws to the device in a
fixed buffer, and keep their window counters and cache lengths on the
device, so that the body (a CUDA graph on the card) never touches the host.

A speculative span keeps the same invariant, a slot's generator position is
the count of tokens it has emitted, so :func:`advance_generator`, the
engine's resume and ``recover`` work unchanged in spec mode
(:func:`_span_draws`, :func:`advance_span_generators`):

- before a span the host stages ``k + 1`` token uniforms a slot, drawn one
  at a time from a CLONE of the slot's generator; emitted token ``j`` is the
  inverse CDF of the residual (``j < k``) or of ``p_{k+1}`` at draw ``j``;
- after the host reads the emitted count ``m``, it advances the real
  generator by ``m`` draws, the same numbers;
- the ``k`` drafter draws and ``k`` acceptance uniforms come from a
  generator seeded by a blake2b hash of the slot generator's state at the
  span's start and a salt (JAX: ``fold_in(rng, _DRAFT_SALT)``), so they
  depend on the seed and the tokens emitted alone;
- all of them go into the state's fixed ``uniforms`` buffer, (rows, 3k+1),
  ahead of the step (:class:`_UniformStage`); greedy spans draw nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from perceiver_io_tpu_torch.core.cache import KVCache
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
from perceiver_io_tpu_torch.device import DeviceLike, check_same_device, resolve_device
from perceiver_io_tpu_torch.graphs import Graph, capture_stream, warm_up
from perceiver_io_tpu_torch.obs import profiler
from perceiver_io_tpu_torch.obs.probes import decode_health
from perceiver_io_tpu_torch.ops.quant import quantize_tensor, quantize_weights, quantized_linears

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


class GenerationAborted(RuntimeError):
    """Raise from an ``on_token`` callback to stop a request mid-decode.

    The cancellation seam of :func:`make_instrumented_generate_fn`: the
    wrapper classifies the abort by :attr:`outcome` instead of ``"error"``,
    so the ``request`` event (and ``GenerationStats``) carries the honest
    terminal outcome with the partial TTFT/TPOT already measured. The
    serving front end (``perceiver_io_tpu_torch.serving``) raises the
    :class:`GenerationDeadlineExceeded` subclass when a request's deadline
    expires mid-decode and this base class for explicit cancellation.
    """

    outcome = "cancelled"


class GenerationDeadlineExceeded(GenerationAborted):
    """Mid-decode deadline expiry — stamped as a ``timeout`` outcome."""

    outcome = "timeout"


def _shift_left_if_full(cache: KVCache) -> KVCache:
    """Drop the oldest slot when the cache is full (the fixed-capacity analog
    of the reference's ``[:, -max_len+1:]`` truncation), the scale planes of
    an int8 cache with their rows (JAX's ``map_slots``). A host length
    returns rolled copies; a device length (:func:`beam_search`'s captured
    step) rolls the buffers in place where the cache is full, so the branch
    is the device's and the addresses stay."""
    if torch.is_tensor(cache.length):
        full = cache.length >= cache.capacity
        for buf in cache.buffers():
            buf.copy_(torch.where(full, torch.roll(buf, -1, dims=1), buf))
        return cache.with_length(cache.length - full.int())
    if cache.length < cache.capacity:
        return cache
    return cache.map_slots(lambda buf: torch.roll(buf, -1, dims=1), cache.length - 1)


class _Int8Weights:
    """int8 copies of a model's matmul weights (``ops.quant``: every
    ``nn.Linear`` weight, one f32 scale an output channel) in buffers of
    their own, at fixed addresses for the object's life: what a decode step
    under ``weight_dtype=torch.int8`` reads.

    :meth:`quantize_` writes the model's current weights into the buffers in
    place (where JAX quantizes per call, the prefill of each call does, so a
    request served poisoned weights quantizes its NaN too). :meth:`serving`
    is the step's side: it dequantizes every buffer to the model's compute
    dtype and puts the results in place of the modules' weights for the
    block, the originals back after it, so that inside a captured step the
    dequantization is part of the graph and runs at every replay (JAX
    dequantizes inside its scan body). Modules shared with the model (the
    speculative drafter's) read the same dequantized weights."""

    def __init__(self, model):
        self.linears = quantized_linears(model)
        self.dtype = getattr(model, "dtype", torch.float32)
        self.q = quantize_weights(model)

    def quantize_(self) -> None:
        with torch.no_grad():
            for name, linear in self.linears.items():
                quantize_tensor(linear.weight, out=self.q[name])

    @contextlib.contextmanager
    def serving(self):
        saved = []
        try:
            for name, linear in self.linears.items():
                saved.append((linear, linear._parameters["weight"]))
                linear._parameters["weight"] = self.q[name].dequantize(self.dtype)
            yield
        finally:
            for linear, weight in saved:
                linear._parameters["weight"] = weight


def _int8_weights(model, weight_dtype) -> Optional[_Int8Weights]:
    """The decode weights ``weight_dtype`` asks for: None (the model's own,
    untouched) or ``torch.int8`` (an :class:`_Int8Weights`); anything else
    raises ValueError, as the JAX package's ``_maybe_quantize_weights``."""
    if weight_dtype is None:
        return None
    if weight_dtype != torch.int8:
        raise ValueError(f"weight_dtype must be None or torch.int8, got {weight_dtype!r}")
    return _Int8Weights(model)


def _with_weights(body, weights: Optional[_Int8Weights]):
    """``body`` run with ``weights``' dequantized weights in place (``body``
    itself where the model's own weights serve)."""
    if weights is None:
        return body

    def served(*args):
        with weights.serving():
            return body(*args)

    return served


def _requantizing(prefill, weights: Optional[_Int8Weights]):
    """``prefill`` (on the float weights) that then quantizes the model's
    weights into ``weights``' buffers, per call, as JAX's prefill does."""
    if weights is None:
        return prefill

    def fn(*args, **kwargs):
        out = prefill(*args, **kwargs)
        weights.quantize_()
        return out

    return fn


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
    """One decode step, over the contiguous caches of :func:`make_decode_fns`
    (one window for the batch: 0-d ``ca_start``/``sa_start`` and cache
    lengths) or over the engine's paged caches (every window counter,
    length, draw and done flag per slot, (S,)). Slide the windows when full
    (expired slots masked through the start counters), apply the model on
    the last token, sample at this step's staged uniforms, freeze finished
    rows. Total over all rows: the engine's idle slots decode into the
    scratch page and the host discards their samples.

    ``state`` keys: ``cache``, ``ca_start`` / ``sa_start`` int32,
    ``token``, ``uniforms`` f32 (this step's draws when sampling, see
    :class:`_UniformStage`), ``generator`` (the pair's, one for the batch)
    or ``generators`` (the engine's, one per slot, None for idle slots;
    read by the host only), ``done`` bool, ``pad_slots`` (rows,
    ca_capacity) bool, ``pos_shift`` (rows, 1), the pair's ``logits``
    (the last position's, (B, V)), and with the pair's ``probes=True`` its
    ``probe`` dict (:func:`~perceiver_io_tpu_torch.obs.probes.decode_health`
    of this step's logits and post-append cross-attention cache, 0-d f32
    tensors).

    The body runs on the device alone (no host sync, no host draw), and it
    writes the next state into the tensors it read: ``token``, ``done``,
    ``ca_start``, ``sa_start``, every cache's ``length`` (and ``logits``,
    ``probe``), so a CUDA graph of it replays on the same state. Returns ``(state,
    tokens)``, ``tokens`` being ``state["token"]``."""
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
        pad_mask=state["pad_slots"] | (ca_idx < ca_start.reshape(-1, 1)), kv_cache=cache, decode=True,
        sa_pad_mask=sa_idx < sa_start.reshape(-1, 1), pos_shift=state["pos_shift"],
    )
    logits = out.logits[:, -1]
    sampled = _sample_at(logits, config, state["uniforms"])
    sampled, done = _finish_sample(sampled, state["done"], config)
    for c, advanced in zip(cache, out.kv_cache):
        c.length.copy_(advanced.length)
    state["ca_start"].copy_(ca_start)
    state["sa_start"].copy_(sa_start)
    state["token"].copy_(sampled)
    state["done"].copy_(done)
    if "logits" in state:
        state["logits"].copy_(logits)
    if "probe" in state:
        for key, value in decode_health(logits, cache[0], ca_start).items():
            state["probe"][key].copy_(value)
    return state, state["token"]


# the engine's step: the same body over paged caches
_paged_decode_step_body = _decode_step_body


class _UniformStage:
    """The host half of a sampled step: one uniform per row, from the
    pair's generator or from each engine slot's own (0 for idle slots),
    staged in pinned memory on the card's machine and copied into the
    state's fixed ``uniforms`` buffer ahead of the step. With ``k`` > 0 (a
    speculative span of ``k`` drafts) a row stages the span's ``3k + 1``
    draws instead (:func:`_span_draws`). Greedy decoding draws nothing."""

    def __init__(self, config: GenerationConfig, device: torch.device, k: int = 0):
        self.config, self.k = config, k
        self._host: Optional[torch.Tensor] = None
        self._copied = torch.cuda.Event() if device.type == "cuda" else None

    def __call__(self, state: dict) -> None:
        if not self.config.do_sample:
            return
        generators = state["generators"] if "generators" in state else state["generator"]
        rows = state["uniforms"].shape[0]
        if self.k:
            if isinstance(generators, torch.Generator):
                generators = [generators] * rows
            u = torch.stack([_span_draws(g, self.k) for g in generators])
        else:
            u = _draw_uniforms(generators, rows)
        if self._copied is None:
            state["uniforms"].copy_(u)
            return
        if self._host is None:
            self._host = torch.empty(u.shape, dtype=u.dtype, pin_memory=True)
        self._copied.synchronize()  # the last step's copy has read the staging buffer
        self._host.copy_(u)
        state["uniforms"].copy_(self._host, non_blocking=True)
        self._copied.record()


_STATE_KEYS = ("ca_start", "sa_start", "token", "uniforms", "done", "pad_slots", "pos_shift", "logits")


def _state_tensors(state: dict) -> tuple:
    """The addresses of every tensor a step reads or writes: each cache's
    buffers, (table) and length (the drafter's too), and the state's own
    tensors."""
    tensors = [t for key in ("cache", "draft_cache") for pool in state.get(key, ()) for t in vars(pool).values()
               if t is not None]
    tensors += [state[k] for k in _STATE_KEYS if state.get(k) is not None]
    tensors += list(state.get("probe", {}).values())
    return tuple(t.data_ptr() for t in tensors)


class _GraphedStep:
    """A decode step on the card: the first call runs the body once on a
    side stream (the warm-up: a real step) and captures it into a CUDA graph
    on that state's tensors; every later call stages the draws and replays.
    A call with another state raises.

    ``body(state) -> (state, *outputs)`` is the step (the decode step's
    :func:`_decode_step_body` by default) and ``stage(state)`` its host half
    (a :class:`_UniformStage` by default); a call returns ``(state,
    *outputs)``, the outputs the graph's own tensors, rewritten by the next
    replay."""

    def __init__(self, model, config: GenerationConfig, name: str, body=None, stage=None):
        self.model, self.config, self.name = model, config, name
        self.body = body if body is not None else (lambda state: _decode_step_body(model, config, state))
        self.stage = stage if stage is not None else _UniformStage(config, model.device)
        self.graph: Optional[Graph] = None
        self._bound = None
        self._stream = capture_stream(model.device)
        # read by obs.recompile.RecompileTracker, as CapturedStep's are: the
        # captures made (0 or 1) and each capturing call's host seconds
        self.captures = 0
        self.capture_s: List[float] = []

    def __call__(self, state: dict):
        self.stage(state)
        if self.graph is None:
            t0 = time.perf_counter()
            out = warm_up(lambda: self.body(state), self._stream)
            self.graph = Graph(lambda: self.body(state)[1:], self.name, self._stream)
            self._bound = _state_tensors(state)
            self.captures += 1
            self.capture_s.append(time.perf_counter() - t0)
            return out
        if _state_tensors(state) != self._bound:
            raise ValueError(f"{self.name} is captured on another state's tensors: a state's tensors are written "
                             "in place, never replaced (core.cache.commit_prefill_ for the engine's)")
        return (state,) + tuple(self.graph.replay())


def _eager_step(model, config: GenerationConfig, device: torch.device, body=None, stage=None):
    """The step's body run eagerly, its draws staged first: the step on the
    CPU, and the card's reference for the captured one. ``body`` and
    ``stage`` are :class:`_GraphedStep`'s."""
    stage = stage if stage is not None else _UniformStage(config, device)
    body = body if body is not None else (lambda state: _decode_step_body(model, config, state))

    def step(state: dict):
        stage(state)
        return body(state)

    return step


def _prefilled_state(out, logits: torch.Tensor, next_token: torch.Tensor, generator: torch.Generator,
                     config: GenerationConfig, pad_slots: torch.Tensor, pos_shift: torch.Tensor,
                     probes: bool = False) -> dict:
    """The decode state a prefill hands over (see :func:`make_decode_fns`);
    with ``probes``, its ``probe`` dict holds the prompt pass's decode
    health (token 0), so the state carries the same keys before and after
    every step."""
    dev, b = next_token.device, next_token.shape[0]
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    if config.eos_token_id is not None:
        done = next_token == config.eos_token_id
    zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    state = {
        "cache": tuple(c.on_device() for c in out.kv_cache),
        "ca_start": zero(),
        "sa_start": zero(),
        "token": next_token.clone(),
        "uniforms": torch.zeros((b,), dtype=torch.float32, device=dev),
        "generator": generator,
        "done": done,
        "pad_slots": pad_slots,
        "pos_shift": pos_shift,
        "logits": logits,
    }
    if probes:
        state["probe"] = decode_health(logits, state["cache"][0], state["ca_start"])
    return state


def _prefill_config(model, config: Optional[GenerationConfig], device: DeviceLike):
    """The budget check and the device both prefill builders start from."""
    config = config or GenerationConfig()
    if config.max_new_tokens < 1:
        raise ValueError("decode fns require max_new_tokens >= 1")
    return config, _model_device(model, device)


def _prefill_pass(model, input_ids: torch.Tensor, pad_mask: Optional[torch.Tensor], prefix_len: int,
                  num_latents: int, config: GenerationConfig, cache_dtype: torch.dtype, generator: torch.Generator,
                  ca_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, probes: bool = False):
    """The prefill both builders run over (B, M) ``input_ids`` on the
    model's device: a fresh cache for the whole prompt and the budget, the
    model's pass, the first sample (one draw from ``generator``) and the
    decode state. ``ca_rows`` are the resident (k, v) cross-attention rows of
    the prompt's ``skip`` leading tokens, (skip, C) each, that ``input_ids``
    follow: they fill the cache's slots [0, skip) and the pass runs at
    ``pos_offset=skip``."""
    dev = input_ids.device
    b, m = input_ids.shape
    skip = 0 if ca_rows is None else ca_rows[0].shape[0]
    ca_capacity = skip + m + config.max_new_tokens
    cache = CausalSequenceModel.init_cache(model.config, b, ca_capacity, num_latents + config.max_new_tokens,
                                           cache_dtype, dev)
    pos_offset = None
    if ca_rows is not None:
        ca = cache[0]
        ca.k[:, :skip] = ca_rows[0].to(ca.k.dtype)
        ca.v[:, :skip] = ca_rows[1].to(ca.v.dtype)
        cache, pos_offset = (ca.with_length(skip),) + tuple(cache[1:]), skip
    pad_slots = torch.zeros((b, ca_capacity), dtype=torch.bool, device=dev)
    if pad_mask is None:
        pos_shift = torch.zeros((b, 1), dtype=torch.long, device=dev)
    else:
        pos_shift = pad_mask.sum(dim=1, keepdim=True)
        pad_slots[:, skip:skip + m] = pad_mask
    out = model(input_ids, prefix_len=prefix_len, pad_mask=pad_mask, kv_cache=cache, pos_offset=pos_offset)
    logits = out.logits[:, -1].clone()
    next_token = _sample(logits, config, generator)
    return next_token, _prefilled_state(out, logits, next_token, generator, config, pad_slots, pos_shift, probes)


def make_prefill_fn(model, num_latents: int = 1, config: Optional[GenerationConfig] = None,
                    cache_dtype: torch.dtype = torch.float32, probes: bool = False, *, device: DeviceLike = "cuda"):
    """The prefill of :func:`make_decode_fns` alone, ``prefill(input_ids,
    pad_mask=None, generator=None) -> (first_token, state)``: no decode step
    is built beside it (the serving engine keeps one prefill per decode
    budget and latent count, and decodes through its own paged step).
    ``probes``: the state's ``probe`` (see :func:`make_decode_fns`)."""
    config, dev = _prefill_config(model, config, device)
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
        with profiler.scope("prefill"):
            return _prefill_pass(model, input_ids, pad_mask, prefix_len, num_latents, config, cache_dtype, generator,
                                 probes=probes)

    return prefill


def make_shared_prefill_fn(model, num_latents: int, skip_tokens: int, seq_len: int,
                           config: Optional[GenerationConfig] = None, cache_dtype: torch.dtype = torch.float32,
                           *, device: DeviceLike = "cuda"):
    """The prefill of a ``seq_len``-token prompt whose first ``skip_tokens``
    tokens have their cross-attention K/V rows resident in shared pool pages
    (the engine's prefix match): the rows are gathered from the pages into a
    fresh contiguous cache, and the model runs over the unshared suffix alone
    (``pos_offset=skip_tokens``), so the prefill's work shrinks to the
    suffix's.

    The result is the unshared prefill's (:func:`make_prefill_fn`) where
    both hold: ``skip_tokens`` is whole pages inside the prompt's context
    region (``skip_tokens <= seq_len - num_latents``; a context row is a
    function of its token and absolute position alone under rotate-at-write
    RoPE, while latent rows pass through ``q_norm`` and the SA stack), and
    the suffix carries every latent. The engine enforces both and otherwise
    joins unshared; this function refuses a geometry that breaks them. The
    suffix's cross-attention runs K2 over the filled cache
    (``core.attention``), as the unshared prefill runs it over the fresh
    keys.

    Returns ``shared_prefill(suffix_ids, pool_k, pool_v, page_ids,
    generator=None) -> (first_token, state)``: ``suffix_ids`` (B,
    ``seq_len - skip_tokens``), ``pool_k``/``pool_v`` the paged CA pools
    (num_pages, page_size, C), ``page_ids`` the matched run
    (``skip_tokens // page_size``,). The first token takes one draw from
    ``generator``, as the unshared prefill's does, and ``state`` carries the
    unshared prefill's keys. Only the pools' pages named are read; nothing
    is written into them. An int8 ``cache_dtype`` raises, as in JAX.
    """
    config, dev = _prefill_config(model, config, device)
    suffix_len = seq_len - skip_tokens
    if cache_dtype == torch.int8:
        raise ValueError("shared prefill over an int8 cache needs the scale-plane gather; the engine gates sharing "
                         "off for cache_dtype=torch.int8")
    if skip_tokens < 1:
        raise ValueError(f"skip_tokens must be >= 1, got {skip_tokens}")
    if suffix_len < num_latents:
        raise ValueError(f"matched run ({skip_tokens} tokens) reaches into the latent region of a {seq_len}-token "
                         f"prompt with {num_latents} latents: latent rows are not shareable")
    _validate_window(model.config, seq_len, num_latents)

    def shared_prefill(suffix_ids, pool_k: torch.Tensor, pool_v: torch.Tensor, page_ids,
                       generator: Optional[torch.Generator] = None):
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        suffix_ids = torch.as_tensor(suffix_ids, device=dev).long()
        if suffix_ids.shape[1] != suffix_len:
            raise ValueError(f"suffix is {suffix_ids.shape[1]} tokens; this fn skips {skip_tokens} of {seq_len}")
        page_ids = torch.as_tensor(page_ids, device=dev).long()
        if page_ids.shape[0] * pool_k.shape[1] != skip_tokens:
            raise ValueError(f"{page_ids.shape[0]} pages of {pool_k.shape[1]} do not cover {skip_tokens} skipped "
                             "tokens (whole pages only)")
        # the resident prefix rows: pool pages -> contiguous slots [0, skip)
        with profiler.scope("shared_prefill"):
            rows = (pool_k[page_ids].reshape(skip_tokens, -1), pool_v[page_ids].reshape(skip_tokens, -1))
            return _prefill_pass(model, suffix_ids, None, suffix_len - num_latents, num_latents, config,
                                 cache_dtype, generator, rows)

    return shared_prefill


def advance_generator(generator: torch.Generator, n_tokens: int, config: GenerationConfig) -> torch.Generator:
    """Advance ``generator`` (in place; returned) past the draws of
    ``n_tokens`` emitted tokens: one ``torch.rand((1,))`` a token when
    ``config.do_sample``, as :func:`_draw_uniforms` draws a row's uniform,
    and nothing for greedy decoding. One draw at a time, as the decode draws
    them (torch does not promise that a batched draw of ``n`` uniforms
    leaves a CPU generator where ``n`` single draws do). The engine's resume by prefill replay hands the replay's
    first sample the generator the uninterrupted stream would hold (JAX:
    ``advance_rng_chain``)."""
    if config.do_sample:
        for _ in range(int(n_tokens)):
            torch.rand((1,), generator=generator)
    return generator


def make_decode_fns(model, num_latents: int = 1, config: Optional[GenerationConfig] = None,
                    cache_dtype: torch.dtype = torch.float32, weight_dtype=None, probes: bool = False, *,
                    device: DeviceLike = "cuda"):
    """The host-driven decode pair ``(prefill, step)``.

    - ``prefill(input_ids, pad_mask=None, generator=None) -> (first_token,
      state)``: validation, cache allocation (``max_new_tokens`` of slack),
      the prompt pass, the first sample. ``input_ids`` (B, S) may be a numpy
      array; ``generator`` is one CPU ``torch.Generator`` for the batch
      (seeded 0 when None). It runs eagerly (its prompt length varies, as
      it retraces in JAX). The state's caches carry their lengths on the
      device (``KVCache.on_device``).
    - ``step(state) -> (state, token)``: one decode step
      (:func:`_decode_step_body`). It writes the state's tensors in place
      and returns the same state, and the emitted token (B,) as a tensor of
      its own; ``state["logits"]`` holds the step's last-position logits.

    On the card the step is a CUDA graph, as the JAX package jits it: its
    first call is a real step that also captures the graph on that state's
    tensors, and later calls replay it (a call with another state's tensors
    raises; one ``make_decode_fns`` pair serves one prefilled state at a
    time). On the CPU, where the caller asked for the CPU, it runs the body
    eagerly. The host draws each step's uniforms before the body runs.

    ``cache_dtype`` is the contiguous caches' dtype (f32 by default, as in
    the JAX package, whatever the model's compute dtype; ``torch.int8``
    stores int8 rows and bf16 scales). ``weight_dtype=torch.int8`` decodes on
    int8 weights (``ops.quant``): the prefill runs on the float weights and
    then quantizes them into the pair's own buffers, per call as in JAX, and
    the step dequantizes them to the model's compute dtype inside its body,
    at every replay. The model must live on ``device``; asking for CUDA
    without a card raises.

    ``probes=True`` (the decode health gauges, ``obs/probes.py``) adds a
    ``probe`` dict to the state: KV-cache occupancy fraction, mean logit
    entropy and non-finite logit fraction (0-d f32 tensors) of the prompt
    pass, then of each step, which writes them in place — outputs of the
    captured graph, like ``logits``, so a caller that keeps one across steps
    keeps a copy (``clone()``, no host sync). Off, the pair is exactly the
    pair without probes.
    """
    config = config or GenerationConfig()
    dev = _model_device(model, device)
    weights = _int8_weights(model, weight_dtype)
    prefill = _requantizing(make_prefill_fn(model, num_latents, config, cache_dtype, probes, device=dev), weights)
    return prefill, _decode_step(model, config, dev, weights)


def _decode_step(model, config: GenerationConfig, dev: torch.device, weights: Optional[_Int8Weights]):
    """:func:`make_decode_fns`' step over the decode weights ``weights``
    (None: the model's own)."""
    def step(state: dict):
        with profiler.scope("decode"):
            state, token = step.body(state)
            return state, token.clone()

    # the body: a _GraphedStep on the card (its ``graph`` is the captured
    # CUDA graph once the first call has run), the eager body on the CPU;
    # ``captured`` is what obs.recompile.RecompileTracker reads
    body = _with_weights(lambda state: _decode_step_body(model, config, state), weights)
    step.body = (_GraphedStep(model, config, "the decode step", body) if dev.type == "cuda"
                 else _eager_step(model, config, dev, body))
    step.captured = step.body if dev.type == "cuda" else None
    return step


def generate(model, input_ids, num_latents: int = 1, pad_mask=None,
             config: Optional[GenerationConfig] = None, generator: Optional[torch.Generator] = None,
             cache_dtype: torch.dtype = torch.float32, weight_dtype=None, *,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Generate ``config.max_new_tokens`` continuation tokens for a
    left-padded prompt ``input_ids`` (B, S); returns (B, S + max_new_tokens)
    including the prompt. The prefill runs eagerly, then :func:`make_decode_fns`'
    step: on the card one captured CUDA graph, replayed for every token after
    the second (the JAX package's compiled scan). ``cache_dtype`` and
    ``weight_dtype`` (None or ``torch.int8``) are :func:`make_decode_fns`'."""
    config = config or GenerationConfig()
    dev = _model_device(model, device)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if config.max_new_tokens <= 0:
        return input_ids
    prefill, step = make_decode_fns(model, num_latents, config, cache_dtype, weight_dtype, device=device)
    token, state = prefill(input_ids, pad_mask, generator)
    tokens: List[torch.Tensor] = [token]
    for _ in range(config.max_new_tokens - 1):
        state, token = step(state)
        tokens.append(token)
    return torch.cat([input_ids, torch.stack(tokens, dim=1)], dim=1)


def make_paged_step_fn(model, config: Optional[GenerationConfig] = None, weight_dtype=None, *,
                       device: DeviceLike = "cuda"):
    """The batched engine's decode step ``step(state) -> (state, tokens)``
    over a paged-cache state (see :func:`_decode_step_body`); the
    state's tensors are written in place. ``serving.engine`` builds the
    state and owns the join/retire loop.

    On the card the step is a CUDA graph, as the JAX package jits it: its
    first call is a real step that also captures the graph on that state's
    tensors, and later calls replay it. On the CPU, where the caller asked
    for the CPU, it runs the body eagerly. The host draws each step's
    uniforms before the body runs (one per active slot, as before).

    ``weight_dtype=torch.int8`` quantizes the model's weights once, here (the
    JAX engine quantizes once at construction), into the step's own
    buffers; the step dequantizes them inside its body at every replay."""
    config = config or GenerationConfig()
    dev = _model_device(model, device)
    body = _with_weights(lambda state: _decode_step_body(model, config, state), _int8_weights(model, weight_dtype))

    def step(state: dict):
        with profiler.scope("decode_paged"):
            return step.body(state)

    # as _decode_step's: the captured step (or the eager body) and what
    # obs.recompile.RecompileTracker reads
    step.body = (_GraphedStep(model, config, "the paged decode step", body) if dev.type == "cuda"
                 else _eager_step(model, config, dev, body))
    step.captured = step.body if dev.type == "cuda" else None
    return step


def _load_state_(dst: dict, src: dict) -> None:
    """Write a prefilled state into another state of the same geometry, in
    place: every cache's buffers and length, the state's own tensors, and the
    generator (a host object). ``dst``'s tensors keep their addresses, so a
    step captured on them replays on the new request."""
    for d, c in zip(dst["cache"], src["cache"]):
        for d_buf, c_buf in zip(d.buffers(), c.buffers()):
            d_buf.copy_(c_buf)
        d.length.copy_(c.length)
    for key in _STATE_KEYS:
        if key in dst:
            dst[key].copy_(src[key])
    for key, value in dst.get("probe", {}).items():
        value.copy_(src["probe"][key])
    dst["generator"] = src["generator"]


# ---------------------------------------------------------------------------
# speculative self-drafting decode
# ---------------------------------------------------------------------------

# mixed into the hash that seeds a span's drafter and acceptance draws, so
# they never repeat the slot generator's own numbers
_DRAFT_SALT = b"perceiver-io-speculative-draft"


def make_drafter(model, draft_depth: int):
    """The truncated-depth self-drafter: a model of ``model``'s class over
    its config with the latent self-attention stack cut to its first
    ``draft_depth`` layers, sharing ``model``'s modules
    (:meth:`CausalSequenceModel.truncated`: no parameter is copied, so a
    poisoned request's in-place weights reach the drafter as they reach the
    flagship). Layer ``i``'s input is layer ``i - 1``'s output, so the
    drafter's prompt pass is the flagship's truncated after layer
    ``draft_depth - 1`` (plus the shared out-norm and readout): its caches
    are the flagship's prefill caches' prefix (the CA cache and the first
    ``draft_depth`` SA caches)."""
    mcfg = model.config
    n_layers = mcfg.num_self_attention_layers
    if not 1 <= draft_depth < n_layers:
        raise ValueError(f"draft_depth must be in [1..{n_layers - 1}] (a {n_layers}-layer flagship), "
                         f"got {draft_depth}")
    rotary = mcfg.num_self_attention_rotary_layers
    cfg = dataclasses.replace(mcfg, num_self_attention_layers=draft_depth,
                              num_self_attention_rotary_layers=rotary if rotary == -1 else min(rotary, draft_depth))
    return model.truncated(cfg)


def _span_draws(generator: Optional[torch.Generator], k: int) -> torch.Tensor:
    """A span's ``3k + 1`` uniforms for one row (zeros for an idle slot):
    ``[0, k+1)`` the next ``k + 1`` draws of ``generator``, one at a time
    from a clone (the real generator is advanced by the emitted count after
    the span, :func:`advance_generator`), emitted token ``j``'s draw;
    ``[k+1, 2k+1)`` the drafter's draws and ``[2k+1, 3k+1)`` the acceptance
    uniforms, from a generator seeded by a hash of ``generator``'s state, so
    they depend on the seed and the tokens emitted alone."""
    if generator is None:
        return torch.zeros(3 * k + 1)
    state = generator.get_state()
    clone = torch.Generator()
    clone.set_state(state)
    own = [torch.rand((1,), generator=clone) for _ in range(k + 1)]
    digest = hashlib.blake2b(state.numpy().tobytes() + _DRAFT_SALT, digest_size=8).digest()
    side = torch.Generator().manual_seed(int.from_bytes(digest, "little") >> 1)
    return torch.cat(own + [torch.rand((2 * k,), generator=side)])


def _inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Ids (...) drawn from ``probs`` (..., V) at the uniforms ``u`` (...):
    the first index whose cumulative mass exceeds ``u`` times the total,
    never a zero-probability entry (:func:`_sample_at`'s rule)."""
    cdf = torch.cumsum(probs, dim=-1)
    idx = torch.searchsorted(cdf, (u[..., None] * cdf[..., -1:]).contiguous(), right=True)[..., 0]
    return idx.clamp_(max=probs.shape[-1] - 1)


def _speculative_accept(config: GenerationConfig, drafts: torch.Tensor, q_logits: torch.Tensor,
                        p_logits: torch.Tensor, done: torch.Tensor, uniforms: Optional[torch.Tensor] = None):
    """The draft/verify acceptance core of the pair and the engine, row by
    row (ragged accepted prefixes fall out per slot).

    Greedy: accept while the flagship's argmax agrees with the draft; the
    first disagreement (or the bonus position after ``k`` accepts) emits the
    flagship's argmax, the sequential greedy stream token for token.
    Sampling: accept ``d_i`` with probability ``min(1, p_i(d_i) /
    q_i(d_i))`` (the multiplied form ``u q <= p``), draw the first rejection
    from the residual ``norm(max(p_i - q_i, 0))`` (``p_i`` where the
    residual is 0), the bonus position from ``p_{k+1}``, both over the
    filtered distributions of :func:`_filtered_logits`: the emitted
    marginals are the sequential path's. Emitted token ``j``'s draw is
    ``uniforms[:, j]`` (the span layout of :func:`_span_draws`).

    :param drafts: (B, k) the drafter's proposals.
    :param q_logits: (B, k, V) the drafter's logits they were drawn from.
    :param p_logits: (B, k+1, V) the flagship's verify logits.
    :param done: (B,) EOS flags; the flag latches per emitted token.
    :param uniforms: (B, 3k+1) the span's draws when sampling, else None.
    :return: ``(tokens (B, k+1), m (B,), new_token (B,), done (B,))``: a row
        emits ``tokens[:m]`` (``pad_token_id`` past ``m``), ``new_token`` is
        ``tokens[m-1]``.
    """
    b, k = drafts.shape
    if config.do_sample:
        pf = torch.softmax(_filtered_logits(p_logits, config), dim=-1)
        qf = torch.softmax(_filtered_logits(q_logits, config), dim=-1)
        p_d = torch.gather(pf[:, :k], -1, drafts[..., None])[..., 0]
        q_d = torch.gather(qf, -1, drafts[..., None])[..., 0]
        accept = uniforms[:, 2 * k + 1:] * q_d <= p_d
        residual = torch.clamp(pf[:, :k] - qf, min=0.0)
        rsum = residual.sum(dim=-1, keepdim=True)
        resid = torch.where(rsum > 0, residual / torch.clamp(rsum, min=1e-20), pf[:, :k])
        fix = _inverse_cdf(torch.cat([resid, pf[:, k:]], dim=1), uniforms[:, : k + 1])
    else:
        fix = torch.argmax(p_logits, dim=-1)  # (B, k+1)
        accept = fix[:, :k] == drafts
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    m = n_acc + 1
    pad, eos = config.pad_token_id, config.eos_token_id
    toks, carry = [], done
    for j in range(k + 1):
        drafted = drafts[:, j] if j < k else fix[:, j]
        raw = torch.where(j < n_acc, drafted, torch.where(j == n_acc, fix[:, j], pad))
        emitted = j < m
        if eos is not None:
            raw = torch.where(carry, pad, raw)
            carry = torch.where(emitted, carry | (raw == eos), carry)
        toks.append(torch.where(emitted, raw, pad))
    tokens = torch.stack(toks, dim=1)
    new_token = torch.gather(tokens, 1, n_acc[:, None])[:, 0]
    return tokens, m, new_token, carry


def _validate_no_slide(mcfg, seq_len: int, num_latents: int, config: GenerationConfig) -> None:
    """A verify span scores ``k + 1`` positions in one forward, and a window
    that slid mid-span would need a different expiry mask per position, so
    the speculative paths (as :func:`beam_search`) need a geometry whose
    windows never fill while decoding."""
    n_lat = min(seq_len, num_latents)
    if seq_len + config.max_new_tokens > mcfg.max_seq_len or n_lat + config.max_new_tokens > mcfg.max_latents:
        raise ValueError(
            "speculative decode does not slide the window: need seq_len + max_new_tokens <= max_seq_len "
            f"({seq_len} + {config.max_new_tokens} vs {mcfg.max_seq_len}) and num_latents + max_new_tokens <= "
            f"max_latents ({n_lat} + {config.max_new_tokens} vs {mcfg.max_latents})")


def _speculative_step_body(model, drafter, config: GenerationConfig, k: int, state: dict):
    """One draft/verify span over the pair's contiguous caches (batch 1, 0-d
    lengths) or the engine's paged pools (per-slot lengths, idle slots into
    the scratch page): ``k + 1`` drafter decode steps over
    ``state["draft_cache"]`` (``k`` proposals by argmax or at the staged
    drafter draws, and a last append that keeps the drafter's caches whole
    through a span that accepts every draft), one flagship forward over
    ``[token, d_0..d_{k-1}]`` (the verify), :func:`_speculative_accept`,
    then the rollback: every cache's length tensor, the flagship's and the
    drafter's, gets ``length + m``, in place. The windows never slide
    (:func:`_validate_no_slide`; the engine checks its geometry). Like
    :func:`_decode_step_body` it runs on the device alone and writes the
    next state into the tensors it read. Returns ``(state, tokens (rows,
    k+1), m (rows,))``."""
    cache, drafted = state["cache"], state["draft_cache"]
    token, pos_shift = state["token"], state["pos_shift"]
    ca_idx = torch.arange(cache[0].capacity, device=token.device)[None, :]
    pad_rows = state["pad_slots"] | (ca_idx < state["ca_start"].reshape(-1, 1))
    u = state["uniforms"] if config.do_sample else None
    cur, drafts, q_logits = token, [], []
    for i in range(k + 1):
        out = drafter(cur[:, None], prefix_len=0, pad_mask=pad_rows, kv_cache=drafted, decode=True,
                      pos_shift=pos_shift)
        drafted = out.kv_cache
        if i < k:
            logits = out.logits[:, -1]
            cur = _sample_at(logits, config, None if u is None else u[:, k + 1 + i])
            drafts.append(cur)
            q_logits.append(logits)
    drafts = torch.stack(drafts, dim=1)
    verified = model(torch.cat([token[:, None], drafts], dim=1), prefix_len=0, pad_mask=pad_rows, kv_cache=cache,
                     decode=True, pos_shift=pos_shift)
    tokens, m, new_token, done = _speculative_accept(config, drafts, torch.stack(q_logits, dim=1),
                                                     verified.logits, state["done"], u)
    back = (m - (k + 1)).int()
    for c, full in zip(cache + state["draft_cache"], verified.kv_cache + drafted):
        c.length.copy_(full.length + back.reshape(full.length.shape))
    state["token"].copy_(new_token)
    state["done"].copy_(done)
    return state, tokens, m


def advance_span_generators(generators: Generators, m, config: GenerationConfig) -> None:
    """After a span: advance each row's generator (one, or one per slot,
    None for idle slots) by the tokens the row emitted, ``m`` (host ints),
    the draws its span read from a clone (:func:`_span_draws`), so a
    generator's position stays the count of tokens it has emitted."""
    if not config.do_sample:
        return
    if isinstance(generators, torch.Generator):
        generators = [generators]
    for g, n in zip(generators, m):
        if g is not None:
            advance_generator(g, int(n), config)


def _speculative_step(model, config: GenerationConfig, k: int, draft_depth: int, dev: torch.device, name: str,
                      weights: Optional[_Int8Weights] = None):
    """The span step of both speculative builders: a :class:`_GraphedStep`
    on the card, the eager body on the CPU. With ``weights`` the whole span
    (the drafter's steps and the verify) runs on the dequantized weights:
    the drafter shares the model's modules, as JAX's drafter shares the
    quantized tree (``drafter_decode_params``)."""
    drafter = make_drafter(model, draft_depth)
    stage = _UniformStage(config, dev, k)
    body = _with_weights(lambda state: _speculative_step_body(model, drafter, config, k, state), weights)

    if dev.type == "cuda":
        return _GraphedStep(model, config, name, body, stage)
    return _eager_step(model, config, dev, body, stage)


def make_speculative_decode_fns(model, num_latents: int = 1, config: Optional[GenerationConfig] = None, *,
                                k: int = 4, draft_depth: int = 1, cache_dtype: torch.dtype = torch.float32,
                                weight_dtype=None, device: DeviceLike = "cuda"):
    """The speculative host-driven pair ``(prefill, step)``.

    - ``prefill(input_ids, pad_mask=None, generator=None) -> (first_token,
      state)``: :func:`make_prefill_fn`'s prefill at batch 1 (batched
      speculative decode is the engine's, :func:`make_speculative_paged_step_fn`)
      with ``k + 1`` slots of slack on every cache for the span appended
      before the rollback, and the windows checked never to slide
      (:func:`_validate_no_slide`). The state adds ``draft_cache``: the
      drafter's caches (:func:`make_drafter`), copies of the prefill's CA
      cache and first ``draft_depth`` SA caches (no second prompt pass). They
      are tensors of their own, since the drafter's in-place appends would
      otherwise write into the flagship's span slots.
    - ``step(state) -> (state, tokens (1, k+1), m (1,))``: one span
      (:func:`_speculative_step_body`); the caller streams ``tokens[:, :m]``
      and calls again while budget remains. The host reads ``m`` when
      sampling, to advance the generator by the emitted tokens.

    Greedy output is the sequential pair's token for token; sampling keeps
    the sequential marginals and the generator contract of the module
    docstring. On the card the step is one CUDA graph (the first call a real
    step that captures), on the CPU the eager body, as
    :func:`make_decode_fns`' step. ``cache_dtype`` and ``weight_dtype`` are
    :func:`make_decode_fns`' (the prefill quantizes the weights per call).
    """
    config = config or GenerationConfig()
    if config.max_new_tokens < 1:
        raise ValueError("speculative decode fns require max_new_tokens >= 1")
    if k < 1:
        raise ValueError(f"k (draft tokens per span) must be >= 1, got {k}")
    dev = _model_device(model, device)
    mcfg = model.config
    slack = dataclasses.replace(config, max_new_tokens=config.max_new_tokens + k + 1)
    weights = _int8_weights(model, weight_dtype)

    def prefill(input_ids, pad_mask=None, generator: Optional[torch.Generator] = None):
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        input_ids = torch.as_tensor(input_ids, device=dev).long()
        b, seq_len = input_ids.shape
        if b != 1:
            raise ValueError("the speculative host-driven pair serves batch 1 (ragged accepted-prefix lengths need "
                             "per-row cache lengths: batched speculative decode is the engine's paged slot mode)")
        prefix_len = _validate_window(mcfg, seq_len, num_latents)
        if pad_mask is None:
            pad_mask = torch.zeros((b, seq_len), dtype=torch.bool, device=dev)
        pad_mask = torch.as_tensor(pad_mask, device=dev).bool()
        _require_pads_in_prefix(pad_mask, prefix_len)
        _validate_no_slide(mcfg, seq_len, num_latents, config)
        token, state = _prefill_pass(model, input_ids, pad_mask, prefix_len, num_latents, slack, cache_dtype,
                                     generator)
        state.pop("logits")
        state["draft_cache"] = tuple(c.map_slots(torch.clone, c.length.clone())
                                     for c in state["cache"][: 1 + draft_depth])
        state["uniforms"] = torch.zeros((b, 3 * k + 1), dtype=torch.float32, device=dev)
        if weights is not None:
            weights.quantize_()
        return token, state

    def step(state: dict):
        state, tokens, m = step.body(state)
        tokens, m = tokens.clone(), m.clone()
        advance_span_generators(state["generator"], m.tolist() if config.do_sample else (), config)
        return state, tokens, m

    step.body = _speculative_step(model, config, k, draft_depth, dev, "the speculative decode step", weights)
    step.captured = step.body if dev.type == "cuda" else None
    return prefill, step


def make_speculative_paged_step_fn(model, config: Optional[GenerationConfig] = None, *, k: int = 4,
                                   draft_depth: int = 1, weight_dtype=None, device: DeviceLike = "cuda"):
    """The engine's speculative batched step ``step(state) -> (state, tokens
    (S, k+1), m (S,))`` over :func:`make_paged_step_fn`'s paged state plus
    ``draft_cache`` (the drafter's CA pool and first ``draft_depth`` SA
    pools, with the flagship pools' geometry and page ids; ``serving.engine``
    commits and releases them beside the flagship's). One span a step
    (:func:`_speculative_step_body`): per-slot ``pad_rows`` from
    ``ca_start``, per-slot acceptance, done flags and rollback; total over
    idle slots, which draft and verify into the scratch page. The host
    stages the span's draws before the step (``uniforms`` (S, 3k+1)) and,
    having read ``m``, advances each slot's generator
    (:func:`advance_span_generators`). On the card one CUDA graph, on the CPU
    the eager body. The windows must never slide: the engine checks its
    geometry when it is built. ``weight_dtype=torch.int8`` quantizes once,
    here, as :func:`make_paged_step_fn`."""
    config = config or GenerationConfig()
    if k < 1:
        raise ValueError(f"k (draft tokens per span) must be >= 1, got {k}")
    dev = _model_device(model, device)
    return _speculative_step(model, config, k, draft_depth, dev, "the speculative paged step",
                             _int8_weights(model, weight_dtype))


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


def _beam_step_body(model, state: dict):
    """One beam-search step over the tiled contiguous caches, in place: the
    SA windows slide when full (:func:`_shift_left_if_full`; the CA cache
    cannot fill), the model on each beam's last token, every beam's top
    continuations over the flattened ``(beams x V)`` candidates, then the
    caches, sequences and flags reordered into their own buffers
    (``index_select``, JAX's ``take``). Finished beams continue with
    ``pad_token_id`` at no cost. Returns ``(state, tokens)``."""
    cache, b, beams, vocab = state["cache"], state["batch"], state["beams"], model.config.vocab_size
    shifted = (cache[0],) + tuple(_shift_left_if_full(c) for c in cache[1:])
    out = model(state["token"][:, None], prefix_len=0, pad_mask=state["pad_slots"], kv_cache=shifted, decode=True,
                pos_shift=state["pos_shift"])
    logprobs = torch.log_softmax(out.logits[:, -1].float(), dim=-1)
    if state["eos"] is not None:
        logprobs = torch.where(state["done"][:, None], state["frozen"][None, :], logprobs)
    cand = (state["beam_scores"][:, None] + logprobs).reshape(b, beams * vocab)
    new_scores, flat_idx = torch.topk(cand, beams, dim=1)
    new_token = (flat_idx % vocab).reshape(-1)
    rows = (state["batch_base"].reshape(b, beams) + flat_idx // vocab).reshape(-1)
    for c, advanced in zip(cache, out.kv_cache):
        for buf in c.buffers():
            buf.copy_(buf.index_select(0, rows))
        c.length.copy_(advanced.length)
    seqs = state["seqs"]
    seqs.copy_(seqs.index_select(0, rows))
    seqs.scatter_(1, state["t"].expand(seqs.shape[0], 1), new_token[:, None])
    done = state["done"].index_select(0, rows)
    if state["eos"] is not None:
        done = done | (new_token == state["eos"])
    state["done"].copy_(done)
    state["beam_scores"].copy_(new_scores.reshape(-1))
    state["token"].copy_(new_token)
    state["t"].add_(1)
    return state, state["token"]


def beam_search(model, input_ids, num_latents: int = 1, num_beams: int = 4, max_new_tokens: int = 64,
                length_penalty: float = 1.0, eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                pad_mask=None, cache_dtype: torch.dtype = torch.float32, weight_dtype=None, *,
                device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding over the fixed-capacity caches (the JAX
    function's counterpart). Beams live as extra batch rows (B * num_beams):
    the prompt pass runs on the B rows, its caches are tiled, and each step
    (:func:`_beam_step_body`) reorders them in place. On the card the step is
    one CUDA graph a call (the first step a real step that captures), on the
    CPU the eager body.

    ``seq_len + max_new_tokens`` must not exceed ``max_seq_len``: the search
    does not slide the CA window (beams share absolute positions); the SA
    windows slide. ``pad_mask`` (B, S), True at left padding, shifts each
    row's positions so a padded row decodes as its unpadded self. Scores are
    the summed log-probabilities over ``length ** length_penalty`` (the
    length up to and with the first EOS). ``cache_dtype`` and
    ``weight_dtype`` (None or ``torch.int8``: the steps on int8 weights
    quantized once a call, the prompt pass on the float ones) are
    :func:`make_decode_fns`'.

    :return: ``(sequences (B, S + max_new_tokens), scores (B,))``: each
        batch element's best beam and its length-penalized score.
    """
    dev = _model_device(model, device)
    mcfg = model.config
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, seq_len = input_ids.shape
    if num_beams < 1:
        raise ValueError("num_beams must be >= 1")
    weights = _int8_weights(model, weight_dtype)
    if seq_len + max_new_tokens > mcfg.max_seq_len:
        raise ValueError(f"seq_len + max_new_tokens ({seq_len + max_new_tokens}) exceeds max_seq_len "
                         f"({mcfg.max_seq_len}) — beam search does not slide the window")
    prefix_len = _validate_window(mcfg, seq_len, num_latents)
    if pad_mask is not None:
        pad_mask = torch.as_tensor(pad_mask, device=dev).bool()
    _require_pads_in_prefix(pad_mask, prefix_len)
    out = model(input_ids, prefix_len=prefix_len, pad_mask=pad_mask,
                kv_cache=CausalSequenceModel.init_cache(mcfg, b, dtype=cache_dtype, device=dev))
    bb = b * num_beams

    def tile(x):
        return x.repeat_interleave(num_beams, dim=0)

    cache = tuple(c.map_slots(tile, torch.tensor(c.length, dtype=torch.int32, device=dev)) for c in out.kv_cache)
    pad_slots = pos_shift = None
    if pad_mask is not None:
        pos_shift = tile(pad_mask.sum(dim=1, keepdim=True))
        pad_slots = torch.zeros((bb, cache[0].capacity), dtype=torch.bool, device=dev)
        pad_slots[:, :seq_len] = tile(pad_mask)
    top0, tok0 = torch.topk(torch.log_softmax(out.logits[:, -1].float(), dim=-1), num_beams, dim=-1)
    token = tok0.reshape(bb)
    seqs = torch.zeros((bb, max_new_tokens), dtype=torch.long, device=dev)
    seqs[:, 0] = token
    done = torch.zeros((bb,), dtype=torch.bool, device=dev) if eos_token_id is None else token == eos_token_id
    frozen = torch.full((mcfg.vocab_size,), float("-inf"), device=dev)
    frozen[pad_token_id] = 0.0
    state = {"cache": cache, "token": token, "done": done, "beam_scores": top0.reshape(bb), "seqs": seqs,
             "t": torch.ones((1, 1), dtype=torch.long, device=dev), "pad_slots": pad_slots, "pos_shift": pos_shift,
             "batch_base": torch.arange(b, device=dev).repeat_interleave(num_beams) * num_beams, "frozen": frozen,
             "eos": eos_token_id, "batch": b, "beams": num_beams}
    if max_new_tokens > 1:
        config = GenerationConfig()

        body = _with_weights(lambda st: _beam_step_body(model, st), weights)

        def no_draws(st):
            return None

        step = (_GraphedStep(model, config, "the beam search step", body, no_draws) if dev.type == "cuda"
                else _eager_step(model, config, dev, body, no_draws))
        for _ in range(max_new_tokens - 1):
            step(state)
    seqs, beam_scores = state["seqs"], state["beam_scores"]
    if eos_token_id is not None:
        is_eos = seqs == eos_token_id
        lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1, max_new_tokens)
    else:
        lengths = torch.full((bb,), max_new_tokens, device=dev)
    final = beam_scores / lengths.float() ** length_penalty
    best_rows = torch.arange(b, device=dev) * num_beams + torch.argmax(final.reshape(b, num_beams), dim=1)
    return torch.cat([input_ids, seqs[best_rows]], dim=1), final[best_rows]


@dataclass
class GenerationStats:
    """Host-measured serving telemetry for one generate request (the
    per-request numbers serving comparisons gate on)."""

    batch: int
    prompt_len: int
    new_tokens: int  # requested
    prefill_s: float  # TTFT: prompt pass + first token on the host clock
    decode_s: float  # wall time for the remaining tokens
    per_token_s: float  # MEAN TPOT — the percentiles live in the event/fields below
    tokens_per_sec: float  # batch * tokens_out / (prefill_s + decode_s)
    compiled: bool  # True when THIS call captured its decode step (timings include it)
    ttft_s: float = 0.0  # == prefill_s (serving-literature name)
    tokens_out: int = 0  # tokens actually produced (== new_tokens unless aborted)
    # terminal outcome of THIS call: "ok" | "error" | "timeout" | "cancelled"
    # ("shed" never reaches this wrapper — a shed request is rejected at
    # admission by the serving front end and never decodes)
    outcome: str = "ok"
    tpot_p50_s: Optional[float] = None  # histogram-derived decode percentiles
    tpot_p90_s: Optional[float] = None
    tpot_p99_s: Optional[float] = None
    # time the request sat queued before the worker picked it up (measured
    # by the caller and handed in per call); None when the caller did no
    # admission accounting
    queue_wait_s: Optional[float] = None
    # worst per-token non-finite-logit fraction (probes=True only): the
    # serving front end's breaker sentinel reads it
    nonfinite_logit_frac: Optional[float] = None


# contiguous decode states kept per (batch, prompt length) by one generate
# fn: each holds its captured step (on the card) and the caches it replays on
_DECODE_STATES_MAX = 8


class _DecodeStates:
    """The decode steps of one generate fn, one step and one fixed state per
    (batch, prompt length), least recently used first out past
    ``_DECODE_STATES_MAX``: ``states(state) -> (step, fixed)`` writes a
    prefilled ``state`` into its geometry's fixed state (:func:`_load_state_`)
    so that the step captured there replays on it; a new geometry keeps
    ``state`` itself and a fresh step (``wrap(step)`` of
    :func:`make_decode_fns`' step, on the decode weights ``weights``)."""

    def __init__(self, model, config: GenerationConfig, device: torch.device,
                 weights: Optional[_Int8Weights] = None, wrap=None):
        self._build = lambda: _decode_step(model, config, device, weights)
        self._wrap = wrap if wrap is not None else (lambda step: step)
        self._states: "OrderedDict[tuple, tuple]" = OrderedDict()

    def __call__(self, state: dict):
        key = tuple(state["pad_slots"].shape)
        if key in self._states:
            step, fixed = self._states.pop(key)
            _load_state_(fixed, state)
        else:
            while len(self._states) >= _DECODE_STATES_MAX:
                self._states.popitem(last=False)
            step, fixed = self._wrap(self._build()), state
        self._states[key] = (step, fixed)
        return step, fixed


def make_generate_fn(model, num_latents: int = 1, config: Optional[GenerationConfig] = None,
                     cache_dtype: torch.dtype = torch.float32, weight_dtype=None, *, device: DeviceLike = "cuda"):
    """``fn(input_ids, pad_mask=None, generator=None) -> tokens`` (B, S +
    max_new_tokens): :func:`generate` for many calls (the JAX function's
    counterpart, which jits it once a prompt shape). It keeps one captured
    decode state per (batch, prompt length), as
    :func:`make_instrumented_generate_fn` does: the first call of a geometry
    captures the step on its state, later ones write their prefill into that
    state and replay. ``weight_dtype=torch.int8``: one set of int8 buffers
    for the fn, which every call's prefill quantizes the weights into (JAX
    quantizes inside each call), read by every geometry's step."""
    config = config or GenerationConfig()
    dev = _model_device(model, device)
    weights = _int8_weights(model, weight_dtype)
    if config.max_new_tokens > 0:
        prefill = _requantizing(make_prefill_fn(model, num_latents, config, cache_dtype, device=dev), weights)
        states = _DecodeStates(model, config, dev, weights)

    def fn(input_ids, pad_mask=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        input_ids = torch.as_tensor(input_ids, device=dev).long()
        if config.max_new_tokens <= 0:
            return input_ids
        token, state = prefill(input_ids, pad_mask, generator)
        tokens: List[torch.Tensor] = [token]
        if config.max_new_tokens > 1:
            step, state = states(state)
            for _ in range(config.max_new_tokens - 1):
                state, token = step(state)
                tokens.append(token)
        return torch.cat([input_ids, torch.stack(tokens, dim=1)], dim=1)

    # the fn's decode steps by geometry (their captured graphs, for a caller
    # that inspects them)
    fn.decode_states = states if config.max_new_tokens > 0 else None
    return fn


def make_instrumented_generate_fn(model, num_latents: int = 1, config: Optional[GenerationConfig] = None,
                                  cache_dtype: torch.dtype = torch.float32, weight_dtype=None, events=None,
                                  registry=None, on_token=None, snapshot_interval_s: float = 30.0,
                                  probes: bool = False, *, device: DeviceLike = "cuda"):
    """``fn(input_ids, pad_mask=None, generator=None) -> (tokens,
    GenerationStats)``: the serving measurement wrapper (the JAX function's
    counterpart; the model holds its own weights, so there is no ``params``
    argument). A host-driven decode over :func:`make_decode_fns` with every
    token individually host-timed (a host value fetch of the token).

    Per call it records TTFT (prompt pass + first token) and a per-token
    decode-latency distribution in a log-bucketed ``obs.metrics.Histogram``;
    the ``request`` event emitted per call carries TTFT, TPOT p50/p90/p99
    from that histogram, tokens in/out, the cache geometry, the sparse
    bucket counts and the outcome. A request that dies mid-decode still
    emits its event with ``outcome="error"`` and the partial TPOT data
    before the exception re-raises; an ``on_token(i, token)`` callback
    raising :class:`GenerationAborted` / :class:`GenerationDeadlineExceeded`
    classifies the event as ``cancelled`` / ``timeout`` instead. Either way
    the exception re-raises with the partial stats attached as
    ``e.generation_stats`` (the marker the serving front end reads).

    On the card the step is the captured decode pair: one pair and one
    decode state per (batch, prompt length), the first request of a geometry
    capturing (``stats.compiled``; a ``compile`` event through
    ``obs.recompile``), later ones writing their prefilled state into that
    state (:func:`_load_state_`) and replaying. On the CPU the same loop
    runs the eager step, which never captures.

    ``fn(..., queue_wait_s=, arrival_ts=, tenant=)`` is the admission seam:
    queue wait lands on the ``request`` event, the request span and the
    ``generate_queue_wait_s`` histogram. ``registry`` (an
    ``obs.metrics.MetricsRegistry``; a fresh one when None) accumulates the
    cross-request counters and histograms and snapshots into ``metrics``
    rows at most every ``snapshot_interval_s``. ``probes=True`` runs the
    decode pair with its health gauges (``make_decode_fns(probes=True)``):
    each token's ``state["probe"]`` is copied on the device (no host sync in
    the token loop) and fetched once after the request, in one copy; the
    wrapper publishes ``generate_kv_cache_frac`` (gauge) and
    ``generate_logit_entropy`` (histogram) into the registry, puts
    ``kv_cache_frac``, ``logit_entropy_mean``/``_last`` and
    ``nonfinite_logit_frac`` on the ``request`` row, and fills
    ``GenerationStats.nonfinite_logit_frac`` (the worst token's), which the
    serving front end's breaker reads. ``cache_dtype`` and ``weight_dtype`` (None or
    ``torch.int8``) are :func:`make_generate_fn`'s: every request's prefill
    quantizes the weights it was served into the fn's int8 buffers.
    """
    config = config or GenerationConfig()
    if config.max_new_tokens < 1:
        raise ValueError("instrumented generation requires max_new_tokens >= 1")
    from perceiver_io_tpu_torch.obs import trace as obs_trace
    from perceiver_io_tpu_torch.obs.metrics import Histogram, MetricsRegistry
    from perceiver_io_tpu_torch.obs.recompile import RecompileTracker

    dev = _model_device(model, device)
    weights = _int8_weights(model, weight_dtype)
    tracker = RecompileTracker(events=events)
    prefill_fn = tracker.wrap(_requantizing(make_prefill_fn(model, num_latents, config, cache_dtype, probes,
                                                            device=dev), weights), "generate_prefill")
    decode_state = _DecodeStates(model, config, dev, weights, lambda step: tracker.wrap(step, "generate_decode_step"))

    registry = registry if registry is not None else MetricsRegistry()
    m_requests = registry.counter("generate_requests_total")
    m_cold = registry.counter("generate_cold_requests_total")
    m_errors = registry.counter("generate_request_errors_total")
    m_timeouts = registry.counter("generate_request_timeouts_total")
    m_cancelled = registry.counter("generate_request_cancelled_total")
    m_tokens = registry.counter("generate_tokens_out_total")
    # WARM samples only: a capture-inflated sample would poison the
    # dashboards' tails for good (the request's own event still reports it,
    # flagged by `compiled`)
    m_ttft = registry.histogram("generate_ttft_s")
    m_tpot = registry.histogram("generate_tpot_s")
    m_queue = registry.histogram("generate_queue_wait_s")
    m_entropy = registry.histogram("generate_logit_entropy") if probes else None
    m_kv_frac = registry.gauge("generate_kv_cache_frac") if probes else None
    tracer = obs_trace.Tracer(events, flush_every=64) if events is not None else None

    def health(state: dict) -> torch.Tensor:
        # a copy on the device (the next replay rewrites the state's own):
        # entropy, occupancy, non-finite fraction
        return torch.stack([state["probe"][k].float() for k in ("logit_entropy", "kv_cache_frac",
                                                                "nonfinite_logit_frac")])

    def fn(input_ids, pad_mask=None, generator: Optional[torch.Generator] = None, queue_wait_s=None,
           arrival_ts=None, tenant=None):
        b, prompt_len = input_ids.shape
        compiles_before = tracker.total_compiles
        request_id = obs_trace.new_span_id()
        hist = Histogram("tpot_s")  # THIS request's decode latencies
        toks: List[torch.Tensor] = []
        healths: List[torch.Tensor] = []
        outcome, err = "ok", None
        ttft = 0.0
        if queue_wait_s is not None:
            queue_wait_s = float(queue_wait_s)
            m_queue.record(queue_wait_s)
        span_cm = tracer.span("request", request_id=request_id) if tracer is not None else contextlib.nullcontext()
        t_all0 = time.perf_counter()
        with span_cm as sp:
            try:
                # timings end at a host value fetch of the token
                c0 = tracker.total_compiles
                t0 = time.perf_counter()
                token, state = prefill_fn(input_ids, pad_mask, generator)
                int(token[0])
                ttft = time.perf_counter() - t0
                if tracker.total_compiles == c0:
                    m_ttft.record(ttft)
                toks.append(token)
                if probes:
                    healths.append(health(state))
                if on_token is not None:
                    on_token(0, token)
                if config.max_new_tokens > 1:
                    step_fn, state = decode_state(state)
                for i in range(1, config.max_new_tokens):
                    c0 = tracker.total_compiles
                    t1 = time.perf_counter()
                    state, token = step_fn(state)
                    int(token[0])
                    dt = time.perf_counter() - t1
                    hist.record(dt)
                    if tracker.total_compiles == c0:
                        m_tpot.record(dt)
                    toks.append(token)
                    if probes:
                        healths.append(health(state))
                    if on_token is not None:
                        on_token(i, token)
            except BaseException as e:  # noqa: BLE001 — event out, then reraise
                # the cancellation seam: an on_token callback raising
                # GenerationAborted (deadline expiry, explicit cancel)
                # classifies by its declared outcome, not as an error
                outcome = e.outcome if isinstance(e, GenerationAborted) else "error"
                err = e
            if sp is not None:
                sp.set("outcome", outcome)
                sp.set("tokens_out", len(toks))
                if queue_wait_s is not None:
                    sp.set("queue_wait_s", round(queue_wait_s, 6))
                if tenant is not None:
                    sp.set("tenant", str(tenant))
        elapsed = time.perf_counter() - t_all0
        decode_s = max(elapsed - ttft, 0.0)
        tokens_out = len(toks)
        compiled = tracker.total_compiles > compiles_before
        health_row = None
        if probes and healths:
            # one host copy for the whole request's gauges. Guarded: on an
            # aborted request they came from the work that failed and the
            # copy may raise; the request row still goes out, without them,
            # and the original exception stays the one surfaced
            try:
                hh = torch.stack(healths).cpu().tolist()
                ents = [row[0] for row in hh]
                kv_frac = hh[-1][1]
                for e in ents:
                    m_entropy.record(e)
                m_kv_frac.set(kv_frac)
                health_row = {
                    "kv_cache_frac": round(kv_frac, 6),
                    "logit_entropy_mean": round(sum(ents) / len(ents), 6),
                    "logit_entropy_last": round(ents[-1], 6),
                    "nonfinite_logit_frac": round(max(row[2] for row in hh), 6),
                }
            except Exception:  # noqa: BLE001 — health is telemetry, never fatal
                health_row = None
        stats = GenerationStats(
            batch=b,
            prompt_len=prompt_len,
            new_tokens=config.max_new_tokens,
            prefill_s=round(ttft, 6),
            decode_s=round(decode_s, 6),
            per_token_s=round(decode_s / max(tokens_out - 1, 1), 6),
            tokens_per_sec=round(b * tokens_out / max(elapsed, 1e-9), 3),
            compiled=compiled,
            ttft_s=round(ttft, 6),
            tokens_out=tokens_out,
            outcome=outcome,
            tpot_p50_s=hist.percentile(50),
            tpot_p90_s=hist.percentile(90),
            tpot_p99_s=hist.percentile(99),
            queue_wait_s=None if queue_wait_s is None else round(queue_wait_s, 6),
            nonfinite_logit_frac=None if health_row is None else health_row["nonfinite_logit_frac"],
        )
        m_requests.inc()
        m_tokens.inc(tokens_out * b)
        if compiled:
            m_cold.inc()
        if outcome == "error":
            m_errors.inc()
        elif outcome == "timeout":
            m_timeouts.inc()
        elif outcome == "cancelled":
            m_cancelled.inc()
        if events is not None:
            row = asdict(stats)
            row.update(
                request_id=request_id,
                span_id=None if tracer is None else sp.span_id,
                # cache geometry: the fixed-capacity windows this request
                # decoded against (the admission-relevant footprint)
                ca_capacity=prompt_len + config.max_new_tokens,
                sa_capacity=num_latents + config.max_new_tokens,
                num_latents=num_latents,
                tpot_hist=dict(sorted((str(k), v) for k, v in hist.counts.items())),
            )
            if health_row is not None:
                row.update(health_row)
            else:
                row.pop("nonfinite_logit_frac", None)  # probes off / copy failed
            if queue_wait_s is None:
                row.pop("queue_wait_s", None)  # no admission accounting upstream
            elif arrival_ts is not None:
                row["arrival_ts"] = round(float(arrival_ts), 6)
            if tenant is not None:
                row["tenant"] = str(tenant)
            if hist.n and hist.n < 5:
                row["tpot_low_n"] = True
            if err is not None:
                row["error"] = repr(err)
            if row.get("span_id") is None:
                row.pop("span_id", None)  # let the ambient span stamp it
            # spans BEFORE the request row: a consumer reading the stream
            # finds the request's span already there
            if tracer is not None:
                tracer.flush()
            events.emit("request", **row)
            registry.maybe_emit(events, min_interval_s=snapshot_interval_s)
        if err is not None:
            # the caller sees the exception, not the return value: carry the
            # partial stats along so a serving front end keeps honest books
            try:
                err.generation_stats = stats
            except Exception:  # noqa: BLE001 — slotted/frozen exception types
                pass
            raise err
        out = torch.cat([torch.as_tensor(input_ids, device=dev).long()] + [t[:, None] for t in toks], dim=1)
        return out, stats

    fn.registry = registry  # exporter access (to_prometheus / snapshot)
    return fn
