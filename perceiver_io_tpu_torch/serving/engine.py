"""The continuous-batching serving engine on a paged KV cache (counterpart of
``perceiver_io_tpu/serving/engine.py::EngineFrontEnd``).

:class:`EngineFrontEnd` is a :class:`~perceiver_io_tpu_torch.serving.frontend.RequestFrontEnd`:
it inherits the whole admission tier (bounded queue, deadline projection,
breaker, drain, clean books, ``request`` events and the metrics registry),
adds a page-fit check (a request whose KV footprint can never fit the pools
sheds ``kv_pages_exhausted`` at admission), and replaces the sequential
service loop by a fixed set of decode slots driven through ONE batched step:

- **join**: a queued request's prompt runs the contiguous prefill
  (``generation.make_prefill_fn``, batch 1), then ``core.cache.commit_prefill_``
  lands its KV rows in freshly granted pages (``serving.pages``) and the slot
  enters the batch; a prefill failure frees both grants and books ``error``;
- **step**: every engine step decodes one token for every active slot
  (``generation.make_paged_step_fn``: per-slot lengths, window counters and
  generators, so each slot's stream equals the request decoded alone). On
  the card the step is one CUDA graph, captured at construction while every
  slot is idle; the engine's state tensors are therefore fixed for its life,
  and join and retire write into them in place;
- **the per-token seam**: every emitted token (token 0 at join) passes the
  fault injector, then cancellation, then the deadline; a slot whose
  outcome is terminal retires at the next token boundary, the same boundary
  as the sequential path's;
- **retire**: finished, cancelled, expired or killed slots leave between
  steps (:func:`core.cache.release_slot_`, in place), their pages return to
  the free list, the request's ``request`` row carries its TPOT histogram,
  queue wait and mean batch size at decode, and queued requests join without
  draining the batch.

- **prefix sharing** (``EngineConfig.prefix_sharing``, on by default as in
  JAX): every join publishes its prompt's whole context-region pages into a
  radix prefix index (``serving.prefix.PrefixIndex``); a later prompt that
  matches a resident run joins through
  ``generation.make_shared_prefill_fn`` (the matched pages' CA rows
  gathered from the pool, the suffix alone prefilled), and the refcounted
  allocator holds one copy of the run. A page leaves the pool, and the
  index, at its last holder's free (:meth:`EngineFrontEnd._free_ca`);
- **eviction** (``EngineConfig.eviction``, off by default): a queued
  request that fits the pool but not the free list reclaims pages from the
  least-progressed slot, which is PARKED (its prompt and served tokens
  kept) and later resumed by prefill replay over ``prompt + served`` with
  one latent more per served token and its generator advanced one draw a
  served token when sampling (``generation.advance_generator``); the books
  identity is ``submitted == terminal + queued + in_flight + parked``;
- **recovery**: with a ``serving.journal.RequestJournal`` the same replay
  survives the engine's death: :meth:`EngineFrontEnd.recover` on a fresh
  engine re-admits every journaled request that has no terminal record.

A poisoned request (``FaultInjector.poison_at``) is served its poisoned
weights for its prefill only, as in JAX: they are written into the model's
parameters in place for the prefill and the originals written back before
anything else runs, so the captured step keeps reading the same addresses
with the original values.

- **speculative slots** (``EngineConfig.spec_k`` > 0): every engine step is
  one draft/verify span a slot (``generation.make_speculative_paged_step_fn``:
  ``spec_k`` drafts of a ``spec_depth``-layer self-drafter sharing the
  model's weights, one verify forward, per-slot acceptance and rollback),
  emitting 1 to ``spec_k + 1`` tokens a slot, each through the per-token
  seam. The drafter's pools mirror the flagship's geometry and page ids, so
  one grant covers both; grants carry ``spec_k + 1`` tokens of slack for the
  span appended before the rollback. The mode needs the no-slide geometry,
  and prefix sharing is off in it (as in JAX).

Every join, fork, eviction and resume writes into the captured step's state
in place (``commit_prefill_``, ``release_slot_``, ``copy_``): no pool or
table tensor is ever rebound.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perceiver_io_tpu_torch.core.cache import commit_prefill_, release_slot_
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
from perceiver_io_tpu_torch.generation import (
    GenerationConfig,
    advance_generator,
    advance_span_generators,
    make_drafter,
    make_paged_step_fn,
    make_prefill_fn,
    make_shared_prefill_fn,
    make_speculative_paged_step_fn,
)
from perceiver_io_tpu_torch.obs import trace as obs_trace
from perceiver_io_tpu_torch.obs.metrics import Histogram, bucket_index
from perceiver_io_tpu_torch.obs.recompile import RecompileTracker
from perceiver_io_tpu_torch.serving.frontend import FrontEndRecord, RequestFrontEnd, _Ticket
from perceiver_io_tpu_torch.serving.journal import RequestJournal
from perceiver_io_tpu_torch.serving.pages import PageAllocator, PageGrant
from perceiver_io_tpu_torch.serving.prefix import PrefixIndex, chunk_key


@dataclass
class EngineConfig:
    """Geometry of the batched engine."""

    # decode slots (the most requests one step serves)
    slots: int = 4
    # tokens per KV page
    page_size: int = 8
    # per-slot token ceilings (prompt + decode budget); the page-table widths
    # derive from these, and a request beyond them sheds kv_pages_exhausted
    max_ca_tokens: int = 64
    max_sa_tokens: int = 32
    # pool size in units of fully loaded slots (1.0 = room for `slots`
    # maxed-out requests, plus the scratch page); below 1.0 the allocator
    # exerts real backpressure
    pool_headroom: float = 1.0
    # cross-request prefix sharing: joining prompts are matched against the
    # radix prefix index and the prefill skips resident pages (refcounted
    # shared grants); False runs the same workload unshared
    prefix_sharing: bool = True
    # page-pressure preemption: a queued request that COULD fit the pool but
    # not the free list reclaims pages from the least-progressed slot
    # (parked, resumed by prefill replay) instead of waiting. Requires the
    # no-slide geometry (max_ca_tokens <= max_seq_len, max_sa_tokens <=
    # max_latents; checked at construction): the replay rebuilds the
    # victim's latents as the tail of prompt + served tokens, which a slid
    # window cannot express
    eviction: bool = False
    # the speculative slot mode: spec_k > 0 drafts that many tokens a step
    # with a self-drafter of spec_depth latent SA layers sharing the model's
    # weights and verifies them in one batched forward, so a step emits 1 to
    # spec_k + 1 tokens a slot. Requires the no-slide geometry (checked at
    # construction); per-slot page spans carry spec_k + 1 tokens of slack
    spec_k: int = 0
    spec_depth: int = 1


def _no_slide(ec: EngineConfig, mcfg) -> bool:
    return ec.max_ca_tokens <= mcfg.max_seq_len and ec.max_sa_tokens <= mcfg.max_latents


def _slide_error(ec: EngineConfig, mcfg, what: str) -> ValueError:
    return ValueError(f"{what} the window: need max_ca_tokens <= max_seq_len "
                      f"({ec.max_ca_tokens} vs {mcfg.max_seq_len}) and max_sa_tokens <= max_latents "
                      f"({ec.max_sa_tokens} vs {mcfg.max_latents})")


class EngineFrontEnd(RequestFrontEnd):
    """The continuous-batching front end (see the module docstring).

    :param model: a ``CausalSequenceModel`` living on ``device``.
    :param engine_config: slot and page geometry.

    Every other argument is :class:`RequestFrontEnd`'s: ``num_latents``,
    ``base_config`` (sampling; ``max_new_tokens`` comes from each request),
    ``cache_dtype`` (the page pools' and the prefill caches' dtype; None:
    f32, as in the JAX engine; a bf16 model serves from bf16 pools with
    ``torch.bfloat16``; ``torch.int8`` stores int8 rows with bf16 scales,
    decoded by the gather route, with prefix sharing off), ``weight_dtype``
    (None, or ``torch.int8``: the decode step reads int8 weights quantized
    once at construction, dequantized inside the step), ``config``,
    ``events``, ``registry``, ``clock``, ``sleep``, ``injector``, ``journal`` (a ``RequestJournal`` or a path;
    it needs the no-slide geometry, as ``eviction`` does) and ``device``
    (``"cuda"`` by default; asking for CUDA without a card raises, pass
    ``device="cpu"`` for the plain versions).
    """

    # resume replays hit a (remaining, num_latents + n) geometry per
    # progress mark: the prefill caches are LRU-bounded, as JAX's are
    _PREFILL_CACHE_MAX = 64

    def __init__(self, model: CausalSequenceModel, *, engine_config: Optional[EngineConfig] = None, **kw):
        super().__init__(model, **kw)
        self.engine_config = ec = engine_config or EngineConfig()
        if (ec.eviction or self.journal is not None) and not _no_slide(ec, model.config):
            raise _slide_error(ec, model.config, "eviction and journal recovery resume by prefill replay and never "
                                                 "slide")
        self._spec = ec.spec_k > 0
        if self._spec and not _no_slide(ec, model.config):
            raise _slide_error(ec, model.config, "speculative slot mode never slides")
        # a verify span appends spec_k + 1 tokens before its rollback: every
        # per-slot page span and grant carries that slack
        self._spec_slack = ec.spec_k + 1 if self._spec else 0
        self._gen_config = self.base_config or GenerationConfig()
        ps = ec.page_size
        self._ca_pages_per_slot = -(-(ec.max_ca_tokens + self._spec_slack) // ps)
        self._sa_pages_per_slot = -(-(ec.max_sa_tokens + self._spec_slack) // ps)
        ca_pool = 1 + max(2, int(round(ec.slots * self._ca_pages_per_slot * ec.pool_headroom)))
        sa_pool = 1 + max(2, int(round(ec.slots * self._sa_pages_per_slot * ec.pool_headroom)))
        self.ca_alloc = PageAllocator(ca_pool, ps)
        self.sa_alloc = PageAllocator(sa_pool, ps)
        # the radix prefix index over CA pool pages (SA rows pass through
        # q_norm and the SA stack: request-specific, never shared)
        self.prefix_index = PrefixIndex(ps)
        def pools(config):
            return CausalSequenceModel.init_paged_cache(
                config, ec.slots, ps, ca_num_pages=ca_pool, ca_pages_per_slot=self._ca_pages_per_slot,
                sa_num_pages=sa_pool, sa_pages_per_slot=self._sa_pages_per_slot, dtype=self._cache_dtype,
                device=self.device,
            )

        caches = pools(model.config)
        s, dev = ec.slots, self.device
        self._state: Dict[str, Any] = {
            "cache": caches,
            "ca_start": torch.empty((s,), dtype=torch.int32, device=dev),
            "sa_start": torch.empty((s,), dtype=torch.int32, device=dev),
            "token": torch.empty((s,), dtype=torch.long, device=dev),
            # one draw a slot, or a span's 3 spec_k + 1 (generation._span_draws)
            "uniforms": torch.empty((s, 3 * ec.spec_k + 1) if self._spec else (s,), dtype=torch.float32,
                                    device=dev),
            "generators": [None] * s,
            "done": torch.empty((s,), dtype=torch.bool, device=dev),
            "pad_slots": torch.empty((s, caches[0].capacity), dtype=torch.bool, device=dev),
            "pos_shift": torch.empty((s, 1), dtype=torch.long, device=dev),
        }
        if self._spec:
            # the drafter's pools mirror the flagship's geometry and page ids:
            # a slot's grant indexes both, so the allocators' books cover the
            # drafter too
            self._state["draft_cache"] = pools(make_drafter(model, ec.spec_depth).config)
        self._reset_state()
        # a capture of the step is its "compile": a `compile` event, and the
        # `compiled` flag of the slots a capturing step decodes for
        self._tracker = RecompileTracker(events=self.events)
        # int8 weights are quantized once, here, by the step's builder (as the
        # JAX engine quantizes at construction); the prefills run on the
        # float weights
        if self._spec:
            self._step_fn = self._tracker.wrap(make_speculative_paged_step_fn(
                model, self._gen_config, k=ec.spec_k, draft_depth=ec.spec_depth, weight_dtype=self.weight_dtype,
                device=dev), "engine_decode_spec_step")
        else:
            self._step_fn = self._tracker.wrap(make_paged_step_fn(model, self._gen_config, self.weight_dtype,
                                                                  device=dev), "engine_decode_step")
        if dev.type == "cuda":
            # the capture: one step while every slot is idle (it writes only
            # the scratch page), then the state back to its initial values
            self._step_fn(self._state)
            self._reset_state()
        self._prefill_fns: "OrderedDict[tuple, Any]" = OrderedDict()
        self._shared_prefill_fns: "OrderedDict[tuple, Any]" = OrderedDict()
        # self._parked (the front end's) holds evicted and recovered slots,
        # FIFO: the oldest preempted work resumes first
        self._slots: List[Optional[_EngineSlot]] = [None] * s
        self._engine_steps = 0
        self._fill_sum = 0  # sum of active-slot counts over steps
        # request index -> served token ids (the streaming surface; the
        # token-exactness checks compare these with the sequential path)
        self.served_tokens: Dict[int, List[int]] = {}
        r = self.registry
        self._m_tokens = r.counter("generate_tokens_out_total")
        self._m_requests = r.counter("generate_requests_total")
        self._m_ttft = r.histogram("generate_ttft_s")
        self._m_tpot = r.histogram("generate_tpot_s")
        self._m_queue_wait = r.histogram("generate_queue_wait_s")
        self._m_fill = r.gauge("engine_batch_fill_frac")
        self._m_pages = r.gauge("engine_kv_pages_used")
        self._m_pages_frac = r.gauge("engine_kv_pages_frac")
        self._m_evictions = r.counter("serve_evictions_total")
        self._m_resumes = r.counter("serve_resumes_total")
        self._m_recovered = r.counter("serve_recovered_total")
        self._m_parked = r.gauge("serve_parked_depth")
        # joins whose prefill skipped resident pages, and the pages skipped
        # (tenant-labelled children too)
        self._m_prefix_hits = r.counter("serve_prefix_hits_total")
        self._m_prefix_pages = r.counter("serve_prefix_pages_shared")
        self._n_prefix_hits = 0
        self._n_prefix_pages_shared = 0
        if self._spec:
            # per-request drafter quality, recorded at retire
            self._m_accept = r.histogram("spec_acceptance_rate")
            self._m_tps = r.histogram("spec_tokens_per_step")
        # per-tenant pages held (feeds engine_kv_pages_used{tenant=...})
        self._tenant_pages: Dict[str, int] = {}
        self._admission_checks.append(self._page_fit_check)

    def _reset_state(self) -> None:
        """Every slot idle, in place: table rows at the scratch page (zeroed),
        lengths and counters 0, done, a neutral token."""
        st = self._state
        for pool in st["cache"] + st.get("draft_cache", ()):
            pool.page_table.zero_()
            pool.length.zero_()
            for buf in pool.buffers():
                buf[0].zero_()
        for key in ("ca_start", "sa_start", "token", "uniforms", "pad_slots", "pos_shift"):
            st[key].zero_()
        st["done"].fill_(True)

    # -- the service clock ---------------------------------------------------

    def _now_s(self) -> float:
        """The clock service timing reads (ttft, step dt, service_s): the
        wall ``perf_counter`` even under an injected ManualClock, which does
        not advance while the card computes. No admission decision reads
        it."""
        return time.perf_counter()

    def _tenant_pages_delta(self, rec, n_pages: int) -> None:
        """Track pages held per tenant; mirrors every grant and free so the
        labeled ``engine_kv_pages_used{tenant=...}`` gauge follows each
        tenant's live KV footprint."""
        if rec.tenant is None:
            return
        cur = self._tenant_pages.get(rec.tenant, 0) + n_pages
        self._tenant_pages[rec.tenant] = cur
        self._m_pages.labels(tenant=rec.tenant).set(cur)

    # -- admission -----------------------------------------------------------

    def _page_fit_check(self, spec, deadline_s):
        """Shed a request whose KV footprint can NEVER fit: prompt + budget
        over a per-slot ceiling (CA window or SA latent stream, exactly what
        :meth:`_try_join` will allocate) or over the whole pool. A transient
        shortage is backpressure (the request waits), never a shed."""
        ca_tokens = int(spec.prompt_len) + int(spec.max_new_tokens)
        sa_tokens = self.num_latents + int(spec.max_new_tokens)
        ec = self.engine_config
        ca_grant, sa_grant = self._grant_tokens(spec.prompt_len, spec.max_new_tokens)
        fits = (
            ca_tokens <= ec.max_ca_tokens
            and sa_tokens <= ec.max_sa_tokens
            and self.ca_alloc.can_ever_fit(ca_grant)
            and self.sa_alloc.can_ever_fit(sa_grant)
        )
        if fits:
            return None
        return "kv_pages_exhausted", {
            "ca_tokens": ca_tokens,
            "max_ca_tokens": ec.max_ca_tokens,
            "sa_tokens": sa_tokens,
            "max_sa_tokens": ec.max_sa_tokens,
            "pool_pages": self.ca_alloc.num_allocatable,
        }

    def _grant_tokens(self, prompt_len: int, max_new_tokens: int) -> Tuple[int, int]:
        """The CA and SA tokens a request's grants cover: its prompt and
        budget, and the speculative span's slack (the span appended before
        its rollback)."""
        return (int(prompt_len) + int(max_new_tokens) + self._spec_slack,
                self.num_latents + int(max_new_tokens) + self._spec_slack)

    # -- join ----------------------------------------------------------------

    def _cached(self, cache: OrderedDict, key: tuple, build):
        """``cache[key]``, built on a miss; least recently used entries go
        past ``_PREFILL_CACHE_MAX``."""
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        while len(cache) >= self._PREFILL_CACHE_MAX:
            cache.popitem(last=False)
        cache[key] = build()
        return cache[key]

    def _prefill_for(self, max_new: int, num_latents: Optional[int] = None):
        """The prefill for one decode budget (eager: its prompt length
        varies per request). ``num_latents`` (the engine's by default) is
        the resume seam: a parked request with ``n`` served tokens replays
        over ``prompt + served`` with ``num_latents + n`` latents, the
        uninterrupted slot's latent set. No decode step is built with it."""
        num_latents = self.num_latents if num_latents is None else int(num_latents)
        cfg = dataclasses.replace(self._gen_config, max_new_tokens=max_new)
        return self._cached(self._prefill_fns, (max_new, num_latents), lambda: make_prefill_fn(
            self.model, num_latents, cfg, self._cache_dtype, device=self.device))

    @property
    def _cache_dtype(self) -> torch.dtype:
        return torch.float32 if self.cache_dtype is None else self.cache_dtype

    def _shared_prefill_for(self, skip_tokens: int, prompt_len: int, max_new: int):
        """The shared prefill of one (skip, prompt, budget) geometry
        (``generation.make_shared_prefill_fn``), LRU-bounded as
        :meth:`_prefill_for`'s."""
        cfg = dataclasses.replace(self._gen_config, max_new_tokens=max_new)
        return self._cached(self._shared_prefill_fns, (skip_tokens, prompt_len, max_new),
                            lambda: make_shared_prefill_fn(self.model, self.num_latents, skip_tokens, prompt_len,
                                                           cfg, self._cache_dtype, device=self.device))

    def _context_pages(self, ticket: _Ticket) -> int:
        """The prompt's whole context-region pages (``prompt_len -
        num_latents`` tokens, page by page): the run a join may share (the
        suffix must carry every latent, so a match never reaches past it)
        and the run it publishes. 0 with sharing off, in the speculative
        slot mode (as in JAX: the drafter's pools would need shared pages of
        their own), and over int8 pools (as in JAX: the shared prefill has no
        scale-plane gather, so the copy-on-write fork never sees int8)."""
        if not self.engine_config.prefix_sharing or self._spec or self._cache_dtype == torch.int8:
            return 0
        return max((ticket.record.prompt_len - self.num_latents) // self.engine_config.page_size, 0)

    def _context_keys(self, ticket: _Ticket) -> list:
        """The chunk keys of the prompt's context-region pages, hashed once a
        ticket (a join that waits for pages, or is resumed, reuses them)."""
        if ticket.prefix_keys is None:
            n = self._context_pages(ticket) * self.engine_config.page_size
            ticket.prefix_keys = self.prefix_index.chunks(np.asarray(ticket.spec.input_ids).reshape(-1)[:n])
        return ticket.prefix_keys

    def _first_key(self, ticket: _Ticket) -> bytes:
        """The key of the prompt's first chunk: the only hash a prompt costs
        while the index holds nothing under it."""
        if ticket.prefix_keys is not None:
            return ticket.prefix_keys[0]
        return chunk_key(np.asarray(ticket.spec.input_ids).reshape(-1)[: self.engine_config.page_size])

    def _match_prefix(self, ticket: _Ticket) -> Tuple[int, ...]:
        """The resident run a join shares: the longest indexed run of the
        prompt's context-region pages (empty with sharing off)."""
        if self._context_pages(ticket) < 1:
            return ()
        return self.prefix_index.match_first(self._first_key(ticket), lambda: self._context_keys(ticket))

    def _publish_prefix(self, ticket: _Ticket, ca_grant: PageGrant, defer: bool) -> None:
        """Index a landed request's context-region pages, after the join
        committed their rows. A shared join publishes too: its fresh context
        pages extend the resident run (the matched head is a no-op). A
        join's run waits in the index until a match could read it
        (``PrefixIndex.defer_insert``; the free withdraws it); a resume's,
        which may repoint a run another request published, goes in now."""
        n = self._context_pages(ticket)
        if n < 1:
            return
        if defer:
            self.prefix_index.defer_insert(ticket.record.index, self._first_key(ticket),
                                           lambda: self._context_keys(ticket), ca_grant.pages[:n])
        else:
            self.prefix_index.insert_keys(self._context_keys(ticket), ca_grant.pages[:n])

    def _free_ca(self, grant: PageGrant, owner: Optional[int] = None) -> None:
        """Free a CA grant and expire the index entries of every page whose
        last holder this was: every CA free (retire, evict, failed joins and
        resumes) comes here, so a recycled page never satisfies a match.
        ``owner`` (a landed request's index) withdraws its run if it still
        waits to be indexed."""
        if owner is not None:
            self.prefix_index.withdraw(owner)
        released = self.ca_alloc.free(grant)
        if released:
            self.prefix_index.expire_pages(released)

    def _fork_shared_append_page(self, ca_grant: PageGrant, append_pos: int) -> Optional[PageGrant]:
        """Copy-on-write on the decode append path: when the CA page that
        token position ``append_pos`` writes into is shared with a co-owner,
        fork it (``PageAllocator.cow_fork``) and copy the page's rows into
        the fresh page, in place in the captured pools. Returns the grant
        (forked or not), or None when the pool has no page to fork into
        (the caller backs off as from a failed allocation; nothing
        changed). With matches capped to whole pages inside the context
        region the append page is never shared, so this guards only."""
        page_slot = append_pos // self.engine_config.page_size
        page = ca_grant.pages[page_slot]
        if page not in ca_grant.shared_pages:
            return ca_grant
        forked = self.ca_alloc.cow_fork(ca_grant, page)
        if forked is None:
            return None
        fresh = forked.pages[page_slot]
        for buf in self._state["cache"][0].buffers():
            buf[fresh].copy_(buf[page])
        return forked

    def _try_join(self, ticket: _Ticket, slot_id: int) -> bool:
        """Prefill the ticket's request and land it in ``slot_id``. Returns
        False (the ticket stays queued) when pages are short right now;
        raises nothing: a prefill failure books the request as a terminal
        error (pages freed), keeping the stream 1:1."""
        rec = ticket.record
        ca_tokens, sa_tokens = self._grant_tokens(rec.prompt_len, rec.max_new_tokens)
        matched = self._match_prefix(ticket)
        ca_grant = (self.ca_alloc.alloc_tokens_shared(ca_tokens, matched) if matched
                    else self.ca_alloc.alloc_tokens(ca_tokens))
        if ca_grant is None:
            return False
        sa_grant = self.sa_alloc.alloc_tokens(sa_tokens)
        if sa_grant is None:
            self._free_ca(ca_grant)
            return False
        if ca_grant.shared_pages:
            # the first decode append (CA position prompt_len) must never
            # write into a page a co-owner still reads
            forked = self._fork_shared_append_page(ca_grant, rec.prompt_len)
            if forked is None:
                self._free_ca(ca_grant)
                self.sa_alloc.free(sa_grant)
                return False
            ca_grant = forked
        self._queue.remove(ticket)
        self._set_queue_gauge()
        now = float(self._clock())
        rec.queue_wait_s = round(max(now - ticket.arrival_s, 0.0), 6)
        self._m_queue_wait.record(rec.queue_wait_s)
        slot = _EngineSlot(ticket=ticket, slot_id=slot_id, ca_grant=ca_grant, sa_grant=sa_grant)
        slot.t_joined = self._now_s()
        self._tenant_pages_delta(rec, ca_grant.n_pages + sa_grant.n_pages)
        if self.events is not None and self._tracer is not None:
            # DETACHED span (no contextvar nesting): slot lifetimes overlap
            # and close out of LIFO order; the span row is recorded at retire
            attrs = {"request_id": slot.request_id}
            if rec.tenant is not None:
                attrs["tenant"] = rec.tenant
            slot.span = obs_trace.Span(name="request", parent_id=None, attrs=attrs)
        t0 = self._now_s()
        try:
            if self._injector is not None:
                self._injector.before_attempt(rec.index)
            generator = torch.Generator().manual_seed(int(ticket.spec.rng_seed))
            # a poisoned request's weights serve its prefill alone; the
            # originals are back before the next replay of the step
            with self._served_with(rec.index) as poisoned:
                if matched:
                    # the matched run's CA rows are resident: gather them and
                    # prefill the suffix alone (one draw, as unshared)
                    skip = len(matched) * self.engine_config.page_size
                    pool = self._state["cache"][0]
                    token, pstate = self._shared_prefill_for(skip, rec.prompt_len, rec.max_new_tokens)(
                        np.asarray(ticket.spec.input_ids)[:, skip:], pool.k, pool.v, matched, generator)
                else:
                    token, pstate = self._prefill_for(rec.max_new_tokens)(ticket.spec.input_ids, None, generator)
            first = int(token[0])
        except Exception as e:  # noqa: BLE001 — books close, pages return
            self._free_ca(ca_grant)
            self.sa_alloc.free(sa_grant)
            self._tenant_pages_delta(rec, -(ca_grant.n_pages + sa_grant.n_pages))
            rec.error = repr(e)
            rec.attempts += 1
            self._retire_books(slot, "error", emit=True)
            return True  # the ticket reached a terminal outcome
        slot.ttft_s = self._now_s() - t0
        rec.attempts += 1
        slot.tokens_out = 1
        self.served_tokens[rec.index] = [first]
        if self.journal is not None:
            self.journal.append("progress", rec.index, tokens=[first])
        # a shared join's commit rewrites the matched pages with the bytes
        # they hold (the rows were gathered from them)
        self._join_state(slot_id, ca_grant, sa_grant, pstate)
        self._slots[slot_id] = slot
        self._in_flight += 1
        if not poisoned:
            # a poisoned request's rows are its own: no later request shares them
            self._publish_prefix(ticket, ca_grant, defer=True)
        if matched:
            self._book_prefix_hit(slot, len(matched))
        self._m_ttft.record(slot.ttft_s)
        # the per-token seam fires for token 0 exactly like the sequential
        # path (injector stalls and kills, cancellation, deadline)
        self._token_seam(slot, 0)
        return True

    def _book_prefix_hit(self, slot: "_EngineSlot", n_pages: int) -> None:
        """The counters and the ``serve.prefix_hit`` row of a shared join."""
        rec = slot.ticket.record
        ps = self.engine_config.page_size
        self._n_prefix_hits += 1
        self._n_prefix_pages_shared += n_pages
        self._m_prefix_hits.inc()
        self._m_prefix_pages.inc(n_pages)
        if rec.tenant is not None:
            self._m_prefix_hits.labels(tenant=rec.tenant).inc()
            self._m_prefix_pages.labels(tenant=rec.tenant).inc(n_pages)
        if self.events is not None:
            row = dict(request_index=rec.index, pages_matched=n_pages, pages_total=-(-rec.prompt_len // ps),
                       tokens_skipped=n_pages * ps)
            if rec.tenant is not None:
                row["tenant"] = rec.tenant
            if slot.span is not None:
                row["span_id"] = slot.span.span_id
            self.events.emit("serve.prefix_hit", **row)

    def _join_state(self, slot: int, ca_grant: PageGrant, sa_grant: PageGrant, pstate: dict) -> None:
        """Commit one prefilled request's prompt KV into its granted pages and
        write its per-slot scalars, all in place."""
        st, dev = self._state, self.device
        prefill_cache = pstate["cache"]
        ca_pages = torch.tensor(ca_grant.pages, dtype=torch.long, device=dev)
        sa_pages = torch.tensor(sa_grant.pages, dtype=torch.long, device=dev)
        ca = st["cache"][0]
        # the drafter's caches are the prefill caches' prefix (shared weights,
        # generation.make_drafter): they land in the drafter's pools under
        # the same page ids
        for pools in (st["cache"], st.get("draft_cache", ())):
            for i, (c, pc) in enumerate(zip(pools, prefill_cache)):
                commit_prefill_(c, slot, ca_pages if i == 0 else sa_pages, pc, pc.length)
        n = min(pstate["pad_slots"].shape[1], ca.capacity)
        st["pad_slots"][slot] = False
        st["pad_slots"][slot, :n] = pstate["pad_slots"][0, :n]
        st["pos_shift"][slot] = pstate["pos_shift"][0]
        st["ca_start"][slot] = 0
        st["sa_start"][slot] = 0
        st["token"][slot] = pstate["token"][0]
        st["done"][slot] = pstate["done"][0]
        st["generators"][slot] = pstate["generator"]

    # -- the per-token seam (injector / cancel / deadline) -------------------

    def _token_seam(self, slot: "_EngineSlot", i: int) -> None:
        rec = slot.ticket.record
        rec.tokens_out = slot.tokens_out
        try:
            if self._injector is not None:
                self._injector.on_token(rec.index, i)
            if slot.ticket.cancelled:
                slot.outcome = "cancelled"
                return
            if slot.ticket.deadline_at is not None and self._clock() > slot.ticket.deadline_at:
                slot.outcome = "timeout"
        except Exception as e:  # noqa: BLE001 — injected kill
            slot.outcome = "error"
            rec.error = repr(e)

    # -- retire --------------------------------------------------------------

    def _retire_books(self, slot: "_EngineSlot", outcome: str, emit: bool) -> None:
        """Terminal accounting for one slot: books, span, event."""
        rec = slot.ticket.record
        rec.ttft_s = None if slot.ttft_s is None else round(slot.ttft_s, 6)
        rec.tokens_out = slot.tokens_out
        rec.compiled = slot.compiled
        rec.decode_s = round(sum(slot.step_times), 6)
        hist = slot.tpot_hist()
        rec.service_s = round(self._now_s() - slot.t_joined, 6)
        self._finish(slot.ticket, outcome)
        # the drafter's quality: raw acceptance over the slot's spans, and
        # decode tokens emitted a span
        accept_rate = tokens_per_step = None
        if slot.spec_spans:
            accept_rate = slot.spec_accepted / (slot.spec_spans * max(self.engine_config.spec_k, 1))
            tokens_per_step = max(slot.tokens_out - 1, 0) / slot.spec_spans
            self._m_accept.record(accept_rate)
            self._m_tps.record(tokens_per_step)
        if slot.span is not None:
            slot.span.set("outcome", outcome)
            slot.span.set("tokens_out", slot.tokens_out)
            self._tracer.record(slot.span)
            self._tracer.flush()  # span row BEFORE the request row
        if emit and self.events is not None:
            row = dict(
                request_id=slot.request_id,
                batch=1,
                prompt_len=rec.prompt_len,
                new_tokens=rec.max_new_tokens,
                ttft_s=0.0 if slot.ttft_s is None else round(slot.ttft_s, 6),
                tokens_out=slot.tokens_out,
                outcome=outcome,
                compiled=slot.compiled,
                queue_wait_s=rec.queue_wait_s,
                decode_s=round(sum(slot.step_times), 6),
                tpot_hist=dict(sorted((str(k), v) for k, v in hist.counts.items())),
            )
            if rec.tenant is not None:
                row["tenant"] = rec.tenant
            if slot.batch_sizes:
                row["batch_size_at_decode"] = round(sum(slot.batch_sizes) / len(slot.batch_sizes), 3)
            if accept_rate is not None:
                row["acceptance_rate"] = round(accept_rate, 6)
                row["tokens_per_step"] = round(tokens_per_step, 6)
            if slot.span is not None:
                row["span_id"] = slot.span.span_id
            for p in (50, 90, 99):
                row[f"tpot_p{p}_s"] = hist.percentile(p)
            if rec.error is not None:
                row["error"] = rec.error
            self.events.emit("request", **row)
        self._m_requests.inc()
        self._m_tokens.inc(slot.tokens_out)
        if self.events is not None:
            # the engine gauges (batch fill, page use) land in `metrics` rows
            # while the batch is live, not only after the drain zeroes them
            self.registry.maybe_emit(self.events, min_interval_s=self.config.snapshot_interval_s)

    def _retire_slot(self, slot_id: int, outcome: str) -> None:
        slot = self._slots[slot_id]
        self._slots[slot_id] = None
        self._in_flight -= 1
        self._free_ca(slot.ca_grant, slot.ticket.record.index)
        self.sa_alloc.free(slot.sa_grant)
        self._tenant_pages_delta(slot.ticket.record, -(slot.ca_grant.n_pages + slot.sa_grant.n_pages))
        self._retire_state(slot_id)
        self._retire_books(slot, outcome, emit=True)
        self._busy_until = float(self._clock())

    def _retire_state(self, slot: int) -> None:
        """Device half of a retire, in place: table row back to scratch,
        length 0, the slot idle with a neutral token."""
        st = self._state
        for c in st["cache"] + st.get("draft_cache", ()):
            release_slot_(c, slot)
        st["token"][slot] = 0
        st["done"][slot] = True
        st["ca_start"][slot] = 0
        st["sa_start"][slot] = 0
        st["pad_slots"][slot] = False
        st["pos_shift"][slot] = 0
        st["generators"][slot] = None

    # -- eviction, parking, resume -------------------------------------------

    def _select_victim(self) -> Optional[int]:
        """The least-progressed slot: fewest tokens served, ties to the
        latest admitted (highest index). Slots already terminal or at their
        budget are never victims: the next sweep frees them anyway."""
        cands = [(s.tokens_out, -s.ticket.record.index, slot_id) for slot_id, s in enumerate(self._slots)
                 if s is not None and s.outcome is None and s.tokens_out < s.ticket.record.max_new_tokens]
        return min(cands)[2] if cands else None

    def _evict_slot(self, slot_id: int) -> None:
        """Preempt one slot: its pages return (a shared page only loses a
        holder), its device slot is released in place, and the request is
        PARKED with its served tokens. Not a terminal transition: the books
        move it from in_flight to parked."""
        slot = self._slots[slot_id]
        self._slots[slot_id] = None
        self._in_flight -= 1
        pages_freed = slot.ca_grant.n_pages + slot.sa_grant.n_pages
        self._free_ca(slot.ca_grant, slot.ticket.record.index)
        self.sa_alloc.free(slot.sa_grant)
        self._tenant_pages_delta(slot.ticket.record, -pages_freed)
        slot.ca_grant = slot.sa_grant = None
        self._retire_state(slot_id)
        slot.slot_id = -1
        slot.evictions += 1
        self._n_evictions += 1
        self._m_evictions.inc()
        rec = slot.ticket.record
        span_id = None
        if slot.span is not None:
            # the preempted segment's span closes here; a resume opens a
            # fresh one under the same request_id
            slot.span.set("outcome", "evicted")
            slot.span.set("tokens_out", slot.tokens_out)
            span_id = slot.span.span_id
            self._tracer.record(slot.span)
            self._tracer.flush()
        slot.span = None
        self._parked.append(slot)
        self._m_parked.set(len(self._parked))
        if self.journal is not None:
            self.journal.append("evict", rec.index, tokens_out=slot.tokens_out)
        if self.events is not None:
            row = dict(request_index=rec.index, tokens_out=slot.tokens_out, pages_freed=pages_freed)
            if rec.tenant is not None:
                row["tenant"] = rec.tenant
            if span_id is not None:
                row["span_id"] = span_id
            self.events.emit("serve.evict", **row)

    def _evict_for(self, ticket: _Ticket) -> bool:
        """Evict least-progressed slots until the queued request fits the
        free lists (True), or no victim is left (False: backpressure, as
        with eviction off)."""
        if not self.engine_config.eviction:
            return False
        ca_tokens, sa_tokens = self._grant_tokens(ticket.record.prompt_len, ticket.record.max_new_tokens)
        while not (self.ca_alloc.can_fit_now(ca_tokens) and self.sa_alloc.can_fit_now(sa_tokens)):
            victim = self._select_victim()
            if victim is None:
                return False
            self._evict_slot(victim)
        return True

    def _park_terminal(self, slot: "_EngineSlot", outcome: str) -> None:
        """A parked request reaching a terminal outcome without a slot
        (cancelled or expired while parked, a failed replay, a recovered
        stream already whole): the books close through the retire path."""
        slot.ticket.record.tokens_out = slot.tokens_out
        self._retire_books(slot, outcome, emit=True)

    def _try_resume(self, slot: "_EngineSlot", slot_id: int) -> bool:
        """Resume a parked request into ``slot_id`` by prefill replay over
        ``prompt + its n served tokens`` with ``num_latents + n`` latents and
        its generator advanced past n draws (when sampling): the replay's
        sample is token n + 1 of the uninterrupted stream. Returns False
        only when pages are short now (it stays parked); a replay failure
        books ``error`` as a join failure does."""
        rec = slot.ticket.record
        idx, n = rec.index, slot.tokens_out
        # the demand is the join's: prompt + n + remaining CA tokens,
        # (num_latents + n) + remaining SA tokens
        ca_tokens, sa_tokens = self._grant_tokens(rec.prompt_len, rec.max_new_tokens)
        ca_grant = self.ca_alloc.alloc_tokens(ca_tokens)
        if ca_grant is None:
            return False
        sa_grant = self.sa_alloc.alloc_tokens(sa_tokens)
        if sa_grant is None:
            self._free_ca(ca_grant)
            return False
        slot.ca_grant, slot.sa_grant = ca_grant, sa_grant
        self._tenant_pages_delta(rec, ca_grant.n_pages + sa_grant.n_pages)
        emitted = self.served_tokens[idx]
        replay_ids = np.concatenate([np.asarray(slot.ticket.spec.input_ids).reshape(1, -1),
                                     np.asarray([emitted])], axis=1)
        if self.events is not None and self._tracer is not None:
            attrs = {"request_id": slot.request_id}
            if rec.tenant is not None:
                attrs["tenant"] = rec.tenant
            slot.span = obs_trace.Span(name="request", parent_id=None, attrs=attrs)
        try:
            if self._injector is not None:
                self._injector.before_attempt(idx)
            generator = advance_generator(torch.Generator().manual_seed(int(slot.ticket.spec.rng_seed)), n,
                                          self._gen_config)
            with self._served_with(idx) as poisoned:
                token, pstate = self._prefill_for(rec.max_new_tokens - n, self.num_latents + n)(
                    replay_ids, None, generator)
            first = int(token[0])
        except Exception as e:  # noqa: BLE001 — books close, pages return
            self._free_ca(ca_grant)
            self.sa_alloc.free(sa_grant)
            self._tenant_pages_delta(rec, -(ca_grant.n_pages + sa_grant.n_pages))
            slot.ca_grant = slot.sa_grant = None
            rec.error = repr(e)
            rec.attempts += 1
            self._park_terminal(slot, "error")
            return True
        rec.attempts += 1
        slot.tokens_out = n + 1
        slot.slot_id = slot_id
        emitted.append(first)
        self._join_state(slot_id, ca_grant, sa_grant, pstate)
        self._slots[slot_id] = slot
        self._in_flight += 1
        # the replay's context rows are the join's (same tokens, same
        # positions): a resume republishes them, which is also how recovery
        # rebuilds the index
        if not poisoned:
            self._publish_prefix(slot.ticket, ca_grant, defer=False)
        self._n_resumes += 1
        self._m_resumes.inc()
        if self.journal is not None:
            self.journal.append("resume", idx, tokens_out=n)
            self.journal.append("progress", idx, tokens=[first])
        if self.events is not None:
            row = dict(request_index=idx, tokens_out=n)
            if rec.tenant is not None:
                row["tenant"] = rec.tenant
            if slot.span is not None:
                row["span_id"] = slot.span.span_id
            self.events.emit("serve.resume", **row)
        self._token_seam(slot, slot.tokens_out - 1)
        return True

    def _resume_parked(self) -> None:
        """Fill free slots from the parked queue first (FIFO), on the pages
        free now: a resume never evicts, so every segment between two
        preemptions serves at least one token and the work left shrinks."""
        if not self._parked:
            return
        for slot_id, occupant in enumerate(self._slots):
            if occupant is not None:
                continue
            while self._parked:
                slot = self._parked[0]
                if slot.ticket.cancelled or (slot.ticket.deadline_at is not None
                                             and float(self._clock()) > slot.ticket.deadline_at):
                    self._parked.pop(0)
                    self._m_parked.set(len(self._parked))
                    self._park_terminal(slot, "cancelled" if slot.ticket.cancelled else "timeout")
                    continue
                if not self._try_resume(slot, slot_id):
                    return  # pages short: the parked head waits
                self._parked.pop(0)
                self._m_parked.set(len(self._parked))
                break  # the slot is filled (or the head reached terminal)
            if not self._parked:
                return

    # -- crash recovery ------------------------------------------------------

    def _check_recover_geometry(self) -> None:
        """Recovery resumes by prefill replay, which never slides a window."""
        ec, mcfg = self.engine_config, self.model.config
        if not _no_slide(ec, mcfg):
            raise _slide_error(ec, mcfg, "journal recovery resumes by prefill replay and never slides")

    def recover(self, journal, handoff_id: Optional[str] = None) -> dict:
        """Re-admit a dead engine's non-terminal requests from its
        write-ahead journal (a ``RequestJournal`` or a path) into this
        engine.

        Idempotent on request index: an index this engine already carries
        (queued, in a slot, parked or terminal) is skipped, so a second pass
        of the same journal is a no-op (``skipped`` counts them).

        Two shapes. An engine without a journal of its own ADOPTS this one:
        both incarnations append to one file, whose books close over the
        union. A survivor with its own journal keeps it: each adopted
        request is re-journaled (submitted, admitted, progress) there, where
        its terminal record will land, and the dead journal gets a
        ``recovered`` record with ``handoff`` (``handoff_id``, this engine's
        journal path by default), which closes it there.

        A request with journaled progress is PARKED, as an evicted one, and
        resumes by prefill replay; one without re-enters the queue. Only the
        page-fit check of admission runs again: a request this engine can
        never fit sheds ``kv_pages_exhausted`` here. Deadlines restart from
        now. A stream already at its budget (or ending in eos) books ``ok``
        without a replay. One ``serve.recover`` row (and span) a request.
        Returns a summary dict."""
        self._check_recover_geometry()
        if not isinstance(journal, RequestJournal):
            journal = RequestJournal(journal)
        handoff_mode = self.journal is not None and self.journal is not journal
        if handoff_mode:
            own = self.journal
            if handoff_id is None:
                handoff_id = own.path
        else:
            self.journal = own = journal
        now = float(self._clock())
        eos = self._gen_config.eos_token_id
        n = done_already = shed = skipped = 0
        known = {r.index for r in self.records}
        for entry in journal.pending():
            if entry.index in known:
                skipped += 1
                continue
            spec = entry.spec()
            if handoff_mode:
                jfields = dict(prompt_len=int(entry.prompt_len), max_new_tokens=int(entry.max_new_tokens),
                               input_ids=list(entry.input_ids), rng_seed=int(entry.rng_seed),
                               deadline_s=None if entry.deadline_s is None else float(entry.deadline_s))
                if entry.tenant is not None:
                    jfields["tenant"] = entry.tenant
                own.append("submitted", entry.index, **jfields)
            rec = FrontEndRecord(index=entry.index, prompt_len=int(entry.prompt_len),
                                 max_new_tokens=int(entry.max_new_tokens), batch=1, tenant=entry.tenant)
            rec.queue_wait_s = 0.0
            self.records.append(rec)
            with self._books_lock:
                self._n["submitted"] += 1
            self._m_submitted.inc()
            if rec.tenant is not None:
                self._m_submitted.labels(tenant=rec.tenant).inc()
            verdict = self._page_fit_check(spec, None)
            if verdict is not None:
                # this engine's geometry can never fit it: re-queueing would
                # spin the drive loops forever
                reason, detail = verdict
                rec.outcome, rec.shed_reason = "shed", reason
                with self._books_lock:
                    self._n["shed"] += 1
                self._m_shed.inc()
                if rec.tenant is not None:
                    self._m_shed.labels(tenant=rec.tenant).inc()
                own.append("terminal", entry.index, outcome="shed", shed_reason=reason)
                if handoff_mode:
                    journal.append("recovered", entry.index, tokens_resumed=0, handoff=str(handoff_id))
                self._emit_frontend_request(rec, shed_reason=reason, queue_depth=len(self._queue), **detail)
                shed += 1
                continue
            with self._books_lock:
                self._n["admitted"] += 1
            self._m_admitted.inc()
            if rec.tenant is not None:
                self._m_admitted.labels(tenant=rec.tenant).inc()
            ticket = _Ticket(spec=spec, record=rec, arrival_s=now,
                             deadline_at=None if entry.deadline_s is None else now + float(entry.deadline_s))
            tokens = [int(t) for t in entry.tokens]
            slot = None
            if tokens:
                slot = _EngineSlot(ticket=ticket, slot_id=-1, ca_grant=None, sa_grant=None)
                slot.t_joined = self._now_s()
                slot.tokens_out = len(tokens)
                self.served_tokens[entry.index] = tokens
            self._n_recovered += 1
            self._m_recovered.inc()
            if handoff_mode:
                own.append("admitted", entry.index)
                if tokens:
                    own.append("progress", entry.index, tokens=tokens)
                journal.append("recovered", entry.index, tokens_resumed=len(tokens), handoff=str(handoff_id))
            else:
                journal.append("recovered", entry.index, tokens_resumed=len(tokens))
            if self.events is not None:
                row = dict(request_index=entry.index, tokens_resumed=len(tokens))
                if entry.tenant is not None:
                    row["tenant"] = entry.tenant
                if self._tracer is not None:
                    # the span carries the request_id the request's resume
                    # span and terminal row will (the parked slot mints it)
                    rid = slot.request_id if slot is not None else self._trace_mod.new_span_id()
                    with self._tracer.span("request", request_id=rid, request_index=entry.index) as sp:
                        sp.set("outcome", "recovered")
                        sp.set("tokens_resumed", len(tokens))
                    self._tracer.flush()
                    row["span_id"] = sp.span_id
                self.events.emit("serve.recover", **row)
            if slot is None:
                self._queue.append(ticket)
                self._set_queue_gauge()
            elif len(tokens) >= rec.max_new_tokens or (eos is not None and tokens[-1] == eos):
                # died between the last token and its retire: nothing to decode
                self._park_terminal(slot, "ok")
                done_already += 1
            else:
                self._parked.append(slot)
            n += 1
        self._m_parked.set(len(self._parked))
        return {"recovered": n, "parked": len(self._parked), "queued": len(self._queue),
                "already_complete": done_already, "shed": shed, "skipped": skipped}

    # -- the engine loop -----------------------------------------------------

    def _active_ids(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _fill_slots(self) -> None:
        """Batched prefill admission: resume parked requests first (on the
        pages free now), then join queued requests into every free slot,
        booking queued cancels and queue-expired deadlines first. Page
        backpressure stops the fill; with ``eviction`` a blocked queue head
        first reclaims pages from the least-progressed slot. It never
        sheds."""
        if not (self._queue or self._parked):
            return  # nothing joins: the gauges hold the last step's values
        self._resume_parked()
        for slot_id, occupant in enumerate(self._slots):
            if occupant is not None:
                continue
            while self._queue:
                ticket = self._queue[0]
                now = float(self._clock())
                if ticket.cancelled:
                    self._queue.popleft()
                    self._set_queue_gauge()
                    ticket.record.queue_wait_s = round(max(now - ticket.arrival_s, 0.0), 6)
                    self._finish(ticket, "cancelled")
                    self._emit_frontend_request(ticket.record, queue_wait_s=ticket.record.queue_wait_s)
                    continue
                if ticket.deadline_at is not None and now > ticket.deadline_at:
                    self._m_queue_expired.inc()
                    self._queue.popleft()
                    self._set_queue_gauge()
                    ticket.record.queue_wait_s = round(max(now - ticket.arrival_s, 0.0), 6)
                    self._finish(ticket, "timeout")
                    self._emit_frontend_request(ticket.record, queue_wait_s=ticket.record.queue_wait_s,
                                                queue_expired=True)
                    continue
                if not self._try_join(ticket, slot_id):
                    # pages short now: evict (when enabled) so the queue head
                    # proceeds, else wait for retires
                    if not self._evict_for(ticket) or not self._try_join(ticket, slot_id):
                        return
                break  # joined (or terminally booked): next slot
        self._update_gauges()

    def sharing_audit(self) -> List[str]:
        """The sharing invariants (empty = clean): both allocators' books,
        refcounts included, the prefix index's structure, and the seam
        between them: every page the index names must be live in the CA
        allocator."""
        problems = self.ca_alloc.audit() + self.sa_alloc.audit() + self.prefix_index.audit()
        for page in self.prefix_index.pages():
            if self.ca_alloc.refcount(page) < 1:
                problems.append(f"prefix index names page {page} with refcount 0 (expire-on-release seam leaked)")
        return problems

    def _update_gauges(self) -> None:
        """The batch-fill and page gauges, once a step: from the allocators'
        counters (``PageAllocator.stats()`` walks every live page, ~0.1 ms
        at the flagship's 4096-page pool, as long as a decode step)."""
        active = len(self._active_ids())
        self._m_fill.set(active / max(self.engine_config.slots, 1))
        ca_used = self.ca_alloc.pages_used
        self._m_pages.set(ca_used + self.sa_alloc.pages_used)
        self._m_pages_frac.set(ca_used / self.ca_alloc.num_allocatable)
        self._m_parked.set(len(self._parked))

    def _sweep_terminal(self) -> None:
        """Retire slots whose outcome is already terminal (a kill at token 0
        in the join seam, a cancel or deadline landing between steps) or
        whose budget is spent (a one-token budget is filled by the prefill)
        before the next batched step decodes, and books, an extra token for
        them; the sequential path retires at the same boundary."""
        for slot_id, slot in enumerate(self._slots):
            if slot is None:
                continue
            if slot.outcome is not None:
                self._retire_slot(slot_id, slot.outcome)
            elif slot.tokens_out >= slot.ticket.record.max_new_tokens:
                self._retire_slot(slot_id, "ok")

    def _engine_step(self) -> None:
        """One batched decode step, then per-slot accounting and retires:
        every emitted token streams through the per-token seam. In the
        speculative slot mode a step emits ``m`` of 1 to ``spec_k + 1``
        tokens a slot: a span past the budget is clipped, and a kill, cancel
        or deadline mid-span drops the span's remaining tokens (the slot
        retires at that token, as the sequential path would); each slot's
        generator then advances by its ``m``
        (``generation.advance_span_generators``)."""
        self._sweep_terminal()
        active = self._active_ids()
        if not active:
            return
        compiles0 = self._tracker.total_compiles
        t0 = self._now_s()
        if self._spec:
            self._state, tokens, m = self._step_fn(self._state)
            # the one host fetch of the step
            rows = torch.cat([tokens, m[:, None]], dim=1).tolist()
            tokens, m = [r[:-1] for r in rows], [r[-1] for r in rows]
            advance_span_generators(self._state["generators"], m, self._gen_config)
        else:
            self._state, tokens = self._step_fn(self._state)
            tokens = [[t] for t in tokens.tolist()]  # the one host fetch of the step
            m = [1] * len(tokens)
        dt = self._now_s() - t0
        self._engine_steps += 1
        self._fill_sum += len(active)
        cold_step = self._tracker.total_compiles > compiles0
        batch_size = len(active)
        # one TPOT sample a token: the step's time shared by the slot's
        # tokens, bucketed once a step without spans
        bucket = bucket_index(dt)
        if not cold_step and not self._spec:
            self._m_tpot.record(dt, count=batch_size)
        eos = self._gen_config.eos_token_id
        for slot_id in active:
            slot = self._slots[slot_id]
            rec = slot.ticket.record
            span = int(m[slot_id])
            n_emit = min(span, rec.max_new_tokens - slot.tokens_out)
            if self._spec:
                # the raw span (drafter quality), before the budget's clip
                slot.spec_spans += 1
                slot.spec_accepted += span - 1
            per_tok = dt / max(n_emit, 1)
            tok_bucket = bucket if n_emit == 1 else bucket_index(per_tok)
            if self._spec and not cold_step:
                self._m_tpot.record(per_tok, count=n_emit)
            emitted, finished = [], False
            for j in range(n_emit):
                tok = int(tokens[slot_id][j])
                slot.tokens_out += 1
                self.served_tokens[rec.index].append(tok)
                emitted.append(tok)
                slot.step_times.append(per_tok)
                slot.step_buckets.append(tok_bucket)
                slot.batch_sizes.append(batch_size)
                if cold_step:
                    slot.compiled = True
                self._token_seam(slot, slot.tokens_out - 1)
                if slot.outcome is not None:  # killed / cancelled / deadline
                    break
                if eos is not None and tok == eos:
                    finished = True
                    break
            if self.journal is not None and emitted:
                # one progress record a slot a step; a token a crash tore
                # off is re-derived by the recovery's replay
                self.journal.append("progress", rec.index, tokens=emitted)
            if slot.outcome is not None:
                self._retire_slot(slot_id, slot.outcome)
            elif finished or slot.tokens_out >= rec.max_new_tokens:
                self._retire_slot(slot_id, "ok")
        self._update_gauges()

    def cancel(self, request_index: int) -> bool:
        """Cancel a queued request, one live in a decode slot (the slot
        retires ``cancelled`` at its next token boundary), or a parked one
        (booked ``cancelled`` when the resume loop reaches it, without a
        replay)."""
        for slot in self._slots:
            if slot is not None and slot.ticket.record.index == request_index:
                slot.ticket.cancelled = True
                return True
        for slot in self._parked:
            if slot.ticket.record.index == request_index and not slot.ticket.cancelled:
                slot.ticket.cancelled = True
                return True
        return super().cancel(request_index)

    @property
    def mean_batch_fill(self) -> float:
        """Mean active-slot fraction over every decode step."""
        denom = self._engine_steps * max(self.engine_config.slots, 1)
        return self._fill_sum / denom if denom else 0.0

    # -- driving (overrides the sequential service loop) ---------------------

    def _terminal_served(self) -> int:
        return sum(self._n[o] for o in ("ok", "error", "timeout", "cancelled"))

    def pump(self, max_requests: Optional[int] = None) -> int:
        """Drive the engine until the queue and the batch drain (or until
        ``max_requests`` reached terminal outcomes)."""
        terminal0 = self._terminal_served()
        done = 0
        # parked is live work: a recovered engine may owe everything parked
        while self._queue or self._active_ids() or self._parked:
            self._check_guard()
            self._fill_slots()
            self._engine_step()
            done = self._terminal_served() - terminal0
            if max_requests is not None and done >= max_requests:
                break
        return done

    def run_closed(self, specs, *, concurrency: int = 4, deadline_s: Optional[float] = None):
        """Closed-loop drive through the engine: ``concurrency`` requests
        queued or in flight; each completion admits the next. Same record and
        books contract as the sequential loop."""
        if concurrency < 1:
            raise ValueError("run_closed needs concurrency >= 1")
        pending = deque(specs)
        out = []

        def admit():
            while pending and (len(self._queue) + len(self._active_ids())) < concurrency:
                out.append(self.submit(pending.popleft(), deadline_s=deadline_s))

        admit()
        while self._queue or pending or self._active_ids() or self._parked:
            self._check_guard()
            admit()
            if not (self._queue or self._active_ids() or self._parked):
                continue
            self._fill_slots()
            self._engine_step()
        if self._draining:
            self.drain()
        return out

    def run_open(self, specs, *, rate_rps: Optional[float] = None, offsets: Optional[List[float]] = None,
                 deadline_s: Optional[float] = None, seed: int = 1):
        """Open-loop drive through the engine: arrivals at seeded Poisson
        offsets (or explicit ``offsets``); between arrivals the live batch
        keeps stepping, and every arrival whose time has passed joins at the
        next fill/step boundary. Under a ``ManualClock`` the idle gaps
        advance the injected timeline; under a real clock the batched steps
        themselves move it."""
        specs = list(specs)
        offsets = self._resolve_offsets(specs, rate_rps, offsets, seed)
        t0 = float(self._clock())
        pending = deque(zip(specs, offsets))
        out = []
        while pending or self._queue or self._active_ids() or self._parked:
            self._check_guard()
            # admit every arrival whose time has passed on the clock
            while pending and t0 + pending[0][1] <= float(self._clock()):
                spec, off = pending.popleft()
                out.append(self.submit(spec, arrival_s=t0 + off, deadline_s=deadline_s))
            if not (self._queue or self._active_ids() or self._parked):
                if pending:  # idle: jump to the next arrival
                    spec, off = pending.popleft()
                    self._advance_to(t0 + off)
                    out.append(self.submit(spec, arrival_s=t0 + off, deadline_s=deadline_s))
                continue
            self._fill_slots()
            self._engine_step()
        if self._draining:
            self.drain()
        return out


@dataclass
class _EngineSlot:
    """Host-side record of one occupied decode slot; a parked request is
    its slot record without a device slot and grants (``slot_id`` -1)."""

    ticket: _Ticket
    slot_id: int
    ca_grant: Optional[PageGrant]
    sa_grant: Optional[PageGrant]
    tokens_out: int = 0
    ttft_s: Optional[float] = None
    compiled: bool = False
    outcome: Optional[str] = None  # set mid-decode by the token seam
    evictions: int = 0  # times this request was evicted (and parked)
    # the speculative slot mode: spans this slot rode and the drafts they
    # accepted, before the budget's clip (drafter quality)
    spec_spans: int = 0
    spec_accepted: int = 0
    span = None

    def __post_init__(self):
        self.request_id = obs_trace.new_span_id()
        self.step_times: List[float] = []
        self.step_buckets: List[int] = []  # obs.metrics.bucket_index of each step time
        self.batch_sizes: List[int] = []
        self.t_joined = time.perf_counter()

    def tpot_hist(self) -> Histogram:
        """This request's decode step times as an ``obs.metrics.Histogram``
        (the one JAX's engine records a token at a time), from the bucket
        indices each step computed once for all its slots."""
        hist = Histogram("tpot_s")
        if self.step_times:
            hist.counts = dict(collections.Counter(self.step_buckets))
            hist.n, hist.sum = len(self.step_times), sum(self.step_times)
            hist.min, hist.max = min(self.step_times), max(self.step_times)
        return hist
