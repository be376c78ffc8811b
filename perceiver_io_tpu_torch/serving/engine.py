"""The continuous-batching serving engine on a paged KV cache (counterpart of
``perceiver_io_tpu/serving/engine.py::EngineFrontEnd``).

:class:`EngineFrontEnd` is a :class:`~perceiver_io_tpu_torch.serving.frontend.RequestFrontEnd`:
it inherits the whole admission tier (bounded queue, deadline projection,
breaker, drain, clean books, ``request`` events and the metrics registry),
adds a page-fit check (a request whose KV footprint can never fit the pools
sheds ``kv_pages_exhausted`` at admission), and replaces the sequential
service loop by a fixed set of decode slots driven through ONE batched step:

- **join**: a queued request's prompt runs the contiguous prefill of
  ``generation.make_decode_fns`` (batch 1), then ``core.cache.commit_prefill_``
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

A poisoned request (``FaultInjector.poison_at``) is served its poisoned
weights for its prefill only, as in JAX: they are written into the model's
parameters in place for the prefill and the originals written back before
anything else runs, so the captured step keeps reading the same addresses
with the original values.

Prefix sharing (ROADMAP A7), eviction, parking and journal recovery (A8)
and the speculative slot mode (A9) are not ported: :class:`EngineConfig` has
no fields for them, so asking for one fails at construction.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from perceiver_io_tpu_torch.core.cache import commit_prefill_, release_slot_
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
from perceiver_io_tpu_torch.generation import GenerationConfig, make_decode_fns, make_paged_step_fn
from perceiver_io_tpu_torch.obs import trace as obs_trace
from perceiver_io_tpu_torch.obs.metrics import Histogram, bucket_index
from perceiver_io_tpu_torch.obs.recompile import RecompileTracker
from perceiver_io_tpu_torch.serving.frontend import RequestFrontEnd, _Ticket
from perceiver_io_tpu_torch.serving.pages import PageAllocator, PageGrant


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


class EngineFrontEnd(RequestFrontEnd):
    """The continuous-batching front end (see the module docstring).

    :param model: a ``CausalSequenceModel`` living on ``device``.
    :param engine_config: slot and page geometry.

    Every other argument is :class:`RequestFrontEnd`'s: ``num_latents``,
    ``base_config`` (sampling; ``max_new_tokens`` comes from each request),
    ``cache_dtype`` (the page pools' and the prefill caches' dtype; None:
    f32, as in the JAX engine; a bf16 model serves from bf16 pools with
    ``torch.bfloat16``), ``config``, ``events``, ``registry``, ``clock``,
    ``sleep``, ``injector`` and ``device`` (``"cuda"`` by default; asking for
    CUDA without a card raises, pass ``device="cpu"`` for the plain
    versions).
    """

    def __init__(self, model: CausalSequenceModel, *, engine_config: Optional[EngineConfig] = None, **kw):
        super().__init__(model, **kw)
        self.engine_config = ec = engine_config or EngineConfig()
        self._gen_config = self.base_config or GenerationConfig()
        cache_dtype = torch.float32 if self.cache_dtype is None else self.cache_dtype
        ps = ec.page_size
        self._ca_pages_per_slot = -(-ec.max_ca_tokens // ps)
        self._sa_pages_per_slot = -(-ec.max_sa_tokens // ps)
        ca_pool = 1 + max(2, int(round(ec.slots * self._ca_pages_per_slot * ec.pool_headroom)))
        sa_pool = 1 + max(2, int(round(ec.slots * self._sa_pages_per_slot * ec.pool_headroom)))
        self.ca_alloc = PageAllocator(ca_pool, ps)
        self.sa_alloc = PageAllocator(sa_pool, ps)
        caches = CausalSequenceModel.init_paged_cache(
            model.config, ec.slots, ps, ca_num_pages=ca_pool, ca_pages_per_slot=self._ca_pages_per_slot,
            sa_num_pages=sa_pool, sa_pages_per_slot=self._sa_pages_per_slot, dtype=cache_dtype,
            device=self.device,
        )
        s, dev = ec.slots, self.device
        self._state: Dict[str, Any] = {
            "cache": caches,
            "ca_start": torch.empty((s,), dtype=torch.int32, device=dev),
            "sa_start": torch.empty((s,), dtype=torch.int32, device=dev),
            "token": torch.empty((s,), dtype=torch.long, device=dev),
            "uniforms": torch.empty((s,), dtype=torch.float32, device=dev),
            "generators": [None] * s,
            "done": torch.empty((s,), dtype=torch.bool, device=dev),
            "pad_slots": torch.empty((s, caches[0].capacity), dtype=torch.bool, device=dev),
            "pos_shift": torch.empty((s, 1), dtype=torch.long, device=dev),
        }
        self._reset_state()
        # a capture of the step is its "compile": a `compile` event, and the
        # `compiled` flag of the slots a capturing step decodes for
        self._tracker = RecompileTracker(events=self.events)
        self._step_fn = self._tracker.wrap(make_paged_step_fn(model, self._gen_config, device=dev),
                                           "engine_decode_step")
        if dev.type == "cuda":
            # the capture: one step while every slot is idle (it writes only
            # the scratch page), then the state back to its initial values
            self._step_fn(self._state)
            self._reset_state()
        self._prefill_fns: Dict[int, Any] = {}
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
        # per-tenant pages held (feeds engine_kv_pages_used{tenant=...})
        self._tenant_pages: Dict[str, int] = {}
        self._admission_checks.append(self._page_fit_check)

    def _reset_state(self) -> None:
        """Every slot idle, in place: table rows at the scratch page (zeroed),
        lengths and counters 0, done, a neutral token."""
        st = self._state
        for pool in st["cache"]:
            pool.page_table.zero_()
            pool.length.zero_()
            pool.k[0].zero_()
            pool.v[0].zero_()
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
        fits = (
            ca_tokens <= ec.max_ca_tokens
            and sa_tokens <= ec.max_sa_tokens
            and self.ca_alloc.can_ever_fit(ca_tokens)
            and self.sa_alloc.can_ever_fit(sa_tokens)
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

    # -- join ----------------------------------------------------------------

    def _prefill_for(self, max_new: int):
        """The prefill for one decode budget (eager: its prompt length
        varies per request)."""
        if max_new not in self._prefill_fns:
            cfg = dataclasses.replace(self._gen_config, max_new_tokens=max_new)
            cache_dtype = torch.float32 if self.cache_dtype is None else self.cache_dtype
            self._prefill_fns[max_new], _ = make_decode_fns(self.model, self.num_latents, cfg, cache_dtype,
                                                            device=self.device)
        return self._prefill_fns[max_new]

    def _try_join(self, ticket: _Ticket, slot_id: int) -> bool:
        """Prefill the ticket's request and land it in ``slot_id``. Returns
        False (the ticket stays queued) when pages are short right now;
        raises nothing: a prefill failure books the request as a terminal
        error (pages freed), keeping the stream 1:1."""
        rec = ticket.record
        ca_grant = self.ca_alloc.alloc_tokens(rec.prompt_len + rec.max_new_tokens)
        if ca_grant is None:
            return False
        sa_grant = self.sa_alloc.alloc_tokens(self.num_latents + rec.max_new_tokens)
        if sa_grant is None:
            self.ca_alloc.free(ca_grant)
            return False
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
            with self._served_with(rec.index):
                token, pstate = self._prefill_for(rec.max_new_tokens)(ticket.spec.input_ids, None, generator)
            first = int(token[0])
        except Exception as e:  # noqa: BLE001 — books close, pages return
            self.ca_alloc.free(ca_grant)
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
        self._join_state(slot_id, ca_grant, sa_grant, pstate)
        self._slots[slot_id] = slot
        self._in_flight += 1
        self._m_ttft.record(slot.ttft_s)
        # the per-token seam fires for token 0 exactly like the sequential
        # path (injector stalls and kills, cancellation, deadline)
        self._token_seam(slot, 0)
        return True

    def _join_state(self, slot: int, ca_grant: PageGrant, sa_grant: PageGrant, pstate: dict) -> None:
        """Commit one prefilled request's prompt KV into its granted pages and
        write its per-slot scalars, all in place."""
        st, dev = self._state, self.device
        prefill_cache = pstate["cache"]
        ca_pages = torch.tensor(ca_grant.pages, dtype=torch.long, device=dev)
        sa_pages = torch.tensor(sa_grant.pages, dtype=torch.long, device=dev)
        ca, sas = st["cache"][0], st["cache"][1:]
        commit_prefill_(ca, slot, ca_pages, prefill_cache[0], prefill_cache[0].length)
        for c, pc in zip(sas, prefill_cache[1:]):
            commit_prefill_(c, slot, sa_pages, pc, pc.length)
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
        self.ca_alloc.free(slot.ca_grant)
        self.sa_alloc.free(slot.sa_grant)
        self._tenant_pages_delta(slot.ticket.record, -(slot.ca_grant.n_pages + slot.sa_grant.n_pages))
        self._retire_state(slot_id)
        self._retire_books(slot, outcome, emit=True)
        self._busy_until = float(self._clock())

    def _retire_state(self, slot: int) -> None:
        """Device half of a retire, in place: table row back to scratch,
        length 0, the slot idle with a neutral token."""
        st = self._state
        for c in st["cache"]:
            release_slot_(c, slot)
        st["token"][slot] = 0
        st["done"][slot] = True
        st["ca_start"][slot] = 0
        st["sa_start"][slot] = 0
        st["pad_slots"][slot] = False
        st["pos_shift"][slot] = 0
        st["generators"][slot] = None

    # -- the engine loop -----------------------------------------------------

    def _active_ids(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _fill_slots(self) -> None:
        """Batched prefill admission: join queued requests into every free
        slot, booking queued cancels and queue-expired deadlines first. Page
        backpressure stops the fill; it never sheds."""
        if not self._queue:
            return  # nothing joins: the gauges hold the last step's values
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
                    return  # pages short: the queue waits for retires
                break  # joined (or terminally booked): next slot
        self._update_gauges()

    def _update_gauges(self) -> None:
        """The batch-fill and page gauges, once a step: from the allocators'
        counters (``PageAllocator.stats()`` walks every live page, ~0.1 ms
        at the flagship's 4096-page pool, as long as a decode step)."""
        active = len(self._active_ids())
        self._m_fill.set(active / max(self.engine_config.slots, 1))
        ca_used = self.ca_alloc.pages_used
        self._m_pages.set(ca_used + self.sa_alloc.pages_used)
        self._m_pages_frac.set(ca_used / self.ca_alloc.num_allocatable)

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
        every emitted token streams through the per-token seam."""
        self._sweep_terminal()
        active = self._active_ids()
        if not active:
            return
        compiles0 = self._tracker.total_compiles
        t0 = self._now_s()
        self._state, tokens = self._step_fn(self._state)
        tokens = tokens.tolist()  # the one host fetch of the step
        dt = self._now_s() - t0
        self._engine_steps += 1
        self._fill_sum += len(active)
        cold_step = self._tracker.total_compiles > compiles0
        batch_size = len(active)
        # one TPOT sample a slot: the step's time, bucketed once for all
        bucket = bucket_index(dt)
        if not cold_step:
            self._m_tpot.record(dt, count=batch_size)
        eos = self._gen_config.eos_token_id
        for slot_id in active:
            slot = self._slots[slot_id]
            rec = slot.ticket.record
            tok = int(tokens[slot_id])
            slot.tokens_out += 1
            self.served_tokens[rec.index].append(tok)
            slot.step_times.append(dt)
            slot.step_buckets.append(bucket)
            slot.batch_sizes.append(batch_size)
            if cold_step:
                slot.compiled = True
            self._token_seam(slot, slot.tokens_out - 1)
            if slot.outcome is not None:  # killed / cancelled / deadline
                self._retire_slot(slot_id, slot.outcome)
            elif slot.tokens_out >= rec.max_new_tokens or (eos is not None and tok == eos):
                self._retire_slot(slot_id, "ok")
        self._update_gauges()

    def cancel(self, request_index: int) -> bool:
        """Cancel a queued request or one live in a decode slot (the slot
        retires ``cancelled`` at its next token boundary)."""
        for slot in self._slots:
            if slot is not None and slot.ticket.record.index == request_index:
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
        while self._queue or self._active_ids():
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
        while self._queue or pending or self._active_ids():
            self._check_guard()
            admit()
            if not (self._queue or self._active_ids()):
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
        while pending or self._queue or self._active_ids():
            self._check_guard()
            # admit every arrival whose time has passed on the clock
            while pending and t0 + pending[0][1] <= float(self._clock()):
                spec, off = pending.popleft()
                out.append(self.submit(spec, arrival_s=t0 + off, deadline_s=deadline_s))
            if not (self._queue or self._active_ids()):
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
    """Host-side record of one occupied decode slot."""

    ticket: _Ticket
    slot_id: int
    ca_grant: PageGrant
    sa_grant: PageGrant
    tokens_out: int = 0
    ttft_s: Optional[float] = None
    compiled: bool = False
    outcome: Optional[str] = None  # set mid-decode by the token seam
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
