"""The continuous-batching serving engine on a paged KV cache (counterpart
of the core of ``perceiver_io_tpu/serving/engine.py::EngineFrontEnd``).

A fixed set of decode slots is driven through ONE batched step:

- **join**: a queued request's prompt runs the contiguous prefill of
  ``generation.make_decode_fns`` (batch 1), then ``core.cache.commit_prefill``
  lands its KV rows in freshly granted pages (``serving.pages``) and the slot
  enters the batch;
- **step**: every engine step decodes one token for every active slot
  (``generation.make_paged_step_fn``: per-slot lengths, window counters and
  generators, so each slot's stream equals the request decoded alone). On
  the card the step is one CUDA graph, captured at construction while every
  slot is idle; the engine's state tensors are therefore fixed for its life,
  and join and retire write into them in place;
- **retire**: finished slots leave between steps, their pages return to the
  free list, and queued requests join without draining the batch.

What the JAX engine's admission tier adds (deadlines, breaker, drain,
events and metrics), prefix sharing, eviction and journal recovery, and the
speculative slot mode are not ported: :class:`EngineConfig` has no fields for
them, so asking for one fails at construction.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from perceiver_io_tpu_torch.core.cache import commit_prefill_, release_slot_
from perceiver_io_tpu_torch.core.modules import CausalSequenceModel
from perceiver_io_tpu_torch.device import DeviceLike
from perceiver_io_tpu_torch.generation import (
    GenerationConfig,
    _model_device,
    make_decode_fns,
    make_paged_step_fn,
)
from perceiver_io_tpu_torch.serving.pages import PageAllocator, PageGrant


@dataclass
class EngineConfig:
    """Geometry of the batched engine."""

    # decode slots (the most requests one step serves)
    slots: int = 4
    # tokens per KV page
    page_size: int = 8
    # per-slot token ceilings (prompt + decode budget); the page-table widths
    # derive from these, and a request beyond them is refused at submit
    max_ca_tokens: int = 64
    max_sa_tokens: int = 32
    # pool size in units of fully loaded slots (1.0 = room for `slots`
    # maxed-out requests, plus the scratch page)
    pool_headroom: float = 1.0


@dataclass
class RequestSpec:
    """One request: the fields of the JAX package's ``obs.loadgen.RequestSpec``
    the engine reads. ``input_ids`` is (1, prompt_len), a numpy array or a
    tensor."""

    index: int
    prompt_len: int
    max_new_tokens: int
    input_ids: Any
    rng_seed: int


@dataclass
class RequestRecord:
    """What one request experienced: ``outcome`` is ``"queued"`` until it
    retires ``"ok"``; ``ttft_s`` covers its prefill and first sample."""

    index: int
    prompt_len: int
    max_new_tokens: int
    outcome: str = "queued"
    ttft_s: Optional[float] = None
    tokens_out: int = 0


@dataclass
class _EngineSlot:
    record: RequestRecord
    ca_grant: PageGrant
    sa_grant: PageGrant
    tokens_out: int = 0


class EngineFrontEnd:
    """The continuous-batching engine (see the module docstring).

    :param model: a ``CausalSequenceModel`` living on ``device``.
    :param num_latents: latent positions at the end of each prompt.
    :param base_config: sampling policy (``max_new_tokens`` comes from each
        request).
    :param engine_config: slot and page geometry.
    :param cache_dtype: the dtype of the page pools and of the prefill's
        contiguous caches (None: f32, as in the JAX engine); a bf16 model
        serves from bf16 pools with ``torch.bfloat16``.
    :param device: ``"cuda"`` by default; asking for CUDA without a card
        raises (pass ``device="cpu"`` for the plain versions).
    """

    def __init__(self, model: CausalSequenceModel, *, num_latents: int = 1,
                 base_config: Optional[GenerationConfig] = None,
                 engine_config: Optional[EngineConfig] = None, cache_dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = "cuda"):
        self.device = _model_device(model, device)
        self.model = model
        self.num_latents = int(num_latents)
        self.cache_dtype = torch.float32 if cache_dtype is None else cache_dtype
        self.engine_config = ec = engine_config or EngineConfig()
        self._gen_config = base_config or GenerationConfig()
        ps = ec.page_size
        self._ca_pages_per_slot = -(-ec.max_ca_tokens // ps)
        self._sa_pages_per_slot = -(-ec.max_sa_tokens // ps)
        ca_pool = 1 + max(2, int(round(ec.slots * self._ca_pages_per_slot * ec.pool_headroom)))
        sa_pool = 1 + max(2, int(round(ec.slots * self._sa_pages_per_slot * ec.pool_headroom)))
        self.ca_alloc = PageAllocator(ca_pool, ps)
        self.sa_alloc = PageAllocator(sa_pool, ps)
        caches = CausalSequenceModel.init_paged_cache(
            model.config, ec.slots, ps, ca_num_pages=ca_pool, ca_pages_per_slot=self._ca_pages_per_slot,
            sa_num_pages=sa_pool, sa_pages_per_slot=self._sa_pages_per_slot, dtype=self.cache_dtype,
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
        self._step_fn = make_paged_step_fn(model, self._gen_config, device=dev)
        if dev.type == "cuda":
            # the capture: one step while every slot is idle (it writes only
            # the scratch page), then the state back to its initial values
            self._step_fn(self._state)
            self._reset_state()
        self._prefill_fns: Dict[int, Any] = {}
        self._slots: List[Optional[_EngineSlot]] = [None] * s
        self._queue: deque = deque()
        self.records: List[RequestRecord] = []
        self._engine_steps = 0
        self._fill_sum = 0
        # request index -> served token ids (the streaming surface; the
        # token-exactness checks compare these with the sequential path)
        self.served_tokens: Dict[int, List[int]] = {}

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

    # -- admission -----------------------------------------------------------

    def submit(self, spec: RequestSpec) -> RequestRecord:
        """Queue one request. A request whose KV footprint can never fit (a
        per-slot ceiling or the whole pool) is refused with ValueError."""
        ec = self.engine_config
        ca_tokens = int(spec.prompt_len) + int(spec.max_new_tokens)
        sa_tokens = self.num_latents + int(spec.max_new_tokens)
        if not (ca_tokens <= ec.max_ca_tokens and sa_tokens <= ec.max_sa_tokens
                and self.ca_alloc.can_ever_fit(ca_tokens) and self.sa_alloc.can_ever_fit(sa_tokens)):
            raise ValueError(
                f"request {spec.index} refused (kv_pages_exhausted): needs {ca_tokens} CA tokens "
                f"(max_ca_tokens={ec.max_ca_tokens}) and {sa_tokens} SA tokens "
                f"(max_sa_tokens={ec.max_sa_tokens})"
            )
        rec = RequestRecord(int(spec.index), int(spec.prompt_len), int(spec.max_new_tokens))
        self.records.append(rec)
        self._queue.append((spec, rec))
        return rec

    # -- join ----------------------------------------------------------------

    def _prefill_for(self, max_new: int):
        if max_new not in self._prefill_fns:
            cfg = dataclasses.replace(self._gen_config, max_new_tokens=max_new)
            self._prefill_fns[max_new], _ = make_decode_fns(
                self.model, self.num_latents, cfg, self.cache_dtype, device=self.device)
        return self._prefill_fns[max_new]

    def _try_join(self, slot_id: int) -> bool:
        """Prefill the queue head and land it in ``slot_id``; False (the
        request stays queued) when pages are short right now."""
        spec, rec = self._queue[0]
        ca_grant = self.ca_alloc.alloc_tokens(rec.prompt_len + rec.max_new_tokens)
        if ca_grant is None:
            return False
        sa_grant = self.sa_alloc.alloc_tokens(self.num_latents + rec.max_new_tokens)
        if sa_grant is None:
            self.ca_alloc.free(ca_grant)
            return False
        self._queue.popleft()
        t0 = time.perf_counter()
        generator = torch.Generator().manual_seed(int(spec.rng_seed))
        token, pstate = self._prefill_for(rec.max_new_tokens)(spec.input_ids, None, generator)
        first = int(token[0])
        rec.ttft_s = time.perf_counter() - t0
        self.served_tokens[rec.index] = [first]
        self._join_state(slot_id, ca_grant, sa_grant, pstate)
        self._slots[slot_id] = _EngineSlot(rec, ca_grant, sa_grant, tokens_out=1)
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

    # -- retire --------------------------------------------------------------

    def _retire_slot(self, slot_id: int) -> None:
        slot = self._slots[slot_id]
        self._slots[slot_id] = None
        self.ca_alloc.free(slot.ca_grant)
        self.sa_alloc.free(slot.sa_grant)
        self._retire_state(slot_id)
        slot.record.tokens_out = slot.tokens_out
        slot.record.outcome = "ok"

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

    # -- the loop ------------------------------------------------------------

    def _active_ids(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _fill_slots(self) -> None:
        for slot_id, occupant in enumerate(self._slots):
            if occupant is None and self._queue and not self._try_join(slot_id):
                return  # pages short: the queue waits for retires

    def _sweep_terminal(self) -> None:
        """Retire slots whose budget is already spent (a one-token budget is
        filled by the prefill) before the next step decodes for them."""
        for slot_id, slot in enumerate(self._slots):
            if slot is not None and slot.tokens_out >= slot.record.max_new_tokens:
                self._retire_slot(slot_id)

    def _engine_step(self) -> None:
        """One batched decode step, then per-slot accounting and retires."""
        self._sweep_terminal()
        active = self._active_ids()
        if not active:
            return
        self._state, tokens = self._step_fn(self._state)
        tokens = tokens.tolist()  # the one host fetch of the step
        self._engine_steps += 1
        self._fill_sum += len(active)
        eos = self._gen_config.eos_token_id
        for slot_id in active:
            slot = self._slots[slot_id]
            tok = int(tokens[slot_id])
            slot.tokens_out += 1
            self.served_tokens[slot.record.index].append(tok)
            if slot.tokens_out >= slot.record.max_new_tokens or (eos is not None and tok == eos):
                self._retire_slot(slot_id)

    @property
    def mean_batch_fill(self) -> float:
        """Mean active-slot fraction over every decode step."""
        denom = self._engine_steps * self.engine_config.slots
        return self._fill_sum / denom if denom else 0.0

    def pump(self) -> None:
        """Drive the engine until the queue and the batch drain."""
        while self._queue or self._active_ids():
            self._fill_slots()
            self._engine_step()

    def run_closed(self, specs, *, concurrency: int = 4) -> List[RequestRecord]:
        """Closed-loop drive: ``concurrency`` requests queued or in flight;
        each retire admits the next."""
        if concurrency < 1:
            raise ValueError("run_closed needs concurrency >= 1")
        pending = deque(specs)
        out: List[RequestRecord] = []
        while pending or self._queue or self._active_ids():
            while pending and len(self._queue) + len(self._active_ids()) < concurrency:
                out.append(self.submit(pending.popleft()))
            self._fill_slots()
            self._engine_step()
        return out

    def books(self) -> dict:
        """Request books: every submitted request is queued, in flight or
        ``ok``; ``balanced`` says the identity holds."""
        n_ok = sum(r.outcome == "ok" for r in self.records)
        queued, in_flight = len(self._queue), len(self._active_ids())
        return {
            "submitted": len(self.records), "ok": n_ok, "queued": queued, "in_flight": in_flight,
            "balanced": len(self.records) == n_ok + queued + in_flight,
        }
