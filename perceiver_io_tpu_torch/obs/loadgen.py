"""Load generation over the instrumented decode path (counterpart of
``perceiver_io_tpu/obs/loadgen.py``): the seeded request mix
(:class:`WorkloadSpec` and its :meth:`~WorkloadSpec.draw`,
:class:`RequestSpec`, :func:`arrival_schedule`), the load runner
(:func:`run_load`, :class:`RequestRecord`, :class:`LoadReport`,
:func:`summarize_load`) and the ``LOAD`` documents with their diff
(:func:`build_load_doc`, :func:`load_doc_metrics`,
:func:`comparability_problems`, :func:`diff_load`,
:func:`format_load_diff`).

Both packages draw from the same ``numpy`` generator in the same order, so a
spec and seed give the same requests (prompt ids, budgets, rng seeds) to the
JAX package and to the port. :func:`run_load` pushes them through the port's
``generation.make_instrumented_generate_fn``, so every request rides the
span / ``request``-event / SLO path, in one of two modes:

- **closed-loop** — fixed concurrency ``c``: ``c`` requests are enqueued at
  t0 and each completion admits the next, so the queue depth is pinned and
  queue-wait converges to ``(c-1) * service_time``;
- **open-loop** — a seeded Poisson arrival schedule at ``rate_rps``: the
  worker sleeps until the next arrival when it is ahead, and queue-wait is
  measured whenever it cannot keep up (``start - arrival``), so an
  overloaded run shows queue growth instead of self-throttling.

Each request's sampling draws come from ``torch.Generator().manual_seed(
rs.rng_seed)``, as the port's serving front ends seed them (the JAX package
seeds a ``PRNGKey`` instead, so sampled streams differ between the packages;
greedy streams do not).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

LOAD_SCHEMA_VERSION = 1

# metric -> (better direction, tolerance kind, default tolerance); the
# diffable surface of a LOAD summary: tails get looser defaults than
# medians, error_rate is zero-tolerance, queue-wait is the noisiest family
# (it compounds every upstream stall).
LOAD_METRICS: Dict[str, tuple] = {
    "achieved_rps": ("higher", "rel", 0.10),
    "throughput_tok_s": ("higher", "rel", 0.10),
    "ttft_s_p50": ("lower", "rel", 0.10),
    "ttft_s_p99": ("lower", "rel", 0.25),
    "tpot_s_p50": ("lower", "rel", 0.10),
    "tpot_s_p99": ("lower", "rel", 0.25),
    "queue_wait_s_p50": ("lower", "rel", 0.50),
    "queue_wait_s_p99": ("lower", "rel", 0.50),
    "error_rate": ("lower", "abs", 0.0),
}

# document fields that must match for two LOAD summaries to be comparable
# at all (stale != regression): the run manifest's (``obs.events.
# write_run_manifest``), the JAX package's keys with ``torch_version`` for
# its ``jax_version``
_MANIFEST_KEYS = (
    "backend",
    "device_kind",
    "device_count",
    "process_count",
    "torch_version",
    "mesh",
    "config_hash",
)


@dataclass(frozen=True)
class WorkloadSpec:
    """Seeded synthetic request mix: everything a request *is* (prompt
    length, token ids, decode budget, rng chain) is drawn from one
    ``numpy`` generator, so two runs of the same spec issue bit-identical
    request streams — the property that makes a LOAD artifact diffable.

    ``prompt_lens``/``max_new_tokens`` are the mix buckets (each request
    draws one of each, uniformly); keep the bucket count small on purpose —
    every distinct (prompt_len, max_new_tokens) pair is a distinct compiled
    prefill/step geometry, and the load generator's job is to measure warm
    serving, not to fuzz the compile cache.

    ``shared_prefix_len > 0`` is the Shareline prompt-homogeneous mode:
    every request's first ``shared_prefix_len`` tokens are ONE common
    seeded preamble (drawn once, before the per-request stream, so the
    stream stays prefix-stable in ``n``) — the system-prompt / few-shot
    traffic shape whose prefill the engine's radix prefix sharing
    collapses. Must be shorter than every prompt bucket: each request
    still carries a unique tail.
    """

    seed: int = 0
    prompt_lens: Tuple[int, ...] = (8, 12)
    max_new_tokens: Tuple[int, ...] = (6, 10)
    batch: int = 1
    shared_prefix_len: int = 0

    def __post_init__(self):
        if not self.prompt_lens or not self.max_new_tokens:
            raise ValueError("WorkloadSpec needs at least one prompt_len and max_new_tokens bucket")
        if min(self.prompt_lens) < 1 or min(self.max_new_tokens) < 1 or self.batch < 1:
            raise ValueError("WorkloadSpec buckets and batch must be >= 1")
        if self.shared_prefix_len < 0:
            raise ValueError("shared_prefix_len must be >= 0")
        if self.shared_prefix_len and self.shared_prefix_len >= min(self.prompt_lens):
            raise ValueError(
                f"shared_prefix_len {self.shared_prefix_len} must be shorter "
                f"than every prompt bucket {self.prompt_lens} (each request "
                "needs a unique tail)"
            )

    def to_dict(self) -> Dict:
        out = {
            "seed": self.seed,
            "prompt_lens": list(self.prompt_lens),
            "max_new_tokens": list(self.max_new_tokens),
            "batch": self.batch,
        }
        # only stamped when active: pre-Shareline artifacts stay
        # byte-comparable (diff_load keys comparability on this dict)
        if self.shared_prefix_len:
            out["shared_prefix_len"] = self.shared_prefix_len
        return out

    def draw(self, n: int, vocab_size: int) -> List["RequestSpec"]:
        """The first ``n`` requests of this spec's stream (deterministic:
        same spec + same n => same list, prefix-stable in n)."""
        import numpy as np

        rng = np.random.default_rng(self.seed)
        shared = (
            rng.integers(0, vocab_size, size=self.shared_prefix_len, dtype=np.int32)
            if self.shared_prefix_len
            else None
        )
        out = []
        for i in range(n):
            prompt_len = int(rng.choice(self.prompt_lens))
            max_new = int(rng.choice(self.max_new_tokens))
            ids = rng.integers(0, vocab_size, size=(self.batch, prompt_len), dtype=np.int32)
            if shared is not None:
                ids[:, : self.shared_prefix_len] = shared
            out.append(
                RequestSpec(
                    index=i,
                    prompt_len=prompt_len,
                    max_new_tokens=max_new,
                    input_ids=ids,
                    rng_seed=int(rng.integers(0, 2**31 - 1)),
                )
            )
        return out


@dataclass(frozen=True)
class RequestSpec:
    """One drawn request (host-side; ``input_ids`` is a numpy array).
    ``tenant`` is the optional multi-tenant identity (Simline,
    docs/serving.md#multi-tenant-telemetry): the serving front ends thread
    it onto request events, spans, journal records and the labeled
    ``serve_*`` metric children; None means single-tenant (everything
    pre-Simline)."""

    index: int
    prompt_len: int
    max_new_tokens: int
    input_ids: object
    rng_seed: int
    tenant: Optional[str] = None


def arrival_schedule(n: int, rate_rps: float, seed: int = 0) -> List[float]:
    """Seeded Poisson arrival offsets (seconds from t0, cumulative,
    monotone): exponential inter-arrivals at ``rate_rps``. Deterministic —
    the open-loop schedule is part of the workload's identity."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    import numpy as np

    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0 / rate_rps, size=n)
    out, t = [], 0.0
    for d in inter:
        t += float(d)
        out.append(t)
    return out


@dataclass
class RequestRecord:
    """What one issued request experienced, host-measured by the load
    generator + the instrumented wrapper's ``GenerationStats``."""

    index: int
    prompt_len: int
    max_new_tokens: int
    batch: int
    queue_wait_s: float
    outcome: str = "ok"  # "ok" | "error"
    compiled: bool = False
    ttft_s: Optional[float] = None
    decode_s: Optional[float] = None
    tokens_out: int = 0
    error: Optional[str] = None


@dataclass
class LoadReport:
    """:func:`run_load`'s result: the summary (the LOAD document body), the
    per-request records, and the shared registry / per-budget generate fns
    (reusable — e.g. a planted SLO-breach request rides the same captured
    fns instead of paying a fresh capture)."""

    mode: str
    summary: Dict
    records: List[RequestRecord]
    registry: object
    generate_fns: Dict[int, Callable] = field(default_factory=dict)


def _pct_block(vals: List[float]) -> Optional[Dict]:
    """The shared percentile block (``summarize_latencies`` shape, rounded
    for the document)."""
    if not vals:
        return None
    from perceiver_io_tpu_torch.utils.profiling import summarize_latencies

    return {
        k: (round(v, 6) if isinstance(v, float) else v)
        for k, v in summarize_latencies(vals).items()
    }


def summarize_load(
    records: List[RequestRecord],
    duration_s: float,
    registry=None,
    mode: str = "closed",
    concurrency: Optional[int] = None,
    rate_rps: Optional[float] = None,
) -> Dict:
    """The LOAD document's ``summary`` body. Latency percentiles are
    **warm-only** (requests that paid a capture are excluded, the
    ``obs.slo`` convention — capture-inflated latencies are not steady
    state; ``warm_only: false`` flags the fallback when every request
    captured). TPOT percentiles come from the registry's ``generate_tpot_s``
    histogram, which the instrumented path feeds with warm per-token samples
    only — a real distribution over every decoded token, not a mean of
    means."""
    n = len(records)
    if n == 0:
        raise ValueError("summarize_load needs at least one record")
    duration_s = max(float(duration_s), 1e-9)
    errors = [r for r in records if r.outcome != "ok"]
    ok = [r for r in records if r.outcome == "ok"]
    warm = [r for r in ok if not r.compiled]
    pool, warm_only = (warm, True) if warm else (ok, False)
    tokens_out = sum(r.tokens_out * r.batch for r in records)
    summary: Dict = {
        "mode": mode,
        "n_requests": n,
        "concurrency": concurrency,
        "target_rps": rate_rps,
        "duration_s": round(duration_s, 6),
        "achieved_rps": round(n / duration_s, 6),
        "throughput_tok_s": round(tokens_out / duration_s, 6),
        "tokens_out": tokens_out,
        "errors": len(errors),
        "error_rate": round(len(errors) / n, 6),
        "ok_rate": round(1.0 - len(errors) / n, 6),
        "n_cold": sum(1 for r in records if r.compiled),
        "warm_only": warm_only,
        "n_latency_requests": len(pool),
    }
    ttfts = [float(r.ttft_s) for r in pool if r.ttft_s is not None]
    if ttfts:
        summary["ttft_s"] = _pct_block(ttfts)
    qws = [float(r.queue_wait_s) for r in pool]
    if qws:
        summary["queue_wait_s"] = _pct_block(qws)
    if registry is not None:
        hist = registry.histogram("generate_tpot_s")
        if hist.n:
            tpot = {f"p{p}": round(hist.percentile(p), 6) for p in (50, 90, 99)}
            tpot["n"] = hist.n
            if hist.n < 5:
                tpot["low_n"] = True
            summary["tpot_s"] = tpot
    from perceiver_io_tpu_torch.obs.slo import _median

    breakdown = {}
    for name, vals in (
        ("queue_wait", [1e3 * r.queue_wait_s for r in pool]),
        ("prefill", [1e3 * float(r.ttft_s) for r in pool if r.ttft_s is not None]),
        ("decode", [1e3 * float(r.decode_s) for r in pool if r.decode_s is not None]),
    ):
        med = _median(vals)
        if med is not None:
            breakdown[name] = round(med, 3)
    if breakdown:
        summary["breakdown_ms"] = breakdown
    return summary


def run_load(
    model,
    spec: WorkloadSpec,
    *,
    mode: str = "closed",
    n_requests: int = 32,
    concurrency: int = 4,
    rate_rps: Optional[float] = None,
    num_latents: int = 1,
    base_config=None,
    cache_dtype=None,
    weight_dtype=None,
    events=None,
    registry=None,
    probes: bool = False,
    snapshot_interval_s: float = 30.0,
    generate_fns: Optional[Dict[int, Callable]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Optional[Callable[[], float]] = None,
    device="cuda",
) -> LoadReport:
    """Drive ``n_requests`` of ``spec``'s stream through the instrumented
    generate path of ``model`` (which holds its own weights: no ``params``
    argument, unlike the JAX function) and return a :class:`LoadReport`.

    ``mode="closed"``: ``concurrency`` requests in flight, each completion
    admits the next. ``mode="open"``: seeded Poisson arrivals at
    ``rate_rps`` (required), queue-wait measured when the worker falls
    behind. ``base_config`` seeds every request's ``GenerationConfig``
    (``max_new_tokens`` is overridden per request from the spec);
    ``generate_fns`` reuses a previous report's per-budget fns (and their
    captured steps). Every request emits its ``request`` event / span
    through ``events`` and publishes into ``registry`` (fresh one when
    None); the run closes with one ``load.summary`` event. ``probes=True``
    adds the decode health gauges to every request; ``device`` is the
    model's (``"cuda"`` by default; pass ``"cpu"`` for a model on the CPU).

    The open-loop worker's pacing is injectable: ``sleep`` plus ``clock``
    (default ``time.perf_counter``) — pass a
    ``serving.faultinject.ManualClock`` as ``clock=`` with its ``.sleep`` as
    ``sleep=`` and the schedule, queue waits and duration all come off the
    manual timeline."""
    import torch

    from perceiver_io_tpu_torch.generation import GenerationConfig, make_instrumented_generate_fn
    from perceiver_io_tpu_torch.obs.metrics import MetricsRegistry

    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be 'closed' or 'open', got {mode!r}")
    if mode == "open" and (rate_rps is None or rate_rps <= 0):
        raise ValueError("open-loop mode needs rate_rps > 0")
    if mode == "closed" and concurrency < 1:
        raise ValueError("closed-loop mode needs concurrency >= 1")
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    registry = registry if registry is not None else MetricsRegistry()
    base_config = base_config or GenerationConfig()
    cache_dtype = cache_dtype if cache_dtype is not None else torch.float32
    fns: Dict[int, Callable] = dict(generate_fns or {})

    def fn_for(max_new: int) -> Callable:
        if max_new not in fns:
            cfg = dataclasses.replace(base_config, max_new_tokens=max_new)
            fns[max_new] = make_instrumented_generate_fn(
                model,
                num_latents=num_latents,
                config=cfg,
                cache_dtype=cache_dtype,
                weight_dtype=weight_dtype,
                events=events,
                registry=registry,
                snapshot_interval_s=snapshot_interval_s,
                probes=probes,
                device=device,
            )
        return fns[max_new]

    specs = spec.draw(n_requests, int(model.config.vocab_size))
    records: List[RequestRecord] = []

    def execute(rs: RequestSpec, queue_wait_s: float, arrival_epoch: float) -> RequestRecord:
        rec = RequestRecord(
            index=rs.index,
            prompt_len=rs.prompt_len,
            max_new_tokens=rs.max_new_tokens,
            batch=spec.batch,
            queue_wait_s=round(queue_wait_s, 6),
        )
        try:
            _, stats = fn_for(rs.max_new_tokens)(
                torch.as_tensor(rs.input_ids),
                None,
                torch.Generator().manual_seed(int(rs.rng_seed)),
                queue_wait_s=rec.queue_wait_s,
                arrival_ts=round(arrival_epoch, 6),
            )
            rec.compiled = stats.compiled
            rec.ttft_s = stats.ttft_s
            rec.decode_s = stats.decode_s
            rec.tokens_out = stats.tokens_out
        except Exception as e:  # noqa: BLE001 — the event already went out
            rec.outcome, rec.error = "error", repr(e)
        return rec

    clock = clock if clock is not None else time.perf_counter
    t0 = clock()
    epoch0 = time.time()
    if mode == "closed":
        queue: deque = deque()
        next_i = 0
        while next_i < len(specs) and len(queue) < concurrency:
            queue.append((specs[next_i], t0))
            next_i += 1
        while queue:
            rs, enq = queue.popleft()
            now = clock()
            records.append(execute(rs, max(now - enq, 0.0), epoch0 + (enq - t0)))
            if next_i < len(specs):
                queue.append((specs[next_i], clock()))
                next_i += 1
    else:
        offsets = arrival_schedule(len(specs), rate_rps, seed=spec.seed + 1)
        for rs, off in zip(specs, offsets):
            arrival = t0 + off
            now = clock()
            if now < arrival:
                sleep(arrival - now)
                now = clock()
            records.append(execute(rs, max(now - arrival, 0.0), epoch0 + off))
    duration_s = clock() - t0

    summary = summarize_load(
        records, duration_s, registry=registry, mode=mode,
        concurrency=concurrency if mode == "closed" else None,
        rate_rps=rate_rps,
    )
    if events is not None:
        events.emit("load.summary", **summary)
        registry.maybe_emit(events, min_interval_s=0.0)
    return LoadReport(mode=mode, summary=summary, records=records,
                      registry=registry, generate_fns=fns)


# ---------------------------------------------------------------------------
# LOAD documents: build, extract, diff
# ---------------------------------------------------------------------------


def build_load_doc(
    n_round: int,
    summary: Dict,
    spec: WorkloadSpec,
    manifest: Optional[Dict] = None,
    extra: Optional[Dict] = None,
) -> Dict:
    """A ``LOAD`` document: round number, schema version, the workload
    identity (spec + mode + request count), the comparability manifest
    subset, and the summary."""
    doc = {
        "n": int(n_round),
        "schema_version": LOAD_SCHEMA_VERSION,
        "mode": summary["mode"],
        "workload": {
            "spec": spec.to_dict(),
            "n_requests": summary["n_requests"],
            "concurrency": summary.get("concurrency"),
            "target_rps": summary.get("target_rps"),
        },
        "manifest": {k: (manifest or {}).get(k) for k in _MANIFEST_KEYS},
        "summary": summary,
    }
    if extra:
        doc.update(extra)
    return doc


def load_doc_metrics(doc: Dict) -> Tuple[Dict[str, float], List[str]]:
    """``(metrics, low_n_families)`` — the diffable flat metrics of one
    LOAD doc."""
    s = doc.get("summary", {}) or {}
    out: Dict[str, float] = {}
    low_n: List[str] = []
    for key in ("achieved_rps", "throughput_tok_s", "error_rate"):
        if isinstance(s.get(key), (int, float)):
            out[key] = float(s[key])
    for fam in ("ttft_s", "tpot_s", "queue_wait_s"):
        block = s.get(fam) or {}
        for p in ("p50", "p99"):
            if isinstance(block.get(p), (int, float)):
                out[f"{fam}_{p}"] = float(block[p])
        if block.get("low_n"):
            low_n.append(fam)
    return out, low_n


def comparability_problems(old: Dict, new: Dict) -> List[str]:
    """Workload/manifest mismatches that make two LOAD documents
    incomparable (never a regression)."""
    problems = []
    for key in ("mode",):
        if old.get(key) != new.get(key):
            problems.append(f"{key}: {old.get(key)!r} != {new.get(key)!r}")
    ow, nw = old.get("workload", {}) or {}, new.get("workload", {}) or {}
    for key in ("spec", "n_requests", "concurrency", "target_rps"):
        if ow.get(key) != nw.get(key):
            problems.append(f"workload.{key}: {ow.get(key)!r} != {nw.get(key)!r}")
    om, nm = old.get("manifest", {}) or {}, new.get("manifest", {}) or {}
    for key in _MANIFEST_KEYS:
        if om.get(key) != nm.get(key):
            problems.append(f"manifest.{key}: {om.get(key)!r} != {nm.get(key)!r}")
    return problems


def diff_load(
    old: Dict, new: Dict, tolerances: Optional[Dict[str, float]] = None
) -> Dict:
    """Classify every shared LOAD metric as regression / improvement /
    neutral under :data:`LOAD_METRICS` tolerances. Returns ``{comparable,
    reason, ok, deltas}`` (each delta: ``{metric, kind, old, new,
    detail}``)."""
    problems = comparability_problems(old, new)
    if problems:
        return {"comparable": False, "reason": "; ".join(problems), "ok": False, "deltas": []}
    tolerances = tolerances or {}
    old_m, old_low = load_doc_metrics(old)
    new_m, new_low = load_doc_metrics(new)
    if not old_m or not new_m:
        return {
            "comparable": False,
            "reason": "no metrics in one of the artifacts",
            "ok": False,
            "deltas": [],
        }
    deltas = []
    for metric, (direction, tol_kind, tol_default) in LOAD_METRICS.items():
        o, n = old_m.get(metric), new_m.get(metric)
        if o is None and n is None:
            continue
        if o is None or n is None:
            deltas.append({"metric": metric, "kind": "neutral", "old": o, "new": n,
                           "detail": "present in only one artifact"})
            continue
        family = metric.rsplit("_p", 1)[0]
        if family in old_low or family in new_low:
            deltas.append({"metric": metric, "kind": "neutral", "old": o, "new": n,
                           "detail": "low_n sample"})
            continue
        tol = float(tolerances.get(metric, tol_default))
        margin = tol * abs(o) if tol_kind == "rel" else tol
        worse = (o - n) if direction == "higher" else (n - o)
        kind = "regression" if worse > margin else (
            "improvement" if -worse > margin else "neutral"
        )
        detail = f"{(n - o) / o * 100:+.1f}%" if o else f"{n - o:+.4g}"
        deltas.append({"metric": metric, "kind": kind, "old": o, "new": n, "detail": detail})
    ok = not any(d["kind"] == "regression" for d in deltas)
    return {"comparable": True, "reason": "", "ok": ok, "deltas": deltas}


def format_load_diff(diff: Dict) -> str:
    if not diff["comparable"]:
        return f"load_diff: NOT COMPARABLE — {diff['reason']}"
    kinds = {"regression": 0, "improvement": 0, "neutral": 0}
    for d in diff["deltas"]:
        kinds[d["kind"]] += 1
    lines = [
        f"load_diff: {kinds['regression']} regression(s), "
        f"{kinds['improvement']} improvement(s), {kinds['neutral']} neutral"
    ]
    order = {"regression": 0, "improvement": 1, "neutral": 2}
    for d in sorted(diff["deltas"], key=lambda d: (order[d["kind"]], d["metric"])):
        old = "-" if d["old"] is None else f"{d['old']:.6g}"
        new = "-" if d["new"] is None else f"{d['new']:.6g}"
        note = f"  ({d['detail']})" if d.get("detail") else ""
        lines.append(f"  [{d['kind']:<11}] {d['metric']}: {old} -> {new}{note}")
    return "\n".join(lines)
