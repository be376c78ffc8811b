"""Per-request SLO aggregation — ``request`` events → an SLO report artifact
(counterpart of ``perceiver_io_tpu/obs/slo.py``).

The serving literature gates on per-request percentiles (TTFT / TPOT
p50/p99 in the Gemma-on-TPU comparison, per-request latency under mixed
prefill/decode in Ragged Paged Attention); this module turns the
``request`` rows ``generation.make_instrumented_generate_fn`` emits into
those numbers:

- **TTFT** percentiles are exact order statistics over the per-request
  scalars (``utils.profiling.summarize_latencies`` — nearest-rank + a
  ``low_n`` mark under 5 samples, never an interpolated fake tail);
- **TPOT** percentiles are derived from the **merged per-request
  histograms**: every request row carries its sparse log-bucket counts
  (``tpot_hist``; global bucket bounds — ``obs.metrics.GROWTH``), so
  merging is exact addition and the run-level p99 is a real distribution
  percentile over every decoded token, not a mean of means.

``build_slo_report`` prefers **warm** requests (excluding calls that paid a
compile) for the latency sections — compile-inflated latencies are not
steady state — falling back to all requests (flagged) when every call
compiled. ``write_slo_report`` persists ``slo_report.json`` next to
``events.jsonl``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

SLO_REPORT_SCHEMA_VERSION = 1


def iter_requests(events: List[Dict]) -> List[Dict]:
    return [e for e in events if e.get("event") == "request"]


def build_slo_report(events: List[Dict], by_tenant: bool = False) -> Optional[Dict]:
    """The SLO aggregate of one run's event stream (None when the run made
    no requests). With ``by_tenant=True`` and any tenant-stamped ``request``
    rows present, the report gains ``tenants``: one full sub-report per
    tenant over that tenant's rows only (same shape, same warm-only
    convention), the surface ``/slo?tenant=`` and the per-tenant isolation
    scenarios read."""
    from perceiver_io_tpu_torch.obs.metrics import merge_counts, percentile_from_counts
    from perceiver_io_tpu_torch.utils.profiling import summarize_latencies

    requests = iter_requests(events)
    if not requests:
        return None
    outcomes: Dict[str, int] = {}
    for r in requests:
        o = str(r.get("outcome", "?"))
        outcomes[o] = outcomes.get(o, 0) + 1
    ok = [r for r in requests if r.get("outcome") == "ok"]
    warm = [r for r in ok if not r.get("compiled")]
    latency_pool, warm_only = (warm, True) if warm else (ok, False)

    # admitted = everything the serving path actually owned; shed requests
    # were rejected at admission (the front end) and must not dilute the
    # served-path accounting: error/timeout/cancelled rates are over
    # ADMITTED requests (10 admitted all failing + 90 shed is a 100% error
    # rate, not 10%), shed_rate is over ALL traffic (it is a share-of-
    # traffic fact). Without shedding upstream, n_admitted == n_requests
    # and every rate means what it always did.
    n_admitted = len(requests) - outcomes.get("shed", 0)
    report: Dict = {
        "schema_version": SLO_REPORT_SCHEMA_VERSION,
        "n_requests": len(requests),
        "n_admitted": n_admitted,
        "outcomes": outcomes,
        "error_rate": round(outcomes.get("error", 0) / max(n_admitted, 1), 6),
        "tokens_in": sum(int(r.get("prompt_len", 0)) * int(r.get("batch", 1)) for r in requests),
        "tokens_out": sum(int(r.get("tokens_out", 0)) * int(r.get("batch", 1)) for r in requests),
        "warm_only": warm_only,
        "n_latency_requests": len(latency_pool),
    }
    if outcomes.get("shed"):
        report["shed_rate"] = round(outcomes["shed"] / len(requests), 6)
    for o in ("timeout", "cancelled"):
        if outcomes.get(o):
            report[f"{o}_rate"] = round(outcomes[o] / max(n_admitted, 1), 6)
    if latency_pool:
        ttfts = [float(r["ttft_s"]) for r in latency_pool if r.get("ttft_s") is not None]
        if ttfts:
            report["ttft_s"] = {
                k: round(v, 6) if isinstance(v, float) else v
                for k, v in summarize_latencies(ttfts).items()
            }
        merged = merge_counts(*(r.get("tpot_hist", {}) for r in latency_pool))
        n_tokens = sum(merged.values())
        if n_tokens:
            tpot = {
                f"p{p}": round(percentile_from_counts(merged, p), 6) for p in (50, 90, 99)
            }
            tpot["n"] = n_tokens
            if n_tokens < 5:
                tpot["low_n"] = True
            report["tpot_s"] = tpot
        tps = [float(r["tokens_per_sec"]) for r in latency_pool if r.get("tokens_per_sec")]
        if tps:
            report["tokens_per_sec_mean"] = round(sum(tps) / len(tps), 3)
        # admission telemetry (loadgen-issued requests only): queue-wait
        # percentiles are exact order statistics like TTFT
        qws = [
            float(r["queue_wait_s"]) for r in latency_pool
            if r.get("queue_wait_s") is not None
        ]
        if qws:
            report["queue_wait_s"] = {
                k: round(v, 6) if isinstance(v, float) else v
                for k, v in summarize_latencies(qws).items()
            }
    if by_tenant:
        tenants = sorted(
            {str(r["tenant"]) for r in requests if r.get("tenant") is not None}
        )
        if tenants:
            report["tenants"] = {
                t: build_slo_report([r for r in requests if r.get("tenant") == t])
                for t in tenants
            }
    return report


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def request_breakdowns(events: List[Dict]) -> Optional[Dict]:
    """Per-request **tail attribution**: queue-wait → prefill → decode →
    compile-if-cold, joined from the event stream (``request`` rows carry
    queue-wait/TTFT/decode; ``compile`` events are stamped with the span of
    the request that paid them, so the join is exact, not positional;
    ``span`` rows supply the end-to-end wall). The shape a p99 post-mortem
    needs: *which stage* ate the slow request, not just that it was slow.

    Returns ``{n, requests: [per-request rows], medians}`` (None when the
    stream has no requests); medians are over warm ok requests
    (``warm_only`` flags the all-cold fallback), the convention every other
    SLO surface uses."""
    requests = iter_requests(events)
    if not requests:
        return None
    spans = {
        e.get("span_id"): e for e in events if e.get("event") == "span"
    }
    compile_s: Dict[str, float] = {}
    for e in events:
        if e.get("event") == "compile" and e.get("span_id") is not None:
            compile_s[e["span_id"]] = compile_s.get(e["span_id"], 0.0) + float(
                e.get("wall_s", 0.0)
            )
    rows: List[Dict] = []
    for r in requests:
        sid = r.get("span_id")
        span = spans.get(sid)
        ttft = r.get("ttft_s")
        decode = r.get("decode_s")
        qw = r.get("queue_wait_s")
        # service = in-worker wall (the request span: prefill + decode +
        # compile-if-cold); total = queue wait + service — the latency the
        # CALLER saw, which is what a p99 breach is measured against
        service_ms = (
            float(span["dur_ms"])
            if span is not None and span.get("dur_ms") is not None
            else 1e3 * (float(ttft or 0.0) + float(decode or 0.0))
        )
        row = {
            "request_id": r.get("request_id"),
            "span_id": sid,
            "outcome": r.get("outcome", "ok"),
            "compiled": bool(r.get("compiled")),
            "queue_wait_ms": None if qw is None else round(1e3 * float(qw), 3),
            "prefill_ms": None if ttft is None else round(1e3 * float(ttft), 3),
            "decode_ms": None if decode is None else round(1e3 * float(decode), 3),
            "compile_ms": round(1e3 * compile_s.get(sid, 0.0), 3),
            "service_ms": round(service_ms, 3),
            "total_ms": round(1e3 * float(qw or 0.0) + service_ms, 3),
        }
        rows.append(row)
    ok = [r for r in rows if r["outcome"] == "ok"]
    warm = [r for r in ok if not r["compiled"]]
    pool, warm_only = (warm, True) if warm else (ok, False)
    medians = {}
    for key in ("queue_wait_ms", "prefill_ms", "decode_ms", "service_ms", "total_ms"):
        med = _median([float(r[key]) for r in pool if r.get(key) is not None])
        if med is not None:
            medians[key] = round(med, 3)
    cold_compile = _median(
        [float(r["compile_ms"]) for r in ok if r["compiled"] and r["compile_ms"]]
    )
    if cold_compile is not None:
        medians["compile_ms_cold"] = round(cold_compile, 3)
    return {"n": len(rows), "requests": rows, "medians": medians, "warm_only": warm_only}


def write_slo_report(run_dir: str, filename: str = "slo_report.json") -> Optional[Dict]:
    """Aggregate the run directory's (merged, shard-aware) event stream and
    persist the report beside it; returns the report (None when there are
    no requests — nothing is written)."""
    from perceiver_io_tpu_torch.obs.events import merged_events

    report = build_slo_report(merged_events(run_dir))
    if report is not None:
        with open(os.path.join(run_dir, filename), "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return report
