"""The port's serving telemetry (``obs/loadgen.py``'s load runner and
documents, ``obs/slo.py``, ``obs/flightrec.py``, ``obs/server.py``) and the
front end's probes feed, against the JAX package's (``tests/test_loadgen.py``,
``tests/test_obs_diff.py``'s SLO tests, ``tests/test_serving.py``'s
sentinel, health-provider, SLO-taxonomy, clock and flight-recorder tests),
on the CPU at the micro CLM those files use (prompt 10, 4 new tokens, 4
latents), the port's model holding JAX's weights. Both packages run the same
seeded requests under a ``ManualClock``; timing fields are never compared."""

import json
import os
import re
import signal
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs import events as jax_events
from perceiver_io_tpu.obs import flightrec as jax_flightrec
from perceiver_io_tpu.obs import loadgen as jax_loadgen
from perceiver_io_tpu.obs import metrics as jax_metrics
from perceiver_io_tpu.obs import server as jax_server
from perceiver_io_tpu.obs import slo as jax_slo
from perceiver_io_tpu_torch import serving as torch_serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs import events as torch_events
from perceiver_io_tpu_torch.obs import flightrec as torch_flightrec
from perceiver_io_tpu_torch.obs import loadgen as torch_loadgen
from perceiver_io_tpu_torch.obs import metrics as torch_metrics
from perceiver_io_tpu_torch.obs import server as torch_server
from perceiver_io_tpu_torch.obs import slo as torch_slo
from perceiver_io_tpu_torch.obs.events import EventLog, merged_events, validate_events
from perceiver_io_tpu_torch.obs.loadgen import (
    RequestRecord,
    WorkloadSpec,
    arrival_schedule,
    build_load_doc,
    diff_load,
    format_load_diff,
    run_load,
    summarize_load,
)
from perceiver_io_tpu_torch.obs.server import ObsServer
from perceiver_io_tpu_torch.obs.slo import build_slo_report, request_breakdowns, write_slo_report

CONFIG = dict(vocab_size=50, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.5)
SIDES = {
    "jax": types.SimpleNamespace(serving=jax_serving, events=jax_events, loadgen=jax_loadgen, slo=jax_slo,
                                 flightrec=jax_flightrec, server=jax_server, metrics=jax_metrics),
    "torch": types.SimpleNamespace(serving=torch_serving, events=torch_events, loadgen=torch_loadgen,
                                   slo=torch_slo, flightrec=torch_flightrec, server=torch_server,
                                   metrics=torch_metrics),
}
# wall-clock fields, which no two runs share
CLOCK_KEYS = ("ts", "uptime_s")


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, 50, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return {"jax": (jm, params), "torch": (tm,)}


def spec_for(ns):
    return ns.loadgen.WorkloadSpec(seed=7, prompt_lens=(10,), max_new_tokens=(4,))


def load_run(models, side, tmp_path, mode, **kw):
    ns = SIDES[side]
    clock = ns.serving.ManualClock()
    out = str(tmp_path / f"{side}_{mode}")
    events = ns.events.EventLog(out, main_process=True)
    extra = {} if side == "jax" else {"device": "cpu"}
    report = ns.loadgen.run_load(*models[side], spec_for(ns), mode=mode, num_latents=4, events=events,
                                 registry=None, snapshot_interval_s=0.0, sleep=clock.sleep, clock=clock,
                                 **extra, **kw)
    return report, out, clock


# ------------------------------------------------------------- the load runner


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_run_load_under_a_manual_clock_matches_jax(models, tmp_path, mode):
    """The same requests and records (index, geometry, queue wait off the
    manual timeline, outcome, tokens), the same summary keys, duration and
    rates; the port's stream validates, carries a ``load.summary`` row and
    queue-wait on every request row; the SLO report and the per-request
    breakdown of its rows equal JAX's functions' over the same rows."""
    kw = dict(n_requests=6, concurrency=2) if mode == "closed" else dict(n_requests=4, rate_rps=20.0)
    runs = {side: load_run(models, side, tmp_path, mode, **kw) for side in ("jax", "torch")}
    (jrep, _, jclock), (trep, out, tclock) = runs["jax"], runs["torch"]

    def records(rep):
        return [(r.index, r.prompt_len, r.max_new_tokens, r.batch, r.queue_wait_s, r.outcome, r.tokens_out)
                for r in rep.records]

    assert records(trep) == records(jrep) and len(trep.records) == kw["n_requests"]
    assert all(r.outcome == "ok" and r.tokens_out == 4 for r in trep.records)
    assert sorted(trep.summary) == sorted(jrep.summary)
    for key in ("mode", "n_requests", "concurrency", "target_rps", "duration_s", "achieved_rps",
                "throughput_tok_s", "tokens_out", "errors", "error_rate"):
        assert trep.summary[key] == jrep.summary[key], key
    if mode == "open":
        offsets = arrival_schedule(4, 20.0, seed=7 + 1)
        assert [r.queue_wait_s for r in trep.records] == [0.0] * 4
        assert trep.summary["duration_s"] == pytest.approx(offsets[-1], abs=1e-6)
        assert tclock() == pytest.approx(offsets[-1], abs=1e-6)
    warnings_out = []
    assert validate_events(out, warnings_out=warnings_out) == [] and warnings_out == []
    stream = merged_events(out)
    reqs = [e for e in stream if e.get("event") == "request"]
    assert len(reqs) == kw["n_requests"] and all(e.get("queue_wait_s") is not None for e in reqs)
    assert [e["n_requests"] for e in stream if e.get("event") == "load.summary"] == [kw["n_requests"]]
    assert trep.registry.histogram("generate_queue_wait_s").n == kw["n_requests"]
    assert build_slo_report(stream) == jax_slo.build_slo_report(stream)
    assert build_slo_report(stream, by_tenant=True) == jax_slo.build_slo_report(stream, by_tenant=True)
    assert request_breakdowns(stream) == jax_slo.request_breakdowns(stream)
    with pytest.raises(ValueError):
        run_load(*models["torch"], spec_for(SIDES["torch"]), mode="open", n_requests=1, device="cpu")
    with pytest.raises(ValueError):
        run_load(*models["torch"], spec_for(SIDES["torch"]), mode="nope", n_requests=1, device="cpu")


def test_run_load_reuses_its_fns_and_probes_the_requests(models, tmp_path):
    """``generate_fns=`` reuses a report's fns; ``probes=True`` puts the
    decode health on every request row."""
    report, out, _ = load_run(models, "torch", tmp_path, "closed", n_requests=2, concurrency=1, probes=True)
    again = run_load(*models["torch"], spec_for(SIDES["torch"]), n_requests=1, num_latents=4, probes=True,
                     generate_fns=report.generate_fns, device="cpu")
    assert again.generate_fns[4] is report.generate_fns[4]
    rows = [e for e in merged_events(out) if e.get("event") == "request"]
    assert all(r["nonfinite_logit_frac"] == 0.0 and 0 < r["kv_cache_frac"] <= 1 for r in rows)


# ------------------------------------------------------------ SLO reports


def _rows(n=5, tpot_bucket="-27"):
    rows = []
    for i in range(n):
        rows.append({"event": "request", "outcome": "ok", "batch": 2, "prompt_len": 8, "tokens_out": 21,
                     "ttft_s": 0.25, "tokens_per_sec": 80.0, "tpot_hist": {tpot_bucket: 20},
                     "compiled": i == 0, "request_id": f"r{i}", "span_id": f"s{i}", "queue_wait_s": 0.01 * i,
                     "tenant": "acme" if i % 2 else "bcorp"})
    return rows


def test_slo_report_merges_request_histograms_as_jax(tmp_path):
    events = EventLog(str(tmp_path), main_process=True)
    for row in _rows():
        events.emit(row.pop("event"), **row)
    stream = merged_events(str(tmp_path))
    report = build_slo_report(stream)
    assert report == jax_slo.build_slo_report(stream)
    assert report["warm_only"] is True and report["n_latency_requests"] == 4
    assert report["ttft_s"]["low_n"] is True and report["tpot_s"]["n"] == 80
    assert report["tokens_out"] == 5 * 21 * 2
    on_disk = write_slo_report(str(tmp_path))
    assert on_disk == json.load(open(os.path.join(str(tmp_path), "slo_report.json")))
    bare = str(tmp_path / "bare")
    EventLog(bare, main_process=True).emit("fit_start", start_step=0, max_steps=1)
    assert write_slo_report(bare) is None and not os.path.exists(os.path.join(bare, "slo_report.json"))


def test_slo_report_counts_errors_as_jax():
    events = [
        {"event": "request", "outcome": "ok", "batch": 1, "prompt_len": 4, "tokens_out": 8, "ttft_s": 0.1,
         "tokens_per_sec": 50.0, "tpot_hist": {"-27": 8}, "compiled": False},
        {"event": "request", "outcome": "error", "batch": 1, "prompt_len": 4, "tokens_out": 2, "ttft_s": 0.1,
         "tokens_per_sec": 10.0, "tpot_hist": {"-27": 2}, "compiled": False},
        {"event": "request", "outcome": "shed", "batch": 1, "prompt_len": 4, "tokens_out": 0},
    ]
    report = build_slo_report(events)
    assert report == jax_slo.build_slo_report(events)
    assert report["outcomes"] == {"ok": 1, "error": 1, "shed": 1}
    assert report["error_rate"] == 0.5 and report["n_latency_requests"] == 1
    assert build_slo_report([{"event": "log"}]) is None


def test_request_breakdowns_joins_compile_by_span():
    events = [
        {"event": "span", "span_id": "s1", "name": "request", "dur_ms": 1200.0},
        {"event": "span", "span_id": "s2", "name": "request", "dur_ms": 50.0},
        {"event": "compile", "fn": "generate_prefill", "wall_s": 1.0, "n_compiles": 1, "span_id": "s1"},
        {"event": "request", "request_id": "r1", "span_id": "s1", "batch": 1, "prompt_len": 8, "ttft_s": 1.05,
         "decode_s": 0.1, "outcome": "ok", "tokens_out": 4, "compiled": True, "queue_wait_s": 0.0},
        {"event": "request", "request_id": "r2", "span_id": "s2", "batch": 1, "prompt_len": 8, "ttft_s": 0.01,
         "decode_s": 0.03, "outcome": "ok", "tokens_out": 4, "compiled": False, "queue_wait_s": 0.2},
    ]
    bd = request_breakdowns(events)
    assert bd == jax_slo.request_breakdowns(events)
    r1, r2 = bd["requests"]
    assert r1["compile_ms"] == 1000.0 and r2["total_ms"] == pytest.approx(250.0)
    assert bd["medians"]["compile_ms_cold"] == 1000.0


# ------------------------------------------------------------- LOAD documents


def _doc(**overrides):
    summary = {
        "mode": "closed", "n_requests": 200, "concurrency": 4, "target_rps": None, "duration_s": 10.0,
        "achieved_rps": 20.0, "throughput_tok_s": 500.0, "tokens_out": 5000, "errors": 0, "error_rate": 0.0,
        "ok_rate": 1.0, "n_cold": 4, "warm_only": True, "n_latency_requests": 196,
        "ttft_s": {"p50": 0.01, "p90": 0.02, "p99": 0.05, "n": 196.0, "mean": 0.012},
        "tpot_s": {"p50": 0.001, "p90": 0.002, "p99": 0.004, "n": 900},
        "queue_wait_s": {"p50": 0.1, "p90": 0.2, "p99": 0.5, "n": 196.0, "mean": 0.12},
        "breakdown_ms": {"queue_wait": 100.0, "prefill": 10.0, "decode": 40.0},
    }
    summary.update(overrides.pop("summary", {}))
    doc = build_load_doc(1, summary, WorkloadSpec(seed=0), manifest={
        "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1, "process_count": 1,
        "torch_version": "2.6.0", "mesh": None, "config_hash": "abc"})
    doc.update(overrides)
    return doc


def test_diff_load_self_clean_classifies_and_refuses_as_jax():
    doc = _doc()
    assert diff_load(doc, doc)["comparable"] and diff_load(doc, doc)["ok"]
    assert all(d["kind"] == "neutral" for d in diff_load(doc, doc)["deltas"])
    worse = _doc(summary={"tpot_s": {"p50": 0.001, "p90": 0.002, "p99": 0.008, "n": 900},
                          "throughput_tok_s": 1000.0, "error_rate": 0.01, "ok_rate": 0.99, "errors": 2})
    diff = diff_load(doc, worse)
    assert diff == jax_loadgen.diff_load(doc, worse)
    kinds = {d["metric"]: d["kind"] for d in diff["deltas"]}
    assert (kinds["tpot_s_p99"], kinds["throughput_tok_s"], kinds["error_rate"]) == (
        "regression", "improvement", "regression")
    assert not diff["ok"] and "regression" in format_load_diff(diff)
    low = _doc(summary={"tpot_s": {"p50": 0.01, "p99": 0.08, "n": 3, "low_n": True}})
    assert {d["metric"]: d["kind"] for d in diff_load(low, low)["deltas"]}["tpot_s_p99"] == "neutral"
    for mutate in (lambda d: d["manifest"].update(device_kind="cpu"),
                   lambda d: d["workload"].update(n_requests=100),
                   lambda d: d.update(mode="open")):
        other = _doc()
        mutate(other)
        d = diff_load(doc, other)
        assert not d["comparable"] and "NOT COMPARABLE" in format_load_diff(d)


def test_summarize_load_warm_only_fallback():
    cold = [RequestRecord(index=i, prompt_len=8, max_new_tokens=4, batch=1, queue_wait_s=0.1, compiled=True,
                          ttft_s=1.0, decode_s=0.5, tokens_out=4) for i in range(3)]
    s = summarize_load(cold, duration_s=2.0)
    assert s == jax_loadgen.summarize_load([jax_loadgen.RequestRecord(**vars(r)) for r in cold], duration_s=2.0)
    assert s["warm_only"] is False and s["n_cold"] == 3 and s["ttft_s"]["low_n"] is True
    err = RequestRecord(index=3, prompt_len=8, max_new_tokens=4, batch=1, queue_wait_s=0.0, outcome="error",
                        error="boom")
    s = summarize_load(cold + [err], duration_s=2.0)
    assert s["errors"] == 1 and s["error_rate"] == 0.25 and s["ok_rate"] == 0.75
    with pytest.raises(ValueError):
        summarize_load([], 1.0)


# --------------------------------------------------------- flight recorder


def _request_row(span_id, ttft=0.01, tpot99=0.001, outcome="ok", request_id="req1"):
    return dict(request_id=request_id, span_id=span_id, batch=1, prompt_len=8, ttft_s=ttft, tpot_p99_s=tpot99,
                outcome=outcome, tokens_out=4)


def _norm(obj, root):
    """``obj`` without its wall-clock fields, the run directory ``root`` cut
    from its strings."""
    if isinstance(obj, dict):
        return {k: _norm(v, root) for k, v in obj.items() if k not in CLOCK_KEYS}
    if isinstance(obj, list):
        return [_norm(v, root) for v in obj]
    return obj.replace(root, "<run>") if isinstance(obj, str) else obj


def _flight_record(ns, rec, root):
    """A recorder's dumps: their names, their contents and the stream's
    ``flight.dump`` rows, clock fields aside."""
    return ([os.path.basename(p) for p in rec.dumps], [_norm(json.load(open(p)), root) for p in rec.dumps],
            [_norm(e, root) for e in ns.events.merged_events(root) if e.get("event") == "flight.dump"])


def _flight_triggers(ns, root):
    events = ns.events.EventLog(root, main_process=True)
    SLOBounds = ns.flightrec.SLOBounds
    rec = ns.flightrec.FlightRecorder(events, slo=SLOBounds(ttft_s=0.1, tpot_p99_s=0.05))
    assert rec.out_dir == root
    rec.emit_rows("span", [
        {"name": "request", "span_id": "aaa", "t_start": 1.0, "t_end": 2.0, "dur_ms": 1000.0,
         "process_index": 0, "attrs": {}},
        {"name": "request", "span_id": "bbb", "t_start": 2.0, "t_end": 3.0, "dur_ms": 1000.0,
         "process_index": 0, "attrs": {}},
    ])
    rec.emit("request", **_request_row("aaa"))
    assert rec.dumps == []
    rec.emit("request", **_request_row("bbb", ttft=0.5, request_id="req2"))
    assert [os.path.basename(p) for p in rec.dumps] == ["flight-slo_ttft-1.json"]
    dump = json.load(open(rec.dumps[0]))
    assert dump["trigger"] == "slo_ttft" and dump["trigger_span_id"] == "bbb"
    assert dump["trigger_request_id"] == "req2" and dump["n_events"] == len(dump["events"]) >= 3
    assert not os.path.exists(rec.dumps[0] + ".tmp")
    dumps = [e for e in ns.events.merged_events(root) if e.get("event") == "flight.dump"]
    assert len(dumps) == 1 and dumps[0]["trigger_span_id"] == "bbb"
    assert ns.events.validate_events(root) == []
    rec.emit("request", **_request_row("aaa", outcome="error"))
    rec.emit("request", **_request_row("aaa", tpot99=0.2))
    rec.emit("request", **_request_row("aaa", outcome="timeout"))
    assert [os.path.basename(p) for p in rec.dumps][1:] == [
        "flight-error-2.json", "flight-slo_tpot-3.json", "flight-timeout-4.json"]
    # per-tenant bounds: a relaxed tenant does not trip the strict one's
    rec.slo = SLOBounds(ttft_s=30, tenants={"acme": SLOBounds(ttft_s=1e-9)})
    rec.emit("request", **_request_row("ccc", ttft=0.5), tenant="bcorp")
    rec.emit("request", **_request_row("ddd", ttft=0.5), tenant="acme")
    assert len(rec.dumps) == 5 and json.load(open(rec.dumps[-1]))["trigger_event"]["tenant"] == "acme"
    return _flight_record(ns, rec, root)


def test_flight_recorder_triggers_dump_and_event(tmp_path):
    """The same rows through JAX's recorder and the port's: the same dumps,
    each with the same contents, and the same ``flight.dump`` rows."""
    got = {side: _flight_triggers(ns, str(tmp_path / side)) for side, ns in SIDES.items()}
    assert got["torch"] == got["jax"]


def _flight_blast_sentinel_sigusr1_cap_and_ring(ns, root):
    FlightRecorder = ns.flightrec.FlightRecorder
    rec = FlightRecorder(ns.events.EventLog(root, main_process=True), max_dumps=3)
    rec.emit("probe", step=1, scopes={"000:layer": {"rms": 1.0}})
    rec.emit("probe.blast", trigger="skip", scope="layer", step=1, affected=["layer"])
    assert [os.path.basename(p) for p in rec.dumps] == ["flight-blast-1.json"]
    assert json.load(open(rec.dumps[0]))["probe_snapshot"]["scopes"] == {"000:layer": {"rms": 1.0}}
    rec.emit("fault.spike", step=2, loss=9.9)
    assert os.path.basename(rec.dumps[1]) == "flight-sentinel-2.json"
    prev = rec.install_signal_handler()
    try:
        signal.raise_signal(signal.SIGUSR1)
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert os.path.basename(rec.dumps[2]) == "flight-sigusr1-3.json"
    rec.emit("fault.halt", step=3)  # capped: the event, no dump
    assert len(rec.dumps) == 3
    kinds = [e["event"] for e in ns.events.merged_events(root)]
    assert kinds.count("flight.dump") == 3 and "fault.halt" in kinds
    ring_dir = os.path.join(root, "ring")
    ring = FlightRecorder(ns.events.EventLog(ring_dir, main_process=True), capacity=4)
    for i in range(10):
        ring.emit("log", step=i)
    assert [r["step"] for r in ring.ring()] == [6, 7, 8, 9]
    assert len([e for e in ns.events.merged_events(ring_dir) if e["event"] == "log"]) == 10
    return _flight_record(ns, rec, root), kinds, _norm(ring.ring(), root)


def test_flight_recorder_blast_sentinel_sigusr1_cap_and_ring(tmp_path):
    """A blast, a sentinel, SIGUSR1 and the dump cap through JAX's recorder
    and the port's: the same dumps and contents, the same stream, the same
    ring."""
    got = {side: _flight_blast_sentinel_sigusr1_cap_and_ring(ns, str(tmp_path / side))
           for side, ns in SIDES.items()}
    assert got["torch"] == got["jax"]


def _flight_concurrent_dumps(ns, root):
    rec = ns.flightrec.FlightRecorder(None, out_dir=root, max_dumps=64)
    stop = threading.Event()

    def chatter():
        while not stop.is_set():
            rec.emit("probe", step=1)

    t = threading.Thread(target=chatter)
    t.start()
    try:
        paths = [rec.dump("sigusr1") for _ in range(16)]
    finally:
        stop.set()
        t.join()
    paths = [p for p in paths if p is not None]
    assert paths and rec.dumps == paths
    # the ring's length depends on the chatter's pace: the dumps' names,
    # keys and sequence numbers do not
    docs = [json.load(open(p)) for p in paths]
    return [os.path.basename(p) for p in paths], [(sorted(d), d["seq"], d["trigger"]) for d in docs]


def test_flight_recorder_dumps_list_consistent_under_concurrent_emit(tmp_path):
    got = {side: _flight_concurrent_dumps(ns, str(tmp_path / side)) for side, ns in SIDES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [f"flight-sigusr1-{i}.json" for i in range(1, 17)]


# ------------------------------------------------------------------ server


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode(), r.headers.get("Content-Type", "")


def _server_endpoints(ns, root):
    events = ns.events.EventLog(root, main_process=True)
    events.emit("request", request_id="r1", batch=1, prompt_len=8, ttft_s=0.01, outcome="ok", tokens_out=4,
                tokens_per_sec=400.0, tpot_hist={"0": 3}, queue_wait_s=0.002, tenant="acme")
    registry = ns.metrics.MetricsRegistry()
    registry.counter("gen_requests").inc(1)
    registry.histogram("lat_s").record(0.01)
    bodies = {}
    with ns.server.ObsServer(registry=registry, run_dir=root) as server:
        assert server.port != 0
        status, body, ctype = _get(server.url + "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "gen_requests 1" in body and 'lat_s_bucket{le="+Inf"} 1' in body
        bodies["/metrics"] = body
        health = json.loads(_get(server.url + "/healthz")[1])
        assert health["status"] == "ok" and health["n_metrics"] == 2
        bodies["/healthz"] = _norm(health, root)
        status, body, ctype = _get(server.url + "/slo")
        slo = json.loads(body)
        assert status == 200 and ctype.startswith("application/json")
        assert slo["n_requests"] == 1 and "queue_wait_s" in slo and "tenant" not in slo
        bodies["/slo"] = _norm(slo, root)
        events.emit("request", request_id="r2", batch=1, prompt_len=8, ttft_s=0.02, outcome="ok", tokens_out=4,
                    tokens_per_sec=200.0, tpot_hist={"0": 3})
        bodies["/slo 2"] = _norm(json.loads(_get(server.url + "/slo")[1]), root)
        assert bodies["/slo 2"]["n_requests"] == 2  # the appended tail
        acme = json.loads(_get(server.url + "/slo?tenant=acme")[1])
        assert acme["tenant"] == "acme" and acme["n_requests"] == 1
        bodies["/slo?tenant=acme"] = _norm(acme, root)
        bodies["/slo?tenant=ghost"] = _norm(json.loads(_get(server.url + "/slo?tenant=ghost")[1]), root)
        assert bodies["/slo?tenant=ghost"]["n_requests"] == 0
        for path, code in (("/nope", 404), ("/slo?bogus=1", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.url + path)
            assert e.value.code == code
            bodies[path] = (e.value.code, e.value.read().decode())
    with ns.server.ObsServer(registry=registry) as server:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url + "/slo")
        assert e.value.code == 404
        bodies["/slo without a run"] = (e.value.code, e.value.read().decode())
    return bodies


def test_obs_server_endpoints(tmp_path):
    """The same rows and metrics behind JAX's server and the port's: the
    same ``/metrics``, ``/healthz`` and ``/slo`` bodies (clock fields
    aside) and the same refusals."""
    got = {side: _server_endpoints(ns, str(tmp_path / side)) for side, ns in SIDES.items()}
    assert got["torch"] == got["jax"]


def _scrape_while_recording(ns):
    reg = ns.metrics.MetricsRegistry()
    h = reg.histogram("busy_s")
    stop = threading.Event()
    errors = []

    def record_loop():
        i = 0
        while not stop.is_set():
            h.record(10.0 ** ((i % 1200) / 100.0 - 6))
            i += 1

    t = threading.Thread(target=record_loop, daemon=True)
    t.start()
    try:
        with ns.server.ObsServer(registry=reg) as server:
            for _ in range(30):
                text = _get(server.url + "/metrics")[1]
                cums = [int(c) for _, c in re.findall(r'busy_s_bucket\{le="([^"}]+)"\} (\d+)', text)]
                count = int(re.search(r"busy_s_count (\d+)", text).group(1))
                if cums != sorted(cums) or (cums and cums[-1] != count):
                    errors.append(f"invariant broken: cums={cums[-3:]} count={count}")
                    break
    finally:
        stop.set()
        t.join(timeout=5)
    assert errors == [] and h.n > 0
    # the counts depend on the recorder's pace: after one more whole sweep
    # (every bucket filled), the exposition's lines without their values do not
    for i in range(1200):
        h.record(10.0 ** (i / 100.0 - 6))
    with ns.server.ObsServer(registry=reg) as server:
        return [line.rsplit(" ", 1)[0] for line in _get(server.url + "/metrics")[1].splitlines()]


def test_prometheus_scrape_concurrent_with_recording():
    got = {side: _scrape_while_recording(ns) for side, ns in SIDES.items()}
    assert got["torch"] == got["jax"]


# ------------------------------------------------------ the front end's feed


def frontend(models, side, tmp_path, *, label, config=None, injector=None, clock=None, engine=False):
    ns = SIDES[side]
    clock = clock or ns.serving.ManualClock()
    out = str(tmp_path / f"{label}_{side}")
    extra = {} if side == "jax" else {"device": "cpu"}
    if engine:
        extra["engine_config"] = ns.serving.EngineConfig(slots=4, page_size=4, max_ca_tokens=24,
                                                         max_sa_tokens=16, prefix_sharing=False)
    cls = ns.serving.EngineFrontEnd if engine else ns.serving.RequestFrontEnd
    fe = cls(*models[side], num_latents=4, config=config, events=ns.events.EventLog(out, main_process=True),
             clock=clock, sleep=clock.sleep, injector=injector, **extra)
    fe.out = out
    return fe


def test_nonfinite_logits_feed_the_breaker_sentinel_as_jax(models, tmp_path):
    """Poisoned weights for request 1 -> NaN logits through the decode ->
    ``nonfinite_logit_frac`` 1.0 on its row and stats -> the breaker opens
    through the ``nonfinite-logits`` sentinel -> the next admissions shed;
    as JAX's front end does."""
    got = {}
    for side in ("jax", "torch"):
        ns = SIDES[side]
        fe = frontend(models, side, tmp_path, label="poison", injector=ns.serving.FaultInjector().poison_at(1),
                      config=ns.serving.FrontEndConfig(probes=True))
        recs = fe.run_closed(spec_for(ns).draw(4, 50), concurrency=1)
        rows = ns.events.merged_events(fe.out)
        got[side] = ([(r.outcome, r.shed_reason) for r in recs], fe.breaker.state,
                     [e["reason"] for e in rows if e.get("event") == "serve.breaker"][:1],
                     [e.get("nonfinite_logit_frac") for e in rows if e.get("event") == "request"])
        assert fe.audit() == []
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ([("ok", None), ("ok", None), ("shed", "breaker_open"), ("shed", "breaker_open")],
                                "open", ["nonfinite-logits"])
    assert got["torch"][3][:2] == [0.0, 1.0]
    assert validate_events(str(tmp_path / "poison_torch"), warnings_out=[]) == []


def test_engine_front_end_takes_no_gauges_from_the_flag_as_jax(models, tmp_path):
    """``EngineFrontEnd(config=FrontEndConfig(probes=True))`` serves through
    its own paged step, as JAX's engine does: no health fields on its rows,
    nothing fed to the breaker."""
    got = {}
    for side in ("jax", "torch"):
        ns = SIDES[side]
        fe = frontend(models, side, tmp_path, label="engine", engine=True,
                      config=ns.serving.FrontEndConfig(probes=True))
        recs = fe.run_closed(spec_for(ns).draw(3, 50), concurrency=3)
        rows = [e for e in ns.events.merged_events(fe.out) if e.get("event") == "request"]
        got[side] = ([r.outcome for r in recs], fe.breaker.state,
                     sorted({k for r in rows for k in r if "entropy" in k or k in ("kv_cache_frac",
                                                                                 "nonfinite_logit_frac")}))
    assert got["torch"] == got["jax"] == (["ok"] * 3, "closed", [])


def test_obs_server_health_provider_and_slo_taxonomy(models, tmp_path):
    """``/healthz`` merges ``RequestFrontEnd.health`` (breaker state, books)
    and degrades on a raising provider; the SLO report of an overloaded open
    loop books shed and timeout rates over the admitted requests."""
    ns = SIDES["torch"]
    fe = frontend(models, "torch", tmp_path, label="health")
    fe.run_closed(spec_for(ns).draw(2, 50), concurrency=1)
    with ObsServer(registry=fe.registry, run_dir=fe.out, health=fe.health) as srv:
        h = json.loads(_get(srv.url + "/healthz")[1])
        assert h["status"] == "ok" and h["books_balanced"] is True and h["breaker"]["state"] == "closed"
        assert h["outcomes"]["ok"] == 2
        fe.breaker.record_sentinel("nonfinite-logits")
        assert json.loads(_get(srv.url + "/healthz")[1])["status"] == "shedding"

    def broken():
        raise RuntimeError("health backend down")

    with ObsServer(registry=fe.registry, health=broken) as srv:
        h = json.loads(_get(srv.url + "/healthz")[1])
        assert h["status"] == "ok" and "health backend down" in h["health_error"]

    clock = ns.serving.ManualClock()
    fe = frontend(models, "torch", tmp_path, label="taxonomy", clock=clock,
                  injector=ns.serving.FaultInjector(clock=clock).stall_at(None, 1, 0.1),
                  config=ns.serving.FrontEndConfig(max_queue=32, est_service_s=0.1))
    fe.run_open(spec_for(ns).draw(20, 50), rate_rps=50.0, deadline_s=0.5, seed=11)
    report = build_slo_report(merged_events(fe.out))
    b = fe.books()
    assert report["outcomes"].get("shed") == b["shed"] > 0 and report["n_admitted"] == b["admitted"]
    assert report["shed_rate"] == pytest.approx(b["shed"] / 20, abs=1e-6)
    if b["timeout"]:
        assert report["timeout_rate"] == pytest.approx(b["timeout"] / b["admitted"], abs=1e-6)
    assert report["n_latency_requests"] <= b["ok"] and fe.audit() == []


def test_healthz_scraped_while_the_front_end_serves(models, tmp_path):
    """``/healthz`` hammered over HTTP from another thread while the front
    end serves (``tests/test_serving.py``'s books hammer through the
    server): every scrape answers 200 with the books' fields, the terminal
    outcomes never exceed the submissions, and the books close balanced."""
    ns = SIDES["torch"]
    fe = frontend(models, "torch", tmp_path, label="hammer")
    bodies, stop = [], threading.Event()
    with ObsServer(registry=fe.registry, run_dir=fe.out, health=fe.health) as server:

        def scrape():
            while not stop.is_set():
                status, body, _ = _get(server.url + "/healthz")
                bodies.append((status, json.loads(body)))

        t = threading.Thread(target=scrape)
        t.start()
        try:
            fe.run_closed(spec_for(ns).draw(6, 50), concurrency=2)
        finally:
            stop.set()
            t.join()
    assert bodies and all(status == 200 and "books_balanced" in b for status, b in bodies)
    assert all(sum(b["outcomes"].values()) <= 6 for _, b in bodies)
    assert fe.books()["balanced"] and fe.audit() == []
