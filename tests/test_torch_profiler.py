"""The port's profiling utilities (``utils/profiling.py``) and the
per-scope rollup of a ``torch.profiler`` run (``obs/profiler.py``, the JAX
package's ``obs/xplane.py`` rollup) with its join to the host spans
(``obs/trace.py::host_device_breakdown``), on the CPU: the percentile
helpers and ``StepTimer`` equal JAX's on the same inputs; a CPU profiler run
under ``record_function`` scopes rolls up by scope (the host plane; the
port's train step, prefill, decode pair and paged engine step each open
their range); a Chrome trace with device kernels (written by hand: this
machine has no card) rolls up by the ranges their launches were issued in;
and the breakdown has JAX's shape for the same spans."""

import gzip
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perceiver_io_tpu.obs import trace as jax_trace
from perceiver_io_tpu.obs import xplane as jax_xplane
from perceiver_io_tpu.utils import profiling as jax_profiling
from perceiver_io_tpu_torch import generation as tg
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs import profiler as P
from perceiver_io_tpu_torch.obs.trace import host_device_breakdown
from perceiver_io_tpu_torch.utils import profiling

CFG = dict(vocab_size=50, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
           num_self_attention_layers=2, cross_attention_dropout=0.5)


# ---------------------------------------------------------------------------
# percentiles and the step timer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4, 5, 17])
def test_percentiles_and_latency_summary_equal_jax(n):
    vals = list(np.random.default_rng(n).exponential(0.01, size=n))
    for p in (0, 1, 50, 90, 99, 100):
        assert profiling.percentile(vals, p) == jax_profiling.percentile(vals, p)
        assert profiling.exact_percentile(vals, p) == jax_profiling.exact_percentile(vals, p)
    assert profiling.summarize_latencies(vals) == jax_profiling.summarize_latencies(vals)
    assert ("low_n" in profiling.summarize_latencies(vals)) == (n < profiling.LOW_N == jax_profiling.LOW_N)
    for bad in ([], ):
        with pytest.raises(ValueError):
            profiling.percentile(bad, 50)
    with pytest.raises(ValueError):
        profiling.percentile(vals, 101)


def test_step_timer_equals_jax(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.5, 1.625, 2.0, 3.0]

    def timer(module):
        clock = iter(ticks)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        t = module.StepTimer(warmup=1)
        t.start()
        for _ in ticks[1:]:
            t.tick()
        return t

    ours, theirs = timer(profiling), timer(jax_profiling)
    assert ours.steps == theirs.steps == [0.25, 0.75, 0.125, 0.375, 1.0]
    assert ours.summary() == theirs.summary()
    assert ours.mean() == theirs.mean() and ours.steps_per_sec() == theirs.steps_per_sec()
    assert ours.percentile(90) == theirs.percentile(90)
    with pytest.raises(ValueError):
        profiling.StepTimer(warmup=5).mean()


# ---------------------------------------------------------------------------
# the rollup
# ---------------------------------------------------------------------------


def test_scope_of_matches_jax_for_scope_paths():
    for name, depth in (("a/b/k", None), ("a/b/c/k", 2), ("k", None), ("decode_paged/paged_walk", 1)):
        assert P.scope_of(name, depth) == jax_xplane.scope_of(name, depth)
    assert P.scope_of("k") == P.UNSCOPED == jax_xplane.UNSCOPED


def test_cpu_profile_rolls_up_by_record_function_scope(tmp_path):
    """Nested ranges become ``outer/inner`` scopes; every outermost operator
    lands in exactly one scope, so the plane's total is the scopes' sum; the
    exported trace (``utils.profiling.trace``) rolls up as the live run."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiling.trace(str(tmp_path), cuda=False) as prof:
        with record_function("outer"):
            torch.mm(a, b)
            with record_function("inner"):
                torch.relu(a)
        torch.add(a, b)
    live, exported = P.rollup(prof), P.rollup(str(tmp_path / "trace.json"))
    assert [r.plane for r in live] == [P.HOST_PLANE] == [r.plane for r in exported]
    host = live[0]
    assert {"outer", "outer/inner", P.UNSCOPED} <= set(host.scopes)
    assert host.total_ps == sum(d for d, _ in host.scopes.values()) == sum(d for d, _ in host.ops.values())
    assert any(op.startswith("outer/inner/aten::relu") for op in host.ops)
    assert P.rollup(prof, depth=1)[0].scopes.keys() >= {"outer"}
    assert "outer/inner" not in P.rollup(prof, depth=1)[0].scopes
    assert exported[0].scopes.keys() == host.scopes.keys()
    lines = []
    P.summarize(prof, by_scope=True, print_fn=lines.append)
    assert any("outer/inner" in line for line in lines)


def test_the_port_opens_its_step_and_decode_scopes():
    """The train step (``train_step``), the prefill (``prefill``), the decode
    pair's step (``decode``) and the engine's paged step (``decode_paged``)
    each run under their range; no range opens inside a layer."""
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    model = CausalLanguageModel(CausalLanguageModelConfig(**CFG), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    t = rng.integers(0, 50, size=(2, 25))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 16, 0.5)}
    state = tt.TrainState.create(model, tt.make_optimizer(1e-3))
    step = tt.make_train_step(tt.clm_loss_fn(8))
    prefill, decode = tg.make_decode_fns(model, 4, tg.GenerationConfig(max_new_tokens=3), device="cpu")
    engine = EngineFrontEnd(model, num_latents=4, engine_config=EngineConfig(slots=2, page_size=4, max_ca_tokens=24,
                                                                             max_sa_tokens=16), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
        _, st = prefill(t[:1, :12])
        decode(st)
        engine.run_closed([RequestSpec(0, 10, 3, t[:1, :10], 1)], concurrency=1)
    scopes = P.rollup(prof)[0].scopes
    for name in ("train_step", "prefill", "decode", "decode_paged"):
        assert scopes.get(name, (0, 0))[1] > 0, (name, sorted(scopes))
    assert all(s.split("/")[0] in ("train_step", "prefill", "decode", "decode_paged", P.UNSCOPED) for s in scopes)


def test_scopes_open_only_while_a_profiler_records(monkeypatch):
    """With no profiler running, the train step, the decode pair and the
    paged engine step open no ``record_function`` range; under a profiler
    each opens its own."""
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    opened = []
    real = P.record_function
    monkeypatch.setattr(P, "record_function", lambda name: opened.append(name) or real(name))
    model = CausalLanguageModel(CausalLanguageModelConfig(**CFG), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    t = rng.integers(0, 50, size=(2, 25))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 16, 0.5)}
    state = tt.TrainState.create(model, tt.make_optimizer(1e-3))
    step = tt.make_train_step(tt.clm_loss_fn(8))
    prefill, decode = tg.make_decode_fns(model, 4, tg.GenerationConfig(max_new_tokens=3), device="cpu")
    engine = EngineFrontEnd(model, num_latents=4, engine_config=EngineConfig(slots=2, page_size=4, max_ca_tokens=24,
                                                                             max_sa_tokens=16), device="cpu")

    def drive():
        step(state, batch)
        _, st = prefill(t[:1, :12])
        decode(st)
        engine.run_closed([RequestSpec(0, 10, 3, t[:1, :10], 1)], concurrency=1)

    drive()
    assert opened == [] and P.scope("x") is P.scope("y")
    with profile(activities=[ProfilerActivity.CPU]):
        drive()
    assert {"train_step", "prefill", "decode", "decode_paged"} <= set(opened)


def _synthetic_trace():
    """A trace as a card's run exports it: a host range around a CUDA graph
    launch (``decode_paged``) and around an eager step's kernel launches
    (``train_step`` with a nested ``prefill``), the kernels correlated to
    their launches, a launch from a thread with no range (autograd's), one
    kernel whose launch the trace lacks (the GPU-side range places it), one
    placed by nothing, a memcpy."""
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": args})

    x("user_annotation", "decode_paged", 0, 100)
    x("cuda_runtime", "cudaGraphLaunch", 10, 5, correlation=5)
    x("kernel", "void paged_walk_kernel<1>(Params)", 200, 30, tid=7, device=0, correlation=5)
    x("kernel", "void paged_merge_kernel<1>(Params)", 230, 10, tid=7, device=0, correlation=5)
    x("user_annotation", "train_step", 1000, 500)
    x("user_annotation", "prefill", 1100, 100)
    x("cuda_runtime", "cudaLaunchKernel", 1120, 3, correlation=9)
    x("kernel", "flash_packed_kernel<F32, 64>", 1300, 50, tid=7, device=0, correlation=9)
    x("cuda_runtime", "cuLaunchKernel", 1150, 3, correlation=10)
    x("kernel", "_layer_norm_fwd_kernel", 1360, 20, tid=7, device=0, correlation=10)
    x("gpu_user_annotation", "train_step", 1600, 200, tid=7, device=0)
    x("kernel", "flash_bwd_dq_kernel<64>", 1650, 40, tid=7, device=0, correlation=99)
    x("kernel", "stray", 5000, 1, tid=7, device=0)
    x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1400, 5, tid=8, device=0, correlation=10)
    x("cuda_runtime", "cudaLaunchKernel", 1300, 2, tid=3, correlation=11)  # autograd's thread, no range of its own
    x("kernel", "flash_bwd_dkv_kernel<64>", 1420, 10, tid=7, device=0, correlation=11)
    x("cpu_op", "aten::mm", 1130, 20)
    x("cpu_op", "aten::addmm", 1135, 5)  # inside aten::mm: counted with it
    return {"traceEvents": ev}


def test_device_kernels_roll_up_by_the_ranges_of_their_launches(tmp_path):
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(_synthetic_trace(), f)
    planes = {r.plane: r for r in P.rollup(str(path))}
    assert sorted(planes) == ["/device:GPU:0", P.HOST_PLANE]
    gpu = planes["/device:GPU:0"]
    assert gpu.scopes == {
        "decode_paged": (40_000_000, 2),  # a graph replay's kernels under the replay's scope
        "train_step/prefill": (75_000_000, 3),  # K2, K1 and a copy, launched inside both ranges
        "train_step": (50_000_000, 2),  # another thread's launch, and one placed by the GPU-side range
        P.UNSCOPED: (1_000_000, 1),
    }
    assert gpu.total_ps == 166_000_000
    assert gpu.ops["decode_paged/void paged_walk_kernel<1>(Params)"] == (30_000_000, 1)
    assert [s for s, _, _ in gpu.top(2)] == ["train_step/prefill", "train_step"]
    assert P.rollup(str(path), depth=1)[0].scopes["train_step"] == (125_000_000, 5)
    assert planes[P.HOST_PLANE].scopes == {"train_step/prefill": (20_000_000, 1)}


def test_host_device_breakdown_has_jax_shape_for_the_same_spans():
    spans = [{"event": "span", "name": "step", "dur_ms": d, "attrs": {"input_wait_ms": 0.5, "dispatch_ms": 1.5}}
             for d in (10.0, 12.0, 11.0, 30.0, 10.5)]
    spans += [{"event": "span", "name": "eval", "dur_ms": 7.0}, {"event": "span", "name": "checkpoint",
                                                                 "dur_ms": 3.0}]
    scopes = {"train_step": (4_000_000_000, 40), "train_step/prefill": (1_000_000_000, 9), "<unscoped>": (5, 1)}
    ours = [P.ScopeRollup(plane="/device:GPU:0", scopes=scopes), P.ScopeRollup(plane=P.HOST_PLANE,
                                                                               scopes={"x": (7, 1)})]
    theirs = [jax_xplane.ScopeRollup(plane="/device:TPU:0", scopes=scopes),
              jax_xplane.ScopeRollup(plane="/host:CPU", scopes={"x": (7, 1)})]
    got, want = host_device_breakdown(spans, ours), jax_trace.host_device_breakdown(spans, theirs)
    assert got == want
    assert got["device"]["per_step_ms"] == pytest.approx(1.0)
    assert host_device_breakdown(spans) == jax_trace.host_device_breakdown(spans)
    cpu_only = host_device_breakdown(spans, [ours[1]])  # a CPU capture: the host plane stands in
    assert cpu_only["device"]["top_scopes"] == [{"scope": "x", "ms": 7e-9}]
    assert math.isclose(got["step_ms"]["p50"], 11.0)
