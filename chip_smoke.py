#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one NVIDIA card.

Usage, from the root of a checkout: ``python3 chip_smoke.py`` (one card).

Phases, each fatal on failure (nothing is caught to keep the exit code 0):

1. device: the card's name and power limit as ``nvidia-smi`` reports them;
2. build: every CUDA kernel of the serving path is compiled from the sources
   in ``perceiver_io_tpu_torch/ops/csrc`` (one ``nvcc`` per source, all at
   once; the Triton kernel compiles at its first launch);
3. kernel parity: each kernel against its plain PyTorch version on the card
   at the flagship's shapes, with the tolerance stated beside each case, and
   its median time beside the plain version's, the PyTorch library call's
   where one computes the same function, and the least time the card could
   take (``bound_ms``);
4. serve: the flagship-width Perceiver AR CLM (seeded random weights)
   answers six greedy requests through ``EngineFrontEnd``; every served
   stream must equal the sequential ``make_decode_fns`` stream up to the
   first step where the sequential logits' top-2 gap is a near tie (the
   paged and contiguous decodes sum in different orders); the page
   allocators must end empty, and every kernel of the path must have
   launched during the serve.

The last two lines of standard output are the ``kernels`` JSON line and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, the script exits non-zero and prints
no result. Parity phases run with TF32 off for matrix products.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(
    vocab_size=262, max_seq_len=16384, max_latents=1024, num_channels=512, num_heads=8,
    num_self_attention_layers=8, cross_attention_dropout=0.5,
)
NUM_LATENTS = 512
N_REQUESTS = 6
NEAR_TIE = 1e-4
# peak rates of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 without tensor cores; bf16 tensor


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10) -> float:
    """Median of per-launch CUDA-event times, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    status = "ok" if err <= tol else "FAIL"
    log(f"parity {name}: max_abs_err={err:.3e} tol={tol:.1e} {status}")
    if err > tol:
        raise SystemExit(f"kernel parity failed: {name} max_abs_err {err} > {tol}")


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------


def flash_phase(gen: torch.Generator) -> dict:
    from torch.nn.functional import scaled_dot_product_attention

    from perceiver_io_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_packed_reference,
    )

    h, c = FLAGSHIP["num_heads"], FLAGSHIP["num_channels"]
    d = c // h
    cases = {  # name: (nq, nkv, dtype, left pads, tolerance)
        "ca_f32": (512, 16384, torch.float32, 0, 1e-5),
        "sa_f32": (512, 512, torch.float32, 0, 1e-5),
        "ca_bf16": (512, 16384, torch.bfloat16, 0, 5e-4),
        "ca_f32_leftpad": (512, 16384, torch.float32, 3001, 1e-5),
    }
    out = {"cases": []}
    for name, (nq, nkv, dtype, pads, tol) in cases.items():
        q = (torch.randn(1, nq, c, generator=gen) * d**-0.5).cuda().to(dtype)
        k = torch.randn(1, nkv, c, generator=gen).cuda().to(dtype)
        v = torch.randn(1, nkv, c, generator=gen).cuda().to(dtype)
        pad = None
        if pads:
            pad = torch.zeros(1, nkv, dtype=torch.bool, device="cuda")
            pad[:, :pads] = True
        o, lse = flash_attention_packed(q, k, v, h, pad_mask=pad, causal=True, return_lse=True)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=True)
        err = max_err(o, ro)
        check(f"flash_packed_fwd {name} out", err, tol)
        check(f"flash_packed_fwd {name} lse", max_err(lse, rlse), 1e-4)
        ms = time_ms(lambda: flash_attention_packed(q, k, v, h, pad_mask=pad, causal=True))
        plain_ms = time_ms(lambda: flash_attention_packed_reference(q, k, v, h, pad_mask=pad, causal=True), 3)
        # the library yardstick: one SDPA call on heads-major views with the
        # same right-aligned causal + pad mask
        qh, kh, vh = (t.reshape(1, -1, h, d).transpose(1, 2) for t in (q, k, v))
        i = torch.arange(nq, device="cuda")[:, None]
        j = torch.arange(nkv, device="cuda")[None, :]
        keep = (j <= i + (nkv - nq))[None, None]
        if pad is not None:
            keep = keep & ~pad[:, None, None, :]
        library_ms = time_ms(lambda: scaled_dot_product_attention(qh, kh, vh, attn_mask=keep))
        el = torch.finfo(dtype).bits // 8
        visible = sum(min(nkv, ii + nkv - nq + 1) for ii in range(nq))
        n_bytes = el * (2 * nq * c + 2 * nkv * c) + 4 * nq * h + (4 * nkv if pads else 0)
        bound_ms, bound_by = bound(n_bytes, 4 * d * h * visible, dtype)
        row = dict(case=name, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"time flash_packed_fwd {name}: {json.dumps(row)}")
        out["cases"].append(row)
    return out


def paged_phase(gen: torch.Generator) -> dict:
    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops.paged_attention import (
        paged_attention_reference,
        paged_decode_attention,
    )

    h, c = FLAGSHIP["num_heads"], FLAGSHIP["num_channels"]
    d = c // h
    slots, page, pps = 4, 16, FLAGSHIP["max_seq_len"] // 16
    num_pages = slots * pps + 1
    cache = init_paged_kv_cache(slots, num_pages, page, pps, c, c, device="cuda")
    cache.k.copy_(torch.randn(num_pages, page, c, generator=gen))
    cache.v.copy_(torch.randn(num_pages, page, c, generator=gen))
    # each slot owns a random permutation of disjoint pages
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).reshape(slots, pps)
    cache.page_table = perm.to(torch.int32).cuda()
    lengths = [1, 2085, 9000, 16320]
    cache.length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qh = (torch.randn(slots, h, d, generator=gen) * d**-0.5).cuda()
    # the engine always passes a pad/window mask: left pads in slot 2,
    # expired window slots in slot 3; every slot keeps a real key
    mask = torch.zeros(slots, cache.capacity, dtype=torch.bool, device="cuda")
    mask[2, :300] = True
    mask[3, :40] = True
    tol = 1e-5
    tokens = sum(lengths)
    pages_read = sum(-(-n // page) for n in lengths)
    rows = []
    for name, m in (("pad_window_mask", mask), ("validity_only", None)):
        o = paged_decode_attention(qh, cache, m)
        torch.cuda.synchronize()
        err = max_err(o, paged_attention_reference(qh, cache, m))
        check(f"paged_decode {name}", err, tol)
        ms = time_ms(lambda: paged_decode_attention(qh, cache, m))
        plain_ms = time_ms(lambda: paged_attention_reference(qh, cache, m), 3)
        # f32 K/V rows of the valid tokens, q and out, int32 table entries
        # walked and lengths; under a mask, its bool entries of those tokens
        n_bytes = 4 * (2 * tokens * c + 2 * slots * c + pages_read + slots) + (tokens if m is not None else 0)
        bound_ms, bound_by = bound(n_bytes, 4 * d * h * tokens, torch.float32)
        row = dict(case=f"{name} slots={slots} page={page} lengths={lengths}", max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        log(f"time paged_decode {name}: {json.dumps(row)}")
        rows.append(row)
    return {"cases": rows}


def layernorm_phase(gen: torch.Generator) -> dict:
    from torch.nn.functional import layer_norm as torch_layer_norm

    from perceiver_io_tpu_torch.ops.layernorm import layer_norm, layer_norm_reference

    rows, c = FLAGSHIP["max_seq_len"], FLAGSHIP["num_channels"]
    x = (torch.randn(rows, c, generator=gen) * 2 + 0.5).cuda()
    w = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
    b = (0.1 * torch.randn(c, generator=gen)).cuda()
    y = layer_norm(x, w, b)
    torch.cuda.synchronize()
    tol = 1e-5
    err = max_err(y, layer_norm_reference(x, w, b))
    check("layer_norm_fwd f32", err, tol)
    ms = time_ms(lambda: layer_norm(x, w, b), 20)
    plain_ms = time_ms(lambda: layer_norm_reference(x, w, b), 20)
    library_ms = time_ms(lambda: torch_layer_norm(x, (c,), w, b, 1e-5), 20)
    bound_ms, bound_by = bound(4 * (2 * rows * c + 2 * c), 8 * rows * c, torch.float32)
    row = dict(case=f"rows={rows} C={c} f32", max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"time layer_norm_fwd: {json.dumps(row)}")
    return {"cases": [row]}


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


class _LogitRecorder:
    """Forwards to the model and keeps each call's last-position logits (the
    sequential path's near-tie check reads them)."""

    def __init__(self, model):
        self.model, self.config, self.device = model, model.config, model.device
        self.logits = []

    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        self.logits.append(out.logits[0, -1].float())
        return out


def serve_phase(card: str) -> dict:
    from perceiver_io_tpu_torch.generation import GenerationConfig, make_decode_fns
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    config = CausalLanguageModelConfig(**FLAGSHIP)
    model = CausalLanguageModel(config, device="cuda", generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: flagship CLM {FLAGSHIP}, {n_params} parameters, f32")
    rng = np.random.default_rng(SEED)
    specs = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(2048, 16257))
        specs.append(RequestSpec(
            index=i, prompt_len=n, max_new_tokens=int(rng.integers(32, 65)),
            input_ids=rng.integers(0, config.vocab_size, size=(1, n)), rng_seed=int(rng.integers(1 << 30)),
        ))
    engine = EngineFrontEnd(
        model, num_latents=NUM_LATENTS, base_config=GenerationConfig(),
        engine_config=EngineConfig(slots=4, page_size=16, max_ca_tokens=16384, max_sa_tokens=1024),
        device="cuda",
    )
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records = engine.run_closed(specs, concurrency=N_REQUESTS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"serve launches: {json.dumps(launches)}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the serving path: {missing}")
    books = engine.books()
    if not books["balanced"] or books["ok"] != N_REQUESTS:
        raise SystemExit(f"engine books wrong: {books}")
    used = (engine.ca_alloc.pages_used, engine.sa_alloc.pages_used)
    problems = engine.ca_alloc.audit() + engine.sa_alloc.audit()
    if used != (0, 0) or problems:
        raise SystemExit(f"page allocators not returned: used={used} problems={problems}")
    prefill_s = sum(r.ttft_s for r in records)
    decoded = sum(len(engine.served_tokens[r.index]) - 1 for r in records)
    decode_tok_s = decoded / (wall_s - prefill_s)
    for r in records:
        log(f"ttft request={r.index} prompt_len={r.prompt_len} ttft_ms={1e3 * r.ttft_s:.3f} card={card}")
    log(f"serve: {N_REQUESTS} requests, {decoded} decoded tokens, wall_s={wall_s:.3f}, "
        f"prefill_s={prefill_s:.3f}, decode_tok_s={decode_tok_s:.1f}, "
        f"mean_batch_fill={engine.mean_batch_fill:.3f}, card={card}")

    # the sequential reference, token by token with its logits
    for spec in specs:
        rec = _LogitRecorder(model)
        prefill, step = make_decode_fns(rec, NUM_LATENTS, GenerationConfig(max_new_tokens=spec.max_new_tokens),
                                        device="cuda")
        token, state = prefill(spec.input_ids)
        want = [int(token[0])]
        for _ in range(spec.max_new_tokens - 1):
            state, token = step(state)
            want.append(int(token[0]))
        got = engine.served_tokens[spec.index]
        logits = torch.stack(rec.logits)
        if not bool(torch.isfinite(logits).all()) or logits.shape != (spec.max_new_tokens, config.vocab_size):
            raise SystemExit(f"request {spec.index}: sequential logits not finite or of the wrong shape")
        top2 = torch.topk(logits, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        tie = next((t for t, g in enumerate(gaps) if g < NEAR_TIE), len(gaps))
        first_diff = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if len(got) != len(want) or (first_diff is not None and first_diff < tie):
            raise SystemExit(f"request {spec.index}: engine stream diverges at step {first_diff} before the "
                             f"first near tie at step {tie}: engine {got} sequential {want}")
        note = "identical" if first_diff is None else f"diverges at step {first_diff}, after the near tie at {tie}"
        log(f"stream request={spec.index} tokens={len(got)} min_top2_gap={min(gaps):.3e} {note}")
    profile_phase(model, card)
    return launches


def profile_phase(model, card: str) -> None:
    """Where a serve's time goes: four 4096-token requests with 24-token
    budgets through a fresh engine under ``torch.profiler``; prints the
    device-busy share of the wall time and the top operators by device and by
    host time. The profiler's own host cost inflates the wall time, so the
    busy share it shows is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perceiver_io_tpu_torch.generation import GenerationConfig
    from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

    rng = np.random.default_rng(SEED + 1)
    specs = [RequestSpec(i, 4096, 24, rng.integers(0, FLAGSHIP["vocab_size"], size=(1, 4096)), i)
             for i in range(4)]
    engine = EngineFrontEnd(
        model, num_latents=NUM_LATENTS, base_config=GenerationConfig(),
        engine_config=EngineConfig(slots=4, page_size=16, max_ca_tokens=16384, max_sa_tokens=1024),
        device="cuda",
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        records = engine.run_closed(specs, concurrency=4)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: an operator's entry repeats the time of the kernels it launched
    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = 1e-3 * sum(device_us(e) for e in kernels)
    by_device = sorted(kernels, key=device_us, reverse=True)[:10]
    by_host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
    log("profile: " + json.dumps({
        "card": card, "requests": len(specs), "prompt_len": 4096, "max_new_tokens": 24,
        "wall_ms": wall_ms, "prefill_ms": 1e3 * sum(r.ttft_s for r in records),
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_device_ms": [[e.key[:80], e.count, 1e-3 * device_us(e)] for e in by_device],
        "top_host_ms": [[e.key, e.count, 1e-3 * e.self_cpu_time_total] for e in by_host],
    }))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from perceiver_io_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0].split(',')[-1].strip()} limit)"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {card}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {sorted(build.CUDA_SOURCES)} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(SEED)
    results = {
        "flash_packed_fwd": ("cuda", "perceiver_io_tpu_torch/ops/csrc/flash_packed.cu",
                             "perceiver_io_tpu/ops/flash_attention.py:606", flash_phase(gen)),
        "paged_decode": ("cuda", "perceiver_io_tpu_torch/ops/csrc/paged_decode.cu",
                         "perceiver_io_tpu/ops/paged_attention.py:62", paged_phase(gen)),
        "layer_norm_fwd": ("triton", "perceiver_io_tpu_torch/ops/layernorm_triton.py",
                           "perceiver_io_tpu/ops/layernorm.py:94", layernorm_phase(gen)),
    }
    launches = serve_phase(card)

    kernels = []
    for name, (route, source, replaces, res) in results.items():
        main_case = res["cases"][0]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces, launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in res["cases"] if c["tol"] == main_case["tol"]),
            tol=main_case["tol"], ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], shape=main_case["case"], card=card, cases=res["cases"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
