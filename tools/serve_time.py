#!/usr/bin/env python3
"""Times the flagship serve of the port in the checkout at ROOT, so that two
commits' engines can be compared in one call on one card.

Usage, on a machine with an NVIDIA card and ``nvcc``:
``python3 tools/serve_time.py [ROOT ...]`` (ROOT defaults to this checkout;
several roots are timed in the order given, each in a process of its own,
which builds the kernels of that root). For each ROOT and each of ``serve``'s
and ``serve_bf16``'s configurations (the flagship CLM with seeded random
weights, f32, and bf16 compute over bf16 pools) it builds the engine with
ROOT's own ``chip_smoke.serve_engine`` (its decode step the captured CUDA
graph), serves ``chip_smoke.serve_specs()`` once to warm up and then
``REPEATS`` times closed-loop (``chip_smoke.serve_run``), and prints one JSON
line: every run's decode tok/s and wall seconds, and their medians. Then the
decode pair of ``chip_smoke.decode_pair_phase``'s bf16 batch-1 run
(``make_decode_fns``, an 8192-token prompt, greedy): after one prefill and
the capturing step of a fresh pair, ``PAIR_STEPS`` timed replays; ``REPEATS``
such runs, printed the same way.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPEATS = 5
PAIR_STEPS = 126


def time_root(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = CausalLanguageModel(CausalLanguageModelConfig(**cs.FLAGSHIP), device="cuda", dtype=dtype,
                                    generator=torch.Generator().manual_seed(cs.SEED))
        engine, _ = cs.serve_engine(model, graphed=True, cache_dtype=None if dtype == torch.float32 else dtype)
        cs.serve_run(engine, cs.serve_specs())  # warm-up
        runs = [cs.serve_run(engine, cs.serve_specs()) for _ in range(REPEATS)]
        tok_s = [r["decode_tok_s"] for r in runs]
        print(json.dumps(dict(root=root, dtype=str(dtype)[6:], decode_tok_s=tok_s,
                              median_decode_tok_s=statistics.median(tok_s),
                              wall_s=[r["wall_s"] for r in runs], steps=runs[0]["steps"])), flush=True)
        del engine, model
        cs.free_card()
    time_pair(root, cs)


def time_pair(root: str, cs) -> None:
    import time

    import numpy as np
    import torch

    from perceiver_io_tpu_torch import generation
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**cs.FLAGSHIP), device="cuda", dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(cs.SEED))
    ids = np.random.default_rng(cs.SEED + 4).integers(0, cs.FLAGSHIP["vocab_size"], size=(1, cs.DECODE_PROMPT))
    config = generation.GenerationConfig(max_new_tokens=PAIR_STEPS + 2)
    tok_s = []
    for _ in range(REPEATS):  # a pair's step is captured on its first state: a pair a run
        prefill, step = generation.make_decode_fns(model, cs.NUM_LATENTS, config, torch.float32, device="cuda")
        _, state = prefill(ids, None)
        state, _ = step(state)  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAIR_STEPS):
            state, _ = step(state)
        torch.cuda.synchronize()
        tok_s.append(PAIR_STEPS / (time.perf_counter() - t0))
        del prefill, step, state
    print(json.dumps(dict(root=root, dtype="bfloat16", phase="decode_pair batch1", decode_tok_s=tok_s,
                          median_decode_tok_s=statistics.median(tok_s))), flush=True)
    del model
    cs.free_card()


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        return time_root(sys.argv[2])
    roots = sys.argv[1:] or [HERE]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)


if __name__ == "__main__":
    main()
