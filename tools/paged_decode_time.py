#!/usr/bin/env python3
"""Times the public ``paged_decode_attention`` (K3) of the port in the
checkout at ROOT, so that two commits' K3 can be compared in one process
on one card.

Usage, on a machine with an NVIDIA card and ``nvcc``:
``python3 tools/paged_decode_time.py [ROOT ...]`` (ROOT defaults to this
checkout; several roots are timed in the order given, each in a process of
its own). For each ROOT and each of the flagship serve's two pool geometries
(the CA pool: 4 slots of 16384 tokens in pages of 16, lengths
1/2085/9000/16320; a latent SA pool: 4 slots of 1024, lengths
513/600/777/1024; each with the engine's pad/window mask, as
``chip_smoke.py``'s K3 cases) prints one JSON line: the card's time of a call
from cold L2 and the host's time of a call (``chip_smoke.time_ms``, median
of 10), the host's time of a call under ``torch.profiler`` (CPU and CUDA
activities, as ``chip_smoke.py``'s profiled serve), and the error against
the plain version.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H, C, PAGE, SLOTS = 8, 512, 16, 4
POOLS = {  # tokens a slot, lengths, {slot: leading masked tokens}
    "ca": (16384, [1, 2085, 9000, 16320], {2: 300, 3: 40}),
    "sa": (1024, [513, 600, 777, 1024], {0: 1, 1: 88, 2: 265, 3: 512}),
}


def time_root(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from perceiver_io_tpu_torch.core.cache import init_paged_kv_cache
    from perceiver_io_tpu_torch.ops.paged_attention import paged_attention_reference, paged_decode_attention

    gen = torch.Generator().manual_seed(0)
    for name, (tokens, lengths, masked) in POOLS.items():
        pps = tokens // PAGE
        n = SLOTS * pps + 1
        cache = init_paged_kv_cache(SLOTS, n, PAGE, pps, C, C, device="cuda")
        cache.k.copy_(torch.randn(n, PAGE, C, generator=gen))
        cache.v.copy_(torch.randn(n, PAGE, C, generator=gen))
        cache.page_table = (torch.randperm(n - 1, generator=gen) + 1).reshape(SLOTS, pps).to(torch.int32).cuda()
        cache.length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        qh = (torch.randn(SLOTS, H, C // H, generator=gen) * (C // H) ** -0.5).cuda()
        mask = torch.zeros(SLOTS, cache.capacity, dtype=torch.bool, device="cuda")
        for s, k in masked.items():
            mask[s, :k] = True
        run = lambda: paged_decode_attention(qh, cache, mask)  # noqa: E731
        err = cs.max_err(run(), paged_attention_reference(qh, cache, mask))
        ms = cs.time_ms(run, dispatch=name)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            cs.time_ms(run, dispatch=f"{name} profiled")
        print(json.dumps(dict(root=root, pool=name, max_abs_err=err, ms=ms, host_ms=cs.DISPATCH_MS[name],
                              profiled_host_ms=cs.DISPATCH_MS[f"{name} profiled"])), flush=True)


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
