#!/usr/bin/env python3
"""Times K4a's f32 build (``bwd_dkv_cuda``, the packed flash backward's
dK/dV) of the port in the checkout at ROOT, so that two commits' K4a can be
compared in one call on one card.

Usage, on a machine with an NVIDIA card and ``nvcc``:
``python3 tools/flash_bwd_dkv_time.py [ROOT ...]`` (ROOT defaults to this
checkout; several roots are timed in the order given, each in a process of
its own, after building its kernels). For each ROOT and each shape (the
CLM's training cross-attention, 1024 latents over 7680 + 1024 keys, 8 heads
of 64, batch 2; the image classifier's self-attention, 512², 8 × 128,
batch 16; the symbolic audio model's cross-attention, 2048 over 4096, 8 ×
96, batch 2; MNIST's decoder, one query over 32 latents, 1 × 128, batch 64)
prints one JSON line: the card's time of a call from cold L2
(``chip_smoke.time_ms``, median of 10) and the largest distance of dK and dV
from the plain backward evaluated in f64, beside the f32 plain version's.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {  # batch, nq, nkv, heads, channels, causal
    "clm_ca": (2, 1024, 8704, 8, 512, True),
    "image_sa": (16, 512, 512, 8, 1024, False),
    "sam_ca": (2, 2048, 4096, 8, 768, True),
    "mnist_dec": (64, 1, 32, 1, 128, False),
}


def time_root(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from perceiver_io_tpu_torch.ops import build
    from perceiver_io_tpu_torch.ops.flash_attention import (
        bias_row,
        bwd_delta,
        bwd_dkv_cuda,
        flash_attention_packed,
        flash_attention_packed_bwd_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    gen = torch.Generator().manual_seed(0)
    for name, (b, nq, nkv, h, c, causal) in SHAPES.items():
        d = c // h
        q = (torch.randn(b, nq, c, generator=gen) * d**-0.5).cuda()
        k, v, do = (torch.randn(b, n, c, generator=gen).cuda() for n in (nkv, nkv, nq))
        o, lse = flash_attention_packed(q, k, v, h, causal=causal, return_lse=True)
        args = (q, k, v, do, lse, bwd_delta(o, do, h), h, bias_row(None, b, nkv, q.device), causal, 1.0)
        dk, dv = bwd_dkv_cuda(*args)
        _, edk, edv = cs.by_batch(lambda lo, hi: flash_attention_packed_bwd_reference(
            *(t[lo:hi].double() for t in (q, k, v, o, lse, do)), h, causal=causal), b)
        _, rdk, rdv = flash_attention_packed_bwd_reference(q, k, v, o, lse, do, h, causal=causal)
        err = max(cs.max_err64(dk, edk), cs.max_err64(dv, edv))
        plain = max(cs.max_err64(rdk, edk), cs.max_err64(rdv, edv))
        ms = cs.time_ms(lambda: bwd_dkv_cuda(*args))
        print(json.dumps(dict(root=root, shape=name, ms=ms, err_f64=err, f32_plain_err_f64=plain)), flush=True)
        del q, k, v, do, o, lse, args, dk, dv, edk, edv, rdk, rdv
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
