#!/usr/bin/env python3
"""Times design variants of the port's split-TF32 flash forward (K2,
``perceiver_io_tpu_torch/ops/csrc/flash_packed.cu`` over
``flash_mma.cuh``) against the shipped kernel, in one process on one card.

Usage, from the root of a checkout on a machine with an NVIDIA card and
``nvcc``: ``PYTHONPATH=. python3 tools/flash_tf32_variants.py``.

Each variant is the shipped sources with one textual change to
``flash_mma.cuh``, built with the port's own nvcc flags into
``build/flash_tf32_variants/<name>/`` and launched through the port's wrapper
(``flash_attention_packed``) at the main path's three shapes: the image
classifier's self-attention (batch 16, 512 x 512, 8 heads of 128), the CLM's
training cross-attention (batch 2, 1024 over 8704 keys, 8 heads of 64,
causal) and the serving prefill (batch 1, 512 over 16384 keys, causal).
Every variant's output is held to the plain version (1e-5) and timed with
``chip_smoke.time_ms`` (L2 flushed, the card kept busy), twice, in turns.
Prints one JSON line per variant and shape, then a summary line.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from perceiver_io_tpu_torch.ops import build  # noqa: E402

SRC = "perceiver_io_tpu_torch/ops/csrc"
OUT = "build/flash_tf32_variants"
SMALL = "  small = __float_as_uint(x - __uint_as_float(big));"
BIG = "  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
BKV = "  static constexpr int BKV = DMAX <= 64 ? 64 : 32;"
QP = "  static constexpr int QP = DMAX <= 64 ? 2 : 1;"
CVT = '''  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float d = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(d));'''
VARIANTS = {
    "shipped": {},
    # the residual rounded to nearest as well (NaN kept: its rounding could
    # carry a NaN into the sign bit)
    "small_rounded": {SMALL: "  const float d = x - __uint_as_float(big);\n"
                             "  small = d == d ? (__float_as_uint(d) + 0x1000u) & 0xFFFFE000u : __float_as_uint(d);"},
    # both parts by PTX's cvt.rna.tf32.f32
    "cvt_rna": {BIG + "\n" + SMALL: CVT},
    # head dim 128 with both Q planes and 64-row kv tiles: one CTA an SM
    "d128_one_cta": {BKV: "  static constexpr int BKV = 64;", QP: "  static constexpr int QP = 2;"},
}
SHAPES = {  # name: batch, nq, nkv, channels, heads, causal
    "image_sa": (16, 512, 512, 1024, 8, False),
    "train_ca": (2, 1024, 8704, 512, 8, True),
    "serve_ca": (1, 512, 16384, 512, 8, True),
}


def build_variants() -> dict:
    head = open(os.path.join(SRC, "flash_mma.cuh")).read()
    nvcc, procs, libs = build._nvcc(), {}, {}
    for name, patch in VARIANTS.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        text = head
        for old, new in patch.items():
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in flash_mma.cuh")
            text = text.replace(old, new)
        with open(os.path.join(d, "flash_mma.cuh"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "libflash_packed.so")
        procs[name] = subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "flash_packed.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        libs[name] = lib
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) registers", out, re.S)
        print(json.dumps({"variant": name, "registers": {cs.kernel_name(k): int(r) for k, r in regs
                                                         if "F32" in k}}), flush=True)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_tf32_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants()
    gen = torch.Generator().manual_seed(0)
    inputs = {}
    for shape, (b, nq, nkv, c, h, causal) in SHAPES.items():
        d = c // h
        q = (torch.randn(b, nq, c, generator=gen) * d**-0.5).cuda()
        inputs[shape] = (q, torch.randn(b, nkv, c, generator=gen).cuda(), torch.randn(b, nkv, c, generator=gen).cuda())
    times = {name: {shape: [] for shape in SHAPES} for name in VARIANTS}
    for _ in range(2):
        for name, lib in libs.items():
            fn = getattr(ctypes.CDLL(lib), "pio_flash_packed_fwd")
            fn.argtypes, fn.restype = build.LAUNCHERS["flash_packed_fwd"][2], ctypes.c_int
            build._LAUNCHERS["flash_packed_fwd"] = fn
            for shape, (b, nq, nkv, c, h, causal) in SHAPES.items():
                q, k, v = inputs[shape]
                row = cs.flash_fwd_case(f"{name}_{shape}", q, k, v, None, h, 1e-5, "variants", causal)
                times[name][shape].append(row["ms"])
                print(json.dumps({"variant": name, "shape": shape, "ms": row["ms"], "max_abs_err": row["max_abs_err"],
                                  "library_ms": row["library_ms"], "card": smi}), flush=True)
    print(json.dumps({"variants_ms": times, "card": smi}))


if __name__ == "__main__":
    main()
