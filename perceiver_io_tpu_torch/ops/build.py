"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``ops/csrc/*.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (``extern "C"``
launchers that take raw device pointers and the CUDA stream) and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds, not minutes. The
libraries land in ``ops/_build/`` (ignored by git) under a name that carries a
hash of the sources and flags, so an edited source is rebuilt, never reused
stale. :func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them; ``-Xptxas=-v`` makes each build report its kernels' registers,
shared memory and spills, which it keeps in ``BUILD_LOGS``.

Nothing here runs at import: the CPU tests import every module, on machines
that have neither ``nvcc`` nor a card. A failed build raises with the
compiler's output; no caller falls back to a plain version on failure.

``LAUNCHES`` counts kernel launches by name: every wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels (``chip_smoke.py`` resets and reads it). Inside a
CUDA graph capture a wrapper records its launch and the card runs nothing:
``graphs.Graph`` takes the capture's counts back out and adds them at every
replay, so the counts stay those of the kernels the card ran. The launchers
run nothing at import and allocate nothing, and each takes the current
stream, which is the capture stream during a capture.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# one shared library per source file; kernel name -> (its source, its C
# launcher, the launcher's argument types); every launcher returns a
# cudaError_t
LAUNCHERS = {
    "flash_packed_fwd": ("flash_packed", "pio_flash_packed_fwd", [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P]),
    "flash_packed_bwd_dkv": ("flash_packed_bwd", "pio_flash_packed_bwd_dkv", [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    "flash_packed_bwd_dq": ("flash_packed_bwd", "pio_flash_packed_bwd_dq", [_P] * 8 + [_I] * 7 + [_F, _I, _P]),
    "paged_decode": ("paged_decode", "pio_paged_decode", [_P] * 6 + [_L, _P, _P] + [_I] * 13 + [_P]),
    "flash_2seg_fwd": ("flash_2seg", "pio_flash_2seg_fwd", [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P]),
    "flash_2seg_bwd_dkv": ("flash_2seg_bwd", "pio_flash_2seg_bwd_dkv", [_P] * 14 + [_I] * 6 + [_F, _I, _P]),
    "flash_2seg_bwd_dq": ("flash_2seg_bwd", "pio_flash_2seg_bwd_dq", [_P] * 11 + [_I] * 6 + [_F, _I, _P]),
    "flash_heads_fwd": ("flash_heads", "pio_flash_heads_fwd", [_P] * 7 + [_I] * 7 + [_F, _I, _I, _P]),
    "flash_heads_bwd_dkv": ("flash_heads_bwd", "pio_flash_heads_bwd_dkv", [_P] * 9 + [_I] * 7 + [_F, _I, _P]),
    "flash_heads_bwd_dq": ("flash_heads_bwd", "pio_flash_heads_bwd_dq", [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P]),
    # not kernels: K8's and K9b's CTA slots an SM at given head dims and
    # dtype (their split rules), K3's launch plan for a geometry
    "paged_decode_plan": ("paged_decode", "pio_paged_decode_plan", [_I] * 7 + [_P]),
    "flash_heads_fwd_slots": ("flash_heads", "pio_flash_heads_fwd_slots", [_I, _I, _I]),
    "flash_heads_bwd_dq_slots": ("flash_heads_bwd", "pio_flash_heads_bwd_dq_slots", [_I, _I, _I]),
}
CUDA_SOURCES = tuple(dict.fromkeys(source for source, _, _ in LAUNCHERS.values()))
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

# the kernels whose bf16 builds count apart, under the name + BF16_SUFFIX
BF16_KERNELS = ("flash_packed_fwd", "paged_decode", "layer_norm_fwd", "flash_packed_bwd_dkv", "flash_packed_bwd_dq",
                "layer_norm_bwd", "flash_2seg_fwd", "flash_2seg_bwd_dkv", "flash_2seg_bwd_dq", "flash_heads_fwd",
                "flash_heads_bwd_dkv", "flash_heads_bwd_dq")
BF16_SUFFIX = "_bf16"

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "flash_packed_fwd": 0, "paged_decode": 0, "layer_norm_fwd": 0,
    "flash_packed_bwd_dkv": 0, "flash_packed_bwd_dq": 0, "layer_norm_bwd": 0,
    "flash_2seg_fwd": 0, "flash_2seg_bwd_dkv": 0, "flash_2seg_bwd_dq": 0,
    "flash_heads_fwd": 0, "flash_heads_bwd_dkv": 0, "flash_heads_bwd_dq": 0,
    **{name + BF16_SUFFIX: 0 for name in BF16_KERNELS},
}

# (kernel name, kv rows) -> launches since the last reset_launches(), for
# the kernels whose wrappers pass their kv rows (K2, K4a, K4b): which of a
# model's attentions the launches served
LAUNCHES_BY_KV: Dict[Tuple[str, int], int] = {}

# source name -> the compiler's output of the build of its library (kept
# beside the library, so a cached library has its log too)
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHERS: Dict[str, object] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_KV.clear()


def count_launch(name: str, dtype=None, kv_rows: Optional[int] = None) -> None:
    """One launch of ``name``; a launch of its bf16 build (``dtype``
    ``torch.bfloat16``) counts under ``name + BF16_SUFFIX``, and also under
    ``(name, kv_rows)`` in ``LAUNCHES_BY_KV`` where ``kv_rows`` is given."""
    if dtype is not None and str(dtype) == "torch.bfloat16":
        name += BF16_SUFFIX
    LAUNCHES[name] += 1
    if kv_rows is not None:
        key = (name, int(kv_rows))
        LAUNCHES_BY_KV[key] = LAUNCHES_BY_KV.get(key, 0) + 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the CUDA kernels "
        "of perceiver_io_tpu_torch are built from source on the machine with the card"
    )


def _library_path(name: str) -> str:
    digest = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                digest.update(fname.encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = CUDA_SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library (and build
    log) yet, one ``nvcc`` process per source, all started together; fill
    ``BUILD_LOGS`` for every named source. Returns name -> library path;
    raises RuntimeError naming every source that failed to build."""
    names = list(names)
    paths = {name: _library_path(name) for name in names}
    todo = [n for n in names if not (os.path.isfile(paths[n]) and os.path.isfile(paths[n] + ".log"))]
    for name in names:
        if name not in todo:
            with open(paths[name] + ".log") as f:
                BUILD_LOGS[name] = f.read()
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            with open(f"{tmp}.log", "w") as f:
                f.write(out)
            os.replace(f"{tmp}.log", paths[name] + ".log")
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def launcher(name: str):
    """The C launcher of one kernel, its argument types declared; its
    source's library is built and loaded first if needed."""
    with _LOCK:
        fn = _LAUNCHERS.get(name)
        if fn is None:
            source, symbol, argtypes = LAUNCHERS[name]
            lib = _LIBS.get(source)
            if lib is None:
                lib = _LIBS[source] = ctypes.CDLL(build_all([source])[source])
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LAUNCHERS[name] = fn
        return fn


def check(err: int, what: str) -> None:
    """Raise on a launcher's nonzero cudaError_t (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
