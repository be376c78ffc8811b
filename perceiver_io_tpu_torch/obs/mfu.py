"""MFU and goodput accounting (counterpart of ``perceiver_io_tpu/obs/mfu.py``:
``device_peak_flops``, ``clm_train_telemetry``, ``GoodputTracker``).

MFU is analytic model FLOPs per second over the card's peak matmul rate:
``mfu = model_flops_per_sec / (peak_flops * n_devices)``. The numerator
counts only the FLOPs the model math requires (``utils.flops.train_step_flops``,
the JAX package's cost model), so rematerialization and padding do not
inflate it.

Goodput is the productive share of wall time: step execution against the
compile (CUDA graph capture) / checkpoint / eval / rollback overheads a
:class:`GoodputTracker` buckets.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Optional, Tuple

import torch

# Per-card dense peak FLOP/s at the training dtype, matched by substring
# against the lowercased ``torch.cuda.get_device_name``. The H100 SXM's dense
# bf16 tensor-core rate from NVIDIA's data sheet, which gives 1,979 TFLOP/s
# with 2:1 sparsity (495 TFLOP/s is its dense TF32 rate). No CPU entry: a CPU
# run reports no MFU.
PEAK_FLOPS = (("h100", 989.4e12),)


def device_peak_flops(device="cuda") -> Optional[float]:
    """Peak FLOP/s of the card ``device`` names, or None for the CPU, a
    machine without a card, or a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for pattern, peak in PEAK_FLOPS:
        if pattern in kind:
            return peak
    return None


def clm_train_telemetry(model_config) -> Optional[Tuple[int, float]]:
    """``(tokens_per_sample, flops_per_sample)`` for a Perceiver AR CLM
    config — what the trainer multiplies by the observed batch size to
    report ``tokens_per_sec`` / ``model_flops_per_sec`` / ``mfu``.

    Tokens are *latent* tokens (the positions that receive a loss); FLOPs
    are fwd+bwd per sample from ``utils.flops.train_step_flops``, with the
    prefix cross-attention discounted by the configured prefix-dropout rate.
    Returns None for configs that are not CLM-shaped."""
    required = ("vocab_size", "max_seq_len", "max_latents", "num_channels",
                "num_self_attention_layers", "self_attention_widening_factor",
                "cross_attention_widening_factor")
    if not all(hasattr(model_config, a) for a in required):
        return None
    from perceiver_io_tpu_torch.utils.flops import train_step_flops

    keep = 1.0 - getattr(model_config, "cross_attention_dropout", 0.5)
    flops = train_step_flops(model_config, batch_size=1, prefix_dropout_keep=keep)
    return model_config.max_latents, float(flops)


class GoodputTracker:
    """Wall-time bucketing: everything measured into a named overhead bucket
    (``compile`` / ``checkpoint`` / ``eval`` / ...) counts against goodput;
    the remainder of elapsed time is productive step time.

    ``goodput = (elapsed - sum(overheads)) / elapsed``.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._buckets: Dict[str, float] = collections.defaultdict(float)

    def add(self, name: str, seconds: float) -> None:
        self._buckets[name] += max(float(seconds), 0.0)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(name, self._clock() - t0)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def overhead(self) -> float:
        """Total seconds booked into overhead buckets so far — snapshot it
        at window boundaries to compute per-window goodput deltas."""
        return sum(self._buckets.values())

    def summary(self) -> Dict[str, float]:
        total = max(self.elapsed(), 1e-9)
        overhead = self.overhead()
        productive = max(total - overhead, 0.0)
        out = {
            "total_s": round(total, 4),
            "productive_s": round(productive, 4),
            "goodput": round(productive / total, 4),
        }
        for name, secs in sorted(self._buckets.items()):
            out[f"{name}_s"] = round(secs, 4)
        return out
