"""The seeded request mix the serving loops read (counterpart of the
first part of ``perceiver_io_tpu/obs/loadgen.py``): :class:`WorkloadSpec`
and its :meth:`~WorkloadSpec.draw`, :class:`RequestSpec`, and
:func:`arrival_schedule`, the seeded Poisson offsets of an open-loop drive.

Both packages draw from the same ``numpy`` generator in the same order, so a
spec and seed give the same requests (prompt ids, budgets, rng seeds) to the
JAX package and to the port. The load generator itself (``run_load``,
``summarize_load``, the ``LOAD_r*`` documents and their diff) waits for
ROADMAP A11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class WorkloadSpec:
    """Seeded synthetic request mix: everything a request *is* (prompt
    length, token ids, decode budget, rng chain) is drawn from one
    ``numpy`` generator, so two runs of the same spec issue bit-identical
    request streams — the property that makes a LOAD artifact diffable.

    ``prompt_lens``/``max_new_tokens`` are the mix buckets (each request
    draws one of each, uniformly); keep the bucket count small on purpose —
    every distinct (prompt_len, max_new_tokens) pair is a distinct compiled
    prefill/step geometry, and the load generator's job is to measure warm
    serving, not to fuzz the compile cache.

    ``shared_prefix_len > 0`` is the Shareline prompt-homogeneous mode:
    every request's first ``shared_prefix_len`` tokens are ONE common
    seeded preamble (drawn once, before the per-request stream, so the
    stream stays prefix-stable in ``n``) — the system-prompt / few-shot
    traffic shape whose prefill the engine's radix prefix sharing
    collapses. Must be shorter than every prompt bucket: each request
    still carries a unique tail.
    """

    seed: int = 0
    prompt_lens: Tuple[int, ...] = (8, 12)
    max_new_tokens: Tuple[int, ...] = (6, 10)
    batch: int = 1
    shared_prefix_len: int = 0

    def __post_init__(self):
        if not self.prompt_lens or not self.max_new_tokens:
            raise ValueError("WorkloadSpec needs at least one prompt_len and max_new_tokens bucket")
        if min(self.prompt_lens) < 1 or min(self.max_new_tokens) < 1 or self.batch < 1:
            raise ValueError("WorkloadSpec buckets and batch must be >= 1")
        if self.shared_prefix_len < 0:
            raise ValueError("shared_prefix_len must be >= 0")
        if self.shared_prefix_len and self.shared_prefix_len >= min(self.prompt_lens):
            raise ValueError(
                f"shared_prefix_len {self.shared_prefix_len} must be shorter "
                f"than every prompt bucket {self.prompt_lens} (each request "
                "needs a unique tail)"
            )

    def to_dict(self) -> Dict:
        out = {
            "seed": self.seed,
            "prompt_lens": list(self.prompt_lens),
            "max_new_tokens": list(self.max_new_tokens),
            "batch": self.batch,
        }
        # only stamped when active: pre-Shareline artifacts stay
        # byte-comparable (diff_load keys comparability on this dict)
        if self.shared_prefix_len:
            out["shared_prefix_len"] = self.shared_prefix_len
        return out

    def draw(self, n: int, vocab_size: int) -> List["RequestSpec"]:
        """The first ``n`` requests of this spec's stream (deterministic:
        same spec + same n => same list, prefix-stable in n)."""
        import numpy as np

        rng = np.random.default_rng(self.seed)
        shared = (
            rng.integers(0, vocab_size, size=self.shared_prefix_len, dtype=np.int32)
            if self.shared_prefix_len
            else None
        )
        out = []
        for i in range(n):
            prompt_len = int(rng.choice(self.prompt_lens))
            max_new = int(rng.choice(self.max_new_tokens))
            ids = rng.integers(0, vocab_size, size=(self.batch, prompt_len), dtype=np.int32)
            if shared is not None:
                ids[:, : self.shared_prefix_len] = shared
            out.append(
                RequestSpec(
                    index=i,
                    prompt_len=prompt_len,
                    max_new_tokens=max_new,
                    input_ids=ids,
                    rng_seed=int(rng.integers(0, 2**31 - 1)),
                )
            )
        return out


@dataclass(frozen=True)
class RequestSpec:
    """One drawn request (host-side; ``input_ids`` is a numpy array).
    ``tenant`` is the optional multi-tenant identity (Simline,
    docs/serving.md#multi-tenant-telemetry): the serving front ends thread
    it onto request events, spans, journal records and the labeled
    ``serve_*`` metric children; None means single-tenant (everything
    pre-Simline)."""

    index: int
    prompt_len: int
    max_new_tokens: int
    input_ids: object
    rng_seed: int
    tenant: Optional[str] = None


def arrival_schedule(n: int, rate_rps: float, seed: int = 0) -> List[float]:
    """Seeded Poisson arrival offsets (seconds from t0, cumulative,
    monotone): exponential inter-arrivals at ``rate_rps``. Deterministic —
    the open-loop schedule is part of the workload's identity."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    import numpy as np

    rng = np.random.default_rng(seed)
    inter = rng.exponential(1.0 / rate_rps, size=n)
    out, t = [], 0.0
    for d in inter:
        t += float(d)
        out.append(t)
    return out
