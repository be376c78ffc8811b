"""Numerics probes (counterpart of ``perceiver_io_tpu/obs/probes.py``): cheap
device statistics (rms, absmax, non-finite fraction, zero fraction) of
selected activations, per-bucket gradient norms and update ratios of a train
step, and the decode health gauges, returned as tensors beside the step's
own outputs — on the card as outputs of the same CUDA graph, never read by
the host inside the step. The trainer keeps snapshots on the device and
fetches them only at log boundaries and on sentinel trips.

Discipline (the JAX module's): :func:`probe` reads a contextvar, and with no
collector open it returns its argument and launches nothing, so a step built
without probes runs the kernels it ran before, bit for bit.

Pieces:

- :class:`ProbeConfig` — the selection (scope globs, grad-bucket depth,
  which stat families run, the trainer's ring length). Passed to
  ``training.make_train_step(probes=...)`` / ``TrainerConfig.probes``.
- :func:`probe` — the tap model code calls at its sites (``core/modules.py``,
  ``core/attention.py``); identity on the tensor.
- :func:`collecting` — the collector ``make_train_step`` opens around each
  chunk's loss forward; collected stats land under ``metrics["probes"]``
  keyed ``"NNN:scope"`` (the zero-padded index keeps forward order when the
  keys are sorted), a repeated site numbered ``scope#n``.
- :func:`grad_bucket_stats` / :func:`update_ratio_stats` — per-bucket
  gradient norms (before the update) and update/parameter ratios (after
  it), bucketed by the JAX package's parameter paths
  (``convert.jax_param_paths``, :func:`param_buckets`), appended to the
  snapshot by :func:`attach_train_stats`.
- :func:`blast_report` — host-side blast-radius attribution over the
  trainer's ring of snapshots: the first scope (in forward order) of the
  earliest snapshot whose stats went non-finite.
- :func:`decode_health` — the decode gauges (KV-cache occupancy, logit
  entropy, non-finite logit fraction) of ``generation.make_decode_fns(
  probes=True)``, published by the instrumented wrapper.

The JAX module's ``probes_live_report`` audits a jaxpr's dataflow; it has no
counterpart here (ROADMAP A14, with the other program analyses).

Remat: a layer under ``activation_checkpointing`` runs its forward again in
the backward; the recompute runs under :func:`suspended` (``core.remat``),
so a scope is collected once a forward, as JAX traces it once.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from fnmatch import fnmatch
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class ProbeConfig:
    """Probe selection.

    ``scopes`` are fnmatch globs against the probe-site names the model
    declares (``perceiver_ar.cross_attend``, ``self_attention.layer_0``,
    ``attention.out`` ...). ``bucket_depth`` controls how many components of
    the JAX parameter path form one gradient/update bucket (4 reaches
    ``params.perceiver_ar.self_attention.layer_0`` — per-layer buckets on
    the flagship). ``ring`` is the host-side knob riding along: how many
    recent snapshots the trainer keeps for blast-radius attribution.
    """

    scopes: Tuple[str, ...] = ("*",)
    activations: bool = True
    grad_norms: bool = True
    update_ratio: bool = True
    bucket_depth: int = 4
    ring: int = 8

    def wants(self, scope: str) -> bool:
        return any(fnmatch(scope, p) for p in self.scopes)


class _Collector:
    """Ordered scope -> stats accumulator for one forward. Keys carry a
    zero-padded call index (``"004:self_attention.layer_1"``) so sorted
    order == forward order."""

    def __init__(self, config: ProbeConfig):
        self.config = config
        self.stats: Dict[str, Dict[str, torch.Tensor]] = {}
        self._seen: Dict[str, int] = {}

    def add(self, scope: str, stats: Dict) -> None:
        n = self._seen.get(scope, 0)
        self._seen[scope] = n + 1
        if n:
            scope = f"{scope}#{n}"  # repeated site (shared blocks in a loop)
        self.stats[ordered_key(len(self.stats), scope)] = stats


_ACTIVE: "contextvars.ContextVar[Optional[_Collector]]" = contextvars.ContextVar(
    "obs_probe_collector", default=None
)


def ordered_key(index: int, scope: str) -> str:
    return f"{index:03d}:{scope}"


def scope_of(key: str) -> str:
    """The bare scope name of an ordered snapshot key."""
    head, sep, tail = key.partition(":")
    return tail if sep and head.isdigit() else key


@contextlib.contextmanager
def collecting(config: ProbeConfig):
    """Open a probe collector for the enclosed forward; :func:`probe` calls
    inside deposit their stats here."""
    col = _Collector(config)
    token = _ACTIVE.set(col)
    try:
        yield col
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def suspended():
    """No collector for the enclosed work (a checkpointed layer's
    recompute: its sites were collected in the forward)."""
    token = _ACTIVE.set(None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    """True when a collector is open (model code can branch cheaply)."""
    return _ACTIVE.get() is not None


@torch.no_grad()
def activation_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-scope stat quartet, reduced on the device in f32: rms, absmax,
    non-finite fraction, zero fraction (0-d f32 tensors). rms/absmax
    propagate NaN/Inf (a poisoned tensor shows up in every column); the
    non-finite fraction is the robust detector blast attribution keys on.
    The reductions read ``x`` in its own dtype and accumulate in f32 (the
    JAX function reduces an f32 copy: the same values, the sum of squares
    in another order; absmax and the fractions are exact either way)."""
    x = x.detach()
    return {
        "rms": torch.linalg.vector_norm(x, dtype=torch.float32) / math.sqrt(x.numel()),
        "absmax": torch.max(torch.abs(x)).float(),
        "nonfinite_frac": torch.mean(torch.isfinite(x).logical_not_(), dtype=torch.float32),
        "zero_frac": torch.mean(x == 0, dtype=torch.float32),
    }


def probe(scope: str, x):
    """Tap one tensor at a named site; returns ``x`` unchanged.

    A no-op (nothing launched) unless a :func:`collecting` context is open
    AND ``scope`` matches the config's globs."""
    col = _ACTIVE.get()
    if col is None or not col.config.activations or not col.config.wants(scope):
        return x
    col.add(scope, activation_stats(x))
    return x


# ---------------------------------------------------------------------------
# gradient / update-ratio buckets (the train-step half)
# ---------------------------------------------------------------------------


def param_buckets(model: torch.nn.Module, depth: int = 4) -> Dict[str, List[torch.nn.Parameter]]:
    """The model's parameters grouped as the JAX package groups its
    parameter tree's leaves: by the first ``depth`` components of each
    parameter's JAX path (``convert.jax_param_paths``) joined with '.',
    each bucket's leaves in the path order of a flattened Flax tree, the
    buckets sorted."""
    from perceiver_io_tpu_torch.convert import jax_param_paths

    paths = jax_param_paths(model)
    named = dict(model.named_parameters())
    out: Dict[str, List[Tuple[str, torch.nn.Parameter]]] = {}
    for name, path in paths.items():
        parts = path.split("/")
        out.setdefault(".".join(parts[:depth]), []).append((path, named[name]))
    return {b: [p for _, p in sorted(leaves, key=lambda t: t[0])] for b, leaves in sorted(out.items())}


def flat(tensors) -> torch.Tensor:
    """One f32 vector of a bucket's tensors (a tensor passes as its own
    view), so that a bucket's stats are a few reductions over one operand,
    not a few a leaf: the captured step's launches stay per bucket."""
    if isinstance(tensors, torch.Tensor):
        return tensors.detach().reshape(-1).float()
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


@torch.no_grad()
def grad_bucket_stats(buckets: Dict[str, Sequence[torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-bucket gradient stats over ``{bucket: gradients}``: l2 norm,
    absmax, non-finite fraction — the backward half of blast attribution (an
    activation blow-up in layer k shows up in that layer's bucket first).
    The JAX package sums its leaves' sums; the port reduces the bucket's
    concatenation (sums in another order)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for bucket, grads in buckets.items():
        g = flat(grads)
        out[f"grad.{bucket}"] = {
            "l2": torch.sqrt(torch.sum(torch.square(g))),
            "absmax": torch.max(torch.abs(g)),
            "nonfinite_frac": torch.sum(~torch.isfinite(g)).float() / g.numel(),
        }
    return out


@torch.no_grad()
def update_ratio_stats(old: Dict[str, Sequence[torch.Tensor]],
                       new: Dict[str, Sequence[torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-bucket ``||p_new - p_old|| / ||p_old||`` — the effective step
    size (a healthy run sits ~1e-3; a bucket at 1e-1 is about to diverge,
    one at 0 is dead or frozen). A bucket may be given as its tensors or as
    their :func:`flat` copy."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for bucket, olds in old.items():
        if bucket not in new:
            continue
        o, n = flat(olds), flat(new[bucket])
        out[f"update.{bucket}"] = {
            "ratio": torch.sqrt(torch.sum(torch.square(n - o))) / (torch.sqrt(torch.sum(torch.square(o))) + 1e-12)}
    return out


def attach_train_stats(pstats: Dict, grad_stats: Dict, update_stats: Dict) -> Dict:
    """Extend a (possibly empty) activation-stat dict with the grad-bucket
    and update-ratio families, continuing the ordered-key numbering so the
    whole snapshot stays in order: forward activations, then gradients, then
    updates. (The JAX function computes both families from its arguments;
    the port's update is in place and its clip rewrites the gradients, so
    the step computes the gradient family before the update, the update
    family after it, and hands both here.)"""
    out = dict(pstats)
    for family in (grad_stats, update_stats):
        for scope, st in family.items():
            out[ordered_key(len(out), scope)] = st
    return out


def mean_stats(snapshots: Sequence[Dict[str, Dict[str, torch.Tensor]]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The chunk average of ``k`` activation snapshots with the same keys
    (``microbatch=k``): summed in chunk order, then scaled by ``1/k``, as the
    JAX package sums its metrics over the chunks and scales them (absmax
    becomes a mean of per-chunk maxima there too)."""
    if len(snapshots) == 1:
        return snapshots[0]
    inv = 1.0 / len(snapshots)
    out = {}
    for key in snapshots[0]:
        acc = dict(snapshots[0][key])
        for snap in snapshots[1:]:
            acc = {s: acc[s] + snap[key][s] for s in acc}
        out[key] = {s: v * inv for s, v in acc.items()}
    return out


# ---------------------------------------------------------------------------
# decode health (the generation half)
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_health(logits: torch.Tensor, kv_cache, kv_start) -> Dict[str, torch.Tensor]:
    """The per-token decode gauges from a step's last-position logits (B, V)
    and the post-append cross-attention cache: KV-window occupancy fraction,
    mean logit entropy (nats — collapsing entropy is the classic
    degenerate-sampling signal), and the non-finite logit fraction (the
    serving-side numerics probe). 0-d f32 tensors; ``kv_cache.length`` and
    ``kv_start`` may be device tensors (never read by the host here)."""
    l32 = logits.float()
    logp = torch.log_softmax(l32, dim=-1)
    # exp(logp) * logp is NaN where logp is -inf: select 0 there
    ent = -torch.sum(torch.where(torch.isfinite(logp), torch.exp(logp) * logp, torch.zeros_like(logp)), dim=-1)
    used = torch.as_tensor(kv_cache.length - kv_start, device=l32.device).float()
    return {
        "logit_entropy": torch.mean(ent),
        # a tensor divisor: torch multiplies by a scalar divisor's reciprocal
        # on the card, which is not the rounded quotient JAX computes
        "kv_cache_frac": used / torch.full_like(used, float(kv_cache.capacity)),
        "nonfinite_logit_frac": torch.mean((~torch.isfinite(l32)).float()),
    }


# ---------------------------------------------------------------------------
# host side: snapshots, ring, blast-radius attribution
# ---------------------------------------------------------------------------


def snapshot_to_host(snapshot: Dict) -> Dict[str, Dict[str, float]]:
    """One device-to-host copy for the whole snapshot (its 0-d tensors
    stacked); values become plain floats (the ``probe`` event body). Key
    order is sorted == forward order (ordered keys)."""
    keys = sorted(snapshot)
    flat = [(k, s, v) for k in keys for s, v in snapshot[k].items()]
    if not flat:
        return {}
    tensors = [v for _, _, v in flat if isinstance(v, torch.Tensor)]
    host = iter(torch.stack([t.detach().float().reshape(()) for t in tensors]).cpu().tolist()) if tensors else iter(())
    out: Dict[str, Dict[str, float]] = {k: {} for k in keys}
    for k, s, v in flat:
        out[k][s] = float(next(host)) if isinstance(v, torch.Tensor) else float(v)
    return out


def _stats_nonfinite(stats: Dict[str, float]) -> bool:
    nf = stats.get("nonfinite_frac")
    if nf is not None and nf > 0:
        return True
    return any(not math.isfinite(float(v)) for v in stats.values())


def first_nonfinite_scope(host_snapshot: Dict[str, Dict[str, float]]) -> Optional[str]:
    """The first scope in forward order whose stats went non-finite — the
    blast origin. ``host_snapshot`` must already be host-fetched."""
    for key in sorted(host_snapshot):
        if _stats_nonfinite(host_snapshot[key]):
            return key
    return None


def blast_report(ring) -> Optional[Dict]:
    """Blast-radius attribution over a ring of ``(step, snapshot)`` entries
    (oldest first, snapshots still on the device): find the EARLIEST
    snapshot containing any non-finite scope and name its first affected
    scope in forward order — where the divergence entered the step — plus
    the full affected set (the blast radius). None when every snapshot is
    clean (e.g. a loss spike without numeric blow-up)."""
    for step, snap in ring:
        host = snapshot_to_host(snap)
        affected = [k for k in sorted(host) if _stats_nonfinite(host[k])]
        if affected:
            origin = affected[0]
            return {
                "step": int(step),
                "scope": scope_of(origin),
                "stats": host[origin],
                "affected": [scope_of(k) for k in affected],
                "n_affected": len(affected),
                "n_scopes": len(host),
            }
    return None
