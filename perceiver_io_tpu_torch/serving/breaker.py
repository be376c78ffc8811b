"""Overload circuit breaker — closed → open → half-open → closed (a copy of
``perceiver_io_tpu/serving/breaker.py``; ``probe_backoff`` is the port's
``training.faults.RetryPolicy``).

The load-shedding complement of the admission queue: the queue protects the
worker from *too much* traffic, the breaker protects callers from a worker
that is *failing* — once the recent error rate (or an in-graph numerics
sentinel: non-finite logits reported by the Probeline decode gauges) says
the serving path is broken, admitting more requests only burns their
deadline budget on guaranteed failures. Standard three-state discipline
(the Gemma-on-TPU serving comparison, arXiv:2605.25645, treats this as
part of the admission tier):

- **closed** — normal admission; terminal outcomes feed a sliding window
  and the breaker opens when the windowed error rate crosses
  ``error_rate_to_open`` (with at least ``min_requests`` observations — a
  single early error must not trip it) or a sentinel fires
  (:meth:`CircuitBreaker.record_sentinel`, which opens immediately: NaN
  logits are not a rate question).
- **open** — every admission probe is answered ``"shed"`` until the probe
  delay elapses. Probe spacing reuses the :class:`RetryPolicy`
  backoff discipline verbatim: the ``n``-th consecutive open waits
  ``probe_backoff.delay(n)`` — bounded exponential growth with
  deterministic counter-seeded jitter, so a flapping backend is probed at
  decorrelated, ever-sparser intervals instead of being hammered.
- **half-open** — exactly one probe request is admitted (``"probe"``);
  concurrent arrivals keep shedding. ``close_after_probes`` consecutive
  probe successes close the breaker (window and open-counter reset); one
  probe failure re-opens it with the next backoff rung.

The breaker never touches requests itself — the front end asks
:meth:`allow` at admission and reports terminal outcomes through
:meth:`record`; ``on_transition`` observes every state change (the front
end turns these into ``serve.breaker`` events, a ``serve_breaker_state``
gauge, and flight-recorder dumps on open).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from perceiver_io_tpu_torch.training.faults import RetryPolicy

# gauge encoding (serve_breaker_state): the scrape side alerts on > 0
STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


@dataclass
class BreakerConfig:
    """Thresholds + probe spacing for :class:`CircuitBreaker`."""

    # sliding window of recent terminal outcomes the error rate is over
    window: int = 16
    # observations required before the error rate can open the breaker
    min_requests: int = 4
    # windowed error rate at or above this opens the breaker
    error_rate_to_open: float = 0.5
    # consecutive half-open probe successes required to close again
    close_after_probes: int = 1
    # probe spacing: the n-th consecutive open waits delay(n) before the
    # half-open probe — RetryPolicy's bounded-exponential-with-jitter
    # schedule, deterministic per (seed, open-count) for chaos replay
    probe_backoff: RetryPolicy = field(
        default_factory=lambda: RetryPolicy(base_delay=0.5, max_delay=30.0, jitter=0.25)
    )


class CircuitBreaker:
    """Error-rate/sentinel-fed circuit breaker (see module docstring).

    :param clock: monotonic-seconds callable — injectable so chaos
        scenarios step through open → half-open without wall-clock.
    :param on_transition: ``fn(prev, new, reason, detail_dict)`` observer.
    """

    def __init__(
        self,
        config: Optional[BreakerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str, dict], None]] = None,
    ):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._on_transition = on_transition
        self.state = "closed"
        # guards the outcome window: record() runs on the serving thread
        # while error_rate() is read by the /healthz scrape thread — an
        # unguarded deque iteration would intermittently RuntimeError and
        # collapse the health body exactly under the load that matters
        self._window_lock = threading.Lock()
        self._outcomes: deque = deque(maxlen=max(int(self.config.window), 1))
        self.n_opens = 0  # consecutive opens since the last close
        self.opens_total = 0
        self.shed_total = 0
        self._probe_in_flight = False
        self._probe_successes = 0
        self._reopen_at: Optional[float] = None

    # -- observation --------------------------------------------------------

    def error_rate(self) -> Optional[float]:
        """Windowed error rate, or None below ``min_requests``."""
        with self._window_lock:
            window = list(self._outcomes)
        if len(window) < self.config.min_requests:
            return None
        return sum(1 for ok in window if not ok) / len(window)

    def _transition(self, new: str, reason: str, **detail) -> None:
        prev, self.state = self.state, new
        if self._on_transition is not None:
            self._on_transition(prev, new, reason, dict(detail))

    def _open(self, reason: str, **detail) -> None:
        self.n_opens += 1
        self.opens_total += 1
        self._probe_in_flight = False
        self._probe_successes = 0
        delay = self.config.probe_backoff.delay(self.n_opens - 1)
        self._reopen_at = self._clock() + delay
        self._transition(
            "open", reason, n_opens=self.n_opens, probe_delay_s=round(delay, 6), **detail
        )

    def _close(self, reason: str) -> None:
        self.n_opens = 0
        self._probe_in_flight = False
        self._probe_successes = 0
        with self._window_lock:
            self._outcomes.clear()  # the failure window must not re-trip the fresh state
        self._reopen_at = None
        self._transition("closed", reason)

    # -- the front end's two calls ------------------------------------------

    def allow(self) -> str:
        """Admission verdict for one arriving request:
        ``"admit"`` (closed), ``"probe"`` (this request is the half-open
        probe — report it back with ``record(..., probe=True,
        cycle=breaker.cycle)``), or ``"shed"``."""
        if self.state == "open" and self._reopen_at is not None and self._clock() >= self._reopen_at:
            self._transition("half_open", "probe-delay-elapsed", n_opens=self.n_opens)
        if self.state == "closed":
            return "admit"
        if self.state == "half_open" and not self._probe_in_flight:
            self._probe_in_flight = True
            return "probe"
        self.shed_total += 1
        return "shed"

    @property
    def cycle(self) -> int:
        """The open-cycle id a probe belongs to (== ``opens_total`` at probe
        issue): a probe verdict arriving after ANOTHER open happened is
        stale and must not judge — or release — the new cycle's probe."""
        return self.opens_total

    def _probe_is_stale(self, cycle: Optional[int]) -> bool:
        return self.state != "half_open" or (
            cycle is not None and cycle != self.opens_total
        )

    def record(self, ok: bool, probe: bool = False, cycle: Optional[int] = None) -> None:
        """Report one terminal outcome of an admitted request.

        For regular requests ``ok`` is "the serving path worked": ``ok``
        and deadline/cancel outcomes count as successes (a timeout under
        load is the queue's problem, not a broken backend); only ``error``
        outcomes (and sentinel trips, reported separately) feed the
        breaker — callers encode that by passing ``outcome != "error"``.
        A PROBE is stricter: only an actually-served ``ok`` may close the
        breaker — a probe that timed out or was cancelled never judged the
        backend and must go through :meth:`release_probe` instead.
        """
        if probe:
            if self._probe_is_stale(cycle):
                # a stale probe finishing after the state moved on (e.g. a
                # sentinel re-opened the breaker while it was queued): its
                # verdict belongs to a dead cycle — judging it would let a
                # dead probe close a freshly re-opened breaker (the re-open
                # already reset the probe bookkeeping, nothing to release)
                return
            self._probe_in_flight = False
            if not ok:
                self._open("probe-failed")
                return
            self._probe_successes += 1
            if self._probe_successes >= self.config.close_after_probes:
                self._close("probe-succeeded")
            return
        if self.state != "closed":
            return  # a straggler finishing after the trip: already accounted
        with self._window_lock:
            self._outcomes.append(bool(ok))
        rate = self.error_rate()
        if rate is not None and rate >= self.config.error_rate_to_open:
            self._open(
                "error-rate", error_rate=round(rate, 6), window=len(self._outcomes)
            )

    def release_probe(self, cycle: Optional[int] = None) -> None:
        """The in-flight probe ended WITHOUT judging the backend (its
        deadline expired queued, or a caller cancelled it): free the probe
        slot so the next arrival probes again. Neither a success (the
        backend was never exercised — closing would re-admit all traffic
        into a possibly-still-broken path) nor a failure (nothing failed).
        A stale probe (another open happened since it was issued) releases
        nothing — it could otherwise free a NEWER cycle's in-flight slot."""
        if self._probe_is_stale(cycle):
            return
        self._probe_in_flight = False

    def record_sentinel(self, reason: str = "sentinel") -> None:
        """A numerics sentinel fired (non-finite logits on a served
        request): open immediately, whatever the error rate."""
        if self.state == "open":
            return
        self._open(reason)

    # -- exposition ---------------------------------------------------------

    def health(self) -> dict:
        """The /healthz slice: state, counters, next-probe countdown."""
        out = {
            "state": self.state,
            "n_opens": self.n_opens,
            "opens_total": self.opens_total,
            "shed_total": self.shed_total,
        }
        rate = self.error_rate()
        if rate is not None:
            out["error_rate"] = round(rate, 6)
        if self.state == "open" and self._reopen_at is not None:
            out["probe_in_s"] = round(max(self._reopen_at - self._clock(), 0.0), 6)
        return out
