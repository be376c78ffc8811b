"""Deterministic serving-path fault injection (a copy of
``perceiver_io_tpu/serving/faultinject.py``; :func:`poison_params` takes a
``state_dict``-shaped mapping).

The training chaos harness injects faults by poisoning *batches* at known
fetch indices; the serving equivalent injects at known **(request index,
token index)** coordinates through the host-side seams the front end
already owns, so no failure needs wall-clock, randomness at run time, or a
cooperating model:

- :meth:`FaultInjector.kill_at` — raise an :class:`InjectedFault` from the
  ``on_token`` seam mid-decode (the "worker died between tokens" class);
  the request books as ``error``, its slot must come back.
- :meth:`FaultInjector.stall_at` — advance the injected :class:`ManualClock`
  by N seconds at a token boundary (a latency stall the deadline enforcer
  sees without anyone actually sleeping); under a real clock it degrades to
  a real ``sleep``.
- :meth:`FaultInjector.fail_prefill` — raise a transient (``OSError``-class
  by default) exception BEFORE the decode starts, n times — the class the
  front end's bounded pre-decode retry must absorb.
- :meth:`FaultInjector.poison_at` — hand the front end a parameter mapping
  with a planted NaN for that request: the logits genuinely go non-finite
  through the real decode (the decode health gauges that would feed the
  breaker's sentinel are ROADMAP A11).

The fleet tier (Fleetline, ``serving/router.py``) adds **replica**
coordinates on top of the request ones:

- :meth:`FaultInjector.kill_replica_at` — raise :class:`EngineCrash` out of
  a named replica's Nth drive step (the "whole process died" class at fleet
  scale; the router's failover replays the dead replica's journal onto a
  survivor);
- :meth:`FaultInjector.brownout_replica` — multiply a replica's service
  time by a factor (consumed through :meth:`latency_factor` by the
  sim-scale engine): the replica stays alive and healthy-looking at the
  RPC level while its EWMA step time degrades, which is exactly the
  failure health-based routing must detect.

Explicit coordinates make scenarios exactly replayable;
:meth:`seeded_kills` draws coordinates from a seeded generator for
soak-style runs (deterministic for a given seed, same discipline as
``WorkloadSpec``). Every injection that fires is appended to
:attr:`injected` so a scenario can assert the plan actually executed.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


class InjectedFault(RuntimeError):
    """A deliberately injected serving failure (never retried as transient
    unless the scenario injects a transient type on purpose)."""


class EngineCrash(BaseException):
    """The "process died" failure class (Evictline crash recovery,
    docs/robustness.md#engine-eviction-and-recovery): deliberately NOT an
    ``Exception`` so no serving seam books it — the engine's per-token seam
    and terminal accounting catch ``Exception`` only, so a planted crash
    propagates straight out of the drive loop exactly like a SIGKILL'd
    process would vanish: in-flight slots stay occupied, no terminal
    records are written, and only the write-ahead request journal
    (``serving.journal``) survives for ``EngineFrontEnd.recover``."""


class ManualClock:
    """A monotonic clock that only moves when told to — the wall-clock-free
    substrate of the serving chaos scenarios.

    Callable (``clock()`` -> seconds) so it drops into every ``clock=``
    seam (front end, breaker, ``run_load``); ``advance``/``advance_to``
    move it forward (never backward); ``sleep`` is the matching injectable
    sleep — sleeping *advances* the clock, so backoff schedules and
    open-loop pacing run instantly but remain visible in the timeline.
    """

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"ManualClock only moves forward, got dt={dt}")
        self.now += float(dt)
        return self.now

    def advance_to(self, t: float) -> float:
        self.now = max(self.now, float(t))
        return self.now

    def sleep(self, dt: float) -> None:
        self.advance(max(float(dt), 0.0))


def poison_params(params, path_filter: Optional[str] = None):
    """A copy of ``params`` (a ``state_dict``-shaped mapping of names to
    tensors) with one NaN planted in the first float tensor (optionally the
    first whose name contains ``path_filter``): that entry is a fresh tensor,
    every other entry the same tensor as in ``params``, whose values stay as
    they were. How a poisoned mapping is served is the engine's concern
    (``serving.engine``: written into the parameters in place for the
    request, the originals restored after)."""
    out = {}
    poisoned = False
    for name, t in params.items():
        if (
            not poisoned
            and torch.is_tensor(t)
            and t.is_floating_point()
            and (path_filter is None or path_filter in name)
        ):
            t = t.detach().clone()
            t.view(-1)[0] = float("nan")
            poisoned = True
        out[name] = t
    if not poisoned:
        raise ValueError(f"no float leaf to poison (path_filter={path_filter!r})")
    return out


class FaultInjector:
    """Deterministic (request, token)-coordinate fault schedule.

    The front end calls the three hooks; an injector with an empty plan is
    a no-op on every path. ``clock`` (a :class:`ManualClock` or None) is
    what stalls advance; without one they fall back to ``sleep``
    (default ``time.sleep`` — real stalls on a real clock).
    """

    def __init__(self, clock: Optional[ManualClock] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._clock = clock
        self._sleep = sleep
        self._kills: Dict[Tuple[int, int], Callable[[], BaseException]] = {}
        self._stalls: Dict[Tuple[int, Optional[int]], float] = {}
        self._prefill_fails: Dict[int, List[BaseException]] = {}
        self._poisoned: set = set()
        self._replica_kills: Dict[str, int] = {}
        self._brownouts: Dict[str, float] = {}
        self.injected: List[dict] = []  # audit: what actually fired

    # -- planning -----------------------------------------------------------

    def kill_at(self, request_index: int, token_index: int,
                exc: Optional[Callable[[], BaseException]] = None) -> "FaultInjector":
        """Raise mid-decode after token ``token_index`` of request
        ``request_index`` streams. ``exc`` is a zero-arg exception factory
        (default: :class:`InjectedFault`)."""
        self._kills[(int(request_index), int(token_index))] = exc or (
            lambda: InjectedFault(
                f"injected kill at request {request_index} token {token_index}"
            )
        )
        return self

    def crash_at(self, request_index: int, token_index: int) -> "FaultInjector":
        """Tear the whole ENGINE down (not just the request) after token
        ``token_index`` of request ``request_index`` streams: raises
        :class:`EngineCrash`, a ``BaseException`` no accounting seam
        catches — the mid-decode death the journal-backed
        ``EngineFrontEnd.recover`` path is certified against
        (``tools/chaos.py serve_crash_recover``)."""
        return self.kill_at(
            request_index, token_index,
            exc=lambda: EngineCrash(
                f"injected engine crash at request {request_index} "
                f"token {token_index}"
            ),
        )

    def stall_at(self, request_index: Optional[int], token_index: int,
                 seconds: float) -> "FaultInjector":
        """Stall ``seconds`` at token ``token_index``; ``request_index``
        None applies to EVERY request (the overload scenario's uniform
        service-time lever)."""
        self._stalls[(None if request_index is None else int(request_index),
                      int(token_index))] = float(seconds)
        return self

    def fail_prefill(self, request_index: int, times: int = 1,
                     exc_type: type = OSError) -> "FaultInjector":
        """Fail the next ``times`` pre-decode attempts of the request with
        ``exc_type`` (default ``OSError`` — a transient the retry policy
        covers)."""
        self._prefill_fails[int(request_index)] = [
            exc_type(f"injected prefill failure {i + 1}/{times} "
                     f"(request {request_index})")
            for i in range(int(times))
        ]
        return self

    def poison_at(self, request_index: int) -> "FaultInjector":
        """NaN-poison the params served to this request (see
        :func:`poison_params`)."""
        self._poisoned.add(int(request_index))
        return self

    def kill_replica_at(self, replica_id: str, step: int) -> "FaultInjector":
        """Tear a named REPLICA down on its ``step``-th drive step (0-based,
        counted by the replica's own drive loop): raises
        :class:`EngineCrash` from :meth:`on_replica_step` — the fleet-scale
        "process died" coordinate the router's journal failover is
        certified against (``tools/chaos.py serve_fleet_failover``)."""
        self._replica_kills[str(replica_id)] = int(step)
        return self

    def brownout_replica(self, replica_id: str,
                         factor: float) -> "FaultInjector":
        """Degrade a named replica: its service time is multiplied by
        ``factor`` (> 1) until :meth:`clear_brownout`. Consumed through
        :meth:`latency_factor` by the sim-scale engine's service-time
        sampling — the replica stays in the fleet, it just gets slow."""
        if float(factor) <= 0:
            raise ValueError(f"brownout factor must be > 0, got {factor}")
        self._brownouts[str(replica_id)] = float(factor)
        self.injected.append({"kind": "brownout", "replica": str(replica_id),
                              "factor": float(factor)})
        return self

    def clear_brownout(self, replica_id: str) -> "FaultInjector":
        """Restore a browned-out replica to nominal service time."""
        if self._brownouts.pop(str(replica_id), None) is not None:
            self.injected.append({"kind": "brownout_clear",
                                  "replica": str(replica_id)})
        return self

    def seeded_kills(self, n_requests: int, rate: float, max_token: int = 4,
                     seed: int = 0) -> "FaultInjector":
        """Draw kill coordinates from a seeded generator: each request is
        killed with probability ``rate`` at a uniform token index in
        ``[1, max_token]`` — deterministic for a given seed."""
        import numpy as np

        rng = np.random.default_rng(seed)
        for i in range(int(n_requests)):
            if rng.random() < rate:
                self.kill_at(i, int(rng.integers(1, max_token + 1)))
        return self

    # -- the front end's hooks ----------------------------------------------

    def on_token(self, request_index: int, token_index: int) -> None:
        """Called from the decode ``on_token`` seam; stalls first (the
        deadline enforcer downstream must see the advanced clock), then
        kills."""
        for key in ((request_index, token_index), (None, token_index)):
            if key in self._stalls:
                dt = self._stalls[key]
                self.injected.append({"kind": "stall", "request": request_index,
                                      "token": token_index, "seconds": dt})
                if self._clock is not None:
                    self._clock.advance(dt)
                else:
                    self._sleep(dt)
        exc = self._kills.pop((request_index, token_index), None)
        if exc is not None:
            self.injected.append({"kind": "kill", "request": request_index,
                                  "token": token_index})
            raise exc()

    def before_attempt(self, request_index: int) -> None:
        """Called before each pre-decode attempt; raises the next planted
        transient failure if any remain."""
        queue = self._prefill_fails.get(request_index)
        if queue:
            e = queue.pop(0)
            self.injected.append({"kind": "prefill_fail", "request": request_index,
                                  "error": repr(e)})
            raise e

    def on_replica_step(self, replica_id: str, step: int) -> None:
        """Called by the fleet router's drive loop once per replica step;
        raises the planted :class:`EngineCrash` when the armed step is
        reached (one-shot — the coordinate is popped so failover's replay
        on a survivor cannot re-fire it)."""
        armed = self._replica_kills.get(str(replica_id))
        if armed is not None and int(step) >= armed:
            self._replica_kills.pop(str(replica_id))
            self.injected.append({"kind": "replica_kill",
                                  "replica": str(replica_id),
                                  "step": int(step)})
            raise EngineCrash(
                f"injected replica crash: {replica_id} at step {step}"
            )

    def latency_factor(self, replica_id: Optional[str]) -> float:
        """The service-time multiplier currently in force for a replica
        (1.0 when nominal or unnamed) — the brownout consumption seam."""
        if replica_id is None:
            return 1.0
        return self._brownouts.get(str(replica_id), 1.0)

    def params_for(self, request_index: int, params):
        """Params the request should be served with (poisoned or not)."""
        if request_index in self._poisoned:
            self.injected.append({"kind": "poison", "request": request_index})
            return poison_params(params)
        return params
