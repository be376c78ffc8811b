"""The port's serving layer (counterpart of ``perceiver_io_tpu/serving``): the
hardened request front end (``serving.frontend.RequestFrontEnd``: a bounded,
deadline-aware admission queue with first-class shedding, mid-decode
deadlines and cancellation through the ``on_token`` seam, bounded pre-decode
retry, graceful drain and the clean-books invariant), the circuit breaker
(``serving.breaker``), the deterministic fault injector and manual clock
(``serving.faultinject``), the continuous-batching engine over paged KV
caches (``serving.engine.EngineFrontEnd``, a ``RequestFrontEnd``) with its
host-side page allocator, radix prefix index (``serving.prefix``), eviction
and the write-ahead request journal its crash recovery replays
(``serving.journal``), the fleet router (``serving.router.FleetRouter``: N
engine replicas behind one submit surface, least-outstanding dispatch,
drain/join and journal-backed failover) and the discrete-event simulator
over the engine's host half (``serving.sim``). ``RequestSpec`` lives in
``obs.loadgen``."""

from perceiver_io_tpu_torch.obs.loadgen import RequestSpec
from perceiver_io_tpu_torch.serving.breaker import STATE_VALUES, BreakerConfig, CircuitBreaker
from perceiver_io_tpu_torch.serving.engine import EngineConfig, EngineFrontEnd
from perceiver_io_tpu_torch.serving.faultinject import (
    EngineCrash,
    FaultInjector,
    InjectedFault,
    ManualClock,
    poison_params,
)
from perceiver_io_tpu_torch.serving.journal import JOURNAL_KINDS, JournalEntry, RequestJournal
from perceiver_io_tpu_torch.serving.frontend import (
    SHED_REASONS,
    TERMINAL_OUTCOMES,
    DecodePathFailure,
    FrontEndConfig,
    FrontEndRecord,
    RequestFrontEnd,
)
from perceiver_io_tpu_torch.serving.pages import PageAllocator, PageGrant, PageStats
from perceiver_io_tpu_torch.serving.prefix import PrefixIndex
from perceiver_io_tpu_torch.serving.router import FleetConfig, FleetRouter, ReplicaHandle

__all__ = [
    "EngineConfig",
    "EngineCrash",
    "EngineFrontEnd",
    "JOURNAL_KINDS",
    "JournalEntry",
    "RequestJournal",
    "PageAllocator",
    "PageGrant",
    "PageStats",
    "PrefixIndex",
    "RequestSpec",
    "STATE_VALUES",
    "BreakerConfig",
    "CircuitBreaker",
    "FaultInjector",
    "InjectedFault",
    "ManualClock",
    "poison_params",
    "SHED_REASONS",
    "TERMINAL_OUTCOMES",
    "FrontEndConfig",
    "FrontEndRecord",
    "DecodePathFailure",
    "RequestFrontEnd",
    "FleetConfig",
    "FleetRouter",
    "ReplicaHandle",
]
