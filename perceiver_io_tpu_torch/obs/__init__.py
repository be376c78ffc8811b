"""Observability for the port (counterpart of ``perceiver_io_tpu/obs/``):
the JSONL event log, the run manifest and the event validator
(``events.py``), host spans and their join to a device capture
(``trace.py``), the metrics registry (``metrics.py``), MFU and goodput
accounting (``mfu.py``), CUDA graph recapture tracking (``recompile.py``),
numerics probes (``probes.py``: per-scope activation, gradient and update
stats as outputs of the captured train step, blast-radius attribution on
sentinel trips, the decode health gauges), per-request SLO aggregation
(``slo.py``), the load generator and its documents (``loadgen.py``), the
flight recorder (``flightrec.py``), the ``/metrics`` + ``/healthz`` +
``/slo`` scrape server (``server.py``) and the per-scope rollup of a
``torch.profiler`` run (``profiler.py``, the JAX package's ``xplane``
rollup). The JAX package's ``probes_live_report`` (a jaxpr dataflow audit)
has no counterpart (ROADMAP A14).
"""

from perceiver_io_tpu_torch.obs.events import (  # noqa: F401
    EVENT_SCHEMA_VERSION,
    KNOWN_EVENT_KINDS,
    REQUEST_OUTCOMES,
    EventLog,
    config_hash,
    event_shards,
    merged_events,
    validate_events,
    write_run_manifest,
)
from perceiver_io_tpu_torch.obs.probes import (  # noqa: F401
    ProbeConfig,
    blast_report,
    decode_health,
    probe,
    snapshot_to_host,
)
from perceiver_io_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from perceiver_io_tpu_torch.obs.mfu import (  # noqa: F401
    GoodputTracker,
    clm_train_telemetry,
    device_peak_flops,
)
from perceiver_io_tpu_torch.obs.flightrec import FlightRecorder, SLOBounds  # noqa: F401
from perceiver_io_tpu_torch.obs.loadgen import (  # noqa: F401
    LoadReport,
    WorkloadSpec,
    arrival_schedule,
    build_load_doc,
    diff_load,
    run_load,
    summarize_load,
)
from perceiver_io_tpu_torch.obs.recompile import RecompileTracker, shape_signature  # noqa: F401
from perceiver_io_tpu_torch.obs.server import ObsServer  # noqa: F401
from perceiver_io_tpu_torch.obs.slo import (  # noqa: F401
    build_slo_report,
    request_breakdowns,
    write_slo_report,
)
from perceiver_io_tpu_torch.obs.trace import (  # noqa: F401
    Span,
    Tracer,
    current_span,
    current_span_id,
    host_device_breakdown,
)

__all__ = [
    "EVENT_SCHEMA_VERSION",
    "KNOWN_EVENT_KINDS",
    "REQUEST_OUTCOMES",
    "ProbeConfig",
    "blast_report",
    "decode_health",
    "probe",
    "snapshot_to_host",
    "EventLog",
    "config_hash",
    "event_shards",
    "merged_events",
    "validate_events",
    "write_run_manifest",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "GoodputTracker",
    "clm_train_telemetry",
    "device_peak_flops",
    "RecompileTracker",
    "shape_signature",
    "build_slo_report",
    "request_breakdowns",
    "write_slo_report",
    "FlightRecorder",
    "SLOBounds",
    "LoadReport",
    "WorkloadSpec",
    "arrival_schedule",
    "build_load_doc",
    "diff_load",
    "run_load",
    "summarize_load",
    "ObsServer",
    "Span",
    "Tracer",
    "current_span",
    "current_span_id",
    "host_device_breakdown",
]
