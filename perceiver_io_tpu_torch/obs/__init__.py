"""Observability for the port (counterpart of part of
``perceiver_io_tpu/obs/``): the JSONL event log, the run manifest and the
event validator with the serving vocabulary (``events.py``), host spans
(``trace.py``), MFU and goodput accounting (``mfu.py``), CUDA graph
recapture tracking (``recompile.py``), the metrics registry
(``metrics.py``) and the seeded request mix (``loadgen.py``). The SLO
reports, the flight recorder, the load generator's runs and documents, the
HTTP server, probes and device-trace rollups wait for ROADMAP A11."""
