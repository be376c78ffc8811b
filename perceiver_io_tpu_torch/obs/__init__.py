"""Observability for the port's trainer (counterpart of the trainer's part of
``perceiver_io_tpu/obs/``): the JSONL event log and run manifest
(``events.py``), host spans (``trace.py``), MFU and goodput accounting
(``mfu.py``) and CUDA graph recapture tracking (``recompile.py``). The
serving-side telemetry (metrics registry, SLO reports, flight recorder,
load generator, HTTP server, probes, device-trace rollups) waits for ROADMAP
A6 and A11."""
