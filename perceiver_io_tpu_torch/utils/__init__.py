"""Host-side utilities for the port (counterpart of ``perceiver_io_tpu/utils/``):
the analytic FLOPs model so far (``flops.py``)."""
