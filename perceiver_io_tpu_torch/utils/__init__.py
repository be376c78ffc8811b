"""Host-side utilities for the port (counterpart of ``perceiver_io_tpu/utils/``):
the analytic FLOPs model (``flops.py``), the scaling-law fit (``laws.py``)
and the profiling helpers (``profiling.py``)."""

from perceiver_io_tpu_torch.utils.laws import (
    ScalingLaw,
    fit_power_law,
    fit_scaling_exponents,
    fit_scaling_law,
)

__all__ = [
    "ScalingLaw",
    "fit_power_law",
    "fit_scaling_exponents",
    "fit_scaling_law",
]
