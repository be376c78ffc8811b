"""Chinchilla-style power-law fitting for the scaling study (a copy of
``perceiver_io_tpu/utils/laws.py``; numpy only; reference:
examples/scaling/clm/scaling/laws.py:7-36): given measured
(FLOPs, optimal params, optimal tokens) triples and fixed exponents a/b,
fit the coefficients of N_opt = k_n * C^a and D_opt = k_d * C^b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class ScalingLaw:
    a: float
    b: float
    k_n: float
    k_d: float

    def n_opt(self, flops):
        return self.k_n * flops**self.a

    def d_opt(self, flops):
        return self.k_d * flops**self.b

    def __str__(self):
        return (
            f"fitted power laws over compute C: N_opt = {self.k_n:.4g} * C**{self.a:.3g} "
            f"params, D_opt = {self.k_d:.4g} * C**{self.b:.3g} tokens"
        )


def fit_power_law(xs: Sequence[float], ys: Sequence[float], m: float) -> float:
    """Least-squares coefficient k of y = k * x^m with fixed exponent m —
    linear in k, so the closed form replaces the reference's curve_fit."""
    xs_m = np.asarray(xs, np.float64) ** m
    ys = np.asarray(ys, np.float64)
    denom = float(np.dot(xs_m, xs_m))
    if denom == 0.0:
        raise ValueError("Cannot fit a power law to all-zero inputs")
    return float(np.dot(xs_m, ys) / denom)


def fit_scaling_law(
    flops_arr: Sequence[float],
    params_arr: Sequence[float],
    tokens_arr: Sequence[float],
    a: float,
    b: float,
) -> ScalingLaw:
    k_n = fit_power_law(flops_arr, params_arr, m=a)
    k_d = fit_power_law(flops_arr, tokens_arr, m=b)
    return ScalingLaw(a=a, b=b, k_n=k_n, k_d=k_d)


def fit_scaling_exponents(
    flops_arr: Sequence[float],
    params_arr: Sequence[float],
    tokens_arr: Sequence[float],
) -> ScalingLaw:
    """FREE-exponent fit: log-log linear regression for both laws
    (``log N_opt = a log C + log k_n``) — the Chinchilla approach-1 exponent
    extraction (arXiv:2203.15556 §3.1), used by the offline multi-model study
    to check exponent stability across seeds. ``fit_scaling_law`` (fixed
    exponents) remains the reference-parity fit
    (reference: examples/scaling/clm/scaling/laws.py:7-36 fixes a/b)."""
    lc = np.log(np.asarray(flops_arr, np.float64))
    a, lkn = np.polyfit(lc, np.log(np.asarray(params_arr, np.float64)), 1)
    b, lkd = np.polyfit(lc, np.log(np.asarray(tokens_arr, np.float64)), 1)
    return ScalingLaw(a=float(a), b=float(b), k_n=float(np.exp(lkn)), k_d=float(np.exp(lkd)))
