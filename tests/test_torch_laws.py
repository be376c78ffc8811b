"""The port's scaling-law fit (``utils/laws.py``, numpy only) held to the
JAX package's within 1e-12 relative: the fixed-exponent coefficients, the
free-exponent log-log fit, the laws' predictions and their refusal of
all-zero inputs."""

import numpy as np
import pytest

from perceiver_io_tpu.utils import laws as jax_laws
from perceiver_io_tpu_torch import utils
from perceiver_io_tpu_torch.utils import laws

REL = 1e-12


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def _study(seed):
    """Chinchilla-like (FLOPs, params, tokens) triples with seeded noise."""
    rng = np.random.default_rng(seed)
    flops = np.logspace(18, 22, 7) * rng.uniform(0.8, 1.2, 7)
    params = 0.1 * flops**0.5 * rng.lognormal(0.0, 0.05, 7)
    tokens = flops / (6 * params)
    return flops, params, tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fits_equal_jax(seed):
    flops, params, tokens = _study(seed)
    for ours, theirs in ((laws.fit_scaling_law(flops, params, tokens, 0.5, 0.5),
                          jax_laws.fit_scaling_law(flops, params, tokens, 0.5, 0.5)),
                         (laws.fit_scaling_exponents(flops, params, tokens),
                          jax_laws.fit_scaling_exponents(flops, params, tokens))):
        for field in ("a", "b", "k_n", "k_d"):
            assert _close(getattr(ours, field), getattr(theirs, field)), field
        for c in (1e19, 3.3e21, 1e24):
            assert _close(ours.n_opt(c), theirs.n_opt(c)) and _close(ours.d_opt(c), theirs.d_opt(c))
        assert str(ours) == str(theirs)
    free = laws.fit_scaling_exponents(flops, params, tokens)
    assert free.a == pytest.approx(0.5, abs=0.05) and free.a + free.b == pytest.approx(1.0, abs=1e-9)
    assert _close(laws.fit_power_law(flops, params, 0.5), jax_laws.fit_power_law(flops, params, 0.5))


def test_refusals_and_exports():
    for mod in (laws, jax_laws):
        with pytest.raises(ValueError, match="all-zero"):
            mod.fit_power_law([0.0, 0.0], [1.0, 2.0], 0.5)
    assert utils.ScalingLaw is laws.ScalingLaw and utils.fit_scaling_law is laws.fit_scaling_law
    assert set(utils.__all__) == {"ScalingLaw", "fit_power_law", "fit_scaling_exponents", "fit_scaling_law"}
