"""The port's fault handling and metrics log against the JAX package's, on
the CPU: ``DivergenceSentinel`` decisions over seeded ``(loss, skipped)``
sequences, ``RetryPolicy.delay``, ``call_with_retry``,
``find_nonfinite_leaf`` and ``QuarantineIterator`` on nested batches, the
``PreemptionGuard`` on real signals, and ``MetricsLogger``'s files for the
same calls (all but the ``time`` column) and ``truncate_after``. Every
comparison is exact: the modules are host code on Python numbers."""

import csv
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from perceiver_io_tpu.training import faults as jfaults
from perceiver_io_tpu.training import metrics as jmetrics
from perceiver_io_tpu_torch.obs.events import EventLog
from perceiver_io_tpu_torch.training import faults, metrics


def _sequence(seed, n=120):
    """Losses drifting down with noise, spikes, NaNs and in-step skips."""
    rng = np.random.default_rng(seed)
    out = []
    level = 5.0
    for _ in range(n):
        level *= 0.99
        r = rng.random()
        if r < 0.08:
            out.append((float("nan"), bool(rng.random() < 0.7)))
        elif r < 0.2:
            out.append((level * float(rng.uniform(5, 40)), False))
        elif r < 0.23:
            out.append((None, bool(rng.random() < 0.5)))
        else:
            out.append((level * float(rng.uniform(0.9, 1.1)), False))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(window=8, min_history=3, spike_factor=4.0, spike_patience=2, skip_limit=2, rollback_limit=3),
    dict(window=3, min_history=1, spike_factor=2.0, spike_patience=1, skip_limit=1, rollback_limit=0),
], ids=["default", "tight", "hair_trigger"])
def test_sentinel_decisions_equal_jaxs(seed, cfg):
    port, ref = faults.DivergenceSentinel(faults.SentinelConfig(**cfg)), jfaults.DivergenceSentinel(
        jfaults.SentinelConfig(**cfg))
    for step, (loss, skipped) in enumerate(_sequence(seed), 1):
        got, want = port.observe(step, loss, skipped), ref.observe(step, loss, skipped)
        assert (got.action, got.reason, got.detail) == (want.action, want.reason, want.detail), step
        if got.action == "rollback":
            port.reset_window()
            ref.reset_window()
    assert (port.skips, port.spikes, port.rollbacks) == (ref.skips, ref.spikes, ref.rollbacks)
    assert port.notify_rollback_unavailable().action == "halt"


@pytest.mark.parametrize("policy", [dict(), dict(base_delay=0.2, max_delay=5.0, jitter=0.5, seed=3),
                                    dict(jitter=0.0)])
def test_retry_policy_delay_equals_jaxs(policy):
    port, ref = faults.RetryPolicy(**policy), jfaults.RetryPolicy(**policy)
    assert [port.delay(a) for a in range(8)] == [ref.delay(a) for a in range(8)]


def test_call_with_retry_schedule_exhaustion_and_reraise():
    slept, seen = [], []
    policy = faults.RetryPolicy(max_retries=2, base_delay=0.1, jitter=0.0)

    def failing():
        raise OSError("flaky")

    with pytest.raises(faults.FetchRetriesExhausted):
        faults.call_with_retry(failing, policy, on_retry=lambda a, e, d: seen.append((a, d)), sleep=slept.append)
    assert seen == [(0, 0.1), (1, 0.2)] and slept == [0.1, 0.2]
    with pytest.raises(OSError, match="flaky"):
        faults.call_with_retry(failing, policy, sleep=lambda d: None, reraise=True)
    with pytest.raises(ValueError):  # not a transient type: no retry
        faults.call_with_retry(lambda: (_ for _ in ()).throw(ValueError("bad")), policy, sleep=slept.append)
    assert len(slept) == 2
    calls = iter([OSError("once"), None])

    def once():
        err = next(calls)
        if err:
            raise err
        return 7

    assert faults.call_with_retry(once, policy, sleep=lambda d: None) == 7


def test_fetch_retry_emitter_writes_events(tmp_path):
    log = EventLog(str(tmp_path))
    faults.fetch_retry_emitter(log)(1, OSError("x"), 0.25)
    (row,) = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    assert (row["event"], row["attempt"], row["error"], row["delay_s"]) == ("fault.fetch_retry", 1, "x", 0.25)


_TREES = [
    {"x": np.ones(3), "y": np.array([1.0, np.nan])},
    {"b": np.array([np.inf]), "a": np.array([np.nan])},  # sorted key order decides
    {"ids": np.array([1, 2]), "aux": [np.ones(2), (np.zeros(1), np.array([np.nan]))]},
    {"scalar": float("nan"), "ok": 1.0},
    {"mask": np.array([True, False]), "name": "text", "none": None, "f": np.float32(1.0)},
    [np.ones(2), {"k": np.array([np.nan], np.float32)}],
]


@pytest.mark.parametrize("tree", range(len(_TREES)))
def test_find_nonfinite_leaf_names_jaxs_path(tree):
    assert faults.find_nonfinite_leaf(_TREES[tree]) == jfaults.find_nonfinite_leaf(_TREES[tree])


def test_find_nonfinite_leaf_reads_torch_tensors():
    assert faults.find_nonfinite_leaf({"a": torch.ones(2), "b": torch.tensor([1.0, float("nan")])}) == "['b']"
    assert faults.find_nonfinite_leaf({"a": torch.ones(2, dtype=torch.bfloat16), "i": torch.arange(3)}) is None


def test_quarantine_iterator_drops_poison_and_bounds_the_drops():
    batches = [{"x": np.ones(2)}, {"x": np.array([np.nan, 1.0])}, {"x": np.full(2, 2.0)}]
    seen = []
    out = list(faults.QuarantineIterator(iter(batches), on_quarantine=lambda p, n: seen.append((p, n))))
    assert [b["x"][0] for b in out] == [1.0, 2.0] and seen == [("['x']", 1)]
    poison = ({"x": np.array([np.nan])} for _ in range(10))
    with pytest.raises(RuntimeError, match="3 consecutive poison batches"):
        list(faults.QuarantineIterator(poison, max_consecutive=3))


def test_preemption_guard_on_signals():
    guard = faults.PreemptionGuard()
    prev = signal.getsignal(signal.SIGTERM)
    assert guard.install()
    signal.raise_signal(signal.SIGTERM)
    assert guard.requested and guard.signal_count == 1
    guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev
    # a second SIGINT falls through to the previous handler (KeyboardInterrupt)
    with faults.PreemptionGuard(signals=(signal.SIGINT,)) as g2:
        signal.raise_signal(signal.SIGINT)
        assert g2.requested
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
    # trip() needs no signal, and a guard off the main thread installs nothing
    g3 = faults.PreemptionGuard()
    g3.trip()
    assert g3.requested
    result = []
    t = threading.Thread(target=lambda: result.append(faults.PreemptionGuard().install()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and result == [False]


def _rows(path):
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]


def test_metrics_logger_files_equal_jaxs(tmp_path):
    calls = [(1, {"train_loss": 5.5}), (2, {"train_loss": 5.25, "lr": 1e-3}), (2, {"val_loss": 5.0}),
             (3, {"train_loss": 4.75, "lr": 9e-4, "mfu": 0.25}), (4, {"train_loss": 4.5})]
    loggers = {"port": metrics.MetricsLogger(str(tmp_path / "port"), use_tensorboard=False),
               "jax": jmetrics.MetricsLogger(str(tmp_path / "jax"), use_tensorboard=False)}
    for logger in loggers.values():
        for step, m in calls:
            logger.log(step, m)
        logger.log_text(4, "sample", "hello")
        logger.log_hparams({"lr": 1e-3})
    port, jax_ = _rows(tmp_path / "port" / "metrics.csv"), _rows(tmp_path / "jax" / "metrics.csv")
    assert port == jax_ and len(port) == 5
    for name in ("samples.txt", "hparams.json"):
        assert open(tmp_path / "port" / name).read() == open(tmp_path / "jax" / name).read()
    assert loggers["port"].truncate_after(2) == loggers["jax"].truncate_after(2) == 2
    assert _rows(tmp_path / "port" / "metrics.csv") == _rows(tmp_path / "jax" / "metrics.csv")
    # resuming into an existing file keeps one header; truncation is idempotent
    again = metrics.MetricsLogger(str(tmp_path / "port"), use_tensorboard=False)
    assert again.truncate_after(2) == 0
    again.log(3, {"train_loss": 1.0})
    with open(tmp_path / "port" / "metrics.csv") as f:
        assert sum(line.startswith("step,") for line in f) == 1
    assert [r["step"] for r in _rows(tmp_path / "port" / "metrics.csv")] == ["1", "2", "2", "3"]


def test_metrics_logger_writes_on_the_main_process_only(tmp_path):
    logger = metrics.MetricsLogger(str(tmp_path / "off"), use_tensorboard=False, main_process=False)
    logger.log(1, {"x": 1.0})
    assert not os.path.exists(tmp_path / "off")
