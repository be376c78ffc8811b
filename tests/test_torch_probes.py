"""The port's numerics probes (``perceiver_io_tpu_torch/obs/probes.py``)
against the JAX package's (``tests/test_probes.py``), on the CPU at that
file's micro CLM (50 tokens, 24-token window, 8 latents, 32 channels, 4
heads, 2 layers), the prefix keep set passed in to both packages.

Tolerances (f32):

- activation stats (rms, absmax) within rtol 1e-5; non-finite and zero
  fractions exact;
- gradient buckets (l2, absmax) within ``tests/test_torch_train.py``'s
  gradient tolerance, 4e-6 relative; non-finite fractions exact;
- update ratios within that file's parameter tolerance (atol 1e-6 a
  parameter) taken over the bucket: ``|ratio - ratio_jax| * ||p_old|| <=
  1e-6 * sqrt(n)``;
- decode entropy within 1e-5; occupancy and non-finite fractions exact."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perceiver_io_tpu.generation import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.generation import make_decode_fns as jax_make_decode_fns
from perceiver_io_tpu.generation import make_instrumented_generate_fn as jax_instrumented
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs import probes as JP
from perceiver_io_tpu.obs.events import EventLog as JaxEventLog
from perceiver_io_tpu.training import MetricsLogger as JaxMetricsLogger
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import Trainer as JaxTrainer
from perceiver_io_tpu.training import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import make_optimizer as jax_make_optimizer
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import generation as tg
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs import probes as TP
from perceiver_io_tpu_torch.obs.events import EventLog, validate_events

CFG = dict(vocab_size=50, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
           num_self_attention_layers=2, cross_attention_dropout=0.5)
LATENTS, PREFIX = 8, 16
ACT_RTOL, GRAD_RTOL, PARAM_ATOL, ENTROPY_ATOL = 1e-5, 4e-6, 1e-6, 1e-5


@pytest.fixture(scope="module")
def params():
    jm = JaxCLM(JaxCLMConfig(**CFG))
    ids = np.random.default_rng(0).integers(0, 50, size=(4, 24))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=PREFIX))


def port_model(params, **options):
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CFG, **options), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return tm


def clm_batch(seed: int, b: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 50, size=(b, 25))
    keep = jpd.sample_prefix_keep_idx(rng, b, PREFIX, 0.5)
    return {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None, "prefix_keep_idx": keep}


def jax_batch(batch):
    return {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}


_JAX_STEPS = {}


def probed_steps(params, microbatch=1, options=None, batch=None, sentinel=False):
    """One probed train step of each package from the same weights and
    batch: (JAX's host snapshot, the port's host snapshot, the port's
    parameter buckets before the step). ``options`` go to the port's model
    alone: they change how a step is computed, not what (JAX's probes leak
    a tracer out of ``nn.remat``, so its reference step is the plain one)."""
    options = options or {}
    batch = batch if batch is not None else clm_batch(1)
    jm = JaxCLM(JaxCLMConfig(**CFG))
    jstate = JaxTrainState.create(jm.apply, params, jax_make_optimizer(1e-3), jax.random.PRNGKey(1))
    if (microbatch, sentinel) not in _JAX_STEPS:  # one compiled step for every test that shares it
        _JAX_STEPS[microbatch, sentinel] = jax_make_train_step(
            jax_clm_loss_fn(jm.apply, max_latents=LATENTS), donate=False, microbatch=microbatch, sentinel=sentinel,
            probes=JP.ProbeConfig())
    _, jmetrics = _JAX_STEPS[microbatch, sentinel](jstate, jax_batch(batch))
    tm = port_model(params, **options)
    before = {b: [p.detach().clone() for p in ps] for b, ps in TP.param_buckets(tm).items()}
    tstate = tt.TrainState.create(tm, tt.make_optimizer(1e-3))
    tstep = tt.make_train_step(tt.clm_loss_fn(LATENTS), microbatch=microbatch, sentinel=sentinel,
                               probes=TP.ProbeConfig())
    _, tmetrics = tstep(tstate, batch)
    return JP.snapshot_to_host(jmetrics["probes"]), TP.snapshot_to_host(tmetrics["probes"]), before


def assert_snapshots_match(want, got, before):
    assert list(got) == list(want)  # JAX's keys, in JAX's order
    for key, stats in want.items():
        scope = TP.scope_of(key)
        assert sorted(got[key]) == sorted(stats), key
        for stat, w in stats.items():
            g = got[key][stat]
            if stat in ("nonfinite_frac", "zero_frac"):
                assert g == w, (key, stat, g, w)
            elif scope.startswith("update."):
                olds = before[scope[len("update."):]]
                n = sum(o.numel() for o in olds)
                norm = math.sqrt(sum(float(torch.sum(o.double() ** 2)) for o in olds))
                assert abs(g - w) * (norm + 1e-12) <= PARAM_ATOL * math.sqrt(n), (key, g, w)
            else:
                rtol = GRAD_RTOL if scope.startswith("grad.") else ACT_RTOL
                assert abs(g - w) <= rtol * abs(w), (key, stat, g, w)


# ---------------------------------------------------------------------------
# the tap
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """The aten operators dispatched inside it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_probe_is_identity_and_noop_without_collector():
    x = torch.arange(6.0).reshape(2, 3)
    with _Ops() as ops:
        assert TP.probe("anything", x) is x  # no collector: the very same tensor
    assert ops.ops == []  # and nothing dispatched
    with TP.collecting(TP.ProbeConfig(scopes=("nomatch*",))) as col, _Ops() as ops:
        assert TP.probe("scope", x) is x
    assert col.stats == {} and ops.ops == []  # scope filter: nothing collected
    with TP.collecting(TP.ProbeConfig()) as col:
        assert TP.probe("scope", x) is x
        TP.probe("scope", x)
        with TP.suspended():
            TP.probe("scope", x)  # a recompute: not collected
    assert list(col.stats) == ["000:scope", "001:scope#1"]
    assert not TP.active()


@pytest.mark.parametrize("case", ["plain", "zeros_and_nan", "inf", "bf16"])
def test_activation_stats_match_jax(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    if case == "zeros_and_nan":
        x[0, :2] = 0.0
        x[1, 0, 0] = np.nan
    elif case == "inf":
        x[2, 1, 3] = -np.inf
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if case == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if case == "bf16" else torch.float32)
    want = {k: float(v) for k, v in JP.activation_stats(jx).items()}
    got = {k: float(v) for k, v in TP.activation_stats(tx).items()}
    assert sorted(got) == sorted(want)
    for k in ("nonfinite_frac", "zero_frac"):
        assert got[k] == want[k], k
    for k in ("rms", "absmax"):
        if math.isnan(want[k]) or math.isinf(want[k]):
            assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), k
        else:
            assert abs(got[k] - want[k]) <= ACT_RTOL * abs(want[k]), (k, got[k], want[k])


# ---------------------------------------------------------------------------
# the probed train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "microbatch2", "remat"])
def test_probed_train_step_matches_jax(params, variant):
    """Activations (embed, each attention output, cross_attend, each layer,
    logits), then every ``grad.*`` bucket, then every ``update.*`` bucket:
    JAX's keys in JAX's order and values, also with two chunks (the chunk
    average) and under activation checkpointing (no scope collected twice:
    the backward's recompute runs without a collector)."""
    microbatch = 2 if variant == "microbatch2" else 1
    options = {"activation_checkpointing": True} if variant == "remat" else {}
    want, got, before = probed_steps(params, microbatch, options)
    names = [TP.scope_of(k) for k in got]
    assert names[:3] == ["perceiver_ar.embed", "attention.out", "perceiver_ar.cross_attend"]
    assert "self_attention.layer_1" in names and "logits" in names
    assert len(names) == len(set(names))
    assert any(n == "grad.params.perceiver_ar.self_attention.layer_0" for n in names)
    assert any(n.startswith("update.") for n in names)
    assert_snapshots_match(want, got, before)


def test_probes_off_step_is_todays_step(params):
    """``probes=None`` runs the step without probes: the same operators as
    after a collector was opened and closed (nothing leaks), no ``probes``
    metric, and the probed step's losses and parameters equal it bit for
    bit (the probes only read)."""
    batch = clm_batch(2)

    def one_step(probes, record=False):
        tm = port_model(params)
        state = tt.TrainState.create(tm, tt.make_optimizer(1e-3))
        step = tt.make_train_step(tt.clm_loss_fn(LATENTS), microbatch=2, sentinel=True, probes=probes)
        with _Ops() as ops:
            _, metrics = step(state, batch)
        return metrics, [p.detach().clone() for p in tm.parameters()], ops.ops

    plain, plain_params, plain_ops = one_step(None)
    with TP.collecting(TP.ProbeConfig()):
        pass
    again, again_params, again_ops = one_step(None)
    probed, probed_params, probed_ops = one_step(TP.ProbeConfig())
    assert "probes" not in plain and "probes" in probed
    assert plain_ops == again_ops and len(probed_ops) > len(plain_ops)
    for k in plain:
        assert torch.equal(plain[k], probed[k]) and torch.equal(plain[k], again[k]), k
    for a, b in zip(plain_params, probed_params):
        assert torch.equal(a, b)


def test_blast_report_names_the_same_scope_as_jax(params):
    """A NaN planted in layer 1's MLP: both packages' reports over the probed
    step's snapshot name ``self_attention.layer_1`` (the attention before it
    stays finite), with the same blast radius."""
    poisoned = jax.tree.map(np.copy, params)
    poisoned["params"]["perceiver_ar"]["self_attention"]["layer_1"]["mlp"]["dense_2"]["kernel"][0, 0] = np.nan
    want, got, _ = probed_steps(poisoned)
    jrep, trep = JP.blast_report([(jnp.int32(1), want)]), TP.blast_report([(1, got)])
    assert trep["scope"] == jrep["scope"] == "self_attention.layer_1"
    assert trep["affected"] == jrep["affected"]
    assert (trep["step"], trep["n_affected"], trep["n_scopes"]) == (jrep["step"], jrep["n_affected"],
                                                                    jrep["n_scopes"])
    # the ring walk: the earliest non-finite snapshot, its first scope
    clean = {TP.ordered_key(0, "embed"): {"rms": torch.tensor(1.0), "nonfinite_frac": torch.tensor(0.0)}}
    assert TP.blast_report([(3, clean)]) is None
    rep = TP.blast_report([(3, clean), (4, got), (5, got)])
    assert rep["step"] == 4 and rep["scope"] == "self_attention.layer_1"


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def toy_batches(n, poison_at=()):
    rng = np.random.default_rng(0)
    out = []
    for i in range(1, n + 1):
        x = rng.normal(size=(4, 8)).astype(np.float32)
        if i in poison_at:
            x = x.copy()
            x[0, 0] = np.nan
        out.append({"x": x, "y": x @ np.ones((8, 2), np.float32)})
    return out


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(8, 2))


def toy_loss(model, batch, generator=None):
    pred = TP.probe("toy.pred", torch.as_tensor(batch["x"]) @ model.w)
    loss = torch.mean((pred - torch.as_tensor(batch["y"])) ** 2)
    return loss, {"loss": loss}


def jax_toy_loss(params, batch, rng):
    pred = JP.probe("toy.pred", batch["x"] @ params["w"])
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"loss": loss}


def fit_rows(tmp_path, side, probes, sentinel=True, max_steps=8, log_interval=2, poison_at=(3, 6)):
    out = str(tmp_path / side)
    if side == "jax":
        state = JaxTrainState.create(None, {"w": jnp.zeros((8, 2))}, jax_make_optimizer(1e-2), jax.random.PRNGKey(0))
        logger = JaxMetricsLogger(out, use_tensorboard=False)
        trainer = JaxTrainer(jax_toy_loss, logger=logger, config=JaxTrainerConfig(
            max_steps=max_steps, log_interval=log_interval, prefetch_batches=0, graphlint=False, graphcheck=False,
            sentinel=sentinel, probes=probes))
    else:
        state = tt.TrainState.create(Toy(), tt.make_optimizer(1e-2))
        logger = tt.MetricsLogger(out, use_tensorboard=False)
        trainer = tt.Trainer(toy_loss, logger=logger, config=tt.TrainerConfig(
            max_steps=max_steps, log_interval=log_interval, prefetch_batches=0, sentinel=sentinel, probes=probes))
    try:
        trainer.fit(state, iter(toy_batches(max_steps, poison_at)))
    finally:
        trainer.close()
        logger.close()
    return [json.loads(line) for line in open(f"{out}/events.jsonl") if line.strip()], out


def test_trainer_probed_fit_emits_probe_rows_and_blasts_as_jax(tmp_path):
    """A probed, sentineled fit over a stream with NaN batches 3 and 6:
    ``probe`` rows at the log boundaries with the planted site and the
    gradient buckets, two ``probe.blast`` rows (steps 3 and 6: the ring is
    cleared after each), ``trigger="skip"``, ``scope="toy.pred"``, inside
    a step span; as JAX's fit emits them."""
    got = {}
    for side in ("jax", "torch"):
        rows, out = fit_rows(tmp_path, side, probes=True)
        probe_rows = [r for r in rows if r["event"] == "probe"]
        assert probe_rows
        for r in probe_rows:
            scopes = {TP.scope_of(k) for k in r["scopes"]}
            assert "toy.pred" in scopes and any(s.startswith("grad.") for s in scopes)
        blasts = [r for r in rows if r["event"] == "probe.blast"]
        span_ids = {r.get("span_id") for r in rows if r["event"] == "span"}
        assert all(b.get("span_id") in span_ids for b in blasts)
        assert blasts[0]["stats"]["nonfinite_frac"] > 0
        got[side] = ([(b["step"], b["trigger"], b["scope"], b["stats"]["nonfinite_frac"]) for b in blasts],
                     [r["step"] for r in probe_rows])
    assert got["torch"] == got["jax"]
    assert [b[:3] for b in got["torch"][0]] == [(3, "skip", "toy.pred"), (6, "skip", "toy.pred")]
    assert validate_events(str(tmp_path / "torch"), warnings_out=[]) == []


def test_blast_fires_on_host_detected_divergence_too(tmp_path):
    """Host detection only (``in_graph_skip=False``): the NaN loss goes to the
    rollback rung, halts without a checkpoint, and the blast still names the
    planted site, ``trigger="halt"``."""
    state = tt.TrainState.create(Toy(), tt.make_optimizer(1e-2))
    logger = tt.MetricsLogger(str(tmp_path), use_tensorboard=False)
    trainer = tt.Trainer(toy_loss, logger=logger, config=tt.TrainerConfig(
        max_steps=6, log_interval=1, prefetch_batches=0, sentinel=tt.SentinelConfig(in_graph_skip=False),
        probes=TP.ProbeConfig(ring=3)))
    with pytest.raises(tt.DivergenceHalt):
        trainer.fit(state, iter(toy_batches(6, poison_at=(3,))))
    trainer.close()
    logger.close()
    rows = [json.loads(line) for line in open(tmp_path / "events.jsonl") if line.strip()]
    blasts = [r for r in rows if r["event"] == "probe.blast"]
    assert blasts and blasts[0]["scope"] == "toy.pred" and blasts[0]["trigger"] == "halt"


def test_trainer_probes_off_adds_nothing(tmp_path):
    rows, _ = fit_rows(tmp_path, "torch", probes=False, poison_at=())
    kinds = {r["event"] for r in rows}
    assert "probe" not in kinds and "probe.blast" not in kinds and "log" in kinds


# ---------------------------------------------------------------------------
# decode health
# ---------------------------------------------------------------------------


def test_decode_health_of_the_pair_matches_jax(params):
    """``make_decode_fns(probes=True)``: the prompt pass's gauges, then each
    step's, as JAX's pair computes them; the stream and the state's other
    keys are those of the pair without probes."""
    jm = JaxCLM(JaxCLMConfig(**CFG))
    tm = port_model(params)
    prompt = np.random.default_rng(1).integers(0, 50, size=(2, 12))
    jpre, jstep = jax_make_decode_fns(jm, 4, JaxGenerationConfig(max_new_tokens=4), probes=True)
    _, jst = jpre(params, jnp.asarray(prompt))
    tpre, tstep = tg.make_decode_fns(tm, 4, tg.GenerationConfig(max_new_tokens=4), probes=True, device="cpu")
    _, tst = tpre(prompt)
    opre, ostep = tg.make_decode_fns(tm, 4, tg.GenerationConfig(max_new_tokens=4), device="cpu")
    _, ost = opre(prompt)
    assert "probe" not in ost
    for i in range(3):
        want = {k: float(v) for k, v in jax.device_get(jst["probe"]).items()}
        got = {k: float(v) for k, v in tst["probe"].items()}
        assert sorted(got) == sorted(want) == ["kv_cache_frac", "logit_entropy", "nonfinite_logit_frac"]
        assert got["kv_cache_frac"] == want["kv_cache_frac"] == (12 + i) / 16
        assert got["nonfinite_logit_frac"] == want["nonfinite_logit_frac"] == 0.0
        assert abs(got["logit_entropy"] - want["logit_entropy"]) <= ENTROPY_ATOL
        assert 0.5 * math.log(50) < got["logit_entropy"] <= math.log(50) + 1e-3
        jst, jtok = jstep(jst)
        tst, ttok = tstep(tst)
        ost, otok = ostep(ost)
        assert torch.equal(ttok, otok) and np.array_equal(np.asarray(jtok), ttok.numpy())


def test_decode_health_entropy_selects_zero_where_logp_is_not_finite():
    """-inf logits (a masked vocabulary) and NaN logits give a finite
    entropy, as JAX's ``where(isfinite(logp), ...)`` does."""
    logits = np.array([[0.0, -np.inf, 1.0, 2.0], [np.nan, 0.0, 0.0, 0.0]], np.float32)

    class Cache:
        length, capacity = 5, 8

    want = {k: float(v) for k, v in JP.decode_health(jnp.asarray(logits), Cache, jnp.int32(1)).items()}
    got = {k: float(v) for k, v in TP.decode_health(torch.from_numpy(logits), Cache, torch.tensor(1)).items()}
    assert math.isfinite(got["logit_entropy"])
    assert abs(got["logit_entropy"] - want["logit_entropy"]) <= ENTROPY_ATOL
    assert got["kv_cache_frac"] == want["kv_cache_frac"] == 0.5
    assert got["nonfinite_logit_frac"] == want["nonfinite_logit_frac"] == 0.25


def test_instrumented_generate_publishes_decode_health_as_jax(params, tmp_path):
    """The request row's ``kv_cache_frac``, ``logit_entropy_mean``/``_last``
    and ``nonfinite_logit_frac``, ``GenerationStats.nonfinite_logit_frac``,
    the ``generate_kv_cache_frac`` gauge and one ``generate_logit_entropy``
    sample a token; without probes none of them."""
    prompt = np.random.default_rng(2).integers(0, 50, size=(2, 10))
    rows = {}
    for side in ("jax", "torch", "off"):
        out = str(tmp_path / side)
        if side == "jax":
            events = JaxEventLog(out, main_process=True)
            fn = jax_instrumented(JaxCLM(JaxCLMConfig(**CFG)), num_latents=4,
                                  config=JaxGenerationConfig(max_new_tokens=5), events=events, probes=True,
                                  snapshot_interval_s=0.0)
            _, stats = fn(params, jnp.asarray(prompt))
        else:
            events = EventLog(out, main_process=True)
            fn = tg.make_instrumented_generate_fn(port_model(params), num_latents=4,
                                                  config=tg.GenerationConfig(max_new_tokens=5), events=events,
                                                  probes=side == "torch", snapshot_interval_s=0.0, device="cpu")
            _, stats = fn(prompt)
        req = [json.loads(line) for line in open(f"{out}/events.jsonl") if line.strip()]
        req = [r for r in req if r["event"] == "request"][-1]
        rows[side] = (req, stats, fn.registry.snapshot())
    (jreq, jstats, jsnap), (treq, tstats, tsnap) = rows["jax"], rows["torch"]
    assert treq["kv_cache_frac"] == jreq["kv_cache_frac"]
    assert treq["nonfinite_logit_frac"] == jreq["nonfinite_logit_frac"] == 0.0
    for key in ("logit_entropy_mean", "logit_entropy_last"):
        assert abs(treq[key] - jreq[key]) <= ENTROPY_ATOL
    assert tstats.nonfinite_logit_frac == jstats.nonfinite_logit_frac == 0.0
    assert tsnap["gauges"]["generate_kv_cache_frac"] == pytest.approx(treq["kv_cache_frac"])
    assert tsnap["histograms"]["generate_logit_entropy"]["n"] == jsnap["histograms"]["generate_logit_entropy"]["n"] == 5
    off_req, off_stats, off_snap = rows["off"]
    assert not {"kv_cache_frac", "logit_entropy_mean", "nonfinite_logit_frac"} & set(off_req)
    assert off_stats.nonfinite_logit_frac is None and "generate_logit_entropy" not in off_snap["histograms"]
    assert validate_events(str(tmp_path / "torch"), warnings_out=[]) == []
