"""The port's causal LM against the JAX package at the micro geometry
(``analysis/flagship.py``: 512 tokens, 128 latents, 64 channels, 4 heads, 2
layers), from the same parameters: the weight bridge, full-forward logits
(with and without left padding), per-step logits of a prefill plus
teacher-forced decode steps (with and without a sliding window), and greedy
token streams. Logit tolerance: atol 1e-4 (f32; the JAX package takes its
einsum attention route on the CPU, the port its flash route's plain
version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu.core import cache as jcache
from perceiver_io_tpu.hf.lightning_ckpt import export_causal_sequence_model_state_dict
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu_torch import generation as tgen
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core import cache as tcache
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**MICRO))
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def test_state_dict_bridge_matches_reference_export(models):
    """The port's parameter names are the reference torch names the JAX
    package exports, and the values are the same arrays (kernels
    transposed)."""
    _, params, tm = models
    sd = state_dict_from_jax(params)
    ref = export_causal_sequence_model_state_dict(params)
    assert sorted(sd) == sorted(ref) == sorted(tm.state_dict())
    for name, value in ref.items():
        np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)
        np.testing.assert_array_equal(tm.state_dict()[name].numpy(), value, err_msg=name)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
def test_forward_logits_match_jax(models, padded):
    jm, params, tm = models
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 262, size=(2, 300))
    pad = None
    if padded:
        pad = np.zeros((2, 300), bool)
        pad[1, :37] = True
    want = jm.apply(params, jnp.asarray(ids), prefix_len=200,
                    pad_mask=None if pad is None else jnp.asarray(pad)).logits
    with torch.no_grad():  # the cache-free forward is differentiable
        got = tm(torch.from_numpy(ids), prefix_len=200, pad_mask=None if pad is None else torch.from_numpy(pad))
    assert got.logits.shape == (2, 100, 262)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), atol=ATOL, rtol=0)


class _JaxRecorder:
    """``model.apply`` that keeps each call's last-position logits (traced
    values: read them inside the same ``jax.jit``)."""

    def __init__(self, model):
        self.model, self.config, self.logits = model, model.config, []

    def apply(self, *args, **kwargs):
        out = self.model.apply(*args, **kwargs)
        self.logits.append(out.logits[:, -1])
        return out


def _jax_step_with_logits(jm, config):
    """One step of ``make_decode_fns`` (its body, ``_decode_step_body``) that
    also returns the step's logits."""

    @jax.jit
    def step(params, carry, pad_slots, pos_shift):
        rec = _JaxRecorder(jm)
        carry, _ = jgen._decode_step_body(rec, jm.config, config, params, carry, pad_slots, pos_shift)
        return carry, rec.logits[0]

    return step


class _TorchRecorder:
    """The port model's ``__call__`` that keeps each call's last-position
    logits."""

    def __init__(self, model):
        self.model, self.config, self.device, self.logits = model, model.config, model.device, []

    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        self.logits.append(out.logits[:, -1].numpy())
        return out


@pytest.mark.parametrize(
    "seq_len,num_latents",
    [(300, 64), (506, 124)],  # the second slides both windows within 8 steps
    ids=["no_slide", "slides"],
)
def test_prefill_and_teacher_forced_decode_logits_match_jax(models, seq_len, num_latents):
    jm, params, tm = models
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 262, size=(1, seq_len))
    forced = rng.integers(0, 262, size=(8,))
    cfg = jgen.GenerationConfig(max_new_tokens=9)
    jprefill, _ = jgen.make_decode_fns(jm, num_latents, cfg)
    _, js = jprefill(params, jnp.asarray(ids), None, jax.random.PRNGKey(0))
    # the prompt pass's logits: the prefill's own forward over fresh caches
    caches = JaxCLM.init_cache(jm.config, 1, seq_len + 9, num_latents + 9)
    jlogits = [np.asarray(jax.jit(lambda p, x: jm.apply(
        p, x, prefix_len=seq_len - num_latents, pad_mask=jnp.zeros(x.shape, bool), kv_cache=caches,
    ).logits[:, -1])(params, jnp.asarray(ids)))]
    jstep = _jax_step_with_logits(jm, cfg)
    carry = (js["cache"], js["ca_start"], js["sa_start"], js["token"], js["rng"], js["done"])
    for t in forced:
        carry = carry[:3] + (jnp.asarray([t]),) + carry[4:]
        carry, logits = jstep(params, carry, js["pad_slots"], js["pos_shift"])
        jlogits.append(np.asarray(logits))
    trec = _TorchRecorder(tm)
    tprefill, tstep = tgen.make_decode_fns(trec, num_latents, tgen.GenerationConfig(max_new_tokens=9),
                                           device="cpu")
    _, tstate = tprefill(ids)
    for t in forced:
        tstate, _ = tstep(dict(tstate, token=torch.tensor([int(t)])))
    assert len(trec.logits) == len(jlogits) == 9
    for step, (got, want) in enumerate(zip(trec.logits, jlogits)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"step {step}")
    if seq_len + 8 > MICRO["max_seq_len"]:
        assert tstate["ca_start"] > 0 and tstate["sa_start"] > 0
        assert int(carry[1]) == tstate["ca_start"] and int(carry[2]) == tstate["sa_start"]


def test_shift_left_if_full_matches_jax():
    rng = np.random.default_rng(4)
    k, v = (rng.standard_normal((2, 6, 8)).astype(np.float32) for _ in range(2))
    for length in (5, 6):  # not full: unchanged; full: the oldest slot drops
        want = jgen._shift_left_if_full(jcache.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(length)))
        got = tgen._shift_left_if_full(tcache.KVCache(torch.from_numpy(k), torch.from_numpy(v), length))
        assert got.length == int(want.length)
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


def test_greedy_streams_match_jax(models):
    """Greedy decoding of a left-padded batch is token-exact against JAX."""
    jm, params, tm = models
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 262, size=(2, 200))
    pad = np.zeros((2, 200), bool)
    pad[0, :11] = True
    cfg = dict(max_new_tokens=12)
    jprefill, jstep = jgen.make_decode_fns(jm, 32, jgen.GenerationConfig(**cfg))
    tok, state = jprefill(params, jnp.asarray(ids), jnp.asarray(pad), jax.random.PRNGKey(0))
    want = [np.asarray(tok)]
    for _ in range(11):
        state, tok = jstep(state)
        want.append(np.asarray(tok))
    got = tgen.generate(tm, ids, 32, pad_mask=pad, config=tgen.GenerationConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got[:, 200:].numpy(), np.stack(want, axis=1))
