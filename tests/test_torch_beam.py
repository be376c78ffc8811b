"""The port's ``beam_search`` and ``make_generate_fn`` on the CPU (the plain
kernel versions), held to the JAX package's (``tests/test_generation.py``'s
beam tests and fixture: vocab 64, a 24-token window, 8 latents, seeded JAX
parameters carried across with ``convert.state_dict_from_jax``).

Held exactly: sequences (and greedy streams); within 1e-5: the
length-penalized scores. The port's search reorders its caches in place
(``index_select`` into the same buffers, JAX's ``take``) and slides the SA
windows by an in-place roll where they are full."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu_torch import generation as tgen
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.generation import GenerationConfig
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

VOCAB = 64
MAX_SEQ_LEN = 24
MAX_LATENTS = 8
B = 2
CONFIG = dict(vocab_size=VOCAB, max_seq_len=MAX_SEQ_LEN, max_latents=MAX_LATENTS, num_channels=32, num_heads=4,
              num_self_attention_layers=2, num_self_attention_rotary_layers=-1, output_norm=True)


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((B, MAX_SEQ_LEN), jnp.int32),
                     prefix_len=MAX_SEQ_LEN - MAX_LATENTS)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def prompt(seq_len=10):
    return np.random.default_rng(5).integers(0, VOCAB, size=(B, seq_len))


def _both(jm, params, tm, ids, **kw):
    """JAX's and the port's search on the same prompt: (sequences, scores)
    of each as numpy."""
    pad = kw.pop("pad_mask", None)
    js, jsc = jgen.beam_search(jm, params, jnp.asarray(ids), pad_mask=None if pad is None else jnp.asarray(pad), **kw)
    ts, tsc = tgen.beam_search(tm, ids, pad_mask=pad, device="cpu", **kw)
    return (np.asarray(js), np.asarray(jsc)), (ts.numpy(), tsc.numpy())


def test_beam_one_equals_greedy(models):
    """One beam is greedy decoding: the port's ``generate``, and JAX's."""
    jm, params, tm = models
    p = prompt(8)
    (js, _), (ts, _) = _both(jm, params, tm, p, num_latents=4, num_beams=1, max_new_tokens=6)
    greedy = tgen.generate(tm, p, 4, config=GenerationConfig(max_new_tokens=6), device="cpu").numpy()
    np.testing.assert_array_equal(ts, greedy)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("num_beams,length_penalty", [(2, 1.0), (4, 1.0), (4, 0.6)])
def test_beam_sequences_and_scores_equal_jax(models, num_beams, length_penalty):
    """Sequences exactly JAX's, scores within 1e-5."""
    jm, params, tm = models
    (js, jsc), (ts, tsc) = _both(jm, params, tm, prompt(8), num_latents=4, num_beams=num_beams, max_new_tokens=6,
                                 length_penalty=length_penalty)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=0)


def test_beam_one_equals_greedy_past_latent_window(models):
    """Deeper than max_latents (4 latents + 14 tokens > 8): the SA windows
    slide by the in-place roll exactly as ``generate``'s start counters
    mask them, and the beams equal JAX's."""
    jm, params, tm = models
    p = prompt(8)
    k = 14
    (js, jsc), (ts, tsc) = _both(jm, params, tm, p, num_latents=4, num_beams=1, max_new_tokens=k)
    greedy = tgen.generate(tm, p, 4, config=GenerationConfig(max_new_tokens=k), device="cpu").numpy()
    np.testing.assert_array_equal(ts, greedy)
    np.testing.assert_array_equal(ts, js)
    (js, jsc), (ts, tsc) = _both(jm, params, tm, p, num_latents=4, num_beams=3, max_new_tokens=k)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=0)


def test_beam_rejects_window_overflow_and_latent_pads(models):
    """Where JAX's search raises, the port's does: a window that would slide
    the CA cache, padding reaching into the latent region, no beams."""
    jm, params, tm = models
    for search, call in ((jgen.beam_search, lambda f, ids, **kw: f(jm, params, jnp.asarray(ids), **{
            k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})),
                         (tgen.beam_search, lambda f, ids, **kw: f(tm, ids, device="cpu", **kw))):
        with pytest.raises(ValueError, match="does not slide the window"):
            call(search, prompt(20), num_latents=8, max_new_tokens=8)
        ids, pad = np.zeros((B, 10), np.int64), np.zeros((B, 10), bool)
        pad[1, :8] = True  # 8 pads > prefix_len = 10 - 4 = 6
        with pytest.raises(ValueError, match="latent region"):
            call(search, ids, pad_mask=pad, num_latents=4, num_beams=2, max_new_tokens=4)
        with pytest.raises(ValueError, match="num_beams must be >= 1"):
            call(search, prompt(8), num_latents=4, num_beams=0, max_new_tokens=4)


def test_beam_padded_batch_equals_unpadded_rows(models):
    """Left padding: each padded row's beams equal the row searched alone
    without its pads, and the padded batch equals JAX's."""
    jm, params, tm = models
    ids = prompt(10)
    pad = np.zeros((B, 10), bool)
    pad[1, :3] = True
    ids[1, :3] = 0
    k = 6
    (js, jsc), (ts, tsc) = _both(jm, params, tm, ids, pad_mask=pad, num_latents=4, num_beams=3, max_new_tokens=k)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=0)
    out0, _ = tgen.beam_search(tm, ids[:1], num_latents=4, num_beams=3, max_new_tokens=k, device="cpu")
    out1, _ = tgen.beam_search(tm, ids[1:, 3:], num_latents=4, num_beams=3, max_new_tokens=k, device="cpu")
    np.testing.assert_array_equal(ts[0, -k:], out0[0, -k:].numpy())
    np.testing.assert_array_equal(ts[1, -k:], out1[0, -k:].numpy())


def test_eos_freezes_beams(models):
    """After a beam's first EOS it continues with PAD at no cost; sequences
    and (EOS-shortened) scores equal JAX's. EOS is each token of the
    unconstrained best beam in turn until a returned beam reaches it, at
    length penalty 0 (the summed log-probability), where a beam that ends
    early keeps its score and so wins."""
    jm, params, tm = models
    p = prompt(8)
    (_, _), (free, _) = _both(jm, params, tm, p, num_latents=4, num_beams=3, max_new_tokens=8)
    hit = 0
    for eos in dict.fromkeys(int(t) for t in free[0, 8:]):
        (js, jsc), (ts, tsc) = _both(jm, params, tm, p, num_latents=4, num_beams=3, max_new_tokens=8,
                                     eos_token_id=eos, pad_token_id=0, length_penalty=0.0)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=0)
        for row in ts[:, 8:]:
            hits = np.nonzero(row == eos)[0]
            if hits.size:
                hit += 1
                assert (row[hits[0] + 1:] == 0).all()
        if hit:
            break
    assert hit, "no beam reached EOS: the check is vacuous"


@pytest.mark.parametrize("sampling", [False, True])
def test_make_generate_fn_equals_generate(models, sampling):
    """``make_generate_fn`` is ``generate`` for every call: two prompt
    geometries, each twice (the second call of a geometry writes its
    prefill into the kept state), greedy and sampled with the same seed;
    greedy, JAX's ``make_generate_fn`` too."""
    jm, params, tm = models
    cfg = GenerationConfig(max_new_tokens=5, do_sample=sampling, temperature=0.8, top_k=10)
    fn = tgen.make_generate_fn(tm, 4, cfg, device="cpu")
    jfn = jgen.make_generate_fn(jm, 4, jgen.GenerationConfig(max_new_tokens=5))
    for seq_len, seed in ((8, 1), (10, 2), (8, 3), (10, 4)):
        ids = np.random.default_rng(seed).integers(0, VOCAB, size=(B, seq_len))
        got = fn(ids, None, torch.Generator().manual_seed(seed))
        want = tgen.generate(tm, ids, 4, config=cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
        assert torch.equal(got, want)
        if not sampling:
            np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(params, jnp.asarray(ids))))
    assert torch.equal(tgen.make_generate_fn(tm, 4, GenerationConfig(max_new_tokens=0), device="cpu")(ids),
                       torch.as_tensor(ids))
