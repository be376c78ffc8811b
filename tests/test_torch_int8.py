"""int8 KV caches and int8 weights in the port, held to the JAX package on the
CPU (the plain kernel versions; JAX's prefill runs its packed flash kernel in
interpret mode under ``default_flash(True)``, the route it takes on its chip,
which attends over the fresh, unquantized keys as the port's prefill does).

Held exactly: ``quantize_kv``, ``quantize_tensor`` (against JAX's transposed
``q``/``scale``) and ``dequantize_weights``; the greedy streams of
``generate``, ``make_decode_fns`` and ``make_generate_fn`` with an int8
cache, int8 weights and both; ``beam_search``'s sequences over an int8 cache
(scores within 1e-5); the speculative pair on both int8 stores against the
int8 sequential stream; the engine's streams, books and eviction counts on
int8 pools and weights, against JAX's engine, with no prefix hit; a poisoned
request's books under int8 weights. Held within 1e-5 (f32): each cached
attention route (contiguous decode, folded and dequantized, the paged gather
route, the span and the prefill) over JAX's own int8 cache contents, with
inputs and weights on a coarse dyadic grid, so that both packages project
the new tokens to the same floats and quantize them to the same int8 rows
(the attention's own sums are the only difference)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu import serving as jax_serving
from perceiver_io_tpu.core import cache as jcache
from perceiver_io_tpu.core.attention import MultiHeadAttention as JaxMHA
from perceiver_io_tpu.core.attention import prefill_mode
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.loadgen import WorkloadSpec as JaxWorkloadSpec
from perceiver_io_tpu.ops import quant as jquant
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu_torch import generation as tgen
from perceiver_io_tpu_torch import serving
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core import cache as tcache
from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
from perceiver_io_tpu_torch.generation import GenerationConfig
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.obs.loadgen import WorkloadSpec
from perceiver_io_tpu_torch.ops import quant as tquant

VOCAB, NUM_LATENTS = 64, 4
CONFIG = dict(vocab_size=VOCAB, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.5)
ENGINE = dict(slots=4, page_size=8, max_ca_tokens=16, max_sa_tokens=8)
# (cache_dtype, weight_dtype) pairs of both packages
STORES = {"int8_cache": ((jnp.int8, None), (torch.int8, None)),
          "int8_weights": ((jnp.float32, jnp.int8), (torch.float32, torch.int8)),
          "both": ((jnp.int8, jnp.int8), (torch.int8, torch.int8))}


@pytest.fixture(scope="module")
def models():
    jm = JaxCLM(JaxCLMConfig(**CONFIG))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(1, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=8)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


def _bf16(x) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)


def _bits(x) -> np.ndarray:
    return x.view(torch.int16).numpy() if torch.is_tensor(x) else np.asarray(x).view(np.int16)


def _flash():
    """JAX's prefill on its kernel route (interpret mode off the TPU)."""
    return default_flash(True)


# ------------------------------------------------------------ the quantizers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_jax_bit_for_bit(dtype):
    """Per-token int8 with bf16 scales: values, scales (bits) and the
    bf16(1.0079) nudge, over magnitudes from 1e-3 to 1e2 and an all-zero
    token, in f32 and bf16 inputs."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 40, 64)) * rng.lognormal(0, 3, (3, 40, 1))).astype(np.float32)
    x[0, 0] = 0.0
    jq, js = jcache.quantize_kv(jnp.asarray(x).astype(getattr(jnp, dtype)))
    tq, ts = tcache.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    amax = np.abs(x).max(-1)
    stored = np.asarray(jnp.maximum(jnp.asarray(amax) / 127.0, 1e-8).astype(jnp.bfloat16)).astype(np.float32)
    assert dtype == "bfloat16" or (stored * 127 < amax).any()  # the nudge is exercised


def _jax_leaves(tree):
    """JAX's quantized tree split into a tree of ``q`` and one of ``scale``."""
    is_q = lambda x: isinstance(x, jquant.QuantizedTensor)  # noqa: E731
    qs = jax.tree.map(lambda x: np.asarray(x.q) if is_q(x) else np.asarray(x), tree, is_leaf=is_q)
    scales = jax.tree.map(lambda x: np.asarray(x.scale) if is_q(x) else np.asarray(x), tree, is_leaf=is_q)
    return qs, scales, sum(is_q(x) for x in jax.tree.leaves(tree, is_leaf=is_q))


def test_quantize_weights_are_jax_transposed_bit_for_bit(models):
    """Every ``nn.Linear`` weight and only those (JAX: every ``kernel``
    leaf): ``q`` and ``scale`` equal JAX's ``q.T`` and ``scale.T`` exactly,
    through the converter's names; embeddings, LayerNorm parameters and
    biases are not quantized; ``min_size`` selects by element count."""
    _, params, tm = models
    jq = jquant.quantize_weights(params)
    qs, scales, n_kernels = _jax_leaves(jq)
    want_q, want_scale = state_dict_from_jax(qs), state_dict_from_jax(scales)
    got = tquant.quantize_weights(tm)
    assert len(got) == n_kernels == 3 * (4 + 2)  # the CA and 2 SA layers: 4 projections, 2 MLP weights each
    for name, qt in got.items():
        assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32 and qt.scale.shape == (qt.q.shape[0], 1)
        np.testing.assert_array_equal(qt.q.float().numpy(), want_q[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(qt.scale.numpy(), want_scale[name].numpy(), err_msg=name)
    assert not any("embedding" in n or "norm" in n or n.endswith("bias") for n in got)
    big = tquant.quantize_weights(tm, min_size=32 * 32 * 4)
    assert set(big) == {n for n, qt in got.items() if qt.q.numel() >= 32 * 32 * 4} and 0 < len(big) < len(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weights_is_jax_bit_for_bit(models, dtype):
    _, params, tm = models
    jdeq = jquant.dequantize_weights(jquant.quantize_weights(params), getattr(jnp, dtype))
    want = state_dict_from_jax(jax.tree.map(lambda x: np.asarray(x).astype(np.float32), jdeq))
    got = tquant.dequantize_weights(tquant.quantize_weights(tm), getattr(torch, dtype))
    for name, w in got.items():
        assert w.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(w.float().numpy(), want[name].numpy(), err_msg=name)


# ---------------------------------------------- the cached attention routes


def _grid(rng, shape, step):
    """Values on a dyadic grid (multiples of ``step``, |x| <= 8 steps): the
    projections of such inputs by such weights are exact in f32."""
    return (rng.integers(-8, 9, size=shape) * step).astype(np.float32)


def _layers(h, c, rng):
    """A JAX and a port attention layer with the same grid weights (no
    biases)."""
    jmha = JaxMHA(num_heads=h, num_q_input_channels=c, num_kv_input_channels=c, causal_attention=True,
                  qkv_bias=False, out_bias=False)
    x = jnp.zeros((1, 1, c))
    jparams = jmha.init(jax.random.PRNGKey(0), x, x)
    jparams = jax.tree.map(lambda a: jnp.asarray(_grid(rng, a.shape, 1 / 32)), jparams)
    tmha = MultiHeadAttention(h, c, c, causal_attention=True, qkv_bias=False, out_bias=False)
    p = jax.tree.map(np.asarray, jparams)["params"]
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            getattr(tmha, name).weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
    return jmha, jparams, tmha


def _contiguous(jc: jcache.KVCache) -> tcache.KVCache:
    return tcache.KVCache(torch.from_numpy(np.asarray(jc.k).copy()), torch.from_numpy(np.asarray(jc.v).copy()),
                          int(jc.length), _bf16(jc.k_scale), _bf16(jc.v_scale))


def _paged(jc: jcache.PagedKVCache) -> tcache.PagedKVCache:
    return tcache.PagedKVCache(torch.from_numpy(np.asarray(jc.k).copy()), torch.from_numpy(np.asarray(jc.v).copy()),
                               torch.from_numpy(np.asarray(jc.page_table).copy()),
                               torch.from_numpy(np.asarray(jc.length).copy()), _bf16(jc.k_scale), _bf16(jc.v_scale))


def _same(tout, jout, tol=1e-5):
    err = float(np.abs(tout.last_hidden_state.numpy() - np.asarray(jout.last_hidden_state)).max())
    assert err <= tol, err
    tc, jc = tout.kv_cache, jout.kv_cache
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(np.asarray(getattr(tc, name)), np.asarray(getattr(jc, name)), err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(_bits(getattr(tc, name)), _bits(getattr(jc, name)), err_msg=name)


@pytest.mark.parametrize("heads", [4, 1])
def test_contiguous_decode_over_an_int8_cache_matches_jax(heads):
    """One query over a filled int8 cache: 4 heads take JAX's block-diagonal
    route, where the scales fold outside both products; 1 head its generic
    route, which dequantizes in full. A left pad masked, rotary encodings
    on. The appended row and its scales are JAX's bit for bit."""
    rng = np.random.default_rng(1)
    b, c, cap, length = 2, 32, 12, 7
    jmha, jparams, tmha = _layers(heads, c, rng)
    jc = jcache.init_kv_cache(b, cap, c, c, dtype=jnp.int8).append(
        jnp.asarray(rng.standard_normal((b, length, c)), jnp.float32),
        jnp.asarray(rng.standard_normal((b, length, c)), jnp.float32))
    x = _grid(rng, (b, 1, c), 1 / 8)
    pad = np.zeros((b, cap), bool)
    pad[1, 0] = True
    rope = _grid(rng, (b, 1, c // heads), 1 / 4)
    jout = jmha.apply(jparams, jnp.asarray(x), jnp.asarray(x), pad_mask=jnp.asarray(pad), rope_q=jnp.asarray(rope),
                      rope_k=jnp.asarray(rope), kv_cache=jc)
    assert tmha._folds_decode_scales(1) == (heads > 1)
    with torch.no_grad():
        tout = tmha(torch.from_numpy(x), torch.from_numpy(x), pad_mask=torch.from_numpy(pad),
                    rope_q=torch.from_numpy(rope), rope_k=torch.from_numpy(rope), kv_cache=_contiguous(jc))
    _same(tout, jout)


def _jax_paged(rng, s, n_pages, page, pps, c, lengths):
    table = np.zeros((s, pps), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, n in enumerate(lengths):
        for j in range(-(-(n + 3) // page)):
            table[i, j] = free.pop()
    empty = jcache.init_paged_kv_cache(s, n_pages, page, pps, c, c, dtype=jnp.int8)
    jc = jcache.PagedKVCache(k=empty.k, v=empty.v, page_table=jnp.asarray(table), length=jnp.zeros((s,), jnp.int32),
                             k_scale=empty.k_scale, v_scale=empty.v_scale)
    full = max(lengths)
    jc = jc.append_span(jnp.asarray(rng.standard_normal((s, full, c)), jnp.float32),
                        jnp.asarray(rng.standard_normal((s, full, c)), jnp.float32))
    return dataclasses.replace(jc, length=jnp.asarray(lengths, jnp.int32))


@pytest.mark.parametrize("n_q", [1, 3])
def test_paged_routes_over_int8_pools_match_jax(n_q):
    """The paged one-query gather route (scales folded, as JAX's) and the
    verify span (``append_span``, then the gather route with the pools
    dequantized in full), over JAX's int8 pools, page tables and ragged
    lengths (an idle slot on the scratch page among them), with a pad mask
    and rotary encodings."""
    rng = np.random.default_rng(2)
    s, page, pps, n_pages, c, h = 4, 4, 4, 17, 32, 4
    jc = _jax_paged(rng, s, n_pages, page, pps, c, [5, 2, 0, 9])
    jc = dataclasses.replace(jc, page_table=jc.page_table.at[2].set(0))
    jmha, jparams, tmha = _layers(h, c, rng)
    x = _grid(rng, (s, n_q, c), 1 / 8)
    pad = np.zeros((s, pps * page), bool)
    pad[0, 1] = pad[3, :2] = True
    rope = _grid(rng, (s, n_q, c // h), 1 / 4)
    jout = jmha.apply(jparams, jnp.asarray(x), jnp.asarray(x), pad_mask=jnp.asarray(pad), rope_q=jnp.asarray(rope),
                      rope_k=jnp.asarray(rope), kv_cache=jc)
    with torch.no_grad():
        tout = tmha(torch.from_numpy(x), torch.from_numpy(x), pad_mask=torch.from_numpy(pad),
                    rope_q=torch.from_numpy(rope), rope_k=torch.from_numpy(rope), kv_cache=_paged(jc))
    _same(tout, jout)


@pytest.mark.parametrize("n", [8, 128])
def test_prefill_into_an_empty_int8_cache_matches_jax(n):
    """The prompt pass over an empty int8 cache, rows and scales JAX's bit
    for bit. At 128 tokens JAX's prefill takes its kernel over the fresh,
    unquantized keys (interpret mode here), and so does the port's; at 8
    JAX's einsum reads the cache it just wrote, dequantized, and so does the
    port's (over int8 rows these are different functions)."""
    rng = np.random.default_rng(3)
    b, c, h = 2, 32, 4
    cap = n + 4
    jmha, jparams, tmha = _layers(h, c, rng)
    assert tmha._prefill_reads_fresh_keys(n, n) == (n >= 128)
    x = _grid(rng, (b, n, c), 1 / 8)
    rope = _grid(rng, (b, n, c // h), 1 / 4)
    jc = jcache.init_kv_cache(b, cap, c, c, dtype=jnp.int8)
    with _flash(), prefill_mode():
        jout = jmha.apply(jparams, jnp.asarray(x), jnp.asarray(x), rope_q=jnp.asarray(rope),
                          rope_k=jnp.asarray(rope), kv_cache=jc)
    with torch.no_grad():
        tout = tmha(torch.from_numpy(x), torch.from_numpy(x), rope_q=torch.from_numpy(rope),
                    rope_k=torch.from_numpy(rope), kv_cache=tcache.init_kv_cache(b, cap, c, c, dtype=torch.int8,
                                                                                 device="cpu"))
    _same(tout, jout)


# ---------------------------------------------------- the decode entry points


def _prompt(b=2):
    ids = np.random.default_rng(4).integers(0, VOCAB, size=(b, 12))
    pad = np.zeros((b, 12), bool)
    pad[1, :3] = True
    return ids, pad


# 14 new tokens after a 12-token prompt slide both windows (CA 24, SA 8)
CFG = GenerationConfig(max_new_tokens=14)


@pytest.fixture(scope="module")
def jax_streams(models):
    """JAX's greedy sequential streams (batch 2, a left-padded row), one per
    store."""
    jm, params, _ = models
    ids, pad = _prompt()
    out = {}
    for name, ((cache_dtype, weight_dtype), _) in STORES.items():
        with _flash():
            prefill, step = jgen.make_decode_fns(jm, NUM_LATENTS, jgen.GenerationConfig(max_new_tokens=14),
                                                 cache_dtype=cache_dtype, weight_dtype=weight_dtype)
            tok, state = prefill(params, jnp.asarray(ids), jnp.asarray(pad), jax.random.PRNGKey(0))
            toks = [np.asarray(tok)]
            for _ in range(CFG.max_new_tokens - 1):
                state, tok = step(state)
                toks.append(np.asarray(tok))
        out[name] = np.stack(toks, axis=1)
    return out


@pytest.mark.parametrize("entry", ["generate", "make_decode_fns", "make_generate_fn"])
@pytest.mark.parametrize("store", list(STORES))
def test_greedy_streams_equal_jax(models, jax_streams, store, entry):
    _, _, tm = models
    cache_dtype, weight_dtype = STORES[store][1]
    ids, pad = _prompt()
    kw = dict(cache_dtype=cache_dtype, weight_dtype=weight_dtype, device="cpu")
    if entry == "generate":
        got = tgen.generate(tm, ids, NUM_LATENTS, torch.from_numpy(pad), CFG, **kw)[:, 12:]
    elif entry == "make_generate_fn":
        fn = tgen.make_generate_fn(tm, NUM_LATENTS, CFG, **kw)
        got = fn(ids, torch.from_numpy(pad))[:, 12:]
        assert torch.equal(fn(ids, torch.from_numpy(pad))[:, 12:], got)  # a second call replays the same state
    else:
        prefill, step = tgen.make_decode_fns(tm, NUM_LATENTS, CFG, **kw)
        tok, state = prefill(ids, torch.from_numpy(pad))
        if cache_dtype == torch.int8:
            assert all(c.quantized and c.k.dtype == torch.int8 for c in state["cache"])
        toks = [tok]
        for _ in range(CFG.max_new_tokens - 1):
            state, tok = step(state)
            toks.append(tok)
        got = torch.stack(toks, dim=1)
    np.testing.assert_array_equal(got.numpy(), jax_streams[store])


def test_int8_weights_leave_the_model_and_its_prefill_float(models):
    """The decode step swaps the dequantized weights in for its body only:
    after a decode the model's parameters are the same tensors with the same
    values, and the int8 stream differs from the float one only through the
    weights (same prompt, same cache dtype)."""
    _, _, tm = models
    before = {n: (p, p.clone()) for n, p in tm.named_parameters()}
    ids, pad = _prompt()
    tgen.generate(tm, ids, NUM_LATENTS, torch.from_numpy(pad), CFG, weight_dtype=torch.int8, device="cpu")
    for n, p in tm.named_parameters():
        assert p is before[n][0] and torch.equal(p, before[n][1]), n


@pytest.mark.parametrize("store", ["int8_cache", "both"])
def test_beam_search_over_an_int8_cache_equals_jax(models, store):
    """Beams of 3 over an int8 cache (the SA windows roll with their scale
    planes; every step reorders rows and scales): sequences equal, scores
    within 1e-5."""
    jm, params, tm = models
    (jc, jw), (tc, tw) = STORES[store]
    ids = np.random.default_rng(5).integers(0, VOCAB, size=(2, 10))
    with _flash():
        jseq, jscore = jgen.beam_search(jm, params, jnp.asarray(ids), NUM_LATENTS, num_beams=3, max_new_tokens=8,
                                        cache_dtype=jc, weight_dtype=jw)
    seq, score = tgen.beam_search(tm, ids, NUM_LATENTS, num_beams=3, max_new_tokens=8, cache_dtype=tc,
                                  weight_dtype=tw, device="cpu")
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-5, rtol=0)


def test_speculative_pair_on_int8_stores_is_the_int8_sequential_stream(models):
    """The quantization levers compose (JAX's ``test_speculative_int8_stores_
    token_exact_greedy``): an int8 cache and int8 weights under the
    speculative pair (the drafter reading the same dequantized modules, its
    caches copies with their scale planes) reproduce the int8 sequential
    stream, which is JAX's."""
    jm, params, tm = models
    ids = np.random.default_rng(6).integers(0, VOCAB, size=(1, 10))
    cfg = GenerationConfig(max_new_tokens=4)  # within the latent window: a span never slides it
    kw = dict(cache_dtype=torch.int8, weight_dtype=torch.int8, device="cpu")
    prefill, step = tgen.make_speculative_decode_fns(tm, NUM_LATENTS, cfg, k=2, draft_depth=1, **kw)
    tok, state = prefill(ids)
    assert all(c.quantized for c in state["draft_cache"])
    assert state["draft_cache"][0].k_scale.data_ptr() != state["cache"][0].k_scale.data_ptr()
    spec = [int(tok[0])]
    while len(spec) < cfg.max_new_tokens:
        state, toks, m = step(state)
        spec.extend(int(t) for t in toks[0, : int(m[0])])
    seq = tgen.generate(tm, ids, NUM_LATENTS, None, cfg, **kw)[0, 10:].tolist()
    with _flash():
        jseq = jgen.generate(jm, params, jnp.asarray(ids), NUM_LATENTS, None, jgen.GenerationConfig(max_new_tokens=4),
                             jax.random.PRNGKey(0), cache_dtype=jnp.int8, weight_dtype=jnp.int8)
    assert spec[: cfg.max_new_tokens] == seq == np.asarray(jseq)[0, 10:].tolist()


def _bf16_decode(model, ids, gen_cfg, cache_dtype, weight_dtype, forced=None):
    """The decode pair's tokens and every step's logits, teacher-forced on
    ``forced`` where given."""
    prefill, step = tgen.make_decode_fns(model, 64, gen_cfg, cache_dtype, weight_dtype, device="cpu")
    token, state = prefill(ids)
    tokens, logits = [token], [state["logits"].clone()]
    for i in range(gen_cfg.max_new_tokens - 1):
        if forced is not None:
            state["token"].copy_(forced[:, i])
        state, token = step(state)
        tokens.append(token)
        logits.append(state["logits"].clone())
    return torch.stack(tokens, dim=1), torch.stack(logits, dim=1).float()


@pytest.fixture(scope="module")
def bf16_pair():
    """A bf16 model (8 heads of 16, 4 SA layers, a 512-token window), its
    prompt, and the bf16 pair's 24 tokens and logits (bf16 caches, float
    weights): the reference every store is held to, decoded once."""
    cfg = CausalLanguageModelConfig(vocab_size=262, max_seq_len=512, max_latents=64, num_channels=128, num_heads=8,
                                    num_self_attention_layers=4)
    model = CausalLanguageModel(cfg, device="cpu", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    ids = np.random.default_rng(1).integers(0, 262, size=(2, 512))
    gen_cfg = GenerationConfig(max_new_tokens=24)
    return (model, ids, gen_cfg, *_bf16_decode(model, ids, gen_cfg, torch.bfloat16, None))


@pytest.mark.parametrize("store", list(STORES))
def test_int8_decode_logits_stay_near_the_bf16_pair(bf16_pair, store):
    """A bf16 model (8 heads of 16, 4 SA layers, a 512-token window) decoding
    24 tokens on int8 stores, teacher-forced on the bf16 pair's tokens (bf16
    caches, float weights): every step's logits within 2e-2 of the bf16
    logits' largest magnitude (the CPU's worst here is 1.3e-2; quantization
    noise, no bug, sets this scale). The card's ``decode_int8_bf16`` states
    its bound from this error."""
    model, ids, gen_cfg, ref_tokens, ref_logits = bf16_pair
    cache_dtype, weight_dtype = STORES[store][1]
    _, logits = _bf16_decode(model, ids, gen_cfg, torch.bfloat16 if cache_dtype == torch.float32 else cache_dtype,
                             weight_dtype, ref_tokens)
    rel = float((logits - ref_logits).abs().max() / ref_logits.abs().max())
    assert 0 < rel <= 2e-2, rel


# ------------------------------------------------------------------ serving


def _specs(n, workload=WorkloadSpec, **kw):
    return workload(**dict(dict(seed=13, prompt_lens=(8, 12), max_new_tokens=(3, 4)), **kw)).draw(n, VOCAB)


def _jax_engine(jm, params, **kw):
    """JAX's engine with scale planes of its own for K and V: JAX's
    ``init_paged_kv_cache`` hands both planes one array, which its engine's
    donating join rejects ("donate the same buffer twice"; the port's
    builder makes two). A copy of each V plane, nothing else changed."""
    jfe = jax_serving.EngineFrontEnd(jm, params, num_latents=NUM_LATENTS, **kw)
    jfe._state["cache"] = tuple(dataclasses.replace(c, v_scale=jnp.array(c.v_scale, copy=True)) if c.quantized
                                else c for c in jfe._state["cache"])
    return jfe


def _streams(fe):
    return {i: [int(t) for t in s] for i, s in fe.served_tokens.items()}


@pytest.mark.parametrize("store", list(STORES))
def test_engine_on_int8_stores_equals_jax_with_evictions(models, store):
    """A half-size pool with eviction on int8 pools, int8 weights or both:
    every request serves ``ok``; the greedy streams, the books (evictions
    and resumes included) and the records equal JAX's engine on the same
    specs; the pages come back."""
    jm, params, tm = models
    (jc, jw), (tc, tw) = STORES[store]
    fe = serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, cache_dtype=tc, weight_dtype=tw, device="cpu",
                                engine_config=serving.EngineConfig(**ENGINE, pool_headroom=0.5, eviction=True))
    assert fe._state["cache"][0].quantized == (tc == torch.int8)
    fe.run_closed(_specs(8), concurrency=8)
    books = fe.books()
    assert books["evictions"] >= 1 and books["ok"] == 8 and books["balanced"], books
    assert fe.audit() == [] and fe.ca_alloc.pages_used == 0 and fe.sa_alloc.pages_used == 0
    with _flash():
        jfe = _jax_engine(jm, params, cache_dtype=jc, weight_dtype=jw,
                          engine_config=jax_serving.EngineConfig(**ENGINE, pool_headroom=0.5, eviction=True))
        jfe.run_closed(_specs(8, JaxWorkloadSpec), concurrency=8)
    assert _streams(fe) == _streams(jfe)
    assert jfe.books() == books
    assert [(r.index, r.outcome, r.tokens_out, r.attempts) for r in jfe.records] == \
        [(r.index, r.outcome, r.tokens_out, r.attempts) for r in fe.records]


def test_int8_engine_gates_prefix_sharing_off(models):
    """Prompts that share an 8-token prefix: a float engine shares pages,
    the int8 engine (as JAX's) reports no hit and serves the same streams as
    JAX's int8 engine; the shared prefill refuses an int8 cache."""
    jm, params, tm = models
    specs = _specs(4, prompt_lens=(12,), shared_prefix_len=8)
    engine = serving.EngineConfig(**ENGINE)
    float_fe = serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, device="cpu", engine_config=engine)
    float_fe.run_closed(specs, concurrency=4)
    assert float_fe._n_prefix_hits > 0
    fe = serving.EngineFrontEnd(tm, num_latents=NUM_LATENTS, cache_dtype=torch.int8, device="cpu",
                                engine_config=engine)
    fe.run_closed(specs, concurrency=4)
    with _flash():
        jfe = _jax_engine(jm, params, cache_dtype=jnp.int8, engine_config=jax_serving.EngineConfig(**ENGINE))
        jfe.run_closed(_specs(4, JaxWorkloadSpec, prompt_lens=(12,), shared_prefix_len=8), concurrency=4)
    assert fe._n_prefix_hits == jfe._n_prefix_hits == 0
    assert fe.books()["ok"] == 4 and fe.sharing_audit() == [] and _streams(fe) == _streams(jfe)
    with pytest.raises(ValueError, match="int8"):
        tgen.make_shared_prefill_fn(tm, NUM_LATENTS, 8, 12, GenerationConfig(max_new_tokens=3), torch.int8,
                                    device="cpu")


def test_spec_engine_and_recovery_on_int8_stores(models, tmp_path):
    """The speculative slot mode on int8 pools and weights (the drafter's
    pools int8 too) serves the int8 sequential streams; an engine crashed
    mid-run and recovered from its journal on a fresh int8 engine serves
    them too, books closed across the restart."""
    _, _, tm = models
    kw = dict(num_latents=NUM_LATENTS, cache_dtype=torch.int8, weight_dtype=torch.int8, device="cpu")
    specs = _specs(5)
    want = {}
    for spec in specs:
        cfg = GenerationConfig(max_new_tokens=spec.max_new_tokens)
        want[spec.index] = tgen.generate(tm, spec.input_ids, NUM_LATENTS, None, cfg, torch.int8, torch.int8,
                                         device="cpu")[0, spec.prompt_len:].tolist()
    spec_fe = serving.EngineFrontEnd(tm, engine_config=serving.EngineConfig(**ENGINE, spec_k=2, spec_depth=1), **kw)
    assert all(c.quantized for c in spec_fe._state["draft_cache"])
    spec_fe.run_closed(specs, concurrency=4)
    assert spec_fe.books()["ok"] == 5 and _streams(spec_fe) == want
    path = str(tmp_path / "journal.jsonl")
    crashed = serving.EngineFrontEnd(tm, journal=path, injector=serving.FaultInjector().crash_at(2, 1),
                                     engine_config=serving.EngineConfig(**ENGINE), **kw)
    with pytest.raises(serving.EngineCrash):
        crashed.run_closed(specs, concurrency=5)
    journal = serving.RequestJournal(path)
    fresh = serving.EngineFrontEnd(tm, engine_config=serving.EngineConfig(**ENGINE), **kw)
    assert fresh.recover(journal)["recovered"] >= 1
    fresh.pump()
    assert fresh.books()["balanced"] and fresh.audit() == []
    assert journal.books()["balanced"] and journal.books()["outcomes"] == {"ok": 5}
    assert {**crashed.served_tokens, **fresh.served_tokens} == want
    assert {i: e.tokens for i, e in journal.replay().items()} == want


def test_poisoned_request_under_int8_weights_books_as_jax(models, monkeypatch):
    """A request poisoned in a matmul weight (the cross-attention's key
    projection, element 0 in both packages) under ``weight_dtype=int8``: its
    prefill quantizes the NaN into the sequential path's int8 buffers, so
    its stream differs from the clean one; the records and books equal
    JAX's, and the next request decodes on clean int8 weights again."""
    from perceiver_io_tpu.serving import faultinject as jfault
    from perceiver_io_tpu_torch.serving import faultinject as tfault

    jm, params, tm = models
    jpoison, tpoison = jfault.poison_params, tfault.poison_params
    monkeypatch.setattr(jfault, "poison_params", lambda p, path_filter=None: jpoison(p, "k_proj"))
    monkeypatch.setattr(tfault, "poison_params",
                        lambda p, path_filter=None: tpoison(p, "cross_attention.0.module.attention.k_proj.weight"))

    def run(fe):
        fe.streams = {}
        seam = fe._on_token

        def on_token(i, token):
            fe.streams.setdefault(fe._active.record.index, []).append(int(token[0]))
            seam(i, token)

        fe._on_token = on_token
        fe.run_closed(WorkloadSpec(seed=7, prompt_lens=(10,), max_new_tokens=(4,)).draw(3, VOCAB), concurrency=1)
        return fe

    def port(poison):
        clock = serving.ManualClock()
        injector = serving.FaultInjector()
        for i in poison:
            injector.poison_at(i)
        return run(serving.RequestFrontEnd(tm, num_latents=4, weight_dtype=torch.int8, clock=clock, sleep=clock.sleep,
                                           injector=injector, device="cpu"))

    fe, clean = port((1,)), port(())
    assert [i["kind"] for i in fe._injector.injected] == ["poison"]
    assert fe.streams[1] != clean.streams[1], "the NaN never reached the logits"
    assert fe.streams[0] == clean.streams[0] and fe.streams[2] == clean.streams[2]
    clock = jax_serving.ManualClock()
    jinjector = jax_serving.FaultInjector().poison_at(1)
    with _flash():
        jfe = jax_serving.RequestFrontEnd(jm, params, num_latents=4, weight_dtype=jnp.int8, clock=clock,
                                          sleep=clock.sleep, injector=jinjector)
        jfe.run_closed(JaxWorkloadSpec(seed=7, prompt_lens=(10,), max_new_tokens=(4,)).draw(3, VOCAB), concurrency=1)
    assert [(r.index, r.outcome, r.tokens_out, r.attempts) for r in jfe.records] == \
        [(r.index, r.outcome, r.tokens_out, r.attempts) for r in fe.records]
    assert jfe.books() == fe.books()


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("weight_dtype", [torch.float16, torch.bfloat16, "int4", torch.int32])
def test_unknown_weight_dtype_raises(models, weight_dtype):
    _, _, tm = models
    ids = np.zeros((1, 6), np.int64)
    calls = [
        lambda: tgen.make_decode_fns(tm, 2, CFG, weight_dtype=weight_dtype, device="cpu"),
        lambda: tgen.generate(tm, ids, 2, None, CFG, weight_dtype=weight_dtype, device="cpu"),
        lambda: tgen.make_generate_fn(tm, 2, CFG, weight_dtype=weight_dtype, device="cpu"),
        lambda: tgen.make_paged_step_fn(tm, CFG, weight_dtype, device="cpu"),
        lambda: tgen.make_speculative_paged_step_fn(tm, CFG, weight_dtype=weight_dtype, device="cpu"),
        lambda: tgen.make_speculative_decode_fns(tm, 2, CFG, weight_dtype=weight_dtype, device="cpu"),
        lambda: tgen.beam_search(tm, ids, 2, max_new_tokens=2, weight_dtype=weight_dtype, device="cpu"),
        lambda: tgen.make_instrumented_generate_fn(tm, 2, CFG, weight_dtype=weight_dtype, device="cpu"),
        lambda: serving.RequestFrontEnd(tm, weight_dtype=weight_dtype, device="cpu"),
        lambda: serving.EngineFrontEnd(tm, weight_dtype=weight_dtype, device="cpu"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="weight_dtype"):
            call()


def test_int8_cache_rejects_other_integer_dtypes():
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        tcache.init_kv_cache(1, 4, 8, 8, dtype=torch.int16, device="cpu")
    cache = tcache.init_kv_cache(1, 4, 8, 8, dtype=torch.int8, device="cpu")
    assert cache.quantized and cache.k_scale.data_ptr() != cache.v_scale.data_ptr()
    rolled = cache.map_slots(lambda a: torch.roll(a, -1, dims=1))
    assert rolled.quantized and rolled.k.dtype == torch.int8
    assert not tcache.init_kv_cache(1, 4, 8, 8, device="cpu").map_slots(lambda a: a).quantized
