"""The port's causal LM in bf16 compute (``dtype=torch.bfloat16``, f32
parameters) against the JAX package's ``dtype=jnp.bfloat16`` at the micro
geometry (``analysis/flagship.py``: 512 tokens, 128 latents, 64 channels, 4
heads, 2 layers), from the same parameters (``convert.state_dict_from_jax``):
one attention layer (JAX's packed flash kernels in interpret mode), the
forward logits, the paged engine's greedy serve from bf16 pools, and the
train step's loss and gradients. Plus the one difference of contract in
bf16: the embedding tables' gradients sum in f32 in the port.

Tolerance rule, for each output: the port's bf16 result lies no further from
the f32 evaluation of the same weights (the JAX package in f32) than 1.5
times JAX's bf16 result does, plus 1e-3 times the size of the f32 output,
all in the L2 norm (the largest single difference of two bf16 evaluations
is too noisy a statistic: over a 64-element LayerNorm gradient it varied by
1.7x between the two frameworks, their L2 distances by at most 1.31x). JAX
runs its Pallas flash kernels in interpret mode (``default_flash(True)``).
Served tokens are equal up to the first step where JAX's top two logits lie
within 2e-2 (a near tie that bf16 logits may break either way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu.core.attention import MultiHeadAttention as JaxMHA
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.obs.loadgen import RequestSpec as JaxRequestSpec
from perceiver_io_tpu.ops.flash_attention import default_flash
from perceiver_io_tpu.ops.gathers import embed_lookup as jax_embed_lookup
from perceiver_io_tpu.serving import EngineConfig as JaxEngineConfig
from perceiver_io_tpu.serving import EngineFrontEnd as JaxEngineFrontEnd
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.adapter import TokenInputAdapterWithRotarySupport
from perceiver_io_tpu_torch.core.attention import MultiHeadAttention
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
NEAR_TIE = 2e-2


def assert_bf16_rule(port, jax_bf16, f32, what: str) -> None:
    """The port's bf16 output no further from the f32 evaluation than 1.5x
    JAX's bf16 output, plus 1e-3 of the f32 output's size (distances and
    size in the L2 norm)."""
    port, jax_bf16, f32 = (np.asarray(x, np.float64) for x in (port, jax_bf16, f32))
    assert port.shape == jax_bf16.shape == f32.shape, what
    d_port, d_jax = np.linalg.norm(port - f32), np.linalg.norm(jax_bf16 - f32)
    bound = 1.5 * d_jax + 1e-3 * np.linalg.norm(f32)
    assert np.isfinite(d_port) and d_port <= bound, f"{what}: port {d_port:.3e} > {bound:.3e} (JAX {d_jax:.3e})"


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def models():
    """JAX's f32 and bf16 models on one parameter tree, the port's bf16
    model on the same parameters."""
    jf, jb = JaxCLM(JaxCLMConfig(**MICRO)), JaxCLM(JaxCLMConfig(**MICRO), dtype=jnp.bfloat16)
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jf, jb, params, tm


def test_bf16_model_keeps_f32_parameters(models):
    *_, tm = models
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tm.dtype == torch.bfloat16


@pytest.mark.parametrize("causal,n", [(True, 160), (False, 130)])
def test_attention_layer_bf16_matches_jax(causal, n):
    """One multi-head attention layer, bf16 compute: projections in bf16,
    JAX's packed flash kernels (interpret mode) against the port's plain
    flash versions."""
    rng = np.random.default_rng(n)
    x = _f32(jnp.asarray(rng.normal(size=(2, n, 64)), jnp.bfloat16))
    kw = dict(num_heads=4, num_q_input_channels=64, num_kv_input_channels=64, causal_attention=causal)
    params = JaxMHA(**kw).init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x))
    out = {}
    with default_flash(True):
        for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            xj = jnp.asarray(x, dtype)
            out[name] = _f32(JaxMHA(**kw, dtype=dtype).apply(params, xj, xj).last_hidden_state)
    layer = MultiHeadAttention(4, 64, 64, causal_attention=causal, dtype=torch.bfloat16)
    p = params["params"]
    with torch.no_grad():
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            getattr(layer, proj).weight.copy_(torch.from_numpy(np.asarray(p[proj]["kernel"]).T.copy()))
            getattr(layer, proj).bias.copy_(torch.tensor(np.asarray(p[proj]["bias"])))
        xt = torch.tensor(x).bfloat16()
        got = layer(xt, xt).last_hidden_state
    assert got.dtype == torch.bfloat16
    assert_bf16_rule(got.float().numpy(), out["bf16"], out["f32"], "attention output")


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
def test_forward_logits_bf16_match_jax(models, padded):
    jf, jb, params, tm = models
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 262, size=(2, 512))
    pad = None
    if padded:
        pad = np.zeros((2, 512), bool)
        pad[1, :37] = True
    jpad = None if pad is None else jnp.asarray(pad)
    with default_flash(True):
        want = {name: _f32(m.apply(params, jnp.asarray(ids), prefix_len=384, pad_mask=jpad).logits)
                for name, m in (("f32", jf), ("bf16", jb))}
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), prefix_len=384, pad_mask=None if pad is None else torch.from_numpy(pad))
    assert got.logits.dtype == torch.bfloat16 and got.logits.shape == (2, 128, 262)
    assert_bf16_rule(got.logits.float().numpy(), want["bf16"], want["f32"], "logits")


def _jax_greedy_with_gaps(jm, params, ids, num_latents, max_new):
    """JAX's sequential bf16 greedy stream (bf16 caches) and the top-2 gap of
    the logits behind each token."""
    config = jgen.GenerationConfig(max_new_tokens=max_new)
    seq_len = ids.shape[1]
    caches = JaxCLM.init_cache(jm.config, 1, seq_len + max_new, num_latents + max_new, dtype=jnp.bfloat16)
    first = jm.apply(params, jnp.asarray(ids), prefix_len=seq_len - num_latents,
                     pad_mask=jnp.zeros(ids.shape, bool), kv_cache=caches).logits[:, -1]
    logits = [_f32(first)[0]]
    prefill, _ = jgen.make_decode_fns(jm, num_latents, config, cache_dtype=jnp.bfloat16)
    _, js = prefill(params, jnp.asarray(ids), None, jax.random.PRNGKey(0))

    class Recorder:
        def __init__(self):
            self.config, self.logits = jm.config, []

        def apply(self, *args, **kwargs):
            out = jm.apply(*args, **kwargs)
            self.logits.append(out.logits[:, -1])
            return out

    @jax.jit
    def step(carry):
        rec = Recorder()
        carry, _ = jgen._decode_step_body(rec, jm.config, config, params, carry, js["pad_slots"], js["pos_shift"])
        return carry, rec.logits[0]

    carry = (js["cache"], js["ca_start"], js["sa_start"], js["token"], js["rng"], js["done"])
    tokens = [int(np.argmax(logits[0]))]
    for _ in range(max_new - 1):
        carry, lg = step(carry)
        logits.append(_f32(lg)[0])
        tokens.append(int(carry[3][0]))
    gaps = [float(np.diff(np.sort(lg)[-2:])[0]) for lg in logits]
    return tokens, gaps


def test_engine_serve_bf16_matches_jax_engine(models):
    """Two greedy requests through the paged engine from bf16 pools, three
    tokens each, against JAX's engine (bf16 model, bf16 pools) up to the
    first near tie of JAX's logits."""
    _, jb, params, tm = models
    rng = np.random.default_rng(7)
    num_latents, engine = 64, dict(slots=2, page_size=16, max_ca_tokens=512, max_sa_tokens=128)
    specs = [dict(index=i, prompt_len=n, max_new_tokens=3, input_ids=rng.integers(0, 262, size=(1, n)),
                  rng_seed=i) for i, n in enumerate((300, 417))]
    te = EngineFrontEnd(tm, num_latents=num_latents, engine_config=EngineConfig(**engine),
                        cache_dtype=torch.bfloat16, device="cpu")
    assert all(pool.k.dtype == torch.bfloat16 for pool in te._state["cache"])
    assert [r.outcome for r in te.run_closed([RequestSpec(**s) for s in specs], concurrency=2)] == ["ok", "ok"]
    je = JaxEngineFrontEnd(jb, params, num_latents=num_latents, base_config=jgen.GenerationConfig(),
                           engine_config=JaxEngineConfig(**engine), cache_dtype=jnp.bfloat16)
    assert [r.outcome for r in je.run_closed([JaxRequestSpec(**s) for s in specs], concurrency=2)] == ["ok", "ok"]
    for s in specs:
        got, want = te.served_tokens[s["index"]], [int(t) for t in je.served_tokens[s["index"]]]
        _, gaps = _jax_greedy_with_gaps(jb, params, s["input_ids"], num_latents, 3)
        tie = next((t for t, g in enumerate(gaps) if g < NEAR_TIE), len(gaps))
        assert len(got) == len(want) == 3
        assert got[:tie] == want[:tie], (s["index"], got, want, gaps)


def test_train_step_loss_and_gradients_bf16_match_jax(models):
    """``clm_loss_fn`` under a fixed prefix keep set, bf16 compute: the loss
    and every parameter's gradient (f32, as the parameters)."""
    jf, jb, params, _ = models
    rng = np.random.default_rng(2)
    t = rng.integers(0, 262, size=(2, 513))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": jpd.sample_prefix_keep_idx(rng, 2, 384, 0.5)}
    jbatch = {k: None if v is None else jnp.asarray(v) for k, v in batch.items()}
    want = {}
    with default_flash(True):
        for name, m in (("f32", jf), ("bf16", jb)):
            (loss, _), grads = jax.jit(jax.value_and_grad(jax_clm_loss_fn(m.apply, max_latents=128),
                                                          has_aux=True))(params, jbatch, jax.random.PRNGKey(0))
            want[name] = (float(loss), state_dict_from_jax(jax.tree.map(np.asarray, grads)))
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    loss, _ = tt.clm_loss_fn(128)(tm, batch, None)
    assert loss.dtype == torch.float32
    loss.backward()
    assert_bf16_rule(float(loss.detach()), want["bf16"][0], want["f32"][0], "loss")
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert_bf16_rule(p.grad.numpy(), want["bf16"][1][name].numpy(), want["f32"][1][name].numpy(), name)


def test_embedding_gradient_sums_in_f32_unlike_jax():
    """The difference of contract: the port looks the f32 rows up and casts
    them, so a table's gradient is the f32 sum of the bf16 row gradients
    (``core/adapter.py::lookup``); JAX casts the table and contracts a
    one-hot matrix with the bf16 gradient, so its sums round to bf16. The
    forward is the same either way (a cast commutes with a row gather)."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(262, 64)).astype(np.float32)
    ids = rng.integers(0, 8, size=(2, 300))  # few distinct ids: every row sums many gradients
    g = torch.tensor(rng.normal(size=(2, 300, 64))).bfloat16()
    adapter = TokenInputAdapterWithRotarySupport(262, 512, 64, abs_pos_emb=False, dtype=torch.bfloat16)
    with torch.no_grad():
        adapter.txt_embedding.weight.copy_(torch.from_numpy(table))
    out = adapter.embed(torch.from_numpy(ids))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.from_numpy(table)[torch.from_numpy(ids)].bfloat16())
    out.backward(g)
    want = torch.zeros(262, 64).index_add_(0, torch.from_numpy(ids).reshape(-1), g.float().reshape(-1, 64))
    assert torch.equal(adapter.txt_embedding.weight.grad, want)
    _, vjp = jax.vjp(lambda w: jax_embed_lookup(w.astype(jnp.bfloat16), jnp.asarray(ids)), jnp.asarray(table))
    jgrad = np.asarray(vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))[0])
    np.testing.assert_allclose(jgrad, want.numpy(), rtol=2**-7, atol=1e-6)
    assert not np.array_equal(jgrad, want.numpy())
