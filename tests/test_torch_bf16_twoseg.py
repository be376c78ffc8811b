"""The port's two-segment route (``fast_kernels({"twoseg"})``) in bf16
compute against the JAX package's on the CPU. The port's plain versions
(what K6, K7a and K7b bf16 are held against on the card) run here; JAX's
Pallas kernels (``_fwd_2seg_kernel``, ``_dkv_2seg_kernel``,
``_dq_2seg_kernel``) run in interpret mode under ``set_default_flash(True)``,
as ``tests/test_torch_twoseg.py`` runs them: ``flash_attention_packed_2seg``
and its five operand gradients, ``CrossAttention`` with converted weights,
the bf16 CLM's loss and gradient tree on the "gather" prefix-dropout route,
and one bf16 ``make_train_step`` step with bf16 Adam moments. Plus the
difference of contract (the port's bf16 two-segment forward keeps ``p``
unrounded, as K2's does, where JAX's kernel rounds it to bf16 once), the
bf16 split rule of K2 and K6, and the C entry points' argument lists
against the launchers' ``ctypes`` declarations.

Tolerance rule, for each output, as ``tests/test_torch_bf16_kernels.py``
states it: the port's bf16 result lies no further from JAX's f32 evaluation
of the same (bf16-representable) inputs and weights than 1.5 times JAX's
bf16 result does, plus 1e-3 of the f32 output's size, all in the L2 norm.
Measured here, the port's distance over JAX's: forward 0.77-0.80, operand
gradients 0.98-1.02, ``CrossAttention`` output 0.94-0.95 and its parameter
gradients at most 1.04, the CLM's loss 0.91 and gradients at most 1.22 (the
LayerNorm parameters' short sums)."""

import ctypes
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceiver_io_tpu_torch.core.attention as tattention
from perceiver_io_tpu.core.modules import CrossAttention as JaxCrossAttention
from perceiver_io_tpu.core.position import frequency_position_encoding, positions
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import clm_loss_fn as jax_clm_loss_fn
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training import prefix_dropout as jpd
from perceiver_io_tpu.training.loop import make_train_step as jax_make_train_step
from perceiver_io_tpu_torch import convert
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.core.modules import CrossAttention
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops import build
from perceiver_io_tpu_torch.ops import flash_attention as tfa

# the module (the package re-exports a function of the same name)
jfa = importlib.import_module("perceiver_io_tpu.ops.flash_attention")

B, H, D, NQ = 2, 4, 16, 128
C = H * D
TWOSEG = frozenset({"twoseg"})
MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
LATENTS, SEQ, PREFIX = 128, 256, 128
# the bf16 model's logits on the two routes, relative L2 distance: the
# routes run the same plain attention on the same bf16 operands and differ
# only where the projections' bf16 GEMMs see other shapes (measured 0.0 on
# this CPU; on the card K2's and K6's online softmax walks differ at the
# seam, chip_smoke.py's eval_twoseg_bf16)
ROUTE_L2 = 1e-3


@pytest.fixture(autouse=True)
def _jax_flash():
    """JAX's fused kernels in interpret mode (its twoseg gate needs flash on)."""
    jfa.set_default_flash(True)
    yield
    jfa.set_default_flash(None)


def bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even), as f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _ratio(port, jax_bf16, f32) -> tuple:
    """(the port's L2 distance from f32, the rule's bound, JAX's distance)."""
    port, jax_bf16, f32 = (np.asarray(x, np.float64) for x in (port, jax_bf16, f32))
    assert port.shape == jax_bf16.shape == f32.shape
    d_port, d_jax = np.linalg.norm(port - f32), np.linalg.norm(jax_bf16 - f32)
    return d_port, 1.5 * d_jax + 1e-3 * np.linalg.norm(f32), d_jax


def assert_bf16_rule(port, jax_bf16, f32, what: str) -> None:
    d_port, bound, d_jax = _ratio(port, jax_bf16, f32)
    assert np.isfinite(d_port) and d_port <= bound, f"{what}: port {d_port:.3e} > {bound:.3e} (JAX {d_jax:.3e})"


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _operands(n_p, nq=NQ, pad=False, seed=0):
    """bf16-representable operands (as f32) and, with ``pad``, left pads in
    the prefix (every row keeps a real key)."""
    rng = np.random.default_rng(seed)
    q = bf16_values(rng.normal(size=(B, nq, C)) * D**-0.5)
    k_p, v_p = (bf16_values(rng.normal(size=(B, n_p, C))) for _ in range(2))
    k_l, v_l = (bf16_values(rng.normal(size=(B, nq, C))) for _ in range(2))
    pad_p = pad_l = None
    if pad:
        pad_p = np.zeros((B, n_p), bool)
        pad_p[:, : min(3, n_p)] = True
        pad_p[1, : n_p // 2] = True
        pad_l = np.zeros((B, nq), bool)
    return (q, k_p, v_p, k_l, v_l), pad_p, pad_l


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax_2seg_vjp(ops, pad_p, pad_l, do, dtype):
    """JAX's output and five operand gradients at ``dtype``, as f32."""
    fn = lambda *t: jfa.flash_attention_packed_2seg(*t, num_heads=H, pad_mask_prefix=_jnp(pad_p),  # noqa: E731
                                                    pad_mask_latent=_jnp(pad_l))
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in ops))
    return [_f32(x) for x in (out, *vjp(jnp.asarray(do, dtype)))]


# ---------------------------------------------------------------------------
# the function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_p,nq,pad", [(200, 128, False), (200, 128, True), (70, 100, True)],
                         ids=["no_pad", "pad", "pad_nq_100"])
def test_forward_and_operand_gradients_bf16_match_jax(n_p, nq, pad):
    ops, pad_p, pad_l = _operands(n_p, nq, pad=pad, seed=n_p + nq)
    do = bf16_values(np.random.default_rng(10).normal(size=(B, nq, C)))
    f32 = _jax_2seg_vjp(ops, pad_p, pad_l, do, jnp.float32)
    jbf = _jax_2seg_vjp(ops, pad_p, pad_l, do, jnp.bfloat16)
    t = [torch.tensor(a).bfloat16().requires_grad_() for a in ops]
    o = tfa.flash_attention_packed_2seg(*t, num_heads=H, pad_mask_prefix=_torch(pad_p),
                                        pad_mask_latent=_torch(pad_l))
    assert o.dtype == torch.bfloat16
    o.backward(torch.tensor(do).bfloat16())
    assert all(x.grad.dtype == torch.bfloat16 for x in t)
    port = [o.detach().float().numpy()] + [x.grad.float().numpy() for x in t]
    for name, p, j, f in zip(("out", "dq", "dk_p", "dv_p", "dk_l", "dv_l"), port, jbf, f32):
        assert_bf16_rule(p, j, f, name)


def test_bf16_forward_keeps_p_unrounded_unlike_jax():
    """The difference of contract. The port's bf16 two-segment forward is the
    concat route's (K2's plain version on the joined operands) bit for bit,
    and keeps ``p`` unrounded before ``P V``, as K6's bf16 build keeps it to
    ~2^-16 (two bf16 parts); JAX's ``_fwd_2seg_kernel`` rounds ``p`` to bf16
    once. JAX's bf16 output lies nearer the p-rounded plain version
    (``round_p=True``) than the port's, and the port's nearer f32."""
    ops, pad_p, pad_l = _operands(200, pad=True, seed=5)
    t = [torch.tensor(a).bfloat16() for a in ops]
    pads = dict(pad_mask_prefix=_torch(pad_p), pad_mask_latent=_torch(pad_l))
    o, lse = tfa.flash_attention_packed_2seg_reference(*t, H, **pads)
    joined = (t[0], torch.cat([t[1], t[3]], 1), torch.cat([t[2], t[4]], 1))
    jpad = torch.cat([pads["pad_mask_prefix"], pads["pad_mask_latent"]], 1)
    ro, rlse = tfa.flash_attention_packed_reference(*joined, H, pad_mask=jpad, causal=True)
    assert o.dtype == torch.bfloat16 and torch.equal(o, ro) and torch.equal(lse, rlse)
    bias = tfa.bias_row(jpad, B, jpad.shape[1], jpad.device)
    rounded, _ = tfa._fwd_plain(*joined, H, bias, True, 1.0, round_p=True)
    assert not torch.equal(rounded, o)
    do = np.zeros((B, NQ, C), np.float32)
    f32, jbf = (_jax_2seg_vjp(ops, pad_p, pad_l, do, dt)[0] for dt in (jnp.float32, jnp.bfloat16))
    dist = lambda a, b: float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))  # noqa: E731
    assert dist(jbf, rounded.float().numpy()) < dist(jbf, o.float().numpy())
    assert dist(o.float().numpy(), f32) < dist(jbf, f32)


@pytest.mark.parametrize("shape,f32_splits,bf16_splits", [
    ((1, 8, 512, 16384, 64), 4, 4),    # the serving prefill: 64 q blocks over 264 CTA slots
    ((1, 8, 1024, 16384, 64), 2, 2),   # K6's eval window (15360 + 1024 keys)
    ((2, 8, 1024, 8704, 64), 1, 1),    # the CLM's training cross-attention: 256 q blocks
    ((1, 8, 512, 600, 128), 2, 1),     # head dim 128: the bf16 build's 64-row kv tiles (f32: 32)
])
def test_kv_split_rule_reads_each_build_tiles(shape, f32_splits, bf16_splits):
    """K2 and K6 split their kv walk in both builds (two CTAs an SM in each),
    at least 8 kv tiles a split: 64 rows in the bf16 build at every head
    dim, 32 above head dim 64 in the f32 build."""
    assert tfa.packed_kv_splits(*shape, sms=132) == f32_splits
    assert tfa.packed_kv_splits(*shape, sms=132, dtype=torch.bfloat16) == bf16_splits


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "long": ctypes.c_long, "long long": ctypes.c_longlong}


def _c_params(source: str, symbol: str) -> list:
    """The ctypes types of a C entry point's parameters, from its source."""
    with open(os.path.join(build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m is not None, symbol
    out = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split()[:-1]).replace("const ", "")
        out.append(ctypes.c_void_p if "*" in param else _CTYPE[decl])
    return out


@pytest.mark.parametrize("name", sorted(build.LAUNCHERS))
def test_launcher_argtypes_match_the_c_entry_point(name):
    """Each launcher's ``ctypes`` argument list is its C entry point's,
    parameter for parameter (a missed dtype code would shift every argument
    after it)."""
    source, symbol, argtypes = build.LAUNCHERS[name]
    assert argtypes == _c_params(source, symbol)


# ---------------------------------------------------------------------------
# CrossAttention
# ---------------------------------------------------------------------------


def _ca_state_dict(params):
    p = params.get("params", params)
    out = {}
    convert._layernorm(p["q_norm"], "q_norm", out)
    convert._layernorm(p["kv_norm"], "kv_norm", out)
    convert._attention(p["attention"], "attention", out)
    return out


@pytest.mark.parametrize("pad", [False, True], ids=["rope", "rope_pad"])
def test_cross_attention_bf16_matches_jax_under_twoseg(monkeypatch, pad):
    """bf16 compute, converted weights: the output and every parameter's
    gradient; the two-segment function receives bf16 operands (the
    projections come out of ``dense`` in bf16 and nothing casts them back)."""
    n_p = 200
    rng = np.random.default_rng(1)
    x_q = bf16_values(rng.normal(size=(B, NQ, C)))
    x_p = bf16_values(rng.normal(size=(B, n_p, C)))
    rope_k = np.asarray(frequency_position_encoding(positions(B, n_p + NQ), D // 2))
    rope_q = rope_k[:, n_p:]
    pad_mask = None
    if pad:
        pad_mask = np.zeros((B, n_p + NQ), bool)
        pad_mask[1, :7] = True
    cot = bf16_values(np.random.default_rng(2).normal(size=(B, NQ, C)))
    kw = dict(num_heads=H, num_q_input_channels=C, num_kv_input_channels=C, causal_attention=True)
    params = jax.tree.map(np.asarray, JaxCrossAttention(**kw).init(jax.random.PRNGKey(0), jnp.asarray(x_q),
                                                                    x_kv_prefix=jnp.asarray(x_p)))
    want = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jca = JaxCrossAttention(**kw, dtype=dtype)

        def jloss(p, jca=jca, dtype=dtype):
            out = jca.apply(p, jnp.asarray(x_q, dtype), x_kv_prefix=jnp.asarray(x_p, dtype),
                            pad_mask=_jnp(pad_mask), rope_q=jnp.asarray(rope_q),
                            rope_k=jnp.asarray(rope_k)).last_hidden_state
            return jnp.sum(out.astype(jnp.float32) * cot), out

        with jfa.fast_kernels(TWOSEG):
            (_, out), grads = jax.value_and_grad(jloss, has_aux=True)(params)
        want[name] = (_f32(out), _ca_state_dict(jax.tree.map(np.asarray, grads)))
    tca = CrossAttention(H, C, C, causal_attention=True, dtype=torch.bfloat16)
    tca.load_state_dict(_ca_state_dict(params), strict=True)
    dtypes = []
    real = tattention.flash_attention_packed_2seg
    monkeypatch.setattr(tattention, "flash_attention_packed_2seg",
                        lambda *a, **k: dtypes.append({t.dtype for t in a[:5]}) or real(*a, **k))
    with tfa.fast_kernels(TWOSEG):
        out = tca(torch.tensor(x_q).bfloat16(), x_kv_prefix=torch.tensor(x_p).bfloat16(), pad_mask=_torch(pad_mask),
                  rope_q=torch.from_numpy(rope_q), rope_k=torch.from_numpy(rope_k)).last_hidden_state
    assert dtypes == [{torch.bfloat16}] and out.dtype == torch.bfloat16
    assert_bf16_rule(out.detach().float().numpy(), want["bf16"][0], want["f32"][0], "output")
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for name, param in tca.named_parameters():
        if name == "attention.k_proj.bias":  # 0 in exact arithmetic: both bf16 gradients are rounding
            continue
        assert_bf16_rule(param.grad.numpy(), want["bf16"][1][name].numpy(), want["f32"][1][name].numpy(), name)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clm():
    jf, jb = JaxCLM(JaxCLMConfig(**MICRO)), JaxCLM(JaxCLMConfig(**MICRO), dtype=jnp.bfloat16)
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    return jf, jb, params


def _port_model(params):
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(convert.state_dict_from_jax(params), strict=True)
    return tm


def _batch(rng, b, n_pad=0):
    t = rng.integers(0, 262, size=(b, SEQ + 1))
    pad = None
    if n_pad:
        pad = np.zeros((b, SEQ), bool)
        pad[1, :n_pad] = True
    keep = jpd.sample_prefix_keep_idx(rng, b, PREFIX, 0.5)
    return {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": pad, "prefix_keep_idx": keep}


def _jax_batch(batch):
    return {k: _jnp(v) for k, v in batch.items()}


def _spy_2seg(monkeypatch):
    calls = []
    real = tattention.flash_attention_packed_2seg
    monkeypatch.setattr(tattention, "flash_attention_packed_2seg",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    return calls


def test_clm_loss_and_gradient_tree_bf16_match_jax_under_twoseg(clm, monkeypatch):
    """A left-padded batch: the "gather" prefix-dropout route (the embedded
    rows, their rotary rows and pad flags gathered by the keep set)."""
    jf, jb, params = clm
    batch = _batch(np.random.default_rng(1), 2, n_pad=37)
    want = {}
    with jfa.fast_kernels(TWOSEG):
        for name, m in (("f32", jf), ("bf16", jb)):
            (loss, _), grads = jax.jit(jax.value_and_grad(jax_clm_loss_fn(m.apply, max_latents=LATENTS),
                                                          has_aux=True))(params, _jax_batch(batch),
                                                                         jax.random.PRNGKey(0))
            want[name] = (float(loss), convert.state_dict_from_jax(jax.tree.map(np.asarray, grads)))
    calls = _spy_2seg(monkeypatch)
    tm = _port_model(params)
    with tfa.fast_kernels(TWOSEG):
        loss, _ = tt.clm_loss_fn(LATENTS)(tm, batch, None)
    loss.backward()
    assert calls == [torch.bfloat16]
    assert_bf16_rule(float(loss.detach()), want["bf16"][0], want["f32"][0], "loss")
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert_bf16_rule(p.grad.numpy(), want["bf16"][1][name].numpy(), want["f32"][1][name].numpy(), name)


def test_bf16_train_step_with_bf16_moments_follows_jax_under_twoseg(clm, monkeypatch):
    """One ``make_train_step`` step (microbatch 2, the sentinel on, bf16 Adam
    moments), port and JAX from the same parameters, batch and keep set:
    the losses within the bf16 forward's rounding of each other (2e-3 on
    losses of about 5.6, as ``tests/test_torch_bf16_optim.py``); the first
    Adam step moves each parameter by about lr * sign(gradient), and a
    gradient within bf16 rounding of 0 may take either sign, so every
    parameter lies within two such moves of JAX's and 99.5% within 2e-4
    (measured: losses 2.9e-5 apart, the largest difference 1.9997e-3,
    99.7% within 2e-4)."""
    _, jb, params = clm
    lr = 1e-3
    jstate = JaxTrainState.create(jb.apply, params, joptim.make_optimizer(lr, gradient_clip=1.0,
                                                                        moment_dtype="bfloat16"),
                                  jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jax_clm_loss_fn(jb.apply, max_latents=LATENTS), donate=False, microbatch=2,
                                sentinel=True)
    tm = _port_model(params)
    tstate = tt.TrainState.create(tm, tt.make_optimizer(lr, gradient_clip=1.0, moment_dtype="bfloat16"))
    tstep = tt.make_train_step(tt.clm_loss_fn(LATENTS), microbatch=2, sentinel=True)
    batch = _batch(np.random.default_rng(4), 4)
    calls = _spy_2seg(monkeypatch)
    with jfa.fast_kernels(TWOSEG), tfa.fast_kernels(TWOSEG):
        jstate, jmetrics = jstep(jstate, _jax_batch(batch))
        tstate, tmetrics = tstep(tstate, batch)
    assert calls == [torch.bfloat16] * 2  # one forward per microbatch chunk
    assert abs(float(tmetrics["loss"]) - float(jmetrics["loss"])) <= 2e-3
    assert float(tmetrics["sentinel_skipped"]) == 0.0
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    init = convert.state_dict_from_jax(params)
    close = total = 0
    for name, p in tm.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr * (1 + 1e-3), name
        assert np.abs(want[name].numpy() - init[name].numpy()).max() > 0.5 * lr, name  # the step moved it
        close, total = close + int((diff <= 2e-4).sum()), total + diff.size
    assert close >= 0.995 * total
    assert all(m.dtype == torch.bfloat16 for m in tstate.optimizer.compact.mu)


@pytest.mark.parametrize("n_pad", [0, 37], ids=["unpadded", "left_padded"])
def test_bf16_twoseg_and_concat_routes_agree(clm, n_pad):
    """The port's bf16 model on both routes, one cache-free forward: the
    same function (the contract pinned above), logits within ``ROUTE_L2``
    (relative L2)."""
    _, _, params = clm
    tm = _port_model(params)
    batch = _batch(np.random.default_rng(6), 2, n_pad)
    ids, pad = torch.from_numpy(batch["input_ids"]), _torch(batch["pad_mask"])
    logits = {}
    with torch.no_grad():
        for name, features in (("concat", frozenset()), ("twoseg", TWOSEG)):
            with tfa.fast_kernels(features):
                logits[name] = tm(ids, prefix_len=PREFIX, pad_mask=pad).logits.double()
    assert logits["twoseg"].dtype == torch.float64 and torch.isfinite(logits["twoseg"]).all()
    rel = float((logits["twoseg"] - logits["concat"]).norm() / logits["concat"].norm())
    assert rel <= ROUTE_L2, rel
