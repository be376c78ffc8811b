"""The port's two-segment route (``fast_kernels({"twoseg"})``) against the JAX
package on the CPU: ``flash_attention_packed_2seg`` (the plain version K6,
K7a and K7b are held against on the card, wired through its autograd
Function) against JAX's, whose Pallas kernels (``_fwd_2seg_kernel``,
``_dkv_2seg_kernel``, ``_dq_2seg_kernel``) run in interpret mode under
``set_default_flash(True)``, as ``tests/test_flash_twoseg.py`` runs them;
``CrossAttention`` with converted JAX weights; the dispatch contract (flag off
is the concat route bit for bit, an empty prefix keeps it, the route joins no
``[prefix; latents]`` tensor); the whole slice (the ``clm_loss_fn`` gradient
tree on both prefix-dropout routes and a 3-step ``make_train_step``
trajectory under twoseg); and the feature switch.

Tolerances (f32; the port's plain versions sum densely, JAX's kernels
blockwise), each beside the largest error measured here:

- forward output: atol 2e-5 (measured 4.2e-7), the bound the JAX package's
  own twoseg tests hold;
- the five operand gradients: atol 1e-5 on values up to 5.5 (measured
  2.6e-6);
- ``CrossAttention``: output atol 2e-5 (measured 2.6e-9); parameter
  gradients relative 1e-5 of each gradient's largest value floored at 1e-2
  (k_proj's bias gets no gradient in exact arithmetic without RoPE, as the
  softmax is shift-invariant; measured 9.1e-7);
- the CLM gradient tree: relative 4e-6 (measured 9.5e-7) and losses 4e-6
  (measured 9.5e-7), the bounds of ``tests/test_torch_train.py``;
- parameters after three AdamW steps: atol 1e-6 for all but a 1e-3 share of
  the entries, 3e-5 for those (measured: 2 of 198,342 entries, both in the
  position table, at 6.5e-6; every other entry within 4.4e-7). Those
  entries' gradients lie within AdamW's eps of zero, where a gradient
  difference of 1e-9 moves the update by a sizeable part of lr."""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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
from perceiver_io_tpu_torch.ops import flash_attention as tfa

# the module (the package re-exports a function of the same name)
jfa = importlib.import_module("perceiver_io_tpu.ops.flash_attention")

B, H, D, NQ = 2, 4, 16, 128
C = H * D
TWOSEG = frozenset({"twoseg"})
FWD_ATOL, GRAD_ATOL = 2e-5, 1e-5
CA_ATOL, CA_GRAD_RTOL, CA_GRAD_FLOOR = 2e-5, 1e-5, 1e-2
CLM_GRAD_RTOL, LOSS_ATOL = 4e-6, 4e-6
PARAM_ATOL, PARAM_ATOL_NEAR_EPS, NEAR_EPS_SHARE = 1e-6, 3e-5, 1e-3
MICRO = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
             num_self_attention_layers=2, output_norm=True)
LATENTS, SEQ, PREFIX = 128, 256, 128


@pytest.fixture(autouse=True)
def _jax_flash():
    """JAX's fused kernels in interpret mode (its twoseg gate needs flash on)."""
    jfa.set_default_flash(True)
    yield
    jfa.set_default_flash(None)


def _operands(n_p, nq=NQ, pad=False, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, nq, C)) * D**-0.5).astype(np.float32)
    k_p, v_p = (rng.normal(size=(B, n_p, C)).astype(np.float32) for _ in range(2))
    k_l, v_l = (rng.normal(size=(B, nq, C)).astype(np.float32) for _ in range(2))
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


def _jax_2seg(pad_p, pad_l):
    return lambda *t: jfa.flash_attention_packed_2seg(*t, num_heads=H, pad_mask_prefix=_jnp(pad_p),
                                                      pad_mask_latent=_jnp(pad_l))


# ---------------------------------------------------------------------------
# (a)-(c) the function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [False, True], ids=["no_pad", "pad"])
@pytest.mark.parametrize("n_p", [1, 70, 128, 200, 384])
def test_forward_matches_jax(n_p, pad):
    ops, pad_p, pad_l = _operands(n_p, pad=pad, seed=n_p)
    want = np.asarray(_jax_2seg(pad_p, pad_l)(*map(jnp.asarray, ops)))
    got, lse = tfa.flash_attention_packed_2seg(*map(torch.from_numpy, ops), num_heads=H,
                                               pad_mask_prefix=_torch(pad_p), pad_mask_latent=_torch(pad_l),
                                               return_lse=True)
    assert got.shape == (B, NQ, C) and lse.shape == (B, NQ, H) and torch.isfinite(lse).all()
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("n_p,nq,pad", [(200, 128, False), (200, 128, True), (70, 100, True)],
                         ids=["no_pad", "pad", "pad_nq_100"])
def test_grads_match_jax_vjp(n_p, nq, pad):
    ops, pad_p, pad_l = _operands(n_p, nq, pad=pad, seed=9)
    do = np.random.default_rng(10).normal(size=(B, nq, C)).astype(np.float32)
    _, vjp = jax.vjp(_jax_2seg(pad_p, pad_l), *map(jnp.asarray, ops))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    t = [torch.from_numpy(a).requires_grad_() for a in ops]
    o = tfa.flash_attention_packed_2seg(*t, num_heads=H, pad_mask_prefix=_torch(pad_p),
                                        pad_mask_latent=_torch(pad_l))
    o.backward(torch.from_numpy(do))
    for name, x, w in zip(("dq", "dk_p", "dv_p", "dk_l", "dv_l"), t, want):
        np.testing.assert_allclose(x.grad.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_contract_errors_match_jax():
    ops, _, _ = _operands(64)
    jops, tops = list(map(jnp.asarray, ops)), list(map(torch.from_numpy, ops))
    for impl, (q, k_p, v_p, k_l, v_l) in ((jfa.flash_attention_packed_2seg, jops),
                                          (tfa.flash_attention_packed_2seg, tops)):
        with pytest.raises(ValueError, match="non-empty prefix"):
            impl(q, k_p[:, :0], v_p[:, :0], k_l, v_l, num_heads=H)
        with pytest.raises(ValueError, match="must equal query length"):
            impl(q, k_p, v_p, k_l[:, :64], v_l[:, :64], num_heads=H)


def test_plain_versions_are_the_concat_route_and_the_function_wires_them():
    """The plain two-segment versions are K2/K4's plain versions on the
    joined operands, and on CPU tensors the Function runs them bit for bit."""
    ops, pad_p, pad_l = _operands(70, pad=True, seed=3)
    t = list(map(torch.from_numpy, ops))
    pads = dict(pad_mask_prefix=_torch(pad_p), pad_mask_latent=_torch(pad_l))
    o, lse = tfa.flash_attention_packed_2seg_reference(*t, H, **pads)
    joined = (t[0], torch.cat([t[1], t[3]], 1), torch.cat([t[2], t[4]], 1))
    jpad = torch.cat([pads["pad_mask_prefix"], pads["pad_mask_latent"]], 1)
    ro, rlse = tfa.flash_attention_packed_reference(*joined, H, pad_mask=jpad, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    do = torch.from_numpy(np.random.default_rng(4).normal(size=(B, NQ, C)).astype(np.float32))
    want = tfa.flash_attention_packed_2seg_bwd_reference(*t, o, lse, do, H, **pads)
    g = [x.clone().requires_grad_() for x in t]
    tfa.flash_attention_packed_2seg(*g, num_heads=H, **pads).backward(do)
    for x, w in zip(g, want):
        assert torch.equal(x.grad, w)


# ---------------------------------------------------------------------------
# (d)-(g) CrossAttention and the dispatch
# ---------------------------------------------------------------------------


def _ca_state_dict(params):
    p = params.get("params", params)
    out = {}
    convert._layernorm(p["q_norm"], "q_norm", out)
    convert._layernorm(p["kv_norm"], "kv_norm", out)
    convert._attention(p["attention"], "attention", out)
    return out


def _ca_inputs(n_p=200, rope=False, pad=False, seed=0):
    rng = np.random.default_rng(seed)
    x_q = rng.normal(size=(B, NQ, C)).astype(np.float32)
    x_p = rng.normal(size=(B, n_p, C)).astype(np.float32)
    rope_q = rope_k = pad_mask = None
    if rope:
        rope_k = np.asarray(frequency_position_encoding(positions(B, n_p + NQ), D // 2))
        rope_q = rope_k[:, n_p:]
    if pad:
        pad_mask = np.zeros((B, n_p + NQ), bool)
        pad_mask[1, :7] = True
    return x_q, x_p, rope_q, rope_k, pad_mask


@pytest.fixture(scope="module")
def cross_attention():
    jca = JaxCrossAttention(num_heads=H, num_q_input_channels=C, num_kv_input_channels=C, causal_attention=True)
    x_q, x_p, *_ = _ca_inputs()
    params = jax.tree.map(np.asarray, jca.init(jax.random.PRNGKey(0), jnp.asarray(x_q), x_kv_prefix=jnp.asarray(x_p)))
    tca = CrossAttention(H, C, C, causal_attention=True)
    tca.load_state_dict(_ca_state_dict(params), strict=True)
    return jca, params, tca


@pytest.mark.parametrize("rope,pad", [(False, False), (True, False), (True, True)],
                         ids=["plain", "rope", "rope_pad"])
def test_cross_attention_matches_jax_under_twoseg(cross_attention, monkeypatch, rope, pad):
    jca, params, tca = cross_attention
    x_q, x_p, rope_q, rope_k, pad_mask = _ca_inputs(rope=rope, pad=pad, seed=1)
    cot = np.random.default_rng(2).normal(size=(B, NQ, C)).astype(np.float32)
    calls = _spy_2seg(monkeypatch)

    def jloss(p):
        out = jca.apply(p, jnp.asarray(x_q), x_kv_prefix=jnp.asarray(x_p), pad_mask=_jnp(pad_mask),
                        rope_q=_jnp(rope_q), rope_k=_jnp(rope_k)).last_hidden_state
        return jnp.sum(out * cot), out

    with jfa.fast_kernels(TWOSEG):
        (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    with tfa.fast_kernels(TWOSEG):
        out = tca(torch.from_numpy(x_q), x_kv_prefix=torch.from_numpy(x_p), pad_mask=_torch(pad_mask),
                  rope_q=_torch(rope_q), rope_k=_torch(rope_k)).last_hidden_state
    assert calls, "twoseg on, but the two-segment function never ran"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=CA_ATOL, rtol=0)
    tca.zero_grad()
    (out * torch.from_numpy(cot)).sum().backward()
    want = _ca_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, param in tca.named_parameters():
        w = want[name].numpy()
        # k_proj's bias gets no gradient in exact arithmetic without RoPE (the
        # softmax is shift-invariant): the scale floors at CA_GRAD_FLOOR
        err = np.abs(param.grad.numpy() - w).max() / max(np.abs(w).max(), CA_GRAD_FLOOR)
        assert err <= CA_GRAD_RTOL, (name, err)


def _spy_2seg(monkeypatch):
    calls = []
    real = tattention.flash_attention_packed_2seg
    monkeypatch.setattr(tattention, "flash_attention_packed_2seg", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _concat_route(tca, x_q, x_p, pad_mask, rope_q, rope_k):
    """The route before twoseg, spelled out."""
    x_qn = tca.q_norm(x_q)
    x_kv = torch.cat([tca.kv_norm(x_p), x_qn], dim=1)
    return tca.attention(x_qn, x_kv, pad_mask=pad_mask, rope_q=rope_q, rope_k=rope_k).last_hidden_state


def test_flag_off_is_the_concat_route_bit_for_bit(cross_attention, monkeypatch):
    _, _, tca = cross_attention
    x_q, x_p, rope_q, rope_k, pad = map(_torch, _ca_inputs(rope=True, pad=True, seed=3))
    calls = _spy_2seg(monkeypatch)
    n_p = x_p.shape[1]
    with torch.no_grad():
        want = _concat_route(tca, x_q, x_p, pad, rope_q, rope_k)
        joint = tca(x_q, x_kv_prefix=x_p, pad_mask=pad, rope_q=rope_q, rope_k=rope_k).last_hidden_state
        pairs = tca(x_q, x_kv_prefix=x_p, pad_mask=(pad[:, :n_p], pad[:, n_p:]), rope_q=rope_q,
                    rope_k=(rope_k[:, :n_p], rope_k[:, n_p:])).last_hidden_state
        assert not calls, "twoseg off, but the two-segment function ran"
        with tfa.fast_kernels(TWOSEG):
            on = tca(x_q, x_kv_prefix=x_p, pad_mask=pad, rope_q=rope_q, rope_k=rope_k).last_hidden_state
    assert torch.equal(joint, want) and torch.equal(pairs, want)
    assert calls
    torch.testing.assert_close(on, want, atol=CA_ATOL, rtol=0)


def test_empty_prefix_keeps_the_concat_route(cross_attention, monkeypatch):
    _, _, tca = cross_attention
    x_q = _torch(_ca_inputs(seed=4)[0])
    calls = _spy_2seg(monkeypatch)
    with torch.no_grad():
        off = tca(x_q, x_kv_prefix=x_q[:, :0]).last_hidden_state
        with tfa.fast_kernels(TWOSEG):
            on = tca(x_q, x_kv_prefix=x_q[:, :0]).last_hidden_state
    assert not calls
    assert torch.equal(on, off)


def test_gate_takes_sequences_shorter_than_jaxs_flash_threshold(cross_attention, monkeypatch):
    """A difference of contract: JAX's gate also asks its flash size policy
    (at least 128 queries and 128 keys), the port's kernels take any length,
    so a 16-latent call takes the two-segment route in the port and the
    concat route in JAX; the outputs agree all the same (atol 2e-5)."""
    jca, params, tca = cross_attention
    x_q, x_p, *_ = _ca_inputs(n_p=9, seed=7)
    x_q = x_q[:, :16]
    jattention = importlib.import_module("perceiver_io_tpu.core.attention")
    jcalls = []
    jreal = jattention.flash_attention_packed_2seg
    monkeypatch.setattr(jattention, "flash_attention_packed_2seg", lambda *a, **k: jcalls.append(1) or jreal(*a, **k))
    calls = _spy_2seg(monkeypatch)
    with jfa.fast_kernels(TWOSEG):
        want = jca.apply(params, jnp.asarray(x_q), x_kv_prefix=jnp.asarray(x_p)).last_hidden_state
    with torch.no_grad(), tfa.fast_kernels(TWOSEG):
        got = tca(torch.from_numpy(x_q), x_kv_prefix=torch.from_numpy(x_p)).last_hidden_state
    assert calls and not jcalls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CA_ATOL, rtol=0)


class _OutputShapes(TorchDispatchMode):
    """Records the shape of every tensor each dispatched op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [(str(func), tuple(t.shape)) for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("padded", [False, True], ids=["compact", "left_padded"])
def test_twoseg_route_joins_no_prefix_latent_tensor(monkeypatch, padded):
    """With the two-segment function replaced by a recording stub, the model's
    cross-attention + self-attention tail (``PerceiverAR._attend``, whose CA
    gets the segments' rotary rows and pad flags as pairs) builds no tensor
    with an axis of the joint length Np + Nq; with the flag off the concat
    route builds several, so the check discriminates."""
    n_p = 70  # joint length 198: no other axis of the micro model has it
    calls = []

    def stub(q, k_p, v_p, k_l, v_l, num_heads, pad_mask_prefix=None, pad_mask_latent=None, sm_scale=1.0):
        calls.append((k_p.shape[1], k_l.shape[1], pad_mask_prefix is None))
        return torch.zeros(q.shape[0], q.shape[1], v_l.shape[2])

    monkeypatch.setattr(tattention, "flash_attention_packed_2seg", stub)
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
    rng = np.random.default_rng(5)
    x_l, x_p = (torch.from_numpy(rng.normal(size=(B, n, C)).astype(np.float32)) for n in (NQ, n_p))
    frq = torch.from_numpy(rng.normal(size=(B, n_p + NQ, D // 2)).astype(np.float32))
    pad_l = pad_p = None
    if padded:
        pad_l, pad_p = torch.zeros(B, NQ, dtype=torch.bool), torch.zeros(B, n_p, dtype=torch.bool)
        pad_p[1, :9] = True
    joint = n_p + NQ
    found = {}
    for features in (frozenset(), TWOSEG):
        with torch.no_grad(), tfa.fast_kernels(features), _OutputShapes() as rec:
            tm._attend(x_l, x_p, frq[:, n_p:], frq[:, :n_p], pad_l, pad_p, None)
        found[features] = [(op, s) for op, s in rec.shapes if joint in s]
    assert found[frozenset()], "the concat route should build [prefix; latents] tensors"
    assert calls == [(n_p, NQ, not padded)]
    assert not found[TWOSEG], found[TWOSEG]


# ---------------------------------------------------------------------------
# (h) the whole slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clm():
    jm = JaxCLM(JaxCLMConfig(**MICRO))
    ids = np.random.default_rng(0).integers(0, 262, size=(1, 160))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=96))
    return jm, params


def _port_model(params):
    tm = CausalLanguageModel(CausalLanguageModelConfig(**MICRO), device="cpu")
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


@pytest.mark.parametrize("n_pad", [0, 37], ids=["unpadded_compact", "left_padded_gather"])
def test_clm_gradient_tree_matches_jax_under_twoseg(clm, monkeypatch, n_pad):
    jm, params = clm
    batch = _batch(np.random.default_rng(1), 2, n_pad)
    calls = _spy_2seg(monkeypatch)
    with jfa.fast_kernels(TWOSEG):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(jax_clm_loss_fn(jm.apply, max_latents=LATENTS),
                                                        has_aux=True))(params, _jax_batch(batch),
                                                                       jax.random.PRNGKey(0))
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    tm = _port_model(params)
    with tfa.fast_kernels(TWOSEG):
        loss, _ = tt.clm_loss_fn(LATENTS)(tm, batch, None)
    loss.backward()  # after the scope: the route was fixed by the forward
    assert len(calls) == 1
    assert abs(float(loss.detach()) - float(jloss)) < LOSS_ATOL
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= CLM_GRAD_RTOL, (name, err)


def test_three_step_trajectory_matches_jax_under_twoseg(clm, monkeypatch):
    jm, params = clm
    rng = np.random.default_rng(2)
    batches = [_batch(rng, 2) for _ in range(3)]
    calls = _spy_2seg(monkeypatch)
    schedule = (joptim.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1),
                tt.cosine_with_warmup(1e-3, training_steps=6, warmup_steps=1))
    jstate = JaxTrainState.create(jm.apply, params, joptim.make_optimizer(schedule[0], gradient_clip=1.0),
                                  jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jax_clm_loss_fn(jm.apply, max_latents=LATENTS), donate=False)
    tm = _port_model(params)
    tstate = tt.TrainState.create(tm, tt.make_optimizer(schedule[1], gradient_clip=1.0))
    tstep = tt.make_train_step(tt.clm_loss_fn(LATENTS))
    jlosses, tlosses = [], []
    with jfa.fast_kernels(TWOSEG), tfa.fast_kernels(TWOSEG):
        for batch in batches:
            jstate, jmetrics = jstep(jstate, _jax_batch(batch))
            tstate, tmetrics = tstep(tstate, batch)
            jlosses.append(float(jmetrics["loss"]))
            tlosses.append(float(tmetrics["loss"]))
    assert len(calls) == 3
    np.testing.assert_allclose(tlosses, jlosses, atol=LOSS_ATOL, rtol=0)
    want = convert.state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    init = convert.state_dict_from_jax(params)
    assert max(float((want[n] - init[n]).abs().max()) for n in want) > 1e-4  # the steps moved the parameters
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel() for n, p in tm.named_parameters()])
    assert diffs.max() <= PARAM_ATOL_NEAR_EPS, diffs.max()
    assert (diffs > PARAM_ATOL).mean() <= NEAR_EPS_SHARE, int((diffs > PARAM_ATOL).sum())


# ---------------------------------------------------------------------------
# (i) the feature switch
# ---------------------------------------------------------------------------


def test_feature_switch_scopes_like_jax():
    assert tfa.ALL_FEATURES == jfa.ALL_FEATURES
    assert tfa.fast_features() == frozenset()
    with tfa.fast_kernels(TWOSEG):
        assert tfa.fast_features() == TWOSEG
        with tfa.fast_kernels(True):
            assert tfa.fast_features() == tfa.ALL_FEATURES
        assert tfa.fast_features() == TWOSEG
        seen = []
        thread = threading.Thread(target=lambda: seen.append(tfa.fast_features()))
        thread.start()
        thread.join()
        assert seen == [frozenset()]  # a scope does not leak into another thread
    assert tfa.fast_features() == frozenset()
    with pytest.raises(ValueError, match="unknown kernel features"):
        with tfa.fast_kernels({"twoseg", "warp_speed"}):
            pass
    with pytest.raises(ValueError, match="unknown kernel features"):
        tfa.set_fast_kernels(["nope"])
    assert tfa.fast_features() == frozenset()


def test_backward_after_the_scope_follows_the_forward_route(cross_attention, monkeypatch):
    _, _, tca = cross_attention
    x_q, x_p, rope_q, rope_k, _ = map(_torch, _ca_inputs(rope=True, seed=6))
    bwd_calls = []
    real = tfa._bwd_2seg_plain
    monkeypatch.setattr(tfa, "_bwd_2seg_plain", lambda *a: bwd_calls.append(1) or real(*a))
    grads = []
    for close_first in (False, True):
        tca.zero_grad()
        with tfa.fast_kernels(TWOSEG):
            out = tca(x_q, x_kv_prefix=x_p, rope_q=rope_q, rope_k=rope_k).last_hidden_state
            if not close_first:
                out.sum().backward()
        if close_first:
            assert tfa.fast_features() == frozenset()
            out.sum().backward()
        grads.append({n: p.grad.clone() for n, p in tca.named_parameters()})
    assert bwd_calls == [1, 1]
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
