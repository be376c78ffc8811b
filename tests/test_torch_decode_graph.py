"""The contiguous decode pair's device-side step (``make_decode_fns``'
``step``, and so ``generate``), the body the card captures into a CUDA
graph, on the CPU:

- it equals the host-length step it replaced bit for bit (tokens and
  logits), over steps that slide both windows: the replaced step, kept
  here as ``_host_length_step``, reads Python-int cache lengths and window
  counters and draws from the generator inside the body;
- its greedy stream equals the JAX package's ``make_decode_fns`` stream
  (f32), past the window slide;
- it writes the state's tensors in place (their addresses do not move);
- its body makes no host read of a tensor: a ``TorchDispatchMode`` fails on
  ``aten._local_scalar_dense``, what ``.item()``, ``bool()`` and ``int()``
  of a tensor reach (the CPU's stand-in for "capturable").

Every comparison here is exact (the same kernels on the same inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perceiver_io_tpu import generation as jgen
from perceiver_io_tpu.models.text import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu_torch import generation as tgen
from perceiver_io_tpu_torch.convert import state_dict_from_jax
from perceiver_io_tpu_torch.core.cache import KVCache
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

# the prompt fills both windows (64 tokens, 16 latents): they slide from the
# first step on
TINY = dict(vocab_size=262, max_seq_len=64, max_latents=16, num_channels=64, num_heads=4,
            num_self_attention_layers=2)
SEQ, LATENTS, NEW = 64, 16, 12
GREEDY = tgen.GenerationConfig(max_new_tokens=NEW)
SAMPLED = tgen.GenerationConfig(max_new_tokens=NEW, do_sample=True, temperature=0.8, top_k=40, top_p=0.95,
                                eos_token_id=5)


def _host_length_step(model, config, state):
    """The step this PR replaced, as it was: host-int cache lengths and
    window counters, the draw inside the body, a new state each step."""
    mcfg = model.config
    cache = state["cache"]
    ca_cache, sa_cache = cache[0], cache[1]
    ca_start, sa_start = state["ca_start"], state["sa_start"]
    if ca_cache.length - ca_start >= mcfg.max_seq_len:
        ca_start += 1
    if sa_cache.length - sa_start >= mcfg.max_latents:
        sa_start += 1
    dev = state["token"].device
    ca_idx = torch.arange(ca_cache.capacity, device=dev)[None, :]
    sa_idx = torch.arange(sa_cache.capacity, device=dev)[None, :]
    out = model(
        state["token"][:, None], prefix_len=0,
        pad_mask=state["pad_slots"] | (ca_idx < ca_start), kv_cache=cache, decode=True,
        sa_pad_mask=sa_idx < sa_start, pos_shift=state["pos_shift"],
    )
    logits = out.logits[:, -1]
    sampled = tgen._sample(logits, config, state["generator"])
    sampled, done = tgen._finish_sample(sampled, state["done"], config)
    return dict(state, cache=out.kv_cache, ca_start=ca_start, sa_start=sa_start, token=sampled,
                done=done), sampled, logits


def _model(dtype, seed=0):
    return CausalLanguageModel(CausalLanguageModelConfig(**TINY), device="cpu", dtype=dtype,
                               generator=torch.Generator().manual_seed(seed))


def _prompt(batch=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 262, size=(batch, SEQ))
    pad = np.zeros((batch, SEQ), bool)
    pad[1, :9] = True
    return ids, pad


@pytest.mark.parametrize("dtype,cache_dtype,config", [
    (torch.float32, torch.float32, GREEDY),
    (torch.float32, torch.float32, SAMPLED),
    (torch.bfloat16, torch.float32, GREEDY),
    (torch.bfloat16, torch.bfloat16, GREEDY),
    (torch.bfloat16, torch.bfloat16, SAMPLED),
], ids=["f32", "f32_sampled", "bf16_f32_cache", "bf16_bf16_cache", "bf16_bf16_cache_sampled"])
def test_device_length_step_equals_the_host_length_step(dtype, cache_dtype, config):
    model = _model(dtype)
    ids, pad = _prompt()
    prefill, step = tgen.make_decode_fns(model, LATENTS, config, cache_dtype, device="cpu")
    first, state = prefill(ids, pad, torch.Generator().manual_seed(3))
    assert all(torch.is_tensor(c.length) and c.length.dtype == torch.int32 for c in state["cache"])
    # the replaced step, from the same prefill: host-int lengths and counters
    first_ref, ref = prefill(ids, pad, torch.Generator().manual_seed(3))
    ref = dict(ref, cache=tuple(KVCache(c.k, c.v, int(c.length)) for c in ref["cache"]), ca_start=0, sa_start=0)
    assert torch.equal(first, first_ref)
    slid = []
    with torch.no_grad():
        for _ in range(NEW - 1):
            state, token = step(state)
            ref, want, want_logits = _host_length_step(model, config, ref)
            assert torch.equal(token, want)
            assert torch.equal(state["logits"], want_logits)
            assert torch.equal(state["done"], ref["done"])
            assert [int(c.length) for c in state["cache"]] == [c.length for c in ref["cache"]]
            slid.append((int(state["ca_start"]), int(state["sa_start"])))
    assert slid[-1] == (ref["ca_start"], ref["sa_start"]) and min(slid[-1]) > 0, slid


@pytest.fixture(scope="module")
def jax_and_port_models():
    jm = JaxCLM(JaxCLMConfig(**TINY))
    ids = np.random.default_rng(0).integers(0, 262, size=(1, SEQ))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), prefix_len=SEQ - LATENTS))
    tm = CausalLanguageModel(CausalLanguageModelConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm


def test_greedy_stream_matches_jax_past_the_window_slide(jax_and_port_models):
    jm, params, tm = jax_and_port_models
    ids, pad = _prompt()
    jprefill, jstep = jgen.make_decode_fns(jm, LATENTS, jgen.GenerationConfig(max_new_tokens=NEW))
    tok, state = jprefill(params, jnp.asarray(ids), jnp.asarray(pad), jax.random.PRNGKey(0))
    want = [np.asarray(tok)]
    for _ in range(NEW - 1):
        state, tok = jstep(state)
        want.append(np.asarray(tok))
    assert int(state["ca_start"]) > 0 and int(state["sa_start"]) > 0  # both windows slid
    got = tgen.generate(tm, ids, LATENTS, pad_mask=pad, config=GREEDY, device="cpu")
    np.testing.assert_array_equal(got[:, SEQ:].numpy(), np.stack(want, axis=1))


def test_step_writes_the_state_in_place():
    prefill, step = tgen.make_decode_fns(_model(torch.float32), LATENTS, SAMPLED, device="cpu")
    _, state = prefill(*_prompt())
    addresses = tgen._state_tensors(state)
    tokens = []
    for _ in range(4):
        out, token = step(state)
        assert out is state
        tokens.append(token)
        assert tgen._state_tensors(state) == addresses
    # each emitted token is a tensor of its own, not the state's buffer
    assert all(t.data_ptr() != state["token"].data_ptr() for t in tokens)
    assert torch.equal(tokens[-1], state["token"]) and not all(torch.equal(tokens[0], t) for t in tokens)


class _NoHostRead(TorchDispatchMode):
    """Fails on a host read of a tensor's value (``.item()``, ``bool()``,
    ``int()`` and ``float()`` of a tensor all reach
    ``aten._local_scalar_dense``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a host read of a tensor inside the decode step's body")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_a_host_read():
    with _NoHostRead(), pytest.raises(AssertionError, match="host read"):
        int(torch.ones((), dtype=torch.int32) + 1)


@pytest.mark.parametrize("config", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_step_body_makes_no_host_read(config):
    """The body alone, after the host stages its draws: what the card
    captures."""
    model = _model(torch.float32)
    prefill, _ = tgen.make_decode_fns(model, LATENTS, config, device="cpu")
    _, state = prefill(*_prompt())
    stage = tgen._UniformStage(config, model.device)
    with torch.no_grad():
        for _ in range(3):  # the windows slide at every step
            stage(state)
            with _NoHostRead():
                _, tokens = tgen._decode_step_body(model, config, state)
            assert tokens is state["token"] and tokens.shape == (2,)
    assert int(state["ca_start"]) == 3 and int(state["sa_start"]) == 3
