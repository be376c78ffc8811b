"""The port's sequence parallelism and FSDP placement rule against the JAX
package, on the CPU: ``ops/online_softmax.py``, ``parallel/ring_attention.py``
(gloo ranks against JAX's ``shard_map`` wrappers on a ``seq=4`` mesh of the
forced CPU devices), ``parallel/long_context.py`` (the prefix-sharded CLM's
loss and gradients on 2 and 4 ranks against ``jax.value_and_grad`` through
JAX's ``make_seq_parallel_clm_loss``; the ring loss with padded latent labels
against JAX's jitted one; the training keep set against the dense ``"mask"``
mode's) and ``parallel/mesh.py``'s ``fsdp_param_shardings`` against JAX's
spec for every parameter of the micro and flagship trees.

The ranks are child processes running this file as a script: they import
torch and the port only (never JAX, never ``tests/conftest.py``), set one
thread each, meet through a ``FileStore`` under ``tmp_path`` with the group
timeout set low, and exchange numpy files with the parent, which computes
the JAX references. One world of each size runs every check of that size.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = dict(vocab_size=64, max_seq_len=64, max_latents=16, num_channels=32, num_heads=4,
             num_self_attention_layers=2, cross_attention_dropout=0.0)
PREFIX = MICRO["max_seq_len"] - MICRO["max_latents"]
# attention blocks: batch, heads, queries, keys, head dim
B, H, N, M, D = 2, 2, 8, 32, 8
CA_CASES = {"plain": (False, False), "causal_padded": (True, True), "masked_row": (False, True)}
SA_CASES = {"plain": (False, False), "causal_padded": (True, True)}
# JAX's tolerances for the sequence-parallel CLM (tests/test_seq_parallel_step.py)
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4, 2e-3
# the ring blocks against JAX's: both f32 sums of the same products
ATTN_ATOL = 2e-6
WORKER_TIMEOUT_S = 240


def _spawn(scenario: str, world: int, d: str):
    """Start ``world`` ranks of this file's worker; returns the processes."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PIO_GROUP_TIMEOUT_S="120", OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), d],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _join(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _port_model(weights, **overrides):
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**{**MICRO, **overrides}), device="cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in weights.items() if k.startswith("w/")},
                          strict=True)
    return model


def _refuses(fn, text: str) -> bool:
    try:
        fn()
    except ValueError as e:
        return text in str(e)
    return False


def _worker(scenario: str, rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    from perceiver_io_tpu_torch.parallel import dist as pdist
    from perceiver_io_tpu_torch.parallel.long_context import (
        make_ring_clm_loss,
        make_seq_parallel_clm_forward,
        make_seq_parallel_clm_loss,
    )
    from perceiver_io_tpu_torch.parallel.mesh import make_mesh
    from perceiver_io_tpu_torch.parallel.ring_attention import make_ring_cross_attention, make_ring_self_attention

    torch.set_num_threads(1)
    pdist.initialize("cpu", rank, world, store=dist.FileStore(os.path.join(d, f"store_{scenario}"), world))
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    t = {k: torch.from_numpy(v) for k, v in ref.items() if not k.startswith("w/")}
    out = {}
    mesh = make_mesh(data=1, seq=world, device="cpu")

    # the seq-parallel loss and its gradients, averaged over the seq group
    model = _port_model(ref)
    loss_fn = make_seq_parallel_clm_loss(model, mesh, prefix_len=PREFIX)
    loss = loss_fn(t["ids"], t["lat_labels"], t["pad"])
    loss.backward()
    out["loss"] = loss.detach().numpy()
    for name, p in model.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        out[f"grad/{name}"] = (g / world).numpy()

    if scenario == "seq4":
        for case, (causal, padded) in CA_CASES.items():
            pm = t[f"pm_{case}"] if padded else None
            o = make_ring_cross_attention(mesh, causal=causal)(t["q"], t["k"], t["v"], pm)
            out[f"ca/{case}"] = o.numpy()
        for case, (causal, padded) in SA_CASES.items():
            pm = t["pm_sa"] if padded else None
            o = make_ring_self_attention(mesh, causal=causal)(t["q_sa"], t["k"], t["v"], pm)
            out[f"sa/{case}"] = o.numpy()  # this rank's block

        # the trainer-signature ring loss: padded latent labels are masked
        ring = make_ring_clm_loss(model, mesh, max_latents=MICRO["max_latents"])
        batch = {"input_ids": t["ids"], "labels": t["labels"], "pad_mask": t["pad_latent"]}
        with torch.no_grad():
            out["ring_poisoned"] = ring(model, batch, None, deterministic=True)[0].numpy()
            out["ring_explicit"] = ring(model, dict(batch, labels=t["labels_explicit"]), None,
                                        deterministic=True)[0].numpy()
        # the direct forward refuses padding past the prefix, as JAX's eager call
        fwd = make_seq_parallel_clm_forward(model, mesh, prefix_len=PREFIX)
        out["refused"] = np.array(_refuses(lambda: fwd(t["ids"], t["pad_latent"]), "left-padded"))

        # the training keep set: the dense "mask" mode's draw over the global
        # prefix, from generators seeded alike
        drop = _port_model(ref, cross_attention_dropout=0.5, prefix_dropout_mode="mask")
        with torch.no_grad():
            dense = drop(t["ids"], prefix_len=PREFIX, deterministic=False,
                         generator=torch.Generator().manual_seed(7)).logits
            seq = make_seq_parallel_clm_forward(drop, mesh, prefix_len=PREFIX)(
                t["ids"], generator=torch.Generator().manual_seed(7), deterministic=False)
            plain = drop(t["ids"], prefix_len=PREFIX).logits
        out["keep_err"] = (seq - dense).abs().max().numpy()
        out["keep_moves"] = (plain - dense).abs().max().numpy()
        # a training draw needs a generator seeded alike on every rank
        out["no_generator_refused"] = np.array(_refuses(lambda: make_seq_parallel_clm_forward(
            drop, mesh, prefix_len=PREFIX)(t["ids"], deterministic=False), "seeded alike"))
        # post-attention and residual dropout raise in training, as in JAX
        residual = _port_model(ref, residual_dropout=0.1)
        out["residual_refused"] = np.array(_refuses(lambda: make_seq_parallel_clm_forward(
            residual, mesh, prefix_len=PREFIX)(t["ids"], deterministic=False), "residual dropout"))

    np.savez(os.path.join(d, f"{scenario}_rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX's references
# ---------------------------------------------------------------------------


def _jax_micro():
    import jax
    import jax.numpy as jnp

    from perceiver_io_tpu.models.text import CausalLanguageModel, CausalLanguageModelConfig

    model = CausalLanguageModel(CausalLanguageModelConfig(**MICRO))
    init = jax.jit(model.init, static_argnames="prefix_len")  # eager init costs ~4x the compile
    params = init(jax.random.PRNGKey(0), jnp.zeros((2, MICRO["max_seq_len"]), jnp.int32), prefix_len=PREFIX)
    return model, params


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from perceiver_io_tpu.parallel import make_mesh
    from perceiver_io_tpu.parallel.long_context import make_ring_clm_loss, make_seq_parallel_clm_loss
    from perceiver_io_tpu.parallel.ring_attention import make_ring_cross_attention, make_ring_self_attention
    from perceiver_io_tpu_torch.convert import state_dict_from_jax

    d = str(tmp_path_factory.mktemp("dist_seq"))
    rng = np.random.default_rng(0)
    seq_len, lat = MICRO["max_seq_len"], MICRO["max_latents"]
    tokens = rng.integers(0, MICRO["vocab_size"], size=(2, seq_len + 1))
    pad = np.zeros((2, seq_len), bool)
    pad[1, :5] = True  # left padding inside the prefix
    pad_latent = np.zeros((2, seq_len), bool)
    pad_latent[:, -2:] = True  # reaching into the latent window
    labels = tokens[:, 1:].copy()
    explicit = labels.copy()
    explicit[:, -2:] = -100
    lat_labels = np.where(pad[:, -lat:], -100, labels[:, -lat:])
    q = rng.standard_normal((B, H, N, D), dtype=np.float32)
    k = rng.standard_normal((B, H, M, D), dtype=np.float32)
    v = rng.standard_normal((B, H, M, D), dtype=np.float32)
    q_sa = rng.standard_normal((B, H, M, D), dtype=np.float32)
    pm = np.zeros((B, M), bool)
    pm[0, :3] = True
    masked_row = pm.copy()
    masked_row[1] = True
    ref = dict(ids=tokens[:, :-1], labels=labels, labels_explicit=explicit, lat_labels=lat_labels, pad=pad,
               pad_latent=pad_latent, q=q, k=k, v=v, q_sa=q_sa, pm_causal_padded=pm, pm_masked_row=masked_row,
               pm_sa=pm)
    model, params = _jax_micro()
    weights = state_dict_from_jax(jax.tree.map(np.asarray, params))
    np.savez(os.path.join(d, "ref.npz"), **ref, **{f"w/{k}": w.numpy() for k, w in weights.items()})
    procs = {n: _spawn(f"seq{n}", n, d) for n in (4, 2)}

    # JAX's references while the ranks run
    # JAX's loss on a seq=4 mesh: its decomposition is exact, so the 2-rank
    # world is held to the same numbers
    mesh = make_mesh(data=1, seq=4, devices=jax.devices()[:4])
    loss = make_seq_parallel_clm_loss(model, mesh, prefix_len=PREFIX)
    value, grads = jax.value_and_grad(loss)(params, jnp.asarray(ref["ids"]), jnp.asarray(lat_labels),
                                            pad_mask=jnp.asarray(pad))
    want = {"loss": (float(value), {k: g.numpy() for k, g in state_dict_from_jax(
        jax.tree.map(np.asarray, grads)).items()})}
    for case, (causal, padded) in CA_CASES.items():
        attend = make_ring_cross_attention(mesh, causal=causal)
        want[f"ca/{case}"] = np.asarray(attend(q, k, v, ref[f"pm_{case}"] if padded else None))
    for case, (causal, padded) in SA_CASES.items():
        want[f"sa/{case}"] = np.asarray(make_ring_self_attention(mesh, causal=causal)(q_sa, k, v, pm if padded
                                                                                      else None))
    ring = make_ring_clm_loss(model, mesh, max_latents=lat)
    batch = {"input_ids": jnp.asarray(ref["ids"]), "labels": jnp.asarray(labels),
             "pad_mask": jnp.asarray(pad_latent)}
    want["ring"] = float(jax.jit(lambda p, b: ring(p, b, jax.random.PRNGKey(0), deterministic=True)[0])(params,
                                                                                                         batch))
    for n, ps in procs.items():
        _join(ps)
    got = {n: [dict(np.load(os.path.join(d, f"seq{n}_rank{r}.npz"))) for r in range(n)] for n in (4, 2)}
    return want, got


def test_online_softmax_matches_jax():
    import jax
    import jax.numpy as jnp

    from perceiver_io_tpu.ops import online_softmax as jos
    from perceiver_io_tpu_torch.ops import online_softmax as tos

    rng = np.random.default_rng(3)
    q, q2, k, v = (rng.standard_normal(s, dtype=np.float32) for s in ((2, 2, 4, 8), (2, 2, 4, 8), (2, 2, 6, 8),
                                                                        (2, 2, 6, 8)))
    masked = rng.random((2, 1, 4, 6)) < 0.3
    masked[0, 0, 1] = True  # a fully masked row

    def run(mod, cast):
        a = mod.block_attention(*(cast(x) for x in (q, k, v, masked)))
        b = mod.block_attention(*(cast(x) for x in (q2, k, v, ~masked)))
        o, _, l = mod.online_combine(a, b)
        return a + (mod.finalize(a[0], a[2]), mod.finalize(o, l))

    got = run(tos, torch.from_numpy)
    want = jax.jit(lambda: run(jos, jnp.asarray))()  # one program: eager JAX dispatch is slow here
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    assert float(got[2][0, 0, 1]) == 0.0 and not got[1].requires_grad
    assert np.all(got[3].numpy()[0, 0, 1] == 0.0)  # a fully masked row finalizes to 0


@pytest.mark.parametrize("case", list(CA_CASES))
def test_seq_sharded_cross_attention_matches_jax(worlds, case):
    want, got = worlds
    for r in range(4):  # replicated: every rank holds the whole output
        np.testing.assert_allclose(got[4][r][f"ca/{case}"], want[f"ca/{case}"], atol=ATTN_ATOL, rtol=0)
    if case == "masked_row":
        assert np.all(got[4][0]["ca/masked_row"][1] == 0.0)


@pytest.mark.parametrize("case", list(SA_CASES))
def test_ring_self_attention_matches_jax(worlds, case):
    want, got = worlds
    whole = np.concatenate([got[4][r][f"sa/{case}"] for r in range(4)], axis=2)
    np.testing.assert_allclose(whole, want[f"sa/{case}"], atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_clm_loss_and_grads_match_jax(worlds, n):
    want, got = worlds
    loss, grads = want["loss"]
    for r in range(n):
        np.testing.assert_allclose(float(got[n][r]["loss"]), loss, rtol=LOSS_RTOL)
    # the seq-averaged gradient is the dense one on every rank
    for name, g in grads.items():
        for r in range(n):
            np.testing.assert_allclose(got[n][r][f"grad/{name}"], g, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_ring_loss_masks_padded_latent_labels_like_jax(worlds):
    want, got = worlds
    for r in range(4):
        np.testing.assert_allclose(float(got[4][r]["ring_poisoned"]), want["ring"], rtol=LOSS_RTOL)
        assert float(got[4][r]["ring_poisoned"]) == pytest.approx(float(got[4][r]["ring_explicit"]), rel=1e-6)
        assert bool(got[4][r]["refused"])


def test_seq_parallel_keep_set_is_the_dense_mask_modes(worlds):
    _, got = worlds
    for r in range(4):
        assert float(got[4][r]["keep_err"]) <= 1e-7
        assert float(got[4][r]["keep_moves"]) > 1e-4  # the dropout moved the logits a thousandfold more
        assert bool(got[4][r]["residual_refused"]) and bool(got[4][r]["no_generator_refused"])


@pytest.mark.parametrize("tree", ["micro", "flagship"])
def test_fsdp_param_shardings_match_jax(tree):
    import jax
    import jax.numpy as jnp

    from perceiver_io_tpu.models.text import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu.parallel import make_mesh as jax_make_mesh
    from perceiver_io_tpu.parallel.mesh import fsdp_param_shardings as jax_shardings
    from perceiver_io_tpu_torch.convert import jax_param_paths
    from perceiver_io_tpu_torch.models.text import CausalLanguageModel as PortCLM
    from perceiver_io_tpu_torch.models.text import CausalLanguageModelConfig as PortConfig
    from perceiver_io_tpu_torch.parallel.mesh import fsdp_param_shardings

    geo = MICRO if tree == "micro" else dict(vocab_size=262, max_seq_len=16384, max_latents=1024, num_channels=512,
                                             num_heads=8, num_self_attention_layers=8, cross_attention_dropout=0.5)
    jm = CausalLanguageModel(CausalLanguageModelConfig(**geo))
    lat = geo["max_latents"]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, lat + 8), jnp.int32), prefix_len=8))
    port = PortCLM(PortConfig(**geo), device="meta")
    paths = jax_param_paths(port)
    devices = jax.devices()
    for fsdp, min_size in ((2, 0), (4, 2**14), (8, 2**14), (8, 0)):
        mesh = jax_make_mesh(data=len(devices) // fsdp, fsdp=fsdp, devices=devices)
        specs = jax_shardings(shapes, mesh, min_weight_size=min_size)
        flat = {"params/" + "/".join(str(getattr(p, "key", p)) for p in path): s.spec
                for path, s in jax.tree_util.tree_flatten_with_path(specs["params"])[0]}
        ours = fsdp_param_shardings(port, min_weight_size=min_size, fsdp_size=fsdp)
        assert sorted(paths[n] for n in ours) == sorted(flat)
        sharded = 0
        for name, dim in ours.items():
            spec = tuple(flat[paths[name]])
            jax_dim = next((i for i, a in enumerate(spec) if a == "fsdp"), None)
            if jax_dim is not None and paths[name].endswith("/kernel"):
                jax_dim = 1 - jax_dim  # the kernel is the Linear weight transposed
            assert dim == jax_dim, (name, spec, dim)
            sharded += dim is not None
        # JAX replicates every micro parameter under the default minimum size
        assert sharded > 0 or (tree == "micro" and min_size > 0)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
