"""The port's embedding-table lookup (``core/adapter.py::lookup``), whose
weight gradient sums each row's contributions in an order fixed by the
indices (``index_put_`` with accumulation) instead of ``F.embedding``'s
CUDA backward, which takes more than 3072 indices in an order that moves
from call to call. CPU only; tolerances stated per test."""

import numpy as np
import pytest
import torch

from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.core import adapter
from perceiver_io_tpu_torch.core.adapter import lookup
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig


@pytest.mark.parametrize("n_ids,rows", [(17408, 262), (300, 16384), (5, 7)])
def test_lookup_matches_embedding_and_repeats(n_ids, rows):
    """Forward rows exactly as ``F.embedding``; the weight gradient within
    f32 rounding of ``F.embedding``'s (atol 1e-5 on sums of up to ~70
    unit-scale rows: the flagship chunk's 17408 token ids over 262 rows),
    bit for bit the same on a second call."""
    g = torch.Generator().manual_seed(0)
    table = torch.nn.Embedding(rows, 32)
    ids = torch.randint(0, rows, (2, n_ids // 2 or 1), generator=g)
    dy = torch.randn(*ids.shape, 32, generator=g)
    out = lookup(table, ids)
    assert torch.equal(out, torch.nn.functional.embedding(ids, table.weight))
    grads = []
    for _ in range(2):
        table.weight.grad = None
        lookup(table, ids).backward(dy)
        grads.append(table.weight.grad.clone())
    table.weight.grad = None
    torch.nn.functional.embedding(ids, table.weight).backward(dy)
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], table.weight.grad, atol=1e-5, rtol=0)


@pytest.mark.parametrize("route", [frozenset(), frozenset({"twoseg"})], ids=["concat", "twoseg"])
def test_the_clm_step_takes_its_table_gradients_through_the_lookup(route, monkeypatch):
    """A micro CLM's train step (token and position tables, the kept prefix
    rows gathered on both routes) against the same step with the tables read
    by ``F.embedding``: the loss bit for bit, every gradient within f32
    rounding (per parameter, max abs difference over the max abs value
    <= 1e-6), and the lookup called for every table read of the step."""
    from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels

    config = CausalLanguageModelConfig(vocab_size=262, max_seq_len=256, max_latents=64, num_channels=64,
                                       num_heads=4, num_self_attention_layers=2)
    rng = np.random.default_rng(2)
    t = rng.integers(0, 262, size=(2, 257))
    batch = {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None,
             "prefix_keep_idx": tt.sample_prefix_keep_idx(rng, 2, 192, 0.5)}
    model = CausalLanguageModel(config, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []

    def counted(table, ids):
        calls.append(table)
        return lookup(table, ids)

    losses, grads = [], []
    for read in (counted, lambda table, ids: table(ids)):
        monkeypatch.setattr(adapter, "lookup", read)
        model.zero_grad(set_to_none=True)
        with fast_kernels(route):
            loss, _ = tt.clm_loss_fn(64)(model, batch)
        loss.backward()
        losses.append(loss.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert calls and all(isinstance(table, torch.nn.Embedding) for table in calls)
    assert torch.equal(losses[0], losses[1])
    rel = {n: float((grads[0][n] - g).abs().max() / g.abs().max()) for n, g in grads[1].items()}
    assert max(rel.values()) <= 1e-6, sorted(rel.items(), key=lambda kv: -kv[1])[:3]
