"""The bodies the card captures into CUDA graphs never touch the host.

A capture records device work only: a host sync inside it (a tensor's
truth value, ``.item()``, ``.tolist()``, ``.cpu()``, ``float()``/``int()``
of a tensor) fails it. Here, on the CPU, each body that the card captures
runs with those methods patched to raise: the paged decode step's body
(greedy and sampled, the draws staged before it), the CLM train step
(microbatch 2, the non-finite sentinel on, a warmup-cosine schedule, on the
concat route and under "twoseg") and the eval step. The host work around
them (the draws, the prefill, the engine's one token fetch) runs before the
patch."""

import numpy as np
import pytest
import torch

from perceiver_io_tpu_torch import generation
from perceiver_io_tpu_torch import training as tt
from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops.flash_attention import fast_kernels
from perceiver_io_tpu_torch.serving import EngineConfig, EngineFrontEnd, RequestSpec

CLM = dict(vocab_size=262, max_seq_len=512, max_latents=128, num_channels=64, num_heads=4,
           num_self_attention_layers=2)
SYNCS = ("__bool__", "item", "tolist", "cpu", "__float__", "__int__")


@pytest.fixture
def no_host_sync(monkeypatch):
    """Patch every host-sync method of ``torch.Tensor`` to raise, once the
    caller enters the returned context."""

    class Guard:
        def __enter__(self):
            for name in SYNCS:
                def refuse(*args, _name=name, **kwargs):
                    raise AssertionError(f"host sync inside a captured body: Tensor.{_name}")

                monkeypatch.setattr(torch.Tensor, name, refuse)

        def __exit__(self, *exc):
            monkeypatch.undo()

    return Guard()


def test_the_guard_catches_a_host_sync(no_host_sync):
    x = torch.ones(2)
    with no_host_sync, pytest.raises(AssertionError, match="__bool__"):
        if x.sum() > 0:
            pass


@pytest.mark.parametrize("config", [generation.GenerationConfig(),
                                    generation.GenerationConfig(do_sample=True, temperature=0.8, top_k=20,
                                                                top_p=0.9, eos_token_id=7)],
                         ids=["greedy", "sampled"])
def test_paged_step_body_needs_no_host(no_host_sync, config, monkeypatch):
    """The body reads the staged draws: it draws nothing on the host."""
    model = CausalLanguageModel(CausalLanguageModelConfig(**dict(CLM, max_seq_len=16, max_latents=8)),
                                device="cpu", generator=torch.Generator().manual_seed(0))
    engine = EngineFrontEnd(model, num_latents=4, base_config=config, device="cpu",
                            engine_config=EngineConfig(slots=3, page_size=8, max_ca_tokens=24, max_sa_tokens=16))
    rng = np.random.default_rng(0)
    for i, n in enumerate((8, 12)):  # two busy slots, one idle
        engine.submit(RequestSpec(i, n, 8, rng.integers(0, 262, size=(1, n)), i))
    engine._fill_slots()
    stage = generation._UniformStage(config, model.device)
    draw = generation._draw_uniforms
    for _ in range(3):  # the windows slide from the second step on
        stage(engine._state)

        def no_draw(*args):
            raise AssertionError("a host draw inside a captured body")

        monkeypatch.setattr(generation, "_draw_uniforms", no_draw)
        with no_host_sync:
            _, tokens = generation._paged_decode_step_body(model, config, engine._state)
        monkeypatch.setattr(generation, "_draw_uniforms", draw)
        assert tokens is engine._state["token"] and tokens.shape == (3,)


@pytest.mark.parametrize("route", [(), ("twoseg",)], ids=["concat", "twoseg"])
def test_train_step_needs_no_host(no_host_sync, route):
    model = CausalLanguageModel(CausalLanguageModelConfig(**CLM), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    state = tt.TrainState.create(model, tt.make_optimizer(tt.cosine_with_warmup(1e-3, 6, 1), gradient_clip=1.0))
    step = tt.make_train_step(tt.clm_loss_fn(128), microbatch=2, sentinel=True)
    rng = np.random.default_rng(1)
    t = rng.integers(0, 262, size=(4, 257))
    batch = {"input_ids": torch.from_numpy(t[:, :-1]), "labels": torch.from_numpy(t[:, 1:]), "pad_mask": None,
             "prefix_keep_idx": torch.from_numpy(tt.sample_prefix_keep_idx(rng, 4, 128, 0.5))}
    with fast_kernels(set(route)), no_host_sync:
        for _ in range(2):
            state, metrics = step(state, batch)
    assert state.step == 2 and float(metrics["sentinel_skipped"]) == 0.0


def test_eval_step_needs_no_host(no_host_sync):
    model = CausalLanguageModel(CausalLanguageModelConfig(**CLM), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    eval_step = tt.make_eval_step(tt.clm_loss_fn(128, deterministic=True))
    t = torch.from_numpy(np.random.default_rng(2).integers(0, 262, size=(2, 257)))
    with no_host_sync:
        loss, metrics = eval_step(model, {"input_ids": t[:, :-1], "labels": t[:, 1:], "pad_mask": None})
    assert np.isfinite(float(loss))
