"""Causal LM training CLI (counterpart of
``perceiver_io_tpu/scripts/text/clm.py``; reference:
perceiver/scripts/text/clm.py:8-27).

Link rules applied (reference ``link_arguments``): ``data.vocab_size →
model.vocab_size`` (tokenizer-derived), ``data.max_seq_len →
model.max_seq_len``, ``trainer.max_steps → optimizer.training_steps``.
At each validation end a text sample is generated and logged
(reference: perceiver/model/text/clm/lightning.py:55-92).

Run: ``python -m perceiver_io_tpu_torch.scripts.text.clm fit --data.dataset=wikitext
--trainer.max_steps=1000 ...`` (on the card; ``--trainer.accelerator=cpu``
runs the plain versions on the CPU). Across processes: ``torchrun
--nproc_per_node=N -m perceiver_io_tpu_torch.scripts.text.clm fit
--trainer.strategy=fsdp ...`` (``dp``, ``fsdp``; ``ring`` and ``seq`` shard
the prefix over the processes through
``parallel.long_context.make_ring_clm_loss``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from perceiver_io_tpu_torch.models.text import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts.text.common import TextDataArgs, build_text_datamodule
from perceiver_io_tpu_torch.training.losses import clm_loss_fn


@dataclass
class CLMTaskArgs:
    sample_prompt: Optional[str] = None
    num_sample_tokens: int = 512
    sample_top_k: int = 10


def make_sample_callback(tokenizer, task_args: CLMTaskArgs):
    """Validation-end sample generation logged as text (reference:
    clm/lightning.py:55-92, @rank_zero_only) through the port's
    ``generate`` on the trained model, its draws from a CPU generator
    seeded by the step (the JAX package's ``PRNGKey(step)``). A sharded
    state (a mesh) logs no sample: generation from sharded weights waits for
    ROADMAP A12 part 2, slice 2."""

    def callback(trainer, state, step):
        if task_args.sample_prompt is None or getattr(state, "mesh", None) is not None:
            return
        from perceiver_io_tpu_torch.generation import GenerationConfig, generate

        model = state.model
        prompt = np.asarray([tokenizer.encode(task_args.sample_prompt)], dtype=np.int32)
        num_latents = min(model.config.max_latents, prompt.shape[1])
        out = generate(
            model,
            prompt,
            num_latents=num_latents,
            config=GenerationConfig(max_new_tokens=task_args.num_sample_tokens, top_k=task_args.sample_top_k),
            generator=torch.Generator().manual_seed(int(step)),
            device=model.device,
        )
        text = tokenizer.decode(out[0].tolist())
        if trainer.logger is not None:
            trainer.logger.log_text(step, "generated_text", text)

    return callback


def main(argv: Optional[Sequence[str]] = None):
    parser = cli.make_parser(
        "Perceiver AR causal language model",
        optimizer_defaults={"lr": 2e-4, "warmup_steps": 200},
    )
    cli.add_dataclass_args(
        parser,
        CausalLanguageModelConfig,
        "model",
        # paper-preset defaults (reference: scripts/text/clm.py:16-24)
        {"max_latents": 512, "num_channels": 512, "num_self_attention_layers": 8, "cross_attention_dropout": 0.5},
    )
    cli.add_dataclass_args(parser, TextDataArgs, "data", {"max_seq_len": 4096, "batch_size": 8})
    cli.add_dataclass_args(parser, CLMTaskArgs, "task")
    cli.add_smoke_preset(
        parser,
        {
            "data.dataset": "synthetic",
            "data.max_seq_len": 1024,
            "data.batch_size": 8,
            "model.max_latents": 256,
            "model.num_channels": 192,
            "model.num_self_attention_layers": 4,
            "trainer.max_steps": 600,
            "trainer.val_interval": 100,
            "trainer.name": "clm_smoke",
            "optimizer.warmup_steps": 50,
        },
    )
    args = cli.parse_args(parser, argv)

    trainer_args = cli.build_dataclass(cli.TrainerArgs, args, "trainer")
    opt_args = cli.build_dataclass(cli.OptimizerArgs, args, "optimizer")
    data_args = cli.build_dataclass(TextDataArgs, args, "data")
    task_args = cli.build_dataclass(CLMTaskArgs, args, "task")

    data = build_text_datamodule(data_args, task="clm")
    # data→model links (reference: clm.py:13-14)
    model_config = cli.build_dataclass(
        CausalLanguageModelConfig,
        args,
        "model",
        vocab_size=data.vocab_size,
        max_seq_len=data_args.max_seq_len,
    )
    seq_len = data_args.max_seq_len
    def ring_loss_builder(model, mesh):
        # --trainer.strategy=ring|seq: the prefix sharded over the seq axis,
        # its cross-attention partial through parallel/ring_attention.py
        from perceiver_io_tpu_torch.parallel.long_context import make_ring_clm_loss

        return make_ring_clm_loss(model, mesh, max_latents=model_config.max_latents)

    train_iter = cli.cycle(data.train_batches())
    if model_config.cross_attention_dropout > 0.0 and trainer_args.strategy not in ("ring", "seq"):
        # host-sampled prefix-dropout keep sets: the in-graph draw's law,
        # drawn while the card computes (ring/seq draw the keep mask in the
        # forward, from the generator every rank holds alike)
        from perceiver_io_tpu_torch.training.prefix_dropout import with_prefix_keep_idx

        train_iter = with_prefix_keep_idx(
            train_iter,
            prefix_len=seq_len - model_config.max_latents,
            dropout=model_config.cross_attention_dropout,
            seed=trainer_args.seed,
        )

    dtype = cli.activation_dtype(trainer_args)
    return cli.run_training(
        lambda device, generator: CausalLanguageModel(model_config, dtype=dtype, device=device, generator=generator),
        model_config,
        clm_loss_fn(model_config.max_latents),
        train_iter,
        data.valid_batches(),
        trainer_args,
        opt_args,
        command=args.command,
        callbacks=[make_sample_callback(data.tokenizer, task_args)],
        ring_loss_builder=ring_loss_builder,
    )


if __name__ == "__main__":
    main()
