"""Masked-LM training CLI (counterpart of
``perceiver_io_tpu/scripts/text/mlm.py``; reference:
perceiver/scripts/text/mlm.py:8-44).

Links: ``data.vocab_size → model.decoder.vocab_size``, ``data.max_seq_len →
model.{encoder,decoder}.max_seq_len``. Defaults follow the reference's paper
presets (8-layer encoder block, 64 input channels).
"""

from __future__ import annotations

from typing import Optional, Sequence

from perceiver_io_tpu_torch.core.config import PerceiverIOConfig
from perceiver_io_tpu_torch.models.text import MaskedLanguageModel, TextDecoderConfig, TextEncoderConfig
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts.text.common import TextDataArgs, build_text_datamodule
from perceiver_io_tpu_torch.training.losses import masked_lm_loss_fn


def add_model_args(parser, encoder_defaults=None, decoder_defaults=None):
    cli.add_dataclass_args(parser, TextEncoderConfig, "model.encoder", encoder_defaults)
    cli.add_dataclass_args(parser, TextDecoderConfig, "model.decoder", decoder_defaults)
    parser.add_argument("--model.num_latents", dest="model.num_latents", type=int, default=64)
    parser.add_argument(
        "--model.num_latent_channels", dest="model.num_latent_channels", type=int, default=64
    )
    parser.add_argument(
        "--model.activation_checkpointing",
        dest="model.activation_checkpointing",
        type=cli._str2bool,
        default=False,
    )


def build_model_config(args, vocab_size: int, max_seq_len: int):
    encoder = cli.build_dataclass(
        TextEncoderConfig, args, "model.encoder", vocab_size=vocab_size, max_seq_len=max_seq_len
    )
    decoder = cli.build_dataclass(
        TextDecoderConfig, args, "model.decoder", vocab_size=vocab_size, max_seq_len=max_seq_len
    )
    return PerceiverIOConfig(
        encoder=encoder,
        decoder=decoder,
        num_latents=getattr(args, "model.num_latents"),
        num_latent_channels=getattr(args, "model.num_latent_channels"),
        activation_checkpointing=getattr(args, "model.activation_checkpointing"),
    )


def make_mask_fill_callback(tokenizer, masked_samples: Sequence[str]):
    """Validation-end mask-fill logging (reference:
    perceiver/model/text/mlm/lightning.py:77-94 + MaskFiller, mlm/utils.py)
    through ``hf.MaskFiller`` on the trained model."""

    def callback(trainer, state, step):
        if not masked_samples:
            return
        from perceiver_io_tpu_torch.hf.mask_filler import MaskFiller

        filler = MaskFiller(state.model, tokenizer, device=state.model.device)
        try:
            predictions = filler.fill(list(masked_samples), num_predictions=3)
            text = "\n".join(", ".join(p) for p in predictions)
        except ValueError as e:  # a bad sample must not abort training
            text = f"mask filling failed: {e}"
        if trainer.logger is not None:
            trainer.logger.log_text(step, "masked_samples", text)

    return callback


def main(argv: Optional[Sequence[str]] = None):
    parser = cli.make_parser(
        "Perceiver IO masked language model",
        optimizer_defaults={"lr": 1e-3, "warmup_steps": 1000},
    )
    add_model_args(parser)
    cli.add_dataclass_args(parser, TextDataArgs, "data", {"max_seq_len": 256, "batch_size": 64})
    parser.add_argument(
        "--task.masked_samples",
        dest="task.masked_samples",
        type=str,
        default=None,
        help="'|'-separated sentences with [MASK] tokens, logged each validation",
    )
    cli.add_smoke_preset(
        parser,
        {
            "data.dataset": "synthetic",
            "data.max_seq_len": 256,
            "data.batch_size": 32,
            "trainer.max_steps": 600,
            # dense early validation: the big descent (uniform ~5.6 nats to
            # the output-marginal ~2.8) happens inside the first 100 steps
            "trainer.val_interval": 50,
            "trainer.name": "mlm_smoke",
            "optimizer.warmup_steps": 50,
        },
    )
    args = cli.parse_args(parser, argv)

    trainer_args = cli.build_dataclass(cli.TrainerArgs, args, "trainer")
    opt_args = cli.build_dataclass(cli.OptimizerArgs, args, "optimizer")
    data_args = cli.build_dataclass(TextDataArgs, args, "data")

    data = build_text_datamodule(data_args, task="mlm")
    model_config = build_model_config(args, data.vocab_size, data_args.max_seq_len)
    samples_flag = getattr(args, "task.masked_samples")
    callbacks = []
    if samples_flag:
        callbacks.append(make_mask_fill_callback(data.tokenizer, samples_flag.split("|")))
    dtype = cli.activation_dtype(trainer_args)
    return cli.run_training(
        lambda device, generator: MaskedLanguageModel(model_config, dtype=dtype, device=device, generator=generator),
        model_config,
        masked_lm_loss_fn(),
        cli.cycle(data.train_batches()),
        data.valid_batches(),
        trainer_args,
        opt_args,
        command=args.command,
        callbacks=callbacks,
    )


if __name__ == "__main__":
    main()
