"""Text-classifier training CLI with two-stage training support (counterpart
of ``perceiver_io_tpu/scripts/text/classifier.py``; reference:
perceiver/scripts/text/classifier.py:8-38,
perceiver/model/text/classifier/lightning.py:14-43):

- ``--model.params=<dir>`` — warm-start the full model from a saved artifact.
- ``--model.encoder.params=<dir>`` — warm-start the encoder (with its token
  adapter) only, e.g. from an MLM run; ``--model.encoder.freeze=true``
  freezes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

from perceiver_io_tpu_torch.core.config import ClassificationDecoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.models.text import TextClassifier, TextEncoderConfig
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts.text.common import TextDataArgs, build_text_datamodule
from perceiver_io_tpu_torch.training.losses import classification_loss_fn

# the encoder's parameter subtrees by their JAX paths (what freeze_mask
# reads), and the state-dict prefix that holds both in the port: module 0 of
# the model, the encoder with its input adapter
ENCODER_SUBTREES = ("input_adapter", "encoder")
ENCODER_PREFIX = "0"


def make_warm_start(model_params_dir: Optional[str], encoder_params_dir: Optional[str]):
    """``model -> None``: the whole model's weights from ``model_params_dir``
    (strict), else the encoder's from ``encoder_params_dir`` (the entries
    under :data:`ENCODER_PREFIX`), written into the built model; None when
    neither is given."""
    if model_params_dir is None and encoder_params_dir is None:
        return None

    from perceiver_io_tpu_torch.training.checkpoint import load_params_into, load_pretrained

    def warm_start(model):
        if model_params_dir is not None:
            load_pretrained(model_params_dir, model=model)
            return
        source, _ = load_pretrained(encoder_params_dir)
        model.load_state_dict(load_params_into(model.state_dict(), source, subtree=ENCODER_PREFIX), strict=True)

    return warm_start


def main(argv: Optional[Sequence[str]] = None):
    parser = cli.make_parser(
        "Perceiver IO text classifier",
        optimizer_defaults={"lr": 1e-4, "warmup_steps": 100},
    )
    cli.add_dataclass_args(parser, TextEncoderConfig, "model.encoder")
    cli.add_dataclass_args(
        parser,
        ClassificationDecoderConfig,
        "model.decoder",
        {"num_output_query_channels": 64, "num_classes": 2},
    )
    parser.add_argument("--model.params", dest="model.params", type=str, default=None)
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
    cli.add_dataclass_args(parser, TextDataArgs, "data", {"dataset": "imdb", "max_seq_len": 256, "batch_size": 64})
    cli.add_smoke_preset(
        parser,
        {
            "data.dataset": "synthetic",
            "data.max_seq_len": 256,
            "data.batch_size": 32,
            "trainer.max_steps": 400,
            "trainer.val_interval": 100,
            "trainer.name": "txt_clf_smoke",
        },
    )
    args = cli.parse_args(parser, argv)

    trainer_args = cli.build_dataclass(cli.TrainerArgs, args, "trainer")
    opt_args = cli.build_dataclass(cli.OptimizerArgs, args, "optimizer")
    data_args = cli.build_dataclass(TextDataArgs, args, "data")

    data = build_text_datamodule(data_args, task="clf")
    num_classes = getattr(data, "num_classes", getattr(args, "model.decoder.num_classes"))
    encoder = cli.build_dataclass(
        TextEncoderConfig,
        args,
        "model.encoder",
        vocab_size=data.vocab_size,
        max_seq_len=data_args.max_seq_len,
    )
    decoder = cli.build_dataclass(
        ClassificationDecoderConfig, args, "model.decoder", num_classes=num_classes
    )
    model_config = PerceiverIOConfig(
        encoder=encoder,
        decoder=decoder,
        num_latents=getattr(args, "model.num_latents"),
        num_latent_channels=getattr(args, "model.num_latent_channels"),
        activation_checkpointing=getattr(args, "model.activation_checkpointing"),
    )
    dtype = cli.activation_dtype(trainer_args)
    return cli.run_training(
        lambda device, generator: TextClassifier(model_config, dtype=dtype, device=device, generator=generator),
        model_config,
        classification_loss_fn(),
        cli.cycle(data.train_batches()),
        data.valid_batches(),
        trainer_args,
        opt_args,
        command=args.command,
        frozen_paths=ENCODER_SUBTREES if encoder.freeze else (),
        warm_start=make_warm_start(getattr(args, "model.params"), encoder.params),
    )


if __name__ == "__main__":
    main()
