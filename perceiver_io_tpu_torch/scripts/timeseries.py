"""Multivariate time-series forecasting CLI — the fork-added root app
(counterpart of ``perceiver_io_tpu/scripts/timeseries.py``; reference:
cli.py:1-16 over model.py/datamodule.py).

Links: ``data.usecols → model channels`` (input and output),
``data.in_len/out_len → model.encoder.in_len / model.decoder.out_len``.

Run: ``python -m perceiver_io_tpu_torch.scripts.timeseries fit
--data.train_path=series.csv --trainer.max_steps=1000 ...``
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.core.config import PerceiverIOConfig
from perceiver_io_tpu_torch.models.timeseries import (
    TimeSeriesDecoderConfig,
    TimeSeriesEncoderConfig,
    TimeSeriesPerceiver,
)
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.training.losses import mse_loss_fn


@dataclass
class TimeSeriesDataArgs:
    train_path: str = ""
    val_path: Optional[str] = None
    test_path: Optional[str] = None
    in_len: int = 4096
    out_len: int = 5000
    stride: int = 1000
    batch_size: int = 8
    usecols: List[int] = field(default_factory=lambda: list(range(1, 8)))
    seed: int = 0


def _synthetic_csv(num_channels: int, rows: int = 20000, seed: int = 7) -> str:
    """Deterministic multivariate series (sine mixtures + trend + noise) for
    fully-offline convergence runs; written once under .cache/timeseries
    (atomic rename-into-place — see parallel/dist.py prepare_once)."""
    from perceiver_io_tpu_torch.parallel.dist import prepare_once

    path = f".cache/timeseries/synthetic_{num_channels}x{rows}_{seed}.csv"

    def build(tmp_path) -> None:
        rng = np.random.default_rng(seed)
        t = np.arange(rows)[:, None]
        freqs = rng.uniform(0.002, 0.05, size=(1, num_channels))
        phases = rng.uniform(0, 2 * np.pi, size=(1, num_channels))
        series = (
            np.sin(2 * np.pi * freqs * t + phases)
            + 0.3 * np.sin(2 * np.pi * 3 * freqs * t)
            + 0.05 * rng.normal(size=(rows, num_channels))
        )
        header = "date," + ",".join(f"ch{i}" for i in range(num_channels))
        body = np.concatenate([t, series], axis=1)
        np.savetxt(tmp_path, body, delimiter=",", header=header, comments="", fmt="%.5f")

    prepare_once(path, build)
    return path


def build_timeseries_datamodule(args: TimeSeriesDataArgs):
    from perceiver_io_tpu_torch.data.timeseries import CSVDataModule

    if args.train_path == "synthetic":
        args.train_path = _synthetic_csv(num_channels=len(args.usecols))
    if not args.train_path:
        raise ValueError("--data.train_path is required")
    if args.val_path is None:
        print(
            "WARNING: --data.val_path not set; validating on the training CSV "
            "(val_loss will track training data)"
        )
    return CSVDataModule(
        train_path=args.train_path,
        val_path=args.val_path or args.train_path,
        test_path=args.test_path or args.val_path or args.train_path,
        in_len=args.in_len,
        out_len=args.out_len,
        stride=args.stride,
        batch_size=args.batch_size,
        usecols=tuple(args.usecols),
        seed=args.seed,
    )


def main(argv: Optional[Sequence[str]] = None):
    parser = cli.make_parser(
        "Multivariate time-series Perceiver",
        optimizer_defaults={"lr": 1e-4, "warmup_steps": 0},
    )
    # reference defaults: 256 latents x 256 channels, 8 single-layer blocks,
    # single-head attention (reference: model.py:48-78)
    cli.add_dataclass_args(
        parser,
        TimeSeriesEncoderConfig,
        "model.encoder",
        {
            "num_cross_attention_heads": 1,
            "num_self_attention_heads": 1,
            "num_self_attention_blocks": 8,
            "num_self_attention_layers_per_block": 1,
        },
    )
    cli.add_dataclass_args(parser, TimeSeriesDecoderConfig, "model.decoder", {"num_cross_attention_heads": 1})
    parser.add_argument("--model.num_latents", dest="model.num_latents", type=int, default=256)
    parser.add_argument(
        "--model.num_latent_channels", dest="model.num_latent_channels", type=int, default=256
    )
    parser.add_argument(
        "--model.activation_checkpointing",
        dest="model.activation_checkpointing",
        type=cli._str2bool,
        default=False,
    )
    cli.add_dataclass_args(parser, TimeSeriesDataArgs, "data")
    cli.add_smoke_preset(
        parser,
        {
            "data.train_path": "synthetic",
            "data.in_len": 512,
            "data.out_len": 256,
            "data.stride": 64,
            "data.batch_size": 8,
            "model.num_latents": 64,
            "model.num_latent_channels": 64,
            "model.encoder.num_self_attention_blocks": 2,
            # single-head CA at init_scale 0.02 predicts the series mean for
            # thousands of steps (same stall as the image classifier — see
            # vision/image_classifier.py smoke preset); 0.1 + a hotter lr
            # reaches well under the series variance within the smoke budget
            "model.encoder.init_scale": 0.1,
            "model.decoder.init_scale": 0.1,
            "optimizer.lr": 3e-3,
            "trainer.max_steps": 1000,
            "trainer.val_interval": 200,
            "trainer.name": "ts_smoke",
        },
    )
    args = cli.parse_args(parser, argv)

    trainer_args = cli.build_dataclass(cli.TrainerArgs, args, "trainer")
    opt_args = cli.build_dataclass(cli.OptimizerArgs, args, "optimizer")
    data_args = cli.build_dataclass(TimeSeriesDataArgs, args, "data")

    data = build_timeseries_datamodule(data_args)
    encoder = cli.build_dataclass(
        TimeSeriesEncoderConfig,
        args,
        "model.encoder",
        num_input_channels=data.num_channels,
        in_len=data_args.in_len,
    )
    decoder = cli.build_dataclass(
        TimeSeriesDecoderConfig,
        args,
        "model.decoder",
        out_len=data_args.out_len,
        num_output_channels=data.num_channels,
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
        lambda device, generator: TimeSeriesPerceiver(model_config, dtype=dtype, device=device, generator=generator),
        model_config,
        mse_loss_fn(),
        cli.cycle(data.train_batches()),
        data.valid_batches(),
        trainer_args,
        opt_args,
        command=args.command,
    )


if __name__ == "__main__":
    main()
