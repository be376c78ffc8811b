"""Symbolic-audio (MIDI) Perceiver AR training CLI (counterpart of
``perceiver_io_tpu/scripts/audio/symbolic.py``; reference:
perceiver/scripts/audio/symbolic.py:8-30).

Links: ``data.max_seq_len → model.max_seq_len``; vocab is the fixed MIDI
event vocabulary (389).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.training.losses import clm_loss_fn


@dataclass
class AudioDataArgs:
    dataset: str = "directory"  # directory | giantmidi | maestro | synthetic
    dataset_dir: str = ".cache/audio"
    max_seq_len: int = 4096
    min_seq_len: Optional[int] = None
    batch_size: int = 16
    preproc_workers: int = 1
    seed: int = 0


def build_audio_datamodule(args: AudioDataArgs):
    from perceiver_io_tpu_torch.data.audio.symbolic import (
        DirectorySymbolicAudioDataModule,
        GiantMidiPianoDataModule,
        MaestroV3DataModule,
        SyntheticSymbolicAudioDataModule,
    )

    classes = {
        "directory": DirectorySymbolicAudioDataModule,
        "giantmidi": GiantMidiPianoDataModule,
        "maestro": MaestroV3DataModule,
        "synthetic": SyntheticSymbolicAudioDataModule,
    }
    if args.dataset not in classes:
        raise ValueError(f"unknown dataset {args.dataset!r}; choose from {sorted(classes)}")
    return classes[args.dataset](
        dataset_dir=args.dataset_dir,
        max_seq_len=args.max_seq_len,
        min_seq_len=args.min_seq_len,
        batch_size=args.batch_size,
        preproc_workers=args.preproc_workers,
        seed=args.seed,
    )


def main(argv: Optional[Sequence[str]] = None):
    parser = cli.make_parser(
        "Perceiver AR symbolic audio model",
        optimizer_defaults={"lr": 2e-4, "warmup_steps": 200},
    )
    # paper presets (reference: scripts/audio/symbolic.py:14-28)
    cli.add_dataclass_args(
        parser,
        SymbolicAudioModelConfig,
        "model",
        {"max_latents": 1024, "num_channels": 512, "num_self_attention_layers": 8},
    )
    cli.add_dataclass_args(parser, AudioDataArgs, "data")
    cli.add_smoke_preset(
        parser,
        {
            "data.dataset": "synthetic",
            "data.dataset_dir": ".cache/sam_smoke",
            "data.max_seq_len": 1024,
            "data.batch_size": 8,
            "model.max_latents": 256,
            "model.num_channels": 192,
            "model.num_self_attention_layers": 4,
            "trainer.max_steps": 500,
            "trainer.val_interval": 100,
            "trainer.name": "sam_smoke",
            "optimizer.warmup_steps": 50,
        },
    )
    args = cli.parse_args(parser, argv)

    trainer_args = cli.build_dataclass(cli.TrainerArgs, args, "trainer")
    opt_args = cli.build_dataclass(cli.OptimizerArgs, args, "optimizer")
    data_args = cli.build_dataclass(AudioDataArgs, args, "data")

    data = build_audio_datamodule(data_args)
    data.prepare_data()
    model_config = cli.build_dataclass(
        SymbolicAudioModelConfig,
        args,
        "model",
        vocab_size=data.vocab_size,
        max_seq_len=data_args.max_seq_len,
    )
    dtype = cli.activation_dtype(trainer_args)
    return cli.run_training(
        lambda device, generator: SymbolicAudioModel(model_config, dtype=dtype, device=device, generator=generator),
        model_config,
        clm_loss_fn(model_config.max_latents),
        cli.cycle(data.train_batches()),
        data.valid_batches(),
        trainer_args,
        opt_args,
        command=args.command,
    )


if __name__ == "__main__":
    main()
