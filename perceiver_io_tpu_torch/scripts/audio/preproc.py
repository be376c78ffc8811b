"""Symbolic-audio preprocessing CLI — MIDI → token memmap (counterpart of
``perceiver_io_tpu/scripts/audio/preproc.py``; reference:
perceiver/scripts/audio/preproc.py:1-30).

Run: ``python -m perceiver_io_tpu_torch.scripts.audio.preproc directory
--data.dataset_dir=path/to/midis --data.preproc_workers=4``
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts.audio.symbolic import AudioDataArgs, build_audio_datamodule


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Preprocess MIDI data", allow_abbrev=False)
    parser.add_argument("dataset", choices=("directory", "giantmidi", "maestro"))
    cli.add_dataclass_args(parser, AudioDataArgs, "data")
    args = parser.parse_args(argv)

    data_args = cli.build_dataclass(AudioDataArgs, args, "data", dataset=args.dataset)
    data = build_audio_datamodule(data_args)
    data.prepare_data()
    print(f"prepared {args.dataset} under {data.preproc_dir}")


if __name__ == "__main__":
    main()
