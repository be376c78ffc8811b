"""Text preprocessing CLI — tokenize/chunk/cache a dataset ahead of training
(counterpart of ``perceiver_io_tpu/scripts/text/preproc.py``; reference:
perceiver/scripts/text/preproc.py:1-47).

Run: ``python -m perceiver_io_tpu_torch.scripts.text.preproc wikitext --task=clm
--data.max_seq_len=4096 --data.cache_dir=.cache/text``
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_tpu_torch.scripts import cli
from perceiver_io_tpu_torch.scripts.text.common import DATASETS, TextDataArgs, build_text_datamodule


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Preprocess a text dataset", allow_abbrev=False)
    parser.add_argument("dataset", choices=sorted(DATASETS))
    parser.add_argument("--task", choices=("clm", "mlm", "clf"), default="clm")
    cli.add_dataclass_args(parser, TextDataArgs, "data")
    args = parser.parse_args(argv)

    data_args = cli.build_dataclass(TextDataArgs, args, "data", dataset=args.dataset)
    data = build_text_datamodule(data_args, task=args.task)
    data.prepare()
    print(f"prepared {args.dataset} for task={args.task} (cache_dir={data_args.cache_dir})")


if __name__ == "__main__":
    main()
