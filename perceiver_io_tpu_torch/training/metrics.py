"""Metrics logging — CSV always, TensorBoard when available (a copy of
``perceiver_io_tpu/training/metrics.py``; the process role from the port's
``parallel.dist``).

Reference parity (SURVEY §5.5): scalar train/val loss + accuracy logging,
per-step learning-rate monitoring, and qualitative text panels (generated
samples, mask fills) at validation end
(reference: perceiver/model/core/lightning.py:63-77, trainer.yaml:3-6,
text/clm/lightning.py:55-104).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict


def _row_step(row: dict) -> float:
    """Step value of a CSV row; rows without a parseable step sort as
    "keep" (-inf) — truncation must never eat foreign rows it can't read."""
    try:
        return float(row.get("step", ""))
    except (TypeError, ValueError):
        return float("-inf")


class MetricsLogger:
    """Appends scalars to ``metrics.csv`` (one row per log call; the header is
    the union of keys seen, and the file is rewritten only on the rare event a
    new key widens it) and mirrors them to TensorBoard if importable. Text
    logs go to TensorBoard text panels and ``samples.txt``."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True, main_process: bool = None):
        # single-writer gating (reference @rank_zero_only semantics,
        # text/clm/lightning.py:54): only process 0 of a multi-host program
        # touches the filesystem; other processes get a no-op logger.
        if main_process is None:
            from perceiver_io_tpu_torch.parallel.dist import is_main_process

            main_process = is_main_process()
        self._active = bool(main_process)
        self.log_dir = os.path.abspath(log_dir)
        if self._active:
            os.makedirs(self.log_dir, exist_ok=True)
        self._csv_path = os.path.join(self.log_dir, "metrics.csv")
        self._keys = ["step", "time"]
        self._header_written = False
        if self._active and os.path.exists(self._csv_path):
            # resume into an existing metrics.csv: seed the key set and the
            # header flag from the file, otherwise the first log after a
            # restart appends a SECOND header row mid-file (and a widening
            # key skips the rewrite because _header_written is still False)
            with open(self._csv_path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._keys = list(header)
                self._header_written = True
                # damaged/foreign header missing the contract keys: widen it
                # NOW via the same rewrite a new metric key triggers —
                # appending to _keys alone would misalign every row after
                missing = [k for k in ("step", "time") if k not in self._keys]
                if missing:
                    self._keys.extend(missing)
                    self._rewrite_with_widened_header()
        self._tb = None
        if use_tensorboard and self._active:
            try:  # torch's tensorboard writer; optional
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.log_dir)
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self._active:
            return
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            row[k] = float(v)
        new_keys = [k for k in row if k not in self._keys]
        if new_keys:
            self._keys.extend(new_keys)
            self._rewrite_with_widened_header()
        with open(self._csv_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._keys, restval="")
            if not self._header_written:
                writer.writeheader()
                self._header_written = True
            writer.writerow(row)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), global_step=int(step))

    def _rewrite_with_widened_header(self) -> None:
        if not self._header_written or not os.path.exists(self._csv_path):
            return
        with open(self._csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        with open(self._csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._keys, restval="")
            writer.writeheader()
            writer.writerows(rows)

    def truncate_after(self, step: int) -> int:
        """Drop rows with ``step`` greater than the given step; returns the
        number of rows removed.

        Auto-resume hygiene (``Trainer.fit(resume="auto")``): a preempted
        run may have logged rows past its last committed checkpoint; the
        resumed run re-executes those steps and re-logs them. Truncating at
        the restore point keeps ``metrics.csv`` equivalent to an
        uninterrupted run instead of carrying duplicate (and possibly
        diverging) rows for the replayed interval."""
        if not self._active or not os.path.exists(self._csv_path):
            return 0
        with open(self._csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        kept = [r for r in rows if _row_step(r) <= step]
        dropped = len(rows) - len(kept)
        if dropped:
            with open(self._csv_path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._keys, restval="")
                writer.writeheader()
                writer.writerows(kept)
        return dropped

    def log_text(self, step: int, tag: str, text: str) -> None:
        if not self._active:
            return
        with open(os.path.join(self.log_dir, "samples.txt"), "a") as f:
            f.write(f"--- step {int(step)} [{tag}] ---\n{text}\n")
        if self._tb is not None:
            self._tb.add_text(tag, text, global_step=int(step))

    def log_hparams(self, hparams: Dict) -> None:
        if not self._active:
            return
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(hparams, f, indent=2, default=str)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
