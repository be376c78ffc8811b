"""Top-k mask filling for masked language models (counterpart of
``perceiver_io_tpu/hf/mask_filler.py``): the masked LM's serving entry point.

Masked samples are strings holding the tokenizer's mask token (``"I have
watched this [MASK] and it was awesome"``); the segments between mask tokens
are tokenized, the batch is right-padded, the model's logits are reduced to
their top-k token ids on the device, and on the host each of the top-k fills
is decoded back to text. Any tokenizer with the port's byte tokenizer's
protocol works (``mask_token``, ``mask_token_id``, ``encode``, ``decode``,
``pad_sequences``); no ``transformers`` import.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from perceiver_io_tpu_torch.device import DeviceLike, check_same_device, resolve_device


class MaskFiller:
    """``fill(samples, num_predictions)`` through ``model`` (a
    :class:`~perceiver_io_tpu_torch.models.text.MaskedLanguageModel`), which
    must lie on ``device`` (``"cuda"`` by default; pass ``device="cpu"`` for
    a model on the CPU)."""

    def __init__(self, model, tokenizer, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        check_same_device(self.device, model.device, "the model")
        self.model = model
        self.tokenizer = tokenizer

    def _encode_masked(self, text: str) -> List[int]:
        tok = self.tokenizer
        ids: List[int] = []
        for i, seg in enumerate(text.split(tok.mask_token)):
            if i > 0:
                ids.append(tok.mask_token_id)
            ids.extend(tok.encode(seg))
        return ids

    @torch.no_grad()
    def top_k(self, ids: np.ndarray, pad_mask: np.ndarray, k: int) -> np.ndarray:
        """(B, N, k) int64 token ids, most likely first, of the model's
        logits at every position of right-padded ``ids``: one forward and a
        top-k on the device, one copy of the ids to the host."""
        dev = self.device
        logits = self.model(torch.as_tensor(ids, device=dev).long(), pad_mask=torch.as_tensor(pad_mask, device=dev))
        return torch.topk(logits.float(), k, dim=-1).indices.cpu().numpy()

    def fill(self, masked_samples: Sequence[str], num_predictions: int = 5) -> List[List[str]]:
        """Per sample, ``num_predictions`` decoded texts with every mask
        position replaced by the k-th most likely token. Raises ValueError
        for a sample without a mask token in the model's window."""
        tok = self.tokenizer
        seqs = [self._encode_masked(t) for t in masked_samples]
        max_len = getattr(getattr(self.model.config, "encoder", None), "max_seq_len", None)
        ids, pad_mask = tok.pad_sequences(seqs, max_length=max_len, padding_side="right")
        top = self.top_k(ids, pad_mask, num_predictions)

        results: List[List[str]] = []
        for row in range(ids.shape[0]):
            row_ids = ids[row][~pad_mask[row]]  # window-truncated, pad-free
            mask_pos = np.nonzero(row_ids == tok.mask_token_id)[0]
            if mask_pos.size == 0:
                detail = (
                    f"it was truncated out of the model's {max_len}-token window"
                    if max_len is not None and len(seqs[row]) > max_len
                    else "the input contains none"
                )
                raise ValueError(f"Sample {row} has no {tok.mask_token} to fill: {detail}")
            fills = []
            for k in range(num_predictions):
                filled = row_ids.copy()
                filled[mask_pos] = top[row, mask_pos, k]
                # special-token predictions stay visible ("[PAD]") instead of
                # deleting the position
                fills.append(tok.decode(filled.tolist(), skip_special_tokens=False))
            results.append(fills)
        return results
