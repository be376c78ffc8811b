"""Serving entry points of the port's task models (counterpart of
``perceiver_io_tpu/hf/``): the masked LM's mask filler."""

from perceiver_io_tpu_torch.hf.mask_filler import MaskFiller

__all__ = ["MaskFiller"]
