"""Inference-side image preprocessing — resize, center crop, channels-last,
normalization (a copy of ``perceiver_io_tpu/data/vision/preprocessor.py``;
reference: perceiver/data/vision/common.py ImagePreprocessor +
imagenet.py ImageNetPreprocessor, which wraps the HF Perceiver feature
extractor's val transform: resize shortest side to 256, center-crop 224,
normalize).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) float32 bilinear resize (align_corners=False convention)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def center_crop(img: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < crop_h or w < crop_w:
        raise ValueError(f"Image {(h, w)} smaller than crop {(crop_h, crop_w)}")
    y = (h - crop_h) // 2
    x = (w - crop_w) // 2
    return img[y : y + crop_h, x : x + crop_w]


class ImagePreprocessor:
    """Raw images -> model-ready channels-last float batches.

    Defaults reproduce the ImageNet validation transform the reference uses
    for the fourier image classifier (resize shortest side 256 -> center crop
    224 -> scale to [0,1] -> normalize mean/std 0.5).
    """

    def __init__(
        self,
        size: Optional[int] = 256,
        crop_size: Optional[Union[int, Tuple[int, int]]] = 224,
        image_mean: float = 0.5,
        image_std: float = 0.5,
        channels_last: bool = True,
    ):
        self.size = size
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) else crop_size
        self.image_mean = image_mean
        self.image_std = image_std
        self.channels_last = channels_last

    def preprocess(self, image) -> np.ndarray:
        img = np.asarray(image)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
            img = img.transpose(1, 2, 0)  # channels-first input
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)

        if self.size is not None:
            h, w = img.shape[:2]
            scale = self.size / min(h, w)
            img = _resize_bilinear(img, max(1, round(h * scale)), max(1, round(w * scale)))
        if self.crop_size is not None:
            img = center_crop(img, *self.crop_size)
        img = (img - self.image_mean) / self.image_std
        if not self.channels_last:
            img = img.transpose(2, 0, 1)
        return img

    def preprocess_batch(self, images: Sequence) -> np.ndarray:
        return np.stack([self.preprocess(im) for im in images])


class ImageNetPreprocessor(ImagePreprocessor):
    """Named instance of the reference's ImageNet val transform
    (reference: perceiver/data/vision/imagenet.py:9-31)."""

    def __init__(self, channels_last: bool = True):
        super().__init__(size=256, crop_size=224, image_mean=0.5, image_std=0.5, channels_last=channels_last)
