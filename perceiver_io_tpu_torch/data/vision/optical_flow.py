"""Optical-flow pre/post-processing: overlapping patch grid, per-pixel 3x3
neighborhood features, weighted patch blending, HSV rendering (a copy of
``perceiver_io_tpu/data/vision/optical_flow.py``; numpy on the host, the
video helpers import OpenCV when called).

Behavioral parity with the reference processor
(reference: perceiver/data/vision/optical_flow.py:16-258), in numpy with
channels-last layouts (the model input is (B, 2, H, W, 27)). The 27 feature
channels per pixel are the 3x3 neighborhood of the 3 image channels in
(ky, kx, c) order, matching the reference's unfold ordering."""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


class OpticalFlowProcessor:
    def __init__(
        self,
        patch_size: Tuple[int, int] = (368, 496),
        patch_min_overlap: int = 20,
        flow_scale_factor: int = 20,
    ):
        if patch_min_overlap >= patch_size[0] or patch_min_overlap >= patch_size[1]:
            raise ValueError(
                f"patch_min_overlap={patch_min_overlap} must be smaller than "
                f"both patch dimensions {patch_size}"
            )
        self.patch_size = patch_size
        self.patch_min_overlap = patch_min_overlap
        self.flow_scale_factor = flow_scale_factor

    # ------------------------------------------------------------ preprocess

    def compute_patch_grid_indices(self, img_shape: Tuple[int, ...]) -> List[Tuple[int, int]]:
        """Patch corner grid with minimum overlap; last row/col right-aligned
        (reference: optical_flow.py:108-114)."""
        ys = list(range(0, img_shape[0], self.patch_size[0] - self.patch_min_overlap))
        xs = list(range(0, img_shape[1], self.patch_size[1] - self.patch_min_overlap))
        ys[-1] = img_shape[0] - self.patch_size[0]
        xs[-1] = img_shape[1] - self.patch_size[1]
        return list(itertools.product(ys, xs))

    @staticmethod
    def _normalize(img: np.ndarray) -> np.ndarray:
        return img.astype(np.float32) / 255.0 * 2 - 1

    @staticmethod
    def _extract_neighborhoods(img: np.ndarray, kernel: int = 3) -> np.ndarray:
        """(H, W, C) -> (H, W, kernel*kernel*C) per-pixel neighborhoods with
        SAME padding, feature order (ky, kx, c)."""
        h, w, c = img.shape
        pad = kernel // 2
        padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
        views = [
            padded[ky : ky + h, kx : kx + w, :]
            for ky in range(kernel)
            for kx in range(kernel)
        ]
        return np.concatenate(views, axis=-1)

    def preprocess(self, image_pair: Sequence[np.ndarray]) -> np.ndarray:
        """Image pair (each (H, W, 3) uint8) -> (num_patches, 2, ph, pw, 27)."""
        img1, img2 = np.asarray(image_pair[0]), np.asarray(image_pair[1])
        if img1.shape != img2.shape:
            raise ValueError(
                f"image pair has mismatched shapes: {img1.shape} vs {img2.shape}"
            )
        h, w = img1.shape[:2]
        if h < self.patch_size[0]:
            raise ValueError(
                f"image height {h} is below the {self.patch_size[0]}-pixel patch "
                "height; pad or resize the image first"
            )
        if w < self.patch_size[1]:
            raise ValueError(
                f"image width {w} is below the {self.patch_size[1]}-pixel patch "
                "width; pad or resize the image first"
            )

        feats = np.stack(
            [
                self._extract_neighborhoods(self._normalize(img1)),
                self._extract_neighborhoods(self._normalize(img2)),
            ],
            axis=0,
        )  # (2, H, W, 27)

        patches = []
        for y, x in self.compute_patch_grid_indices((h, w)):
            patches.append(feats[:, y : y + self.patch_size[0], x : x + self.patch_size[1], :])
        return np.stack(patches, axis=0)

    def preprocess_batch(self, image_pairs: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
        shapes = {np.asarray(im).shape for pair in image_pairs for im in pair}
        if len(shapes) != 1:
            raise ValueError(f"image pairs have mismatched shapes: {sorted(map(str, shapes))}")
        return np.stack([self.preprocess(pair) for pair in image_pairs], axis=0)

    # ----------------------------------------------------------- postprocess

    def _patch_weights(self) -> np.ndarray:
        """Distance-to-border weights for blending overlapping patches
        (reference: optical_flow.py:190-196)."""
        ph, pw = self.patch_size
        wy, wx = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
        wx = np.minimum(wx + 1, pw - wx)
        wy = np.minimum(wy + 1, ph - wy)
        return np.minimum(wx, wy).astype(np.float32)[..., None]

    def postprocess(self, predictions: np.ndarray, img_shape: Tuple[int, ...]) -> np.ndarray:
        """(B, num_patches, ph, pw, 2) or (num_patches, ph, pw, 2) patch flows
        -> (B, H, W, 2) blended flow."""
        if predictions.ndim == 4:
            predictions = predictions[None]
        height, width = img_shape[0], img_shape[1]
        grid_indices = self.compute_patch_grid_indices(img_shape)
        b, p = predictions.shape[:2]
        if p != len(grid_indices):
            raise ValueError(
                f"Number of patches in the input does not match the number of calculated patches based "
                f"on the supplied image size (nr_patches='{p}', calculated={len(grid_indices)})."
            )

        weights_patch = self._patch_weights()
        flow = np.zeros((b, height, width, 2), np.float32)
        weights = np.zeros((b, height, width, 1), np.float32)
        for i, (y, x) in enumerate(grid_indices):
            flow[:, y : y + self.patch_size[0], x : x + self.patch_size[1]] += (
                predictions[:, i] * self.flow_scale_factor * weights_patch
            )
            weights[:, y : y + self.patch_size[0], x : x + self.patch_size[1]] += weights_patch
        return flow / weights

    def process(self, model_fn, image_pairs, batch_size: int = 1) -> np.ndarray:
        """preprocess -> micro-batched model calls -> blend
        (reference: optical_flow.py:207-240). ``model_fn`` maps
        (N, 2, ph, pw, 27) -> (N, ph, pw, 2)."""
        img_shape = np.asarray(image_pairs[0][0]).shape
        predictions = []
        for i in range(0, len(image_pairs), batch_size):
            feats = self.preprocess_batch(image_pairs[i : i + batch_size])
            n, p = feats.shape[:2]
            flat = feats.reshape((n * p,) + feats.shape[2:])
            for j in range(0, flat.shape[0], batch_size):
                predictions.append(np.asarray(model_fn(flat[j : j + batch_size])))
        preds = np.concatenate(predictions, axis=0)
        preds = preds.reshape((len(image_pairs), -1) + preds.shape[1:])
        return self.postprocess(preds, img_shape)


def render_optical_flow(flow: np.ndarray) -> np.ndarray:
    """Flow (H, W, 2) -> RGB uint8 via HSV (reference: optical_flow.py:243-253)."""
    import cv2

    hsv = np.zeros((flow.shape[0], flow.shape[1], 3), dtype=np.uint8)
    mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
    hsv[..., 0] = ang / np.pi / 2 * 180
    hsv[..., 1] = np.clip(mag * 255 / 24, 0, 255)
    hsv[..., 2] = 255
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


def read_video_frames(video_path: Path) -> List[np.ndarray]:
    """(reference: perceiver/data/vision/video_utils.py:8-24)"""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def write_video(video_path: Path, frames: List[np.ndarray], fps: int = 30) -> None:
    """(reference: perceiver/data/vision/video_utils.py:27-46)"""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        str(video_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def write_optical_flow_video(video_path: Path, frames: List[np.ndarray], fps: int = 30) -> None:
    write_video(video_path, [render_optical_flow(np.asarray(f)) for f in frames], fps=fps)
