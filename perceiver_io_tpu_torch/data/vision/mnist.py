"""MNIST data module (a numpy copy of ``perceiver_io_tpu/data/vision/mnist.py``):
HF ``datasets`` when locally cached, synthetic digits for fully-offline smoke
runs (reference: perceiver/data/vision/mnist.py:17-96).

Transforms (numpy equivalents of the reference's torchvision pipeline):
optional random crop (train), scale to [0, 1], normalize to [-1, 1],
channels-last (the port's image layout)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from perceiver_io_tpu_torch.data.loader import Batches


class _TransformedImages:
    def __init__(self, images: np.ndarray, labels: np.ndarray, transform):
        self.images = images
        self.labels = labels
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.transform(self.images[i]), "label": np.int32(self.labels[i])}


def mnist_transform(normalize: bool = True, random_crop: Optional[int] = None, seed: int = 0):
    rng = np.random.default_rng(seed)

    def transform(img: np.ndarray) -> np.ndarray:
        x = np.asarray(img, dtype=np.float32)
        if x.ndim == 2:
            x = x[..., None]
        if random_crop is not None:
            h, w = x.shape[:2]
            top = int(rng.integers(0, h - random_crop + 1))
            left = int(rng.integers(0, w - random_crop + 1))
            x = x[top : top + random_crop, left : left + random_crop]
        x = x / 255.0
        if normalize:
            x = (x - 0.5) / 0.5
        return x

    return transform


# 5x7 bitmap digit font for the synthetic source: class-dependent structure
# (glyph identity) under nuisance variation (translation, intensity, noise),
# so offline smoke training can genuinely learn and generalize — random pixels
# with random labels would only ever memorize.
_DIGIT_FONT = [
    "01110 10001 10011 10101 11001 10001 01110",  # 0
    "00100 01100 00100 00100 00100 00100 01110",  # 1
    "01110 10001 00001 00010 00100 01000 11111",  # 2
    "11110 00001 00001 01110 00001 00001 11110",  # 3
    "00010 00110 01010 10010 11111 00010 00010",  # 4
    "11111 10000 11110 00001 00001 10001 01110",  # 5
    "00110 01000 10000 11110 10001 10001 01110",  # 6
    "11111 00001 00010 00100 01000 01000 01000",  # 7
    "01110 10001 10001 01110 10001 10001 01110",  # 8
    "01110 10001 10001 01111 00001 00010 01100",  # 9
]


def synthetic_digits(n: int, seed: int = 0, size: int = 28):
    """Deterministic learnable digit images: the glyph (label) is rendered at
    2x scale at a random offset with intensity jitter and background noise."""
    rng = np.random.default_rng(seed)
    glyphs = []
    for spec in _DIGIT_FONT:
        bitmap = np.array([[int(c) for c in row] for row in spec.split()], np.float32)
        glyphs.append(np.kron(bitmap, np.ones((2, 2), np.float32)))  # 14 x 10
    labels = rng.integers(0, 10, n).astype(np.int64)
    images = np.zeros((n, size, size), np.float32)
    gh, gw = glyphs[0].shape
    for i, lab in enumerate(labels):
        top = int(rng.integers(0, size - gh + 1))
        left = int(rng.integers(0, size - gw + 1))
        intensity = float(rng.uniform(0.6, 1.0))
        images[i, top : top + gh, left : left + gw] = glyphs[lab] * intensity
    images = images * 255.0 + rng.normal(0.0, 12.0, images.shape)
    return np.clip(images, 0, 255).astype(np.uint8), labels


class MNISTDataModule:
    num_classes = 10

    def __init__(
        self,
        dataset_dir: str = ".cache/mnist",
        normalize: bool = True,
        random_crop: Optional[int] = None,
        batch_size: int = 64,
        shuffle: bool = True,
        synthetic: bool = False,
        seed: int = 0,
    ):
        self.dataset_dir = dataset_dir
        self.normalize = normalize
        self.random_crop = random_crop
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.synthetic = synthetic
        self.seed = seed
        self._train = None
        self._valid = None

    @property
    def image_shape(self):
        s = self.random_crop or 28
        return (s, s, 1)

    def _load(self):
        if self._train is not None:
            return
        if self.synthetic:
            images, labels = synthetic_digits(4096, seed=self.seed)
            self._train = (images[:3584], labels[:3584])
            self._valid = (images[3584:], labels[3584:])
            return
        import datasets

        ds = datasets.load_dataset("mnist", cache_dir=self.dataset_dir)
        self._train = (
            np.stack([np.asarray(im) for im in ds["train"]["image"]]),
            np.asarray(ds["train"]["label"]),
        )
        self._valid = (
            np.stack([np.asarray(im) for im in ds["test"]["image"]]),
            np.asarray(ds["test"]["label"]),
        )

    def train_batches(self) -> Batches:
        self._load()
        tf = mnist_transform(self.normalize, self.random_crop, seed=self.seed)
        return Batches(
            _TransformedImages(*self._train, tf),
            batch_size=self.batch_size,
            shuffle=self.shuffle,
            seed=self.seed,
        )

    def valid_batches(self) -> Batches:
        self._load()
        # validation never crops; reference center-consistency via full image
        tf = mnist_transform(self.normalize, None)
        dataset = self._valid
        if self.random_crop is not None:
            # crop validation images centrally to the train image shape
            c = self.random_crop
            off = (28 - c) // 2
            images = dataset[0][:, off : off + c, off : off + c]
            dataset = (images, dataset[1])
        return Batches(
            _TransformedImages(*dataset, tf), batch_size=self.batch_size, shuffle=False
        )
