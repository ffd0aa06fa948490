"""MNIST data pipeline: a numpy copy of ``distributed_tensorflow_tpu/data/mnist.py``.

The reference calls the TF tutorial loader
``input_data.read_data_sets("MNIST_data", one_hot=True)`` and consumes
``mnist.train.next_batch(100)`` in the hot loop and the full test split for
per-epoch eval. This module reproduces that API, bit for bit with the JAX
package's numpy path (which its C++ gather and loader also match).

Sources, in priority order:

1. **Real MNIST IDX files** in ``data_dir`` (the standard
   ``train-images-idx3-ubyte[.gz]`` quartet), parsed with numpy. Nothing is
   downloaded.
2. **Deterministic synthetic MNIST** with identical shapes and splits
   (55000/5000/10000, 784 features in [0, 1], 10 one-hot classes): each
   class has a smooth random prototype; samples are spatially jittered,
   brightness-scaled, noisy copies. The reference MLP learns it past the
   0.72 test-accuracy oracle.

``next_batch`` walks a shuffled permutation and reshuffles at each epoch
boundary, carrying the tail of one epoch into the head of the next.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct

import numpy as np

NUM_CLASSES = 10
IMAGE_SIZE = 28
IMAGE_PIXELS = IMAGE_SIZE * IMAGE_SIZE

_TRAIN_IMAGES = "train-images-idx3-ubyte"
_TRAIN_LABELS = "train-labels-idx1-ubyte"
_TEST_IMAGES = "t10k-images-idx3-ubyte"
_TEST_LABELS = "t10k-labels-idx1-ubyte"
_VALIDATION_SIZE = 5000  # tutorial loader's split: 55000 train / 5000 val


def _one_hot(labels: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


class DataSet:
    """One split with the tutorial loader's ``next_batch`` iteration contract."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *, seed: int = 0):
        if images.shape[0] != labels.shape[0]:
            raise ValueError(
                f"{images.shape[0]} images but {labels.shape[0]} labels"
            )
        self._images = images
        self._labels = labels
        self._rng = np.random.default_rng(seed)
        self._perm = self._rng.permutation(images.shape[0])
        self._index = 0
        self._epochs_completed = 0

    @property
    def images(self) -> np.ndarray:
        return self._images

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    @property
    def num_examples(self) -> int:
        return self._images.shape[0]

    @property
    def epochs_completed(self) -> int:
        return self._epochs_completed

    def next_batch(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """Next ``batch_size`` examples. Tutorial-loader semantics: when the
        epoch's permutation runs out mid-batch, the leftover tail is served
        concatenated with the head of the next epoch's shuffle — no example
        is ever dropped."""
        if self._index + batch_size > self.num_examples:
            rest = self._perm[self._index :]
            self._epochs_completed += 1
            self._perm = self._rng.permutation(self.num_examples)
            take = batch_size - rest.shape[0]
            idx = np.concatenate([rest, self._perm[:take]])
            self._index = take
        else:
            idx = self._perm[self._index : self._index + batch_size]
            self._index += batch_size
        return self._images[idx], self._labels[idx]


@dataclasses.dataclass(frozen=True)
class Datasets:
    train: DataSet
    validation: DataSet
    test: DataSet


# ---------------------------------------------------------------------------
# Source 1: real MNIST IDX files
# ---------------------------------------------------------------------------


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx_images(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    # Multiply by the f32-rounded reciprocal (not divide by 255.0), as the
    # JAX package's parsers do, so both packages read identical arrays.
    return data.reshape(n, rows * cols).astype(np.float32) * np.float32(1.0 / 255.0)


def _read_idx_labels(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic {magic} in {path}")
        data = np.frombuffer(f.read(n), dtype=np.uint8)
    return data.astype(np.int64)


def _idx_files_present(data_dir: str) -> bool:
    return all(
        os.path.exists(os.path.join(data_dir, name))
        or os.path.exists(os.path.join(data_dir, name + ".gz"))
        for name in (_TRAIN_IMAGES, _TRAIN_LABELS, _TEST_IMAGES, _TEST_LABELS)
    )


def _load_idx(data_dir: str):
    train_x = _read_idx_images(os.path.join(data_dir, _TRAIN_IMAGES))
    train_y = _read_idx_labels(os.path.join(data_dir, _TRAIN_LABELS))
    test_x = _read_idx_images(os.path.join(data_dir, _TEST_IMAGES))
    test_y = _read_idx_labels(os.path.join(data_dir, _TEST_LABELS))
    return train_x, train_y, test_x, test_y


# ---------------------------------------------------------------------------
# Source 2: deterministic synthetic MNIST
# ---------------------------------------------------------------------------


def _smooth(field: np.ndarray, passes: int = 2) -> np.ndarray:
    """Cheap separable box blur to turn white noise into digit-like blobs."""
    for _ in range(passes):
        field = (
            field
            + np.roll(field, 1, -1)
            + np.roll(field, -1, -1)
            + np.roll(field, 1, -2)
            + np.roll(field, -1, -2)
        ) / 5.0
    return field


def _synthetic_split(
    n: int, rng: np.random.Generator, prototypes: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    labels = rng.integers(0, NUM_CLASSES, size=n)
    protos = prototypes[labels]  # [n, 28, 28]
    # Per-sample spatial jitter (±3 px) — vectorized via index arithmetic.
    dx = rng.integers(-3, 4, size=n)
    dy = rng.integers(-3, 4, size=n)
    rows = (np.arange(IMAGE_SIZE)[None, :, None] + dy[:, None, None]) % IMAGE_SIZE
    cols = (np.arange(IMAGE_SIZE)[None, None, :] + dx[:, None, None]) % IMAGE_SIZE
    imgs = protos[np.arange(n)[:, None, None], rows, cols]
    brightness = rng.uniform(0.7, 1.3, size=(n, 1, 1))
    noise = rng.normal(0.0, 0.15, size=imgs.shape)
    imgs = np.clip(imgs * brightness + noise, 0.0, 1.0).astype(np.float32)
    return imgs.reshape(n, IMAGE_PIXELS), labels


def _load_synthetic(seed: int = 0):
    rng = np.random.default_rng(seed)
    raw = rng.random((NUM_CLASSES, IMAGE_SIZE, IMAGE_SIZE))
    prototypes = _smooth(raw, passes=3)
    # Normalize each prototype to [0, 1] with a dark background like MNIST.
    prototypes -= prototypes.min(axis=(1, 2), keepdims=True)
    prototypes /= prototypes.max(axis=(1, 2), keepdims=True)
    prototypes = np.where(prototypes > 0.55, prototypes, 0.0)
    train_x, train_y = _synthetic_split(60000, rng, prototypes)
    test_x, test_y = _synthetic_split(10000, rng, prototypes)
    return train_x, train_y, test_x, test_y


# ---------------------------------------------------------------------------
# Public entry point (API parity with the tutorial loader)
# ---------------------------------------------------------------------------


def read_data_sets(
    data_dir: str = "MNIST_data",
    one_hot: bool = True,
    *,
    seed: int = 0,
    synthetic: bool | None = None,
) -> Datasets:
    """Load MNIST with the reference's loader API (reference tfsingle.py:13-14).

    ``synthetic=None`` auto-detects: real IDX files in ``data_dir`` win,
    otherwise the deterministic synthetic dataset is generated in-memory.
    """
    if synthetic is None:
        synthetic = not _idx_files_present(data_dir)
    if synthetic:
        train_x, train_y, test_x, test_y = _load_synthetic(seed)
    else:
        train_x, train_y, test_x, test_y = _load_idx(data_dir)

    if one_hot:
        train_yy: np.ndarray = _one_hot(train_y)
        test_yy: np.ndarray = _one_hot(test_y)
    else:
        train_yy, test_yy = train_y, test_y

    val_x, val_y = train_x[:_VALIDATION_SIZE], train_yy[:_VALIDATION_SIZE]
    trn_x, trn_y = train_x[_VALIDATION_SIZE:], train_yy[_VALIDATION_SIZE:]
    return Datasets(
        train=DataSet(trn_x, trn_y, seed=seed + 1),
        validation=DataSet(val_x, val_y, seed=seed + 2),
        test=DataSet(test_x, test_yy, seed=seed + 3),
    )
