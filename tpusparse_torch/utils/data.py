"""MNIST data for the port's training loop, in numpy.

Counterpart of `tpusparse/utils/data.py:23-89`; for the same seed every
array equals the JAX package's. The default is a deterministic synthetic
MNIST stand-in (class-prototype images plus Gaussian noise, normalised like
the usual (0.1307, 0.3081) transform) that a linear classifier can learn.
Real MNIST idx files are read when they are already on disk; nothing is
downloaded.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, Tuple

import numpy as np


def synthetic_mnist(
    seed: int = 0, n_train: int = 4096, n_test: int = 512, num_classes: int = 10
):
    """Learnable MNIST-shaped dataset: (train_x, train_y, test_x, test_y),
    images (n, 784) float32, labels (n,) int32."""
    rng = np.random.default_rng(seed)
    prototypes = rng.normal(0.0, 1.0, size=(num_classes, 784)).astype(np.float32)

    def make(n):
        labels = rng.integers(0, num_classes, size=n)
        noise = rng.normal(0.0, 0.8, size=(n, 784)).astype(np.float32)
        images = prototypes[labels] + noise
        images = (images - 0.1307) / 0.3081
        return images.astype(np.float32), labels.astype(np.int32)

    train_x, train_y = make(n_train)
    test_x, test_y = make(n_test)
    return train_x, train_y, test_x, test_y


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(data_dir: str | None = None):
    """Real MNIST if the four idx files (optionally .gz) are under
    `data_dir` (default: the MNIST_DIR environment variable), else
    `synthetic_mnist()`."""
    data_dir = data_dir or os.environ.get("MNIST_DIR", "")
    names = [
        "train-images-idx3-ubyte",
        "train-labels-idx1-ubyte",
        "t10k-images-idx3-ubyte",
        "t10k-labels-idx1-ubyte",
    ]
    if data_dir:
        paths = []
        for nm in names:
            for cand in (os.path.join(data_dir, nm), os.path.join(data_dir, nm + ".gz")):
                if os.path.exists(cand):
                    paths.append(cand)
                    break
        if len(paths) == 4:
            tx = _read_idx(paths[0]).reshape(-1, 784).astype(np.float32) / 255.0
            ty = _read_idx(paths[1]).astype(np.int32)
            vx = _read_idx(paths[2]).reshape(-1, 784).astype(np.float32) / 255.0
            vy = _read_idx(paths[3]).astype(np.int32)
            tx = (tx - 0.1307) / 0.3081
            vx = (vx - 0.1307) / 0.3081
            return tx, ty, vx, vy
    return synthetic_mnist()


def batches(
    x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0, drop_last=True
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled minibatch iterator over (x, y)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    end = len(x) - (len(x) % batch_size if drop_last else 0)
    for i in range(0, end, batch_size):
        idx = order[i : i + batch_size]
        yield x[idx], y[idx]
