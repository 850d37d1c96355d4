"""Synthetic feature-vector classification data for the FL protocol path.

``gaussian_clusters`` draws from the same ``numpy.random.Generator``
streams as ``src/repro/data/synthetic.py``, so both packages train on the
same arrays.  The data stay numpy; callers place them on a device.
``token_batches`` and ``make_mnist_like`` serve the model substrate and
are not ported yet (ROADMAP.md, queue 1 item 10).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_clusters(n: int, d: int = 64, n_classes: int = 10,
                      seed: int = 0, centers_seed: int = 0,
                      noise: float = 0.7) -> Tuple[np.ndarray, np.ndarray]:
    """One gaussian blob per class: ``(n, d)`` float32 features and
    ``(n,)`` int32 labels.  ``centers_seed`` fixes the class geometry, so
    train and validation sets drawn with different ``seed``s share it."""
    centers = np.random.default_rng(centers_seed).normal(
        0.0, 1.0, (n_classes, d)).astype(np.float32)
    g = np.random.default_rng(seed)
    labels = g.integers(0, n_classes, n).astype(np.int32)
    xs = centers[labels] + g.normal(0.0, noise, (n, d)).astype(np.float32)
    return xs.astype(np.float32), labels
