"""Synthetic data generators, numpy copies of ``src/repro/data/synthetic.py``
drawing from the same ``numpy.random.Generator`` streams, so both packages
train on the same arrays: token streams for the LM runs, feature-vector
clusters for the FL protocol path, and an MNIST-like image set for the
paper's LeNet-5 workload (the real MNIST download is not available
offline).  The data stay numpy; callers place them on a device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def token_batches(vocab_size: int, batch: int, seq: int, seed: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Zipf-ish token stream with next-token labels (shifted inputs)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab_size, size=(batch, seq + 1), p=probs)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


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


def make_mnist_like(n: int = 4096, seed: int = 0,
                    image_size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """10-class 'digit' images (n, size, size, 1) float32 and int32
    labels: a class-dependent oriented stripe and an offset blob, jittered,
    over noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    xs = rng.normal(0.0, 0.15, (n, image_size, image_size, 1)).astype(
        np.float32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / \
        image_size
    for c in range(10):
        idx = np.where(labels == c)[0]
        ang = 2 * np.pi * c / 10.0
        stripe = np.sin(8.0 * (np.cos(ang) * xx + np.sin(ang) * yy))
        cx = 0.3 + 0.4 * np.cos(ang) * 0.5 + 0.2
        cy = 0.3 + 0.4 * np.sin(ang) * 0.5 + 0.2
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
        pattern = (stripe * 0.6 + blob * 1.2)[None, :, :, None]
        jitter = rng.normal(1.0, 0.1, (len(idx), 1, 1, 1)).astype(np.float32)
        xs[idx] += (pattern * jitter).astype(np.float32)
    return xs, labels
