"""Non-IID federated data partitioning (Dirichlet label skew), the standard
cross-device FL data model for the paper's MNIST workload: a copy of
``src/repro/fl/partition.py`` (numpy only, host side)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 8) -> List[np.ndarray]:
    """Returns per-client index arrays with Dirichlet(alpha) label skew."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            client_idx[client].extend(part.tolist())
    # rebalance tiny clients (deterministic round-robin steal)
    for i in range(n_clients):
        while len(client_idx[i]) < min_per_client:
            donor = int(np.argmax([len(c) for c in client_idx]))
            client_idx[i].append(client_idx[donor].pop())
    return [np.asarray(sorted(ci), np.int64) for ci in client_idx]


def skew_report(labels: np.ndarray, parts: List[np.ndarray]) -> Dict:
    n_classes = int(labels.max()) + 1
    hist = np.stack([np.bincount(labels[p], minlength=n_classes)
                     for p in parts])
    frac = hist / np.maximum(hist.sum(1, keepdims=True), 1)
    return {"sizes": [len(p) for p in parts],
            "max_class_frac": frac.max(1).tolist()}
