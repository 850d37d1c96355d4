"""Input pipeline: host batches put on the device by a background thread,
and the deterministic (client, round) batch selector of the FL runs, as
``src/repro/data/pipeline.py`` has them.  Seeding a batch by (client,
round) makes rounds reproducible across restarts: the checkpoint and
restart contract needs it.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_device(batch, device: torch.device):
    """numpy arrays (or tensors) onto ``device``: through pinned host
    memory with a non-blocking copy to a card, as they are to the CPU."""
    def one(a):
        t = torch.as_tensor(a)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


class Prefetcher:
    """Background-thread prefetch of host batches onto ``device`` (the
    card unless named), at most ``depth`` batches ahead."""

    def __init__(self, it: Iterator, depth: int = 2, device=None):
        self._it = it
        self._device = resolve_device(device)
        self._q: collections.deque = collections.deque()
        self._depth = depth
        self._lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._stop = False
        self._sem = threading.Semaphore(0)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for batch in self._it:
                if self._stop:
                    return
                batch = _to_device(batch, self._device)
                while len(self._q) >= self._depth and not self._stop:
                    threading.Event().wait(0.002)
                with self._lock:
                    self._q.append(batch)
                self._sem.release()
        except BaseException as e:  # noqa: BLE001 — raised on next()
            self._err = e
            self._sem.release()

    def __iter__(self):
        return self

    def __next__(self):
        self._sem.acquire()
        if self._err is not None:
            raise self._err
        with self._lock:
            return self._q.popleft()

    def close(self):
        self._stop = True


def client_batch_fn(xs: np.ndarray, ys: np.ndarray, parts,
                    batch_size: int) -> Callable[[int, int], Dict]:
    """Deterministic (client, round) -> batch selector over a partition."""
    def get(client: int, rnd: int) -> Dict[str, np.ndarray]:
        idx = parts[client]
        rng = np.random.default_rng(hash((client, rnd)) % (2 ** 32))
        pick = rng.choice(idx, size=min(batch_size, len(idx)), replace=False)
        return {"images": xs[pick], "labels": ys[pick]}
    return get
