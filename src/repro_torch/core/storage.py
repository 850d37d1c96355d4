"""IPFS-style content-addressed off-chain blob store (paper §III-C.4).

Model weights and task descriptions live off the chain; only their content
ids (hashes) go on the ledger.  Backed by an in-memory dict with an
optional on-disk spill directory.

``put`` pickles host copies: every tensor leaf of a dict, list or tuple
becomes a numpy array first (``.cpu().numpy()``), so a tree of tensors
pickles to the same bytes, and gets the same content id, as the JAX
package's store gives the same values held as numpy arrays.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Dict, Optional

import torch


def content_id(blob: bytes) -> str:
    return "Qm" + hashlib.sha256(blob).hexdigest()[:44]


def to_host(obj: Any) -> Any:
    """``obj`` with every tensor leaf replaced by a numpy copy."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


class BlobStore:
    def __init__(self, spill_dir: Optional[str] = None):
        self._mem: Dict[str, bytes] = {}
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def put(self, obj: Any) -> str:
        blob = pickle.dumps(to_host(obj))
        cid = content_id(blob)
        if self.spill_dir:
            path = os.path.join(self.spill_dir, cid)
            if not os.path.exists(path):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)     # atomic publish
        else:
            self._mem[cid] = blob
        return cid

    def get(self, cid: str) -> Any:
        if self.spill_dir:
            with open(os.path.join(self.spill_dir, cid), "rb") as f:
                blob = f.read()
        else:
            blob = self._mem[cid]
        if content_id(blob) != cid:
            raise ValueError(f"content hash mismatch for {cid} (tampering?)")
        return pickle.loads(blob)

    def has(self, cid: str) -> bool:
        if self.spill_dir:
            return os.path.exists(os.path.join(self.spill_dir, cid))
        return cid in self._mem
