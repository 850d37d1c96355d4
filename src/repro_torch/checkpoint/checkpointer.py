"""Content-addressed, atomic checkpoints of trees of tensors, in the JAX
package's layout (``src/repro/checkpoint/checkpointer.py``):

    <dir>/step_000000123/
        manifest.json        # leaf paths, shapes, dtypes, blob cids
    <dir>/blobs/<cid>.bin    # one blob per leaf: its raw bytes
    <dir>/LATEST             # atomic pointer file

  * atomic publish (blobs first, then the manifest, then ``LATEST``, each
    renamed into place);
  * integrity: every blob re-hashed on restore;
  * dedup: a leaf whose bytes are already stored (same cid) is not
    rewritten;
  * async save: the tree is copied to the host, then written by a thread.

A tree is nested dicts of tensors (or numpy arrays, or scalars).  A cid
is the first 32 hex digits of the SHA-256 of the leaf's bytes, so a
float32 or int32 leaf gets the cid the JAX ``Checkpointer`` gives it.
bfloat16 is stored as its raw 16-bit words with the dtype name
``bfloat16`` in the manifest, the bytes the JAX package writes through
``ml_dtypes``, which the port does not import.  ``restore`` returns CPU
tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _leaf_paths(tree) -> Dict[str, Any]:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
        elif isinstance(node, (torch.Tensor, np.ndarray)) or \
                np.isscalar(node):
            flat["/".join(path)] = node
        else:
            raise TypeError(
                f"the checkpointer stores dicts of tensors; got "
                f"{type(node).__name__} at {'/'.join(path)!r} (convert "
                f"dataclass nodes to dicts first, as launch/train.py does)")
    walk((), tree)
    return flat


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host array holding the leaf's bytes, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        return t.numpy().copy(), str(t.numpy().dtype)
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.copy(), str(arr.dtype)


def _cid(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()[:32]


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(os.path.join(self.dir, "blobs"), exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None):
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for path, leaf in _leaf_paths(tree).items():
            arr, dtype = _host(leaf)
            raw = arr.tobytes()
            cid = _cid(raw)
            blob = os.path.join(self.dir, "blobs", cid + ".bin")
            if not os.path.exists(blob):
                tmp = blob + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(raw)
                os.replace(tmp, blob)
            manifest["leaves"][path] = {
                "cid": cid, "shape": list(arr.shape), "dtype": dtype}
        step_dir = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(step_dir, exist_ok=True)
        mtmp = os.path.join(step_dir, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(step_dir, "manifest.json"))
        ltmp = os.path.join(self.dir, "LATEST.tmp")
        with open(ltmp, "w") as f:
            f.write(f"step_{step:09d}")
        os.replace(ltmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        return manifest

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        # copy to the host before the thread starts: the caller may go on
        # to overwrite or free the tensors
        host = _unflatten({path: leaf.detach().to("cpu", copy=True)
                           if isinstance(leaf, torch.Tensor)
                           else np.array(leaf, copy=True)
                           for path, leaf in _leaf_paths(tree).items()})
        self.wait()
        self._async_thread = threading.Thread(
            target=self.save, args=(step, host, extra), daemon=True)
        self._async_thread.start()

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[-1])

    def restore(self, step: Optional[int] = None) -> Tuple[Any, Dict]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        step_dir = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for path, meta in manifest["leaves"].items():
            blob = os.path.join(self.dir, "blobs", meta["cid"] + ".bin")
            with open(blob, "rb") as fb:
                raw = fb.read()
            if _cid(raw) != meta["cid"]:
                raise IOError(f"checkpoint blob corrupted: {path}")
            flat[path] = _tensor(raw, meta["dtype"], meta["shape"])
        return _unflatten(flat), manifest["extra"]

    # -- retention -------------------------------------------------------------
    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        live = set()
        for d in steps[-self.keep:]:
            mf = os.path.join(self.dir, d, "manifest.json")
            if os.path.exists(mf):
                with open(mf) as f:
                    live.update(m["cid"] for m in
                                json.load(f)["leaves"].values())
        blob_dir = os.path.join(self.dir, "blobs")
        for b in os.listdir(blob_dir):
            if b.split(".")[0] not in live:
                os.remove(os.path.join(blob_dir, b))
