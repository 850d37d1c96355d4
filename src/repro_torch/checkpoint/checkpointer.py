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

A tree that holds DTensors (one mesh's: the launcher's trainer stacks on
a ``DeviceMesh``) is saved by every rank of the process group, each its
own local shards:

    <dir>/step_000000123/
        manifest.rank00003.json   # rank 3's: its world size, the mesh's
                                  # axes, and per leaf the cid of its
                                  # shard with the leaf's global shape
                                  # and placements
    <dir>/blobs/<cid>.bin         # shared: a shard two ranks hold (the
                                  # merged weights' rows) is stored once

Each rank writes its blobs and its manifest; then a barrier (on a gloo
group of the checkpointer's own, so that an async save's thread never
meets the round's collectives), rank 0 writes ``LATEST`` and collects
the garbage, and a second barrier holds every rank until that is done.
``restore(mesh=...)`` gives each rank its shards back as DTensors, on a
mesh of the shape and world size the step was saved on; any other mesh,
or none, raises, naming both (there is no resharding on restore, as the
JAX package has none).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


class _Shard(NamedTuple):
    """A DTensor leaf copied to the host: this rank's local shard, the
    leaf's global shape and placements, and its mesh's axes."""

    local: torch.Tensor
    shape: Tuple[int, ...]
    placements: Tuple[str, ...]
    mesh: Dict[str, int]


def _placement_name(p) -> str:
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(p, Shard):
        return f"S({p.dim})"
    if isinstance(p, Replicate):
        return "R"
    raise ValueError(f"the checkpointer stores Shard and Replicate "
                     f"placements, not {p}")


def _placement(name: str):
    from torch.distributed.tensor import Replicate, Shard
    return Replicate() if name == "R" else Shard(int(name[2:-1]))


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_host(leaf):
    """A leaf copied to the host (a DTensor as its ``_Shard``): the caller
    may go on to overwrite or free the tensor."""
    if _is_dtensor(leaf):
        mesh = leaf.device_mesh
        return _Shard(leaf.to_local().detach().to("cpu", copy=True),
                      tuple(leaf.shape),
                      tuple(map(_placement_name, leaf.placements)),
                      dict(zip(mesh.mesh_dim_names, mesh.shape)))
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _leaf_paths(tree) -> Dict[str, Any]:
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
        elif isinstance(node, (torch.Tensor, np.ndarray, _Shard)) or \
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


def _manifest_name(rank: Optional[int]) -> str:
    return "manifest.json" if rank is None else f"manifest.rank{rank:05d}.json"


def _mesh_of(flat: Dict[str, Any]) -> Optional[Dict[str, int]]:
    """The axes of the one mesh the tree's DTensor leaves lie on (None
    where it holds none)."""
    meshes = [leaf.mesh for leaf in flat.values() if isinstance(leaf, _Shard)]
    if any(m != meshes[0] for m in meshes):
        raise ValueError(f"the checkpointer stores the DTensors of one mesh; "
                         f"got {sorted(map(str, meshes))}")
    return meshes[0] if meshes else None


def _rank_world() -> Tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("a tree of DTensors is saved and restored by "
                           "every rank of a process group; none is set up")
    return dist.get_rank(), dist.get_world_size()


def _dtensor(local: torch.Tensor, mesh, meta: Dict) -> torch.Tensor:
    """A restored shard as its DTensor on ``mesh``'s device."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.specs import _contiguous_strides
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(meta["global_shape"])
    return DTensor.from_local(local.to(dev), mesh,
                              tuple(map(_placement, meta["placements"])),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(os.path.join(self.dir, "blobs"), exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._group = None

    # -- save ------------------------------------------------------------------
    def _barrier_group(self):
        """The checkpointer's own gloo group, made on its first sharded
        save, which every rank calls from its main thread."""
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        return self._group

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        flat = {path: _to_host(leaf) if _is_dtensor(leaf) else leaf
                for path, leaf in _leaf_paths(tree).items()}
        mesh = _mesh_of(flat)
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        rank = None
        if mesh is not None:
            rank, world = _rank_world()
            group = self._barrier_group()
            manifest.update(rank=rank, world=world, mesh=mesh)
        for path, leaf in flat.items():
            arr, dtype = _host(leaf.local if isinstance(leaf, _Shard)
                               else leaf)
            raw = arr.tobytes()
            cid = _cid(raw)
            blob = os.path.join(self.dir, "blobs", cid + ".bin")
            if not os.path.exists(blob):
                tmp = blob + f".tmp{rank or 0}.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(raw)
                os.replace(tmp, blob)
            manifest["leaves"][path] = {
                "cid": cid, "shape": list(arr.shape), "dtype": dtype}
            if isinstance(leaf, _Shard):
                manifest["leaves"][path].update(
                    global_shape=list(leaf.shape),
                    placements=list(leaf.placements))
        step_dir = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(step_dir, exist_ok=True)
        name = _manifest_name(rank)
        mtmp = os.path.join(step_dir, name + ".tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(step_dir, name))
        if mesh is not None:
            dist.barrier(group=group)      # every rank's manifest in place
        if rank in (None, 0):
            ltmp = os.path.join(self.dir, "LATEST.tmp")
            with open(ltmp, "w") as f:
                f.write(f"step_{step:09d}")
            os.replace(ltmp, os.path.join(self.dir, "LATEST"))
            self._gc()
        if mesh is not None:
            dist.barrier(group=group)      # no blob of the next step yet
        return manifest

    def save_async(self, step: int, tree, extra: Optional[Dict] = None):
        # copy to the host before the thread starts: the caller may go on
        # to overwrite or free the tensors
        host = {path: _to_host(leaf)
                for path, leaf in _leaf_paths(tree).items()}
        if _mesh_of(host) is not None:
            self._barrier_group()
        self.wait()
        self._async_thread = threading.Thread(
            target=self.save, args=(step, _unflatten(host), extra),
            daemon=True)
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

    def restore(self, step: Optional[int] = None,
                mesh=None) -> Tuple[Any, Dict]:
        """The step's tree (the latest's by default) and its ``extra``.
        A step saved from a mesh is restored on a ``DeviceMesh`` of the
        same axes and world size (``mesh``), its DTensor leaves as
        DTensors on it; one saved without, with no mesh."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        step_dir = os.path.join(self.dir, f"step_{step:09d}")
        rank = None
        if not os.path.exists(os.path.join(step_dir, "manifest.json")):
            rank = _rank_world()[0] if mesh is not None else 0
        with open(os.path.join(step_dir, _manifest_name(rank))) as f:
            manifest = json.load(f)
        saved = (f"a {manifest['mesh']} mesh of world size "
                 f"{manifest['world']}") if "mesh" in manifest \
            else "no mesh"
        here = "no mesh" if mesh is None else (
            f"a {dict(zip(mesh.mesh_dim_names, mesh.shape))} mesh of world "
            f"size {_rank_world()[1]}")
        if saved != here:
            raise ValueError(f"checkpoint step {step} was saved on {saved}; "
                             f"restoring on {here} (no resharding on "
                             f"restore)")
        flat = {}
        for path, meta in manifest["leaves"].items():
            blob = os.path.join(self.dir, "blobs", meta["cid"] + ".bin")
            with open(blob, "rb") as fb:
                raw = fb.read()
            if _cid(raw) != meta["cid"]:
                raise IOError(f"checkpoint blob corrupted: {path}")
            flat[path] = _tensor(raw, meta["dtype"], meta["shape"])
            if "placements" in meta:
                flat[path] = _dtensor(flat[path], mesh, meta)
        return _unflatten(flat), manifest["extra"]

    # -- retention -------------------------------------------------------------
    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)
        live = set()
        for d in steps[-self.keep:]:
            for name in os.listdir(os.path.join(self.dir, d)):
                if not (name.startswith("manifest")
                        and name.endswith(".json")):
                    continue
                with open(os.path.join(self.dir, d, name)) as f:
                    live.update(m["cid"] for m in
                                json.load(f)["leaves"].values())
        blob_dir = os.path.join(self.dir, "blobs")
        for b in os.listdir(blob_dir):
            if b.split(".")[0] not in live:
                os.remove(os.path.join(blob_dir, b))
