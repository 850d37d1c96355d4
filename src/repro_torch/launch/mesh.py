"""The ledger fabric's device mesh: K shard lanes over the local cards.

The JAX package shards the fabric's lane rows over a 1-D ``("shard",)``
device mesh (``src/repro/launch/mesh.py``).  A ``torch.distributed``
``DeviceMesh`` needs an initialised process group, and the port runs as
one process, so the shard mesh here is a plain frozen record: the axis
name and the devices, in order.  One H100 is a one-device mesh.

The model substrate's meshes (``make_host_mesh``, ``make_production_mesh``)
are the same kind of record with the axes ``("data", "model")``, both of
size 1: the port trains on one card, so the training launcher runs T = 1
trainer.  The JAX package's 16 x 16 (or 2 x 16 x 16 multi-pod) meshes, and
any mesh wider than the local cards, raise: they need the sharded model
(ROADMAP.md queue 1 item 10(f)).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import SHARD_LANE_AXIS


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: ``axis`` names it, ``devices`` are its members."""

    axis: str
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


@functools.lru_cache(maxsize=None)
def n_local_devices() -> int:
    """The CUDA cards this process sees, probed once (1 where it sees
    none: a CPU caller runs on one device)."""
    return max(1, torch.cuda.device_count())


def make_shard_mesh(max_devices: Optional[int] = None, *,
                    device=None) -> ShardMesh:
    """1-D ``"shard"`` mesh over the local cards (at most
    ``max_devices``), or over ``device="cpu"`` alone.  ``device=None``
    means the cards and raises without one."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ShardMesh(SHARD_LANE_AXIS, (dev,))
    n = n_local_devices()
    if max_devices is not None:
        n = max(1, min(n, max_devices))
    return ShardMesh(SHARD_LANE_AXIS,
                     tuple(torch.device("cuda", i) for i in range(n)))


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """The training launcher's mesh: ``shape`` maps each axis name to its
    size, ``devices`` are its members."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_train_mesh(data: int = 1, model: int = 1, *,
                    device=None) -> TrainMesh:
    """A ``("data", "model")`` mesh on one device (the card unless
    named); wider meshes raise (ROADMAP.md queue 1 item 10(f))."""
    if data * model != 1:
        raise NotImplementedError(
            f"a {data} x {model} training mesh needs the sharded model and "
            f"one process a card (ROADMAP.md queue 1 item 10(f)); the port "
            f"trains on one device")
    return TrainMesh({"data": 1, "model": 1}, (resolve_device(device),))


def make_host_mesh(device=None) -> TrainMesh:
    """The 1 x 1 mesh (the JAX package's CPU smoke mesh)."""
    return make_train_mesh(device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> TrainMesh:
    """One card's answer to the JAX package's production mesh: 1 x 1.
    ``multi_pod`` raises (ROADMAP.md queue 1 item 10(f))."""
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh (2 x 16 x 16) needs the sharded model "
            "across hosts (ROADMAP.md queue 1 item 10(f))")
    return make_train_mesh(device=device)
