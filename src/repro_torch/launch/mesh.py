"""The ledger fabric's device mesh: K shard lanes over the local cards.

The JAX package shards the fabric's lane rows over a 1-D ``("shard",)``
device mesh (``src/repro/launch/mesh.py``).  A ``torch.distributed``
``DeviceMesh`` needs an initialised process group, and the port runs as
one process, so the shard mesh here is a plain frozen record: the axis
name and the devices, in order.  One H100 is a one-device mesh.  The
production meshes of the model substrate are not ported (ROADMAP.md,
item 10(f)).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

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
