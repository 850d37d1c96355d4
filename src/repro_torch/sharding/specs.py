"""How the ledger fabric's lane rows split over the shard mesh.

Only what the fabric reads of the JAX package's
``src/repro/sharding/specs.py``: the axis name and the lane-row split.
The model substrate's policies and ``MeshCtx`` are not ported (ROADMAP.md,
item 10(f)).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

#: the ledger fabric's 1-D mesh axis (launch/mesh.make_shard_mesh)
SHARD_LANE_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """How ``(K, W)`` lane buffers split over a mesh axis: contiguous
    row blocks, one a device, rows padded to a multiple of the mesh size
    by empty lanes; the word axis stays whole on each device."""

    axis: str = SHARD_LANE_AXIS

    def padded_rows(self, n_rows: int, mesh_size: int) -> int:
        """Rows after padding ``n_rows`` to a multiple of the mesh size."""
        return -(-n_rows // mesh_size) * mesh_size

    def blocks(self, n_rows: int, mesh_size: int) -> List[Tuple[int, int]]:
        """The ``[lo, hi)`` row block of each device, over the padded
        rows."""
        per = self.padded_rows(n_rows, mesh_size) // mesh_size
        return [(i * per, (i + 1) * per) for i in range(mesh_size)]


def shard_lane_spec() -> LaneSpec:
    """The split of shard-lane buffers (kernels/shard_lanes.py): lane
    rows over the ``"shard"`` axis, each device folding its own lanes
    with no traffic between devices."""
    return LaneSpec()
