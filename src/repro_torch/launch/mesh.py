"""The port's device meshes, and the card's constants for the roofline.

  * The ledger fabric's shard mesh (``make_shard_mesh``): K shard lanes
    over the local cards, a plain frozen record (the axis name and the
    devices, in order), as the fabric runs in one process.  One H100 is
    a one-device mesh.
  * The model substrate's meshes, ``("data", "model")`` or ``("pod",
    "data", "model")``: a ``torch.distributed`` ``DeviceMesh`` over the
    default process group, one rank a card.  ``make_production_mesh``
    builds the JAX package's 16 x 16 (256 cards) or 2 x 16 x 16 (512
    cards) over a group of that size: the ``fake`` backend in the dry
    run (``launch/dryrun.py``), or the group ``torchrun`` set up.
    ``make_train_mesh(data, model)`` does the same over ``data x model``
    ranks, and ``make_mesh`` over a 2- or 3-axis shape (the launcher's
    ``--mesh-shape``).  Each raises, naming the world size it found, where the
    group is missing or of another size.  The 1 x 1 meshes need no
    process group: with none initialised they are a :class:`TrainMesh`
    record of one device, as the one-card launcher runs them.

``mesh_shape`` and ``mesh_device`` read either kind.  Building a mesh
never touches a card before it is asked for one.

The launchers' side (``launch/train.py``, ``launch/serve_model.py``):
``add_mesh_args`` gives a parser ``--host-mesh``, ``--mesh-shape DxM|PxDxM``
and ``--multi-pod`` (one of them at most), ``process_group`` starts
``torchrun``'s group where its environment names one, and
``mesh_from_flags`` builds the mesh the flags name: the 1 x 1 mesh, a
mesh of that shape, or by default the production mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import SHARD_LANE_AXIS

# NVIDIA H100 SXM5 80GB, per card, for the dry run's roofline
# (``launch/dryrun.py``).  The names are the JAX package's, so the two dry
# runs read alike; none of the figures is the TPU's.
#: dense bfloat16 tensor-core peak, FLOP/s (NVIDIA H100 datasheet, SXM5,
#: without sparsity), as ``chip_smoke.BF16_TENSOR_FLOPS`` has it
PEAK_FLOPS_BF16 = 989e12
#: device memory rate, bytes/s (NVIDIA H100 datasheet, SXM5 HBM3), as
#: ``chip_smoke.HBM_BYTES_PER_S`` has it
HBM_BW = 3.35e12
#: bytes a card crosses to another card of its group a second: one
#: 400 Gb/s NDR InfiniBand link a card (NVIDIA ConnectX-7 datasheet).
#: Both production meshes span nodes of 8 cards, so a ``model`` group of
#: 16 crosses a node boundary and runs at the network's rate, not
#: NVLink's 450 GB/s a direction
ICI_BW = 50e9
#: device memory, bytes: ``torch.cuda.get_device_properties(0)
#: .total_memory`` read on an NVIDIA H100 80GB HBM3 (700.00 W power limit)
HBM_BYTES = 85_017_493_504

#: the production meshes: (shape, axis names) by ``multi_pod``
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


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
    """The 1 x 1 mesh with no process group: ``shape`` maps each axis
    name to its size, ``devices`` are its members."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a :class:`TrainMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_device(mesh) -> torch.device:
    """The device this process's rank of ``mesh`` runs on."""
    if isinstance(mesh, TrainMesh):
        return mesh.devices[0]
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world size must be the product of ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    want = 1
    for n in shape:
        want *= n
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != want:
        found = "no process group" if world is None \
            else f"a process group of world size {world}"
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} mesh {names} needs a process "
            f"group of world size {want} (one rank a card: torchrun, or the "
            f"dry run's fake backend); found {found}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_train_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``("data", "model")`` mesh: the 1 x 1 :class:`TrainMesh` on one
    device (the card unless named) where no process group is set up, a
    ``DeviceMesh`` over the default group (of world size ``data x
    model``) otherwise."""
    import torch.distributed as dist
    if data * model == 1 and not dist.is_initialized():
        return TrainMesh({"data": 1, "model": 1}, (resolve_device(device),))
    return _device_mesh((data, model), ("data", "model"), device)


def make_mesh(shape: Tuple[int, ...], *, device=None):
    """``make_train_mesh(*shape)`` for (data, model), or the ``("pod",
    "data", "model")`` mesh of (pod, data, model) over the default
    process group (of world size ``pod x data x model``)."""
    if len(shape) == 2:
        return make_train_mesh(*shape, device=device)
    if len(shape) == 3:
        return _device_mesh(tuple(shape), PRODUCTION[True][1], device)
    raise ValueError(f"a mesh of (data, model) or (pod, data, model), not "
                     f"{tuple(shape)}")


def make_host_mesh(device=None):
    """The 1 x 1 mesh (the JAX package's CPU smoke mesh)."""
    return make_train_mesh(device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The JAX package's production mesh as a ``DeviceMesh``: 16 x 16
    ``("data", "model")`` (256 cards), or with ``multi_pod`` 2 x 16 x 16
    ``("pod", "data", "model")`` (512 cards), over the default process
    group, which must be of that size."""
    shape, names = PRODUCTION[multi_pod]
    return _device_mesh(shape, names, device)


# -----------------------------------------------------------------------------
# The launchers' flags and process group
# -----------------------------------------------------------------------------
def _mesh_shape_arg(text: str):
    try:
        shape = tuple(int(n) for n in text.split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise argparse.ArgumentTypeError(
            f"{text!r}: DxM (data x model) or PxDxM (pod x data x model)")
    return shape


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    """``--multi-pod``, ``--host-mesh`` and ``--mesh-shape`` on ``ap``."""
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="1x1 mesh (the CPU smoke mesh)")
    ap.add_argument("--mesh-shape", type=_mesh_shape_arg, default=None,
                    help="DxM or PxDxM: the production mesh's axes at "
                         "another size, over the default process group")


def check_mesh_args(ap: argparse.ArgumentParser, args) -> None:
    """``ap.error`` where more than one flag names the mesh."""
    if sum((args.host_mesh, args.mesh_shape is not None,
            args.multi_pod)) > 1:
        ap.error("--host-mesh, --mesh-shape and --multi-pod each name the "
                 "mesh: give one")


def mesh_from_flags(args, device=None):
    """The mesh ``add_mesh_args``' flags name: ``make_host_mesh`` for
    ``--host-mesh``, ``make_mesh`` for ``--mesh-shape``, otherwise
    ``make_production_mesh`` (2 x 16 x 16 with ``--multi-pod``)."""
    if args.host_mesh:
        return make_host_mesh(device)
    if args.mesh_shape is not None:
        return make_mesh(args.mesh_shape, device=device)
    return make_production_mesh(multi_pod=args.multi_pod, device=device)


def rank0() -> bool:
    """True outside a process group and on its rank 0."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def process_group(device=None):
    """``torchrun``'s process group, where its environment names one
    (``WORLD_SIZE``) and none is set up: ``nccl`` on the cards, each rank
    on its ``LOCAL_RANK``'s, or ``gloo`` on the CPU; destroyed on
    leaving.  Otherwise nothing: a group the caller set up stays its."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        yield
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()
