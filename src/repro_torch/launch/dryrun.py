"""The dry run: every (architecture x input shape x mesh) cell sized on a
faked 256- or 512-card H100 mesh, in one process, allocating nothing.

The JAX package's dry run fakes 512 host devices and compiles each cell
(``src/repro/launch/dryrun.py``).  Here:

  * the mesh is a ``DeviceMesh`` over the ``fake`` process-group backend
    (``init_process_group("fake", store=FakeStore(), rank=0,
    world_size=256 or 512)``): 16 x 16 ``("data", "model")`` or 2 x 16 x
    16 ``("pod", "data", "model")``, this process rank 0;
  * under ``FakeTensorMode`` the weights, optimizer state, batch and
    decode state are DTensors laid out by the model's specs
    (``launch/steps.build_cell``), their local shards fake tensors on
    ``--device`` (the card's type by default, ``cpu`` where there is no
    card): nothing is allocated on that device, and no kernel launches
    (the kernels' fake forms, ``kernels/factory.py``);
  * the step runs once; ``trace_s`` is its wall time;
  * ``torch.distributed._tools.mem_tracker.MemTracker`` records rank 0's
    live bytes through the cell (stand-ins made, step run):
    ``memory.peak_bytes_est`` is its peak, ``fits_hbm`` that peak against
    ``HBM_BYTES``;
  * ``analysis.hlo_cost.counting`` counts rank 0's local aten ops and the
    kernels' registered costs (``walk.flops``, ``walk.bytes``: per card,
    as the JAX HLO walk's are) and the collectives DTensor and the
    model's local regions issue (``walk.collective_*``, not counted as
    memory bytes); ``CommDebugMode`` counts the same collectives by op
    (``walk.comm_debug_counts``);
  * the roofline terms divide those by the card's datasheet constants
    (``launch/mesh.py``: H100 SXM5's bf16 peak, its HBM3 rate, one
    400 Gb/s link a card), and the model FLOPs come from
    ``analysis/model_flops.py``.

The record has the JAX record's keys, except ``trace_s`` for
``lower_s`` / ``compile_s`` and ``counted`` for ``xla_cost``.  The fake
backend becomes the process's default group, so the dry run runs in a
process of its own.  On a CPU fake mesh DTensor swaps an all-to-all for
an all-gather and a chunk (it warns so); the counts are DTensor's.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
    python -m repro_torch.launch.dryrun --fl-round --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.analysis.hlo_cost import counting, unseen_shape_inference
from repro_torch.analysis.model_flops import model_flops
from repro_torch.configs.base import SHAPES, cell_is_skipped
from repro_torch.configs.registry import ASSIGNED, get_config, get_shape
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, ICI_BW,
                                     PEAK_FLOPS_BF16, make_mesh,
                                     make_production_mesh)

#: the production meshes' world sizes, by ``--mesh`` name
WORLD = {"single": 256, "multi": 512}


def fake_world(world_size: int):
    """Make this process rank 0 of a ``fake`` process group of
    ``world_size`` ranks (replacing any fake group it had); returns the
    group's size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return world_size
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    return world_size


def mesh_for(kind: str, device: str, shape=None):
    """The faked mesh of ``kind`` (``single``, ``multi``) on ``device``;
    ``shape`` = (data, model) gives a small mesh instead (tests)."""
    if shape is not None:
        n = 1
        for d in shape:
            n *= d
        fake_world(n)
        return make_mesh(tuple(shape), device=device)
    fake_world(WORLD[kind])
    return make_production_mesh(multi_pod=(kind == "multi"), device=device)


def _nested(flat: dict) -> dict:
    """A flat dict of weights as the nested tree ``model_flops`` reads
    (the embedding as ``embed.table``)."""
    out: dict = {}
    for key, t in flat.items():
        path = ["embed", "table"] if key == "embed" else key.split(".")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = t
    return out


def _measure(build, device):
    """Run ``build()`` (-> a cell) and its step once on fake tensors:
    (cell, the step's count, CommDebugMode's counts, MemTracker's peak
    bytes on the device, the step's wall seconds)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    with FakeTensorMode(), unseen_shape_inference():
        tracker = MemTracker()
        with tracker:
            cell = build()
            t0 = time.time()
            with CommDebugMode() as comm, counting() as cost:
                cell.step(*cell.args)
            trace_s = time.time() - t0
        peak = tracker.get_tracker_snapshot("peak")
    dev = torch.device(device)
    per_dev = {torch.device(k) if not isinstance(k, torch.device) else k: v
               for k, v in peak.items()}
    mine = [v for k, v in per_dev.items() if k.type == dev.type]
    peak_bytes = max((v["Total"] for v in mine), default=0)
    counts = {str(k).split(".")[-1]: int(v)
              for k, v in comm.get_comm_counts().items()}
    return cell, cost, counts, peak_bytes, trace_s


def weight_bytes(model) -> dict:
    """The weights' bytes a card holds under the model's specs
    (``weight_bytes``), against ``ModelConfig.param_count()`` in bfloat16
    split evenly over data x model (``weight_bytes_even``; the ``pod``
    axis shares no weight): a leaf the specs replicate (a norm, or a dim
    ``sanitize_spec`` leaves whole) raises the first."""
    ctx = model.ctx
    pshape = model.params_shape()
    total = 0
    for key, spec in model.params_pspecs(pshape).items():
        t = pshape[key]
        shards = 1
        for e in ctx.fit(spec, tuple(t.shape)):
            shards *= ctx.size(e)
        total += t.numel() * t.element_size() // shards
    even = 2 * model.cfg.param_count() / (ctx.size("data")
                                          * ctx.size("model"))
    return {"weight_bytes": total, "weight_bytes_even": even,
            "weight_bytes_over_even": total / even}


def _walk(cost, comm_counts) -> dict:
    return {"flops": cost.flops, "bytes": cost.bytes,
            "collective_bytes": cost.collective_bytes,
            "collective_wire_bytes": cost.collective_wire_bytes,
            "collectives": dict(cost.collectives),
            "collective_counts": dict(cost.collective_counts),
            "comm_debug_counts": comm_counts,
            "custom_calls": len(cost.custom_calls),
            "warnings": cost.warnings[:5]}


def _terms(cost) -> dict:
    return {"compute_s": cost.flops / PEAK_FLOPS_BF16,
            "memory_s": cost.bytes / HBM_BW,
            "collective_s": cost.collective_bytes / ICI_BW}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, *, device: str = "cuda", cfg=None,
             shape=None, mesh_shape=None):
    """One cell's record.  ``cfg``, ``shape`` and ``mesh_shape`` (a
    (data, model) or (pod, data, model) tuple) override the registry's
    config, the named shape and the production mesh (tests)."""
    from repro_torch.launch.steps import build_cell
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    skip = cell_is_skipped(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    try:
        mesh = mesh_for(mesh_kind, device, mesh_shape)
        n_chips = mesh.size()
        cell, cost, comm, peak, trace_s = _measure(
            lambda: build_cell(cfg, shape, mesh, device=device), device)
        mf = model_flops(cfg, shape, _nested(cell.model.params_shape()))
        terms = _terms(cost)
        dominant = max(terms, key=terms.get)
        mem = {"peak_bytes_est": peak, **weight_bytes(cell.model)}
        rec.update(
            status="ok", kind=cell.kind, n_chips=n_chips,
            trace_s=round(trace_s, 2), memory=mem,
            fits_hbm=peak <= HBM_BYTES,
            counted={"flops": cost.flops, "dot_flops": cost.dot_flops,
                     "bytes": cost.bytes,
                     "transcendentals": cost.transcendentals,
                     "convert_bytes": cost.convert_bytes},
            walk=_walk(cost, comm),
            roofline={
                **terms,
                "dominant": dominant,
                "step_time_lb_s": max(terms.values()),
                "model_flops_global": mf["model_flops_total"],
                "model_flops_per_chip": mf["model_flops_total"] / n_chips,
                "useful_flops_ratio": (mf["model_flops_total"] / n_chips)
                / max(cost.flops, 1.0),
                "roofline_fraction": min(
                    1.0, (mf["model_flops_total"] / n_chips
                          / PEAK_FLOPS_BF16)
                    / max(max(terms.values()), 1e-30)),
            },
        )
        if verbose:
            print(f"== {arch} x {shape_name} x {mesh_kind} "
                  f"({cell.kind}, {n_chips} cards) ==")
            print(f"walk: flops/card={cost.flops:.3e} "
                  f"bytes/card={cost.bytes:.3e} "
                  f"coll/card={cost.collective_bytes:.3e} "
                  f"{dict(cost.collective_counts)}")
            print(f"roofline: compute={terms['compute_s']*1e3:.2f}ms "
                  f"memory={terms['memory_s']*1e3:.2f}ms "
                  f"coll={terms['collective_s']*1e3:.2f}ms "
                  f"dominant={dominant} "
                  f"frac={rec['roofline']['roofline_fraction']:.3f} "
                  f"peak_mem={peak/2**30:.2f}GiB fits={rec['fits_hbm']} "
                  f"trace={trace_s:.1f}s", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"== {arch} x {shape_name} x {mesh_kind} FAILED ==")
            print(rec["error"], flush=True)
    return rec


def run_fl_round_cell(arch: str, mesh_kind: str, h_local_steps: int = 8,
                      seq_len: int = 4096, verbose: bool = True, *,
                      device: str = "cuda", cfg=None, mesh_shape=None,
                      local_batch: int = 16, trainer_axes=None):
    """Dry-run the paper-technique cell: the rollup round
    (``fl/round.build_fl_round_cell``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.fl.round import FLRoundSpec, build_fl_round_cell
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer, spec_for_config
    cfg = cfg or get_config(arch)
    rec = {"arch": arch, "shape": f"fl_round_h{h_local_steps}",
           "mesh": mesh_kind}
    try:
        mesh = mesh_for(mesh_kind, device, mesh_shape)
        n_chips = mesh.size()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        axes = tuple(trainer_axes or (("pod", "data") if "pod" in sizes
                                      else ("data",)))
        n_trainers = 1
        for a in axes:
            n_trainers *= sizes[a]
        spec = FLRoundSpec(n_trainers=n_trainers,
                           h_local_steps=h_local_steps,
                           local_batch=local_batch)

        def build():
            model = build_model(cfg, device, mesh=mesh)
            opt = make_optimizer(spec_for_config(cfg),
                                 groups=model.param_groups(
                                     model.params_shape()))
            return build_fl_round_cell(model, opt, spec, mesh, seq_len,
                                       trainer_axes=trainer_axes,
                                       device=device)
        cell, cost, comm, peak, trace_s = _measure(build, device)
        step_shape = ShapeConfig("fl_round", seq_len,
                                 local_batch * n_trainers, "train")
        mf = model_flops(cfg, step_shape,
                         _nested(cell.model.params_shape()))
        terms = _terms(cost)
        rec.update(
            status="ok", kind="fl_round", n_chips=n_chips,
            h_local_steps=h_local_steps, n_trainers=n_trainers,
            trace_s=round(trace_s, 2),
            memory={"peak_bytes_est": peak}, fits_hbm=peak <= HBM_BYTES,
            walk=_walk(cost, comm),
            roofline={**terms,
                      "dominant": max(terms, key=terms.get),
                      "step_time_lb_s": max(terms.values()),
                      "collective_s_per_local_step":
                          terms["collective_s"] / h_local_steps,
                      "model_flops_global":
                          mf["model_flops_total"] * h_local_steps},
        )
        if verbose:
            print(f"== fl_round {arch} H={h_local_steps} x {mesh_kind} "
                  f"({n_trainers} trainers) ==")
            print(f"walk: flops/card={cost.flops:.3e} "
                  f"bytes/card={cost.bytes:.3e} "
                  f"coll/card={cost.collective_bytes:.3e} "
                  f"{dict(cost.collective_counts)}")
            print(f"roofline: compute={terms['compute_s']*1e3:.2f}ms "
                  f"memory={terms['memory_s']*1e3:.2f}ms "
                  f"coll={terms['collective_s']*1e3:.2f}ms "
                  f"peak_mem={peak/2**30:.2f}GiB trace={trace_s:.1f}s",
                  flush=True)
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"== fl_round {arch} FAILED ==\n{rec['error']}",
                  flush=True)
    return rec


def _dump(rec, path: str) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fl-round", action="store_true",
                    help="dry-run the paper-technique rollup-round cell")
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (nothing is allocated "
                         "on it): the card's type, or cpu")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    if args.fl_round:
        arch = args.arch or "yi-6b"
        fail = 0
        for mk in meshes:
            rec = run_fl_round_cell(arch, mk, args.local_steps,
                                    device=args.device)
            _dump(rec, os.path.join(
                args.out, f"fl_round__{arch}__h{args.local_steps}__{mk}.json"))
            fail += rec["status"] != "ok"
        raise SystemExit(1 if fail else 0)

    if args.all:
        cells = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        cells = [(args.arch, args.shape)]
    n_ok = n_fail = n_skip = 0
    t0 = time.time()
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, device=args.device)
            _dump(rec, os.path.join(args.out, f"{arch}__{shape}__{mk}.json"))
            n_ok += rec["status"] == "ok"
            n_fail += rec["status"] == "error"
            n_skip += rec["status"] == "skipped"
    print(f"\ndry-run summary: ok={n_ok} failed={n_fail} skipped={n_skip} "
          f"({time.time() - t0:.1f} s)")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
