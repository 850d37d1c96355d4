"""Training launcher: rollup-FL rounds of a token LM (``fl/round.py``)
with checkpointing, resume-latest, straggler deadlines and reputation
updates, as ``src/repro/launch/train.py`` runs them.

    python -m repro_torch.launch.train --host-mesh        # qwen2-0.5b, one card
    python -m repro_torch.launch.train --host-mesh --reduced --device cpu
    python -m repro_torch.launch.train --host-mesh --ckpt-dir /tmp/ck --resume
    python -m repro_torch.launch.train --host-mesh --arch moonshot-v1-16b-a3b \\
        --layers 4
    torchrun --nnodes 32 --nproc-per-node 8 ... \\
        -m repro_torch.launch.train --arch qwen2-0.5b      # 16 x 16
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --mesh-shape 2x2 --reduced --device cpu           # four CPU ranks

The mesh comes from ``launch/mesh.py``: ``--host-mesh`` is the 1 x 1
mesh, ``--mesh-shape DxM`` or ``PxDxM`` a (pod x) data x model mesh, and
without either the production mesh (16 x 16, or 2 x 16 x 16 with
``--multi-pod``), over the default process group.  A round has T = data
x pod trainers, as the JAX launcher takes it.  Under ``torchrun`` (its
``WORLD_SIZE`` set, no group yet) the launcher starts the group itself,
``nccl`` on the cards (each rank on its ``LOCAL_RANK``'s card) or
``gloo`` with ``--device cpu``, and destroys it on the way out; a group
the caller set up is used as it is.  Without a group the meshes wider
than 1 x 1 raise, naming the world size found.

The round follows the kind of mesh:

  * a ``DeviceMesh`` (every mesh inside a process group, ``--host-mesh``
    in a one-rank group too) runs the mesh round
    (``fl.round.build_fl_round_cell``): one trainer a data (x pod) group,
    its weights sharded over ``model`` and the commit an all-reduce over
    the trainers.  Each rank holds only its own trainer's shards of the
    weights (drawn leaf by leaf, ``fl.round.init_params_T``), of the
    optimizer state (zeros, as every optimizer's starts) and of the
    batches (``launch.steps.shard``), and its checkpoints hold those
    shards (``checkpoint/checkpointer.py``).  The reputation book stays
    whole on every rank, which runs the same update on the gathered
    losses and distances; rank 0 prints the lines.
  * the ``TrainMesh`` record (``--host-mesh`` with no process group)
    runs the one-card round (``build_fl_round``): the T = 1 trainer over
    a replicated stack, its commit and distances the ``weighted_agg`` and
    ``model_distance`` kernels.

Full configs take their own optimizer (``spec_for_config``: adamw for
qwen2-0.5b); ``--reduced`` takes sgdm at lr 0.05.  The initial weights
come from a ``torch.Generator`` seeded 0 on the device, not from the JAX
package's ``jax.random`` draws, so the two launchers start from other
weights.  Every round's batches come from one
``numpy.random.default_rng(17)`` stream, made before the first round, as
the JAX launcher draws them, so an uninterrupted run sees the JAX
launcher's tokens (every rank draws the whole block, and lays out its
own trainer's row).  On ``--resume`` the skipped rounds' blocks are drawn
and dropped first (every round draws one block of the same shape), so a
resumed run sees the batches the uninterrupted run saw (the JAX launcher
restarts its stream at 17 on resume).  ``--layers N`` cuts the stack to N
layers at full width (a depth one card holds, where the whole model does
not).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.core.reputation import (ReputationParams, TrainerBook,
                                         end_of_task_update, init_book)
from repro_torch.fl.round import (FLRoundSpec, build_fl_round,
                                  build_fl_round_cell, init_params_T,
                                  replicate, stack_shape)
from repro_torch.launch.mesh import (TrainMesh, add_mesh_args,
                                     check_mesh_args, mesh_device,
                                     mesh_from_flags, mesh_shape,
                                     process_group, rank0)
from repro_torch.launch.steps import shard, stand_in
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import (OptimizerSpec, make_optimizer,
                                          spec_for_config)
from repro_torch.runtime.fault_tolerance import (HeartbeatRegistry,
                                                 RoundDeadline)

DATA_SEED = 17


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=16)
    add_mesh_args(ap)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to this depth (a multiple of the "
                         "block pattern's period), at full width")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    check_mesh_args(ap, args)
    return args


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


class OneCardRound:
    """The ``TrainMesh``'s round (``build_fl_round``): plain tensors on
    one device, the T trainers in turn over a replicated (T, ...)
    stack."""

    def __init__(self, model, opt, spec: FLRoundSpec):
        self.model, self.opt, self.spec = model, opt, spec
        self.device = model.device
        self.fl_round = build_fl_round(model, opt, spec)

    def init(self, seed: int = 0):
        params = self.model.train_params(self.model.init_params(seed))
        T = self.spec.n_trainers
        return replicate(params, T), replicate(self.opt.init(params), T)

    def restore(self, ck):
        tree, extra = ck.restore()
        return (_to(tree["params_T"], self.device),
                _to(tree["opt_T"], self.device), tree["book"], extra)

    def step(self, params_T, opt_T, scores, toks):
        """One round on ``toks`` (the (T, H, B, S + 1) block): (params_T,
        opt_T, loss, distances, digest)."""
        batches = {k: torch.as_tensor(v, dtype=torch.int32,
                                      device=self.device)
                   for k, v in (("tokens", toks[..., :-1]),
                                ("labels", toks[..., 1:]))}
        params_T, opt_T, m = self.fl_round(params_T, opt_T, scores, batches)
        return params_T, opt_T, m["loss"], m["distances"], m["digest"]


class MeshRound:
    """A ``DeviceMesh``'s round (``build_fl_round_cell``): the trainer
    stacks and batches as DTensors laid out by the cell's specs, each
    rank's local shards one trainer row."""

    def __init__(self, model, opt, spec: FLRoundSpec, mesh, seq_len: int):
        self.model, self.opt, self.spec, self.mesh = model, opt, spec, mesh
        self.device = model.device
        self.cell = build_fl_round_cell(model, opt, spec, mesh, seq_len,
                                        stand_ins=False)

    def init(self, seed: int = 0):
        pspecs_T, ospecs_T = self.cell.specs[:2]
        T = self.spec.n_trainers
        params_T = init_params_T(self.model, pspecs_T, T, seed)
        # every optimizer's state starts at zero (moments, factored second
        # moments, the step count): each rank makes its shards as zeros
        # where opt.init of the trainer's DTensor weights would make
        # whole tensors (torch.zeros of the global shape)
        oshape = self.opt.init(self.model.params_shape())
        opt_T = stand_in(self.model.ctx, stack_shape(oshape, T), ospecs_T,
                         self.device, make=torch.zeros)
        return params_T, opt_T

    def restore(self, ck):
        tree, extra = ck.restore(mesh=self.mesh)
        return tree["params_T"], tree["opt_T"], tree["book"], extra

    def step(self, params_T, opt_T, scores, toks):
        ctx, (_, _, s_spec, b_spec) = self.model.ctx, self.cell.specs
        batches = {k: shard(ctx, v.astype(np.int32), b_spec[k], self.device)
                   for k, v in (("tokens", toks[..., :-1]),
                                ("labels", toks[..., 1:]))}
        params_T, opt_T, m = self.cell.step(
            params_T, opt_T, shard(ctx, scores, s_spec, self.device),
            batches)
        return (params_T, opt_T, m["loss"].full_tensor(),
                m["distances"].full_tensor(), m["digest"])


def run_rounds(fl, *, rounds: int, seq_len: int, ck=None,
               resume: bool = False) -> list:
    """The launcher's loop over ``fl`` (a ``OneCardRound`` or a
    ``MeshRound``): rounds ``[start, rounds)``, each ``fl.step`` on the
    round's block of the data stream, the reputation book's update, the
    deadline and an async checkpoint; returns one dict a round (round,
    loss, digest, mean_rep, seconds)."""
    spec, dev = fl.spec, fl.device
    T = spec.n_trainers
    book = init_book(T, device=dev)
    rp = ReputationParams()
    registry = HeartbeatRegistry()
    deadline = RoundDeadline()
    say = print if rank0() else (lambda *a, **kw: None)

    start_round = 0
    if ck is not None and resume and ck.latest_step() is not None:
        params_T, opt_T, saved, extra = fl.restore(ck)
        book = TrainerBook(**{k: v.to(dev) for k, v in saved.items()})
        start_round = extra["round"] + 1
        say(f"resumed from round {extra['round']}")
    else:
        params_T, opt_T = fl.init(0)

    rng = np.random.default_rng(DATA_SEED)
    block = (T, spec.h_local_steps, spec.local_batch, seq_len + 1)
    vocab = fl.model.cfg.vocab_size
    for _ in range(start_round):       # the rounds a resumed run skips
        rng.integers(0, vocab, block)
    lines = []
    for rnd in range(start_round, rounds):
        t0 = time.time()
        for t in range(T):
            registry.beat(f"trainer{t}")
        toks = rng.integers(0, vocab, block)
        params_T, opt_T, loss, distances, digest = fl.step(
            params_T, opt_T, book.reputation.clone(), toks)

        # end-of-round reputation refresh (oracle score ~ loss proxy)
        score_auto = torch.clamp(1.5 - loss / 10.0, 0.0, 1.0)
        h = float(spec.h_local_steps)
        book, _ = end_of_task_update(
            book, torch.full((T,), float(score_auto), device=dev),
            torch.full((T,), h, device=dev), torch.full((T,), h, device=dev),
            distances, torch.ones(T, device=dev), rp)

        if not deadline.ready(T, T, elapsed=time.time() - t0):
            raise RuntimeError("round deadline missed with every trainer in")
        line = {"round": rnd, "loss": float(loss), "digest": int(digest),
                "mean_rep": float(book.reputation.mean()),
                "seconds": time.time() - t0}
        lines.append(line)
        say(f"round {rnd}: loss={line['loss']:.4f} "
            f"digest=0x{line['digest']:08x} "
            f"mean_rep={line['mean_rep']:.3f} ({line['seconds']:.1f}s)",
            flush=True)
        if ck is not None:
            ck.save_async(rnd, {
                "params_T": params_T, "opt_T": opt_T,
                "book": {f.name: getattr(book, f.name)
                         for f in dataclasses.fields(book)}},
                extra={"round": rnd})
    if ck is not None:
        ck.wait()
    say("training complete.")
    return lines


def main(argv=None) -> list:
    """Runs the rounds; returns one dict a round (round, loss, digest,
    mean_rep, seconds), on every rank."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.layers is not None:
        if args.layers < 1 or args.layers % len(cfg.pattern):
            raise ValueError(f"--layers {args.layers}: {cfg.name} stacks "
                             f"periods of {len(cfg.pattern)} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.input_mode != "tokens" or cfg.enc_dec or cfg.family == "conv":
        raise ValueError("the FL-LM launcher drives token-LM archs")
    opt_spec = spec_for_config(cfg) if not args.reduced \
        else OptimizerSpec(name="sgdm", lr=0.05)
    # the mesh round lays the optimizer state out by the config's name
    cfg = dataclasses.replace(cfg, optimizer=opt_spec.name)

    with process_group(args.device):
        mesh = mesh_from_flags(args, args.device)
        sizes = mesh_shape(mesh)
        dev = mesh_device(mesh)
        one_card = isinstance(mesh, TrainMesh)
        model = build_model(cfg, dev, mesh=None if one_card else mesh)
        opt = make_optimizer(opt_spec,
                             groups=model.param_groups(model.params_shape()))
        spec = FLRoundSpec(n_trainers=sizes["data"] * sizes.get("pod", 1),
                           h_local_steps=args.local_steps,
                           local_batch=args.local_batch)
        fl = OneCardRound(model, opt, spec) if one_card \
            else MeshRound(model, opt, spec, mesh, args.seq_len)
        ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
        return run_rounds(fl, rounds=args.rounds, seq_len=args.seq_len,
                          ck=ck, resume=args.resume)


if __name__ == "__main__":
    main()
