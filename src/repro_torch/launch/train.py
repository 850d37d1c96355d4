"""Training launcher: rollup-FL rounds of a token LM (``fl/round.py``)
with checkpointing, resume-latest, straggler deadlines and reputation
updates, as ``src/repro/launch/train.py`` runs them.

    python -m repro_torch.launch.train --host-mesh        # qwen2-0.5b, one card
    python -m repro_torch.launch.train --host-mesh --reduced --device cpu
    python -m repro_torch.launch.train --host-mesh --ckpt-dir /tmp/ck --resume
    python -m repro_torch.launch.train --host-mesh --arch moonshot-v1-16b-a3b \
        --layers 4

The mesh comes from ``launch/mesh.py``: ``--host-mesh`` is the 1 x 1 mesh
of one card, a round of T = 1 trainer (T = data x pod, as the JAX
launcher takes it).  Without ``--host-mesh`` the launcher asks for the
production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) over the
default process group: outside a group of that size it raises, naming the
world size it found, and inside one it refuses too, because the round on
that mesh (``fl.round.build_fl_round_cell``, one trainer a data group,
what the dry run traces) is not wired into this launcher, whose round
(``build_fl_round``) runs the T trainers in turn on one card.  Full
configs take their own optimizer (``spec_for_config``: adamw for
qwen2-0.5b); ``--reduced`` takes sgdm at lr 0.05.  The initial weights
come from a ``torch.Generator`` seeded 0 on the device, not from the JAX
package's ``jax.random`` draws, so the two launchers start from other
weights.  Every round's batches come from one
``numpy.random.default_rng(17)`` stream, made before the first round, as
the JAX launcher draws them, so an uninterrupted run sees the JAX
launcher's tokens.  On ``--resume`` the skipped rounds' blocks are drawn
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
from repro_torch.fl.round import FLRoundSpec, build_fl_round, replicate
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_device, mesh_shape)
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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="1x1 mesh (the CPU smoke mesh)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to this depth (a multiple of the "
                         "block pattern's period), at full width")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main(argv=None) -> list:
    """Runs the rounds; returns one dict a round (round, loss, digest,
    mean_rep, seconds)."""
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

    mesh = make_host_mesh(args.device) if args.host_mesh \
        else make_production_mesh(multi_pod=args.multi_pod,
                                  device=args.device)
    sizes = mesh_shape(mesh)
    if not args.host_mesh:
        raise NotImplementedError(
            f"the {sizes} mesh's round is fl.round.build_fl_round_cell, "
            f"which this launcher does not drive: its build_fl_round would "
            f"hold every trainer's weights and repeat their steps on each "
            f"rank (ROADMAP.md §3); --host-mesh runs the one-card round")
    dev = mesh_device(mesh)
    model = build_model(cfg, dev)
    params = model.train_params(model.init_params(0))
    opt = make_optimizer(
        spec_for_config(cfg) if not args.reduced
        else OptimizerSpec(name="sgdm", lr=0.05),
        groups=model.param_groups(params))
    T = sizes["data"] * sizes.get("pod", 1)
    spec = FLRoundSpec(n_trainers=T, h_local_steps=args.local_steps,
                       local_batch=args.local_batch)
    fl_round = build_fl_round(model, opt, spec)

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    book = init_book(T, device=dev)
    rp = ReputationParams()
    registry = HeartbeatRegistry()
    deadline = RoundDeadline()

    start_round = 0
    params_T = replicate(params, T)
    opt_T = replicate(opt.init(params), T)
    del params
    if ck is not None and args.resume and ck.latest_step() is not None:
        restored, extra = ck.restore()
        params_T = _to(restored["params_T"], dev)
        opt_T = _to(restored["opt_T"], dev)
        book = TrainerBook(**{k: v.to(dev)
                              for k, v in restored["book"].items()})
        start_round = extra["round"] + 1
        print(f"resumed from round {extra['round']}")

    rng = np.random.default_rng(DATA_SEED)
    block = (T, spec.h_local_steps, spec.local_batch, args.seq_len + 1)
    for _ in range(start_round):       # the rounds a resumed run skips
        rng.integers(0, cfg.vocab_size, block)
    lines = []
    for rnd in range(start_round, args.rounds):
        t0 = time.time()
        for t in range(T):
            registry.beat(f"trainer{t}")
        toks = rng.integers(0, cfg.vocab_size, block)
        batches = {"tokens": torch.as_tensor(toks[..., :-1], dtype=torch.int32,
                                             device=dev),
                   "labels": torch.as_tensor(toks[..., 1:], dtype=torch.int32,
                                             device=dev)}
        scores = book.reputation.clone()
        params_T, opt_T, m = fl_round(params_T, opt_T, scores, batches)

        # end-of-round reputation refresh (oracle score ~ loss proxy)
        score_auto = torch.clamp(1.5 - m["loss"] / 10.0, 0.0, 1.0)
        h = float(spec.h_local_steps)
        book, _ = end_of_task_update(
            book, torch.full((T,), float(score_auto), device=dev),
            torch.full((T,), h, device=dev), torch.full((T,), h, device=dev),
            m["distances"], torch.ones(T, device=dev), rp)

        if not deadline.ready(T, T, elapsed=time.time() - t0):
            raise RuntimeError("round deadline missed with every trainer in")
        line = {"round": rnd, "loss": float(m["loss"]),
                "digest": int(m["digest"]),
                "mean_rep": float(book.reputation.mean()),
                "seconds": time.time() - t0}
        lines.append(line)
        print(f"round {rnd}: loss={line['loss']:.4f} "
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
    print("training complete.")
    return lines


if __name__ == "__main__":
    main()
