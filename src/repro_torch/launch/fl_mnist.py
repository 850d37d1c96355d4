"""The paper's own end-to-end workload (§VI), the port of
``examples/fl_mnist.py``: LeNet-5 federated training with good / malicious
/ lazy trainers, DON evaluation, reputation-weighted aggregation (Eq. 1),
zk-rollup settlement, escrow payouts.  This is the Fig. 3 experiment as a
runnable script, on the object engine with the L2 rollup (``RollupSpec()``)
or, under ``--no-rollup``, the L1 alone.

Usage (on the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.launch.fl_mnist --tasks 5 --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.fl_mnist --device cpu
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List

import torch

from repro_torch.api import ChainSpec, FLTaskSpec, NodeSpec, RollupSpec
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import client_batch_fn
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl.client import ClientConfig, TrainingAgent
from repro_torch.fl.dp import DPConfig
from repro_torch.fl.partition import dirichlet_partition, skew_report
from repro_torch.fl.server import AutoDFL
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

BEHAVIORS = ("good", "good", "malicious", "lazy")


def behaviors(clients: int) -> List[str]:
    return (list(BEHAVIORS) * 8)[:clients]


def run(tasks: int = 5, rounds: int = 4, clients: int = 4,
        rollup: bool = True, device=None,
        say: Callable[[str], None] = print) -> Dict:
    """The experiment at ``examples/fl_mnist.py``'s settings: a Dirichlet
    split (alpha 0.8) of 2,048 synthetic MNIST images, 256 of them the
    publisher's validation set; ``tasks`` run_task calls of ``rounds``
    rounds over ``clients`` TrainingAgents; ``say`` prints.  Returns the
    node, each task's ``FLTaskResult``, the final accuracy and the
    trainers' behaviours."""
    dev = resolve_device(device)
    cfg = get_config("lenet5")
    model = build_model(cfg, dev)
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.05, grad_clip=5.0))
    xs, ys = make_mnist_like(2048, seed=1)
    val = {"images": xs[:256], "labels": ys[:256]}
    parts = dirichlet_partition(ys[256:], clients, alpha=0.8, seed=0)
    say(f"non-IID partition: {skew_report(ys[256:], parts)['sizes']}")
    bf = client_batch_fn(xs[256:], ys[256:], parts, 64)
    eval_fn = model.accuracy_fn()

    spec = NodeSpec(chain=ChainSpec(backend="object"),
                    rollup=RollupSpec() if rollup else None)
    node = AutoDFL(model, opt, clients, eval_fn, val, spec=spec, device=dev)
    kinds = behaviors(clients)
    agents = [TrainingAgent(
        ClientConfig(f"trainer{i}", kinds[i],
                     dp=DPConfig(noise_multiplier=0.05)),
        model, opt, node.store, bf, seed=i, device=dev)
        for i in range(clients)]

    say(f"{'task':>5s} | " + " | ".join(
        f"{b[:4]}{i}" for i, b in enumerate(kinds)))
    results = []
    for t in range(tasks):
        res = node.run_task(FLTaskSpec(f"task{t}", rounds=rounds), agents, bf)
        results.append(res)
        say(f"{t:5d} | " + " | ".join(f"{r:5.3f}" for r in res.reputations))

    acc = float(eval_fn(results[-1].global_params,
                        {k: torch.as_tensor(v).to(dev)
                         for k, v in val.items()}))
    say(f"\nglobal model accuracy: {acc:.3f}")
    say(f"payouts (last task): "
        f"{ {k: round(v, 2) for k, v in results[-1].payouts.items()} }")
    if node.rollup is not None:
        total_l2 = sum(b["total"] for b in node.rollup.gas_log)
        say(f"rollup: {len(node.rollup.batches)} batches, "
            f"settled gas={total_l2:.0f}")
    say(f"L1 chain: {len(node.chain.blocks)} blocks, "
        f"gas={node.chain.total_gas:.0f}")
    return {"node": node, "results": results, "accuracy": acc,
            "behaviors": kinds}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--no-rollup", action="store_true",
                    help="single-layer L1 baseline (paper Fig. 5 comparison)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.tasks, args.rounds, args.clients, not args.no_rollup,
               args.device)


if __name__ == "__main__":
    main()
