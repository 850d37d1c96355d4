"""Quickstart: the port's twin of ``examples/quickstart.py``.

1. Drive the public node API: NodeSpec -> NodeClient -> tx receipts,
   account views, state root (the zk-rollup RPC surface).
2. Build any assigned architecture from the registry (--arch).
3. Run a few training steps with a reduced config
   (``launch.steps.build_train_step``; LeNet's loss for the conv family).
4. Run one reputation-weighted rollup round (the paper's technique) at
   T 2, H 2 (``fl.round.build_fl_round``) for a token LM.

Usage (on the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.examples.quickstart --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import NodeClient, NodeSpec, ShardSpec
from repro_torch.configs.registry import REGISTRY, reduced_config
from repro_torch.device import resolve_device
from repro_torch.fl.round import FLRoundSpec, build_fl_round, replicate
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import build_model
from repro_torch.models.transformer import _torch_dtype
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer


def api_demo(device=None) -> dict:
    """The public API path: typed spec -> client -> receipts + events.
    Returns what it printed."""
    spec = NodeSpec(shards=ShardSpec(count=2))    # 2-shard L2 over one L1
    client = NodeClient.from_spec(spec, device=device)
    receipts = [client.submit("submitLocalModel", f"trainer{i % 4}")
                for i in range(25)]
    client.flush()                                 # seal + prove + settle
    client.run_until(5.0)                          # L1 blocks to t=5s
    r = client.refresh(receipts[0])
    print(f"tx receipt: status={r.status} shard={r.shard} batch={r.batch} "
          f"aggregate={r.aggregate_ref} l1_block={r.block} "
          f"gas={r.gas_breakdown['batch_total']:.0f} "
          f"verify_share={r.gas_breakdown['verify_share']:.1f}")
    acct = client.get_account("trainer0")
    print(f"account trainer0: submissions={acct.submissions} "
          f"reputation={acct.reputation:.2f}")
    events = client.events()                       # typed, pull-based
    kinds = sorted({e.kind for e in events})
    windows = [e for e in events if e.kind == "window_settled"]
    root = client.state_root()
    print(f"state root: {root}  (events: {kinds}, windows: {len(windows)})")
    assert r.status == "finalized" and acct.submissions > 0 and windows
    assert windows[-1].fabric_root
    assert "block_packed" in client.capabilities()
    return {"receipt": r, "account": acct, "state_root": root,
            "kinds": kinds, "windows": len(windows)}


def make_batch(cfg, rng, B: int, S: int, device) -> dict:
    """One training batch of ``cfg``'s input mode, drawn from ``rng`` as
    the JAX example draws it: tokens and labels; embeds and M-RoPE
    positions for an ``embeds`` config; audio frames for whisper; images
    and zero labels for the conv family."""
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    i32 = dict(dtype=torch.int32, device=device)
    b = {"tokens": torch.as_tensor(toks[:, :-1], **i32),
         "labels": torch.as_tensor(toks[:, 1:], **i32)}
    dt = _torch_dtype(cfg.dtype)
    if cfg.input_mode == "embeds":
        b = {"embeds": torch.as_tensor(
                 rng.normal(0, 0.02, (B, S, cfg.d_model)), device=device
             ).to(dt),
             "positions": torch.arange(S, **i32).expand(3, B, S),
             "labels": b["labels"]}
    elif cfg.input_mode == "audio":
        b["audio_embeds"] = torch.as_tensor(
            rng.normal(0, 0.02, (B, cfg.enc_seq, cfg.d_model)),
            device=device).to(dt)
    elif cfg.family == "conv":
        b = {"images": torch.as_tensor(rng.normal(size=(B, 32, 32, 1)),
                                       dtype=torch.float32, device=device),
             "labels": torch.zeros((B,), **i32)}
    return b


def main(argv=None) -> dict:
    """Runs the four parts; returns the API demo's record, each step's
    loss and the round's metrics (None for a model it does not apply
    to)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(REGISTRY))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    api = api_demo(dev)

    cfg = reduced_config(REGISTRY[args.arch])
    print(f"arch={cfg.name} family={cfg.family} (reduced config)")
    model = build_model(cfg, dev)
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.05))
    params = model.init_params(0)
    if cfg.family != "conv":
        params = model.train_params(params)
    state = opt.init(params)
    step = build_train_step(model, opt)

    rng = np.random.default_rng(0)
    B, S = 2, 16
    losses = []
    for i in range(args.steps):
        params, state, m = step(params, state, make_batch(cfg, rng, B, S,
                                                          dev))
        losses.append(float(m["loss"]))
        print(f"step {i}: loss={losses[-1]:.4f}")

    round_metrics = None
    if cfg.family != "conv" and cfg.input_mode == "tokens":
        # one rollup round with 2 virtual trainers (the paper's technique)
        T, H = 2, 2
        fl_round = build_fl_round(model, opt, FLRoundSpec(T, H, B))
        toks = rng.integers(0, cfg.vocab_size, (T, H, B, S + 1))
        batches = {k: torch.as_tensor(v, dtype=torch.int32, device=dev)
                   for k, v in (("tokens", toks[..., :-1]),
                                ("labels", toks[..., 1:]))}
        scores = torch.tensor([0.9, 0.6], device=dev)
        _, _, round_metrics = fl_round(replicate(params, T),
                                       replicate(state, T), scores, batches)
        print(f"rollup round: loss={float(round_metrics['loss']):.4f} "
              f"distances="
              f"{round_metrics['distances'].float().cpu().numpy().round(3)} "
              f"digest=0x{int(round_metrics['digest']):08x}")
    print("done.")
    return {"api": api, "losses": losses, "round": round_metrics}


if __name__ == "__main__":
    main()
