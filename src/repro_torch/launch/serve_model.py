"""Model-inference serving launcher: batched KV-cache decode of a token LM
on the (pod,)data x model mesh, with the reputation gate on the request
path.

    python -m repro_torch.launch.serve_model --host-mesh     # yi-6b, one card
    python -m repro_torch.launch.serve_model --host-mesh --reduced --device cpu
    torchrun --nnodes 32 --nproc-per-node 8 ... \\
        -m repro_torch.launch.serve_model                  # 16 x 16
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve_model \\
        --mesh-shape 2x2 --reduced --device cpu           # four CPU ranks

The mesh comes from ``launch/mesh.py`` as the training launcher takes it:
``--host-mesh`` is the 1 x 1 mesh, ``--mesh-shape DxM`` or ``PxDxM`` a
(pod x) data x model mesh, and without either the production mesh (16 x
16, or 2 x 16 x 16 with ``--multi-pod``), over the default process group
(``torchrun``'s, which the launcher starts and destroys where none is set
up).  Without a group the meshes wider than 1 x 1 raise, naming the world
size found.  The decode follows the kind of mesh:

  * the ``TrainMesh`` record (``--host-mesh`` with no process group):
    ``generate``, plain tensors on one card;
  * a ``DeviceMesh`` (every mesh inside a process group, ``--host-mesh``
    in a one-rank group too): ``generate_on_mesh``, on DTensors laid out
    by the model's specs.  Each rank draws the weights leaf by leaf and
    keeps its own shards (``launch.steps.init_params_sharded``); the
    decode state and every step's token are cut from whole tensors every
    rank holds (``launch.steps.shard``); each step's logits, split over
    ``model`` on the vocab, are gathered and the argmax taken over the
    whole vocab, so every rank returns the same tokens.  Rank 0 prints.

Each prompt token is decoded into the cache in turn, then ``--tokens``
tokens are generated greedily, as the JAX package's serve loop does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.core.reputation import ReputationParams, init_book
from repro_torch.launch.mesh import (TrainMesh, add_mesh_args,
                                     check_mesh_args, mesh_device,
                                     mesh_from_flags, mesh_shape,
                                     process_group, rank0)
from repro_torch.launch.steps import init_params_sharded, shard
from repro_torch.models.model import build_model


def _greedy(step, prompts, n_tokens: int) -> np.ndarray:
    """Feed ``prompts`` (B, P) token by token through ``step(tok, t)``,
    which decodes ``tok`` (B, 1) at position t and returns the argmax
    token (B, 1); then take ``n_tokens`` tokens.  Returns them as a (B,
    n_tokens) array."""
    P = prompts.shape[1]
    for t in range(P):
        tok = step(prompts[:, t:t + 1], t)
    generated = []
    for t in range(P, P + n_tokens):
        generated.append(tok[:, 0])
        tok = step(tok, t)
    return torch.stack(generated, 1).cpu().numpy()


def generate(model, params, prompts, n_tokens: int) -> np.ndarray:
    """Greedy decode: feed ``prompts`` (B, P) token by token, then take
    ``n_tokens`` argmax tokens.  Returns them as a (B, n_tokens) array."""
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=model.device)
    B, P = prompts.shape
    state = model.init_decode_state(B, P + n_tokens + 1)

    def step(tok, t):
        nonlocal state
        logits, state = model.decode(params, state, {"tokens": tok,
                                                     "pos": t})
        return logits.argmax(-1).to(torch.int32)[:, None]
    return _greedy(step, prompts, n_tokens)


def generate_on_mesh(model, params, prompts, n_tokens: int) -> np.ndarray:
    """``generate`` on ``model``'s ``DeviceMesh``: ``params`` a flat dict
    of DTensors laid out by ``model.params_pspecs()``
    (``init_params_sharded``), the decode state ``init_decode_state``'s
    leaves cut by ``model.decode_state_pspecs``, each step's token
    (``prompts`` (B, P), whole on every rank) laid out by the decode
    ``input_pspecs``; each step's (B, V) logits gathered and the argmax
    taken over the whole vocab.  Returns the (B, n_tokens) array, the
    same on every rank."""
    ctx, dev = model.ctx, model.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device=dev)
    B, P = prompts.shape
    max_len = P + n_tokens + 1
    sspecs = model.decode_state_pspecs(B, max_len)
    state = {b: {k: shard(ctx, v, sspecs[b][k], dev) for k, v in sub.items()}
             for b, sub in model.init_decode_state(B, max_len).items()}
    tspec = model.input_pspecs(ShapeConfig("serve_decode", max_len, B,
                                           "decode"))["tokens"]

    def step(tok, t):
        nonlocal state
        logits, state = model.decode(params, state, {
            "tokens": shard(ctx, tok, tspec, dev), "pos": t})
        return logits.full_tensor().argmax(-1).to(torch.int32)[:, None]
    return _greedy(step, prompts, n_tokens)


def main(argv=None) -> dict:
    """Serves one batch; returns its tokens, seconds and tokens/s, on
    every rank."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(REGISTRY))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    add_mesh_args(ap)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    check_mesh_args(ap, args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.input_mode != "tokens" or cfg.enc_dec or cfg.family == "conv":
        # as the JAX launcher: whisper serves through Model (encode, then
        # decode against the cross K / V), not this token loop
        raise ValueError(f"{cfg.name}: the serving launcher drives "
                         f"token-LM archs")

    with process_group(args.device):
        mesh = mesh_from_flags(args, args.device)
        one_card = isinstance(mesh, TrainMesh)
        model = build_model(cfg, mesh_device(mesh),
                            mesh=None if one_card else mesh)

        # reputation gate: requests from identities below R_min are
        # rejected
        book = init_book(args.batch, device=model.device)
        if not bool((book.reputation >= ReputationParams().r_min).all()):
            raise RuntimeError("newcomers must start above the trust line")

        if one_card:
            params, run = model.init_params(0), generate
        else:
            params = init_params_sharded(model, model.params_pspecs(), 0)
            run = generate_on_mesh
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len))
        t0 = time.perf_counter()
        ids = run(model, params, prompts, args.tokens)
        dt = time.perf_counter() - t0
    n_steps = args.prompt_len + args.tokens
    tok_s = args.batch * n_steps / dt
    where = model.device if one_card else f"a {mesh_shape(mesh)} mesh"
    if rank0():
        print(f"served {args.batch} x {n_steps} steps in {dt:.2f}s "
              f"({tok_s:.1f} tok/s) on {where}; sample: "
              f"{ids[0, :8].tolist()}")
    return {"tokens": ids, "seconds": dt, "tokens_per_s": tok_s}


if __name__ == "__main__":
    main()
