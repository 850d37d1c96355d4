"""Model-inference serving launcher: batched KV-cache decode of a token LM
on one card, with the reputation gate on the request path.

    python -m repro_torch.launch.serve_model                 # yi-6b on the card
    python -m repro_torch.launch.serve_model --reduced --device cpu

Each prompt token is decoded into the cache in turn, then ``--tokens``
tokens are generated greedily, as the JAX package's serve loop does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.core.reputation import ReputationParams, init_book
from repro_torch.models.model import build_model


def generate(model, params, prompts, n_tokens: int) -> np.ndarray:
    """Greedy decode: feed ``prompts`` (B, P) token by token, then take
    ``n_tokens`` argmax tokens.  Returns them as a (B, n_tokens) array."""
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=model.device)
    B, P = prompts.shape
    state = model.init_decode_state(B, P + n_tokens + 1)
    logits = None
    for t in range(P):
        logits, state = model.decode(params, state, {
            "tokens": prompts[:, t:t + 1], "pos": t})
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    generated = []
    for t in range(P, P + n_tokens):
        generated.append(tok[:, 0])
        logits, state = model.decode(params, state, {"tokens": tok, "pos": t})
        tok = logits.argmax(-1).to(torch.int32)[:, None]
    return torch.stack(generated, 1).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(REGISTRY))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.input_mode != "tokens" or cfg.enc_dec or cfg.family == "conv":
        # as the JAX launcher: whisper serves through Model (encode, then
        # decode against the cross K / V), not this token loop
        raise ValueError(f"{cfg.name}: the serving launcher drives "
                         f"token-LM archs")
    model = build_model(cfg, args.device)

    # reputation gate: requests from identities below R_min are rejected
    book = init_book(args.batch, device=model.device)
    if not bool((book.reputation >= ReputationParams().r_min).all()):
        raise RuntimeError("newcomers must start above the trust line")

    params = model.init_params(0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    ids = generate(model, params, prompts, args.tokens)
    dt = time.perf_counter() - t0
    n_steps = args.prompt_len + args.tokens
    tok_s = args.batch * n_steps / dt
    print(f"served {args.batch} x {n_steps} steps in {dt:.2f}s "
          f"({tok_s:.1f} tok/s) on {model.device}; sample: "
          f"{ids[0, :8].tolist()}")
    return {"tokens": ids, "seconds": dt, "tokens_per_s": tok_s}


if __name__ == "__main__":
    main()
