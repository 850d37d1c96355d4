"""Node-service launcher: boot the admission-controlled HTTP face.

    PYTHONPATH=src python -m repro_torch.launch.serve_node \
        --port 8545 --shards 2 --window 1.0 --pool-cap 4096

Builds a ``ServeSpec`` from the flags (those of
``src/repro/launch/serve_node.py``), boots ``repro_torch.serve``'s
``NodeService`` + ``HttpNodeServer`` on ``--device`` (default: the CUDA
card; raises without one, ``--device cpu`` runs on the CPU) and serves
until interrupted (``--serve-for`` bounds the run for smoke tests).  With
``--port 0`` it binds an ephemeral port and prints it on the listening
line.  docs/SERVING.md documents the endpoints and the admission knobs.
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Optional, Sequence

from repro_torch.api.specs import (AdmissionSpec, NodeSpec, RollupSpec,
                                   ServeSpec, ShardSpec)


def build_spec(args: argparse.Namespace) -> ServeSpec:
    shards = (ShardSpec(count=args.shards, fabric=True)
              if args.shards > 1 else None)
    node = NodeSpec(rollup=None if args.no_rollup else RollupSpec(),
                    shards=shards)
    admission = AdmissionSpec(
        rate_limit=args.rate_limit, burst=args.burst,
        fee_floor=args.fee_floor, rep_gate=args.rep_gate,
        pool_cap=args.pool_cap, evict=not args.no_evict)
    return ServeSpec(node=node, admission=admission, host=args.host,
                     port=args.port, queue_cap=args.queue_cap,
                     window=args.window, event_cap=args.event_cap)


async def _serve(spec: ServeSpec, serve_for: Optional[float],
                 device=None) -> None:
    from repro_torch.serve import HttpNodeServer, NodeService
    server = HttpNodeServer(NodeService(spec, device=device))
    host, port = await server.start()
    print(f"node service listening on http://{host}:{port}/rpc "
          f"(window={spec.window}s, pool_cap={spec.admission.pool_cap}, "
          f"device={server.service.client.target.device})", flush=True)
    try:
        if serve_for is not None:
            await asyncio.sleep(serve_for)
        else:
            assert server._server is not None
            await server._server.serve_forever()
    finally:
        await server.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="admission-controlled node service (repro_torch.serve)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8545,
                    help="0 binds an ephemeral port")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--no-rollup", action="store_true",
                    help="serve a chain-only (L1) node")
    ap.add_argument("--window", type=float, default=1.0,
                    help="modeled seconds between pool flushes")
    ap.add_argument("--queue-cap", type=int, default=1024)
    ap.add_argument("--event-cap", type=int, default=65536,
                    help="EventLog ring-buffer cap")
    ap.add_argument("--pool-cap", type=int, default=4096)
    ap.add_argument("--rate-limit", type=float, default=50.0)
    ap.add_argument("--burst", type=float, default=20.0)
    ap.add_argument("--fee-floor", type=int, default=0)
    ap.add_argument("--rep-gate", default="surcharge",
                    choices=("off", "surcharge", "reject"))
    ap.add_argument("--no-evict", action="store_true",
                    help="reject (429) at pool cap instead of evicting")
    ap.add_argument("--serve-for", type=float, default=None,
                    help="seconds to serve before a clean shutdown")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        asyncio.run(_serve(build_spec(args), args.serve_for, args.device))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
