"""Concurrent node service: admission-controlled serving of one stack.

The port's serving face (``src/repro/serve``; docs/SERVING.md): a
stdlib-only asyncio JSON-RPC/HTTP server (``HttpNodeServer``) over a
single-writer ``NodeService`` that owns one ``repro_torch.api`` stack,
with the mempool admission layer (``AdmissionController``/``PendingPool``)
in front — per-sender token buckets, a fee floor, reputation-gated
admission and lowest-fee-first spam eviction, all pure functions of
modeled time.  Configure with ``repro_torch.api.ServeSpec``/
``AdmissionSpec``; launch with ``python -m repro_torch.launch.serve_node``.
The stack runs on the CUDA card unless ``device=`` names another, and
every ledger op runs on the event loop's thread and torch's current
stream (``serve/service.py``).

    from repro_torch.api import ServeSpec
    from repro_torch.serve import HttpNodeServer, NodeService

    server = HttpNodeServer(NodeService(ServeSpec()), port=0)
    host, port = await server.start()
"""
from repro_torch.serve.admission import (REJECT_REASONS, AdmissionController,
                                         Decision, PendingPool, PoolEntry)
from repro_torch.serve.http import HttpNodeServer, http_rpc
from repro_torch.serve.service import NodeService, ServeMetrics, replay_ops

__all__ = [
    "AdmissionController", "Decision", "PendingPool", "PoolEntry",
    "REJECT_REASONS",
    "HttpNodeServer", "http_rpc",
    "NodeService", "ServeMetrics", "replay_ops",
]
