"""Serving quickstart, the port's twin of ``examples/serve_quickstart.py``:
boot the node service, drive it over real HTTP.

Boots ``repro_torch.serve``'s admission-controlled node service on an
ephemeral port (in-process, stdlib only), then walks the whole client
flow on the wire (submit -> receipt polling -> finalize -> account /
state-root / event reads), asserting each step, so that it runs as the
serving smoke test.

Usage (the stack on the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.examples.serve_quickstart
    PYTHONPATH=src python -m repro_torch.examples.serve_quickstart \\
        --device cpu
"""
from __future__ import annotations

import argparse
import asyncio

from repro_torch.api import AdmissionSpec, NodeSpec, ServeSpec
from repro_torch.serve import HttpNodeServer, NodeService, http_rpc


async def run(device=None) -> dict:
    """The six steps; returns the account view, the state root, the
    events' kinds and the admission metrics read over the wire."""
    spec = ServeSpec(node=NodeSpec(), port=0,
                     admission=AdmissionSpec(rate_limit=200.0, burst=50.0))
    server = HttpNodeServer(NodeService(spec, device=device))
    host, port = await server.start()
    print(f"node service on http://{host}:{port}/rpc")
    try:
        # 1. submit a few transactions from two trainers
        refs = []
        for i in range(6):
            status, body = await http_rpc(host, port, "submit", {
                "fn": "submitLocalModel", "sender": f"trainer{i % 2}",
                "at": 0.1 * i})
            assert status == 200, (status, body)
            assert body["result"]["status"] == "queued", body
            refs.append(body["result"]["ref"])
        print(f"submitted {len(refs)} txs, refs {refs[0]}..{refs[-1]}")

        # 2. a queued tx has a pollable receipt before it lands on-ledger
        _, body = await http_rpc(host, port, "receipt", {"ref": refs[0]})
        assert body["result"]["status"] in ("queued", "submitted"), body

        # 3. finalize: drain the pool, settle the open session
        _, body = await http_rpc(host, port, "flush")
        assert body["result"]["status"] == "finalized", body
        print(f"finalized: {body['result']['flushed']} txs on-ledger")

        # 4. receipts now resolve against the ledger with a proof lifecycle
        _, body = await http_rpc(host, port, "receipt", {"ref": refs[0]})
        rcpt = body["result"]
        assert rcpt["status"] in ("finalized", "confirmed"), rcpt
        print(f"receipt {refs[0]}: {rcpt['status']}, "
              f"gas breakdown keys {sorted(rcpt['gas_breakdown'])}")

        # 5. account view + state root + cursor-paged events
        _, body = await http_rpc(host, port, "get_account",
                                 {"address": "trainer0"})
        account = body["result"]
        assert account["submissions"] == 3, body
        _, body = await http_rpc(host, port, "state_root")
        root = body["result"]["state_root"]
        assert root
        _, body = await http_rpc(host, port, "events", {"cursor": 0})
        events = body["result"]["events"]
        assert events and body["result"]["dropped"] == 0
        kinds = sorted({e["kind"] for e in events})
        print(f"state root {root}; {len(events)} events, kinds {kinds}")

        # 6. admission metrics are live counters
        _, body = await http_rpc(host, port, "metrics")
        metrics = body["result"]
        assert metrics["admitted"] == len(refs), body
        print(f"metrics: {metrics}")
    finally:
        await server.close()
    print("serving quickstart OK")
    return {"account": account, "state_root": root, "kinds": kinds,
            "metrics": metrics}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return asyncio.run(run(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
