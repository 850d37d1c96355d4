"""Public node API of the port: typed specs, one ledger factory, an
RPC-style client.  Entry points run on the CUDA card unless the caller
passes ``device=``.

    from repro_torch.api import NodeClient, NodeSpec, RollupSpec

    client = NodeClient.from_spec(NodeSpec(rollup=RollupSpec(n_lanes=2)))
    receipts = client.submit_arrays(batch)     # a TxArrays on the card
    client.seal(); client.run_until(1.0)
    root = client.state_root()
"""
from repro_torch.api.client import (RECEIPT_STATUSES, AccountView,
                                    NodeClient, TxReceipt)
from repro_torch.api.factory import (build_chain, build_ledger, build_stack,
                                     l1_of)
from repro_torch.api.specs import (ChainSpec, DONSpec, FLTaskSpec,
                                   NodeSpec, ProverSpec, ReputationSpec,
                                   RollupSpec, WorkloadSpec, as_task_spec)
from repro_torch.core.events import (AggregateVerified, BatchSealed,
                                     BlockPacked, EventsDropped, LedgerEvent,
                                     ProofGenerated, WindowSettled)

__all__ = [
    "AccountView", "NodeClient", "TxReceipt", "RECEIPT_STATUSES",
    "build_chain", "build_ledger", "build_stack", "l1_of",
    "ChainSpec", "DONSpec", "FLTaskSpec", "NodeSpec", "ProverSpec",
    "ReputationSpec", "RollupSpec", "WorkloadSpec", "as_task_spec",
    "AggregateVerified", "BatchSealed", "BlockPacked", "EventsDropped",
    "LedgerEvent", "ProofGenerated", "WindowSettled",
]
