"""THE shared invariant catalog for the port's static checker and sanitizer.

Every rule the port enforces lives here exactly once: the AST pass
(analysis/lint.py) and the runtime sanitizer (analysis/sanitize.py) are
two enforcement layers over this one table, so a rule id printed by
either layer resolves to the same contract, rationale and fix hint.

The rule ids, titles and static / dynamic split are the JAX package's
(``src/repro/analysis/invariants.py``), so that a rule id means the same
contract in both packages.  Where a rule's port form differs, only its
rationale and fix hint do: R002 checks the port's factory (a plain
``torch`` version and a hand-written ``cuda`` kernel, a
``tests/test_torch_*.py`` parity test, the card check in
``chip_smoke.py``), and R004 is host-sync hygiene inside the functions
``torch.func`` transforms or ``torch.compile`` traces.

R001-R005 and R008 have a static form; R001 and R005-R007 have a
dynamic form (gas conservation and the receipt lifecycle only exist at
run time, so the sanitizer carries rules the AST pass cannot).

Pure stdlib: the port's own copy, importing nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: StateArrays columns whose writes must be paired with ``mark_dirty``
#: (mirrors core.state.STATE_SCHEMA; kept literal so the linter does not
#: import torch to analyze source text).
STATE_COLUMNS: Tuple[str, ...] = (
    "balances", "stake", "reputation",
    "tasks_published", "submissions", "rep_events",
)

#: in-place tensor methods that write a column (R001)
INPLACE_TENSOR_METHODS: Tuple[str, ...] = (
    "index_add_", "index_put_", "scatter_add_", "scatter_", "copy_",
    "add_", "sub_", "mul_", "fill_", "zero_",
)

#: kernel-registry contract (R002): every op carries the plain PyTorch
#: version and the hand-written CUDA kernel, so at least two impls
REQUIRED_MIRROR_IMPL = "torch"
REQUIRED_KERNEL_IMPL = "cuda"
MIN_IMPLS_PER_OP = 2
#: where an op's CPU parity test and its card check live (R002)
PARITY_TEST_PREFIX = "tests/test_torch_"
CARD_CHECK_FILE = "chip_smoke.py"

#: determinism sweep seeds (R003): classes whose methods anchor the
#: reachability walk, plus the free functions on the digest path.
DETERMINISM_SEED_CLASSES: Tuple[str, ...] = ("FusedWindowLoop", "StateArrays")
DETERMINISM_SEED_FUNCS: Tuple[str, ...] = (
    "canonical_bytes", "chunked_root", "chunk_fold_digests",
    "_fold_digests", "_seal_digests",
)
#: torch's draws from the global generator unless given ``generator=``
TORCH_RNG_DRAWS: Tuple[str, ...] = (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
)

#: transforms whose function argument is traced (R004): ``torch.func`` /
#: ``torch.vmap`` and ``torch.compile``
TRACING_TRANSFORMS: Tuple[str, ...] = (
    "vmap", "grad", "grad_and_value", "jacrev", "jvp", "compile",
)
#: tensor methods that copy to the host and wait for the device (R004)
HOST_SYNC_METHODS: Tuple[str, ...] = ("item", "tolist", "cpu", "numpy")

#: the one module allowed to mutate EventLog internals (R005).
EVENTLOG_OWNER_MODULE = "core/events.py"

#: admission-purity sweep seeds (R008): the mempool admission layer —
#: every method of these classes (and everything they reach) must
#: decide on modeled time alone, never the wall clock.
ADMISSION_SEED_CLASSES: Tuple[str, ...] = ("AdmissionController",
                                           "PendingPool")
ADMISSION_SEED_FUNCS: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One contract: id, what it protects, and how each layer enforces it."""

    rule: str            # "R001"
    title: str
    rationale: str       # why the contract exists (one paragraph)
    fix_hint: str        # the canonical remediation, shown with findings
    static: bool         # enforced by analysis/lint.py
    dynamic: bool        # enforced by analysis/sanitize.py


CATALOG: Dict[str, Invariant] = {inv.rule: inv for inv in (
    Invariant(
        rule="R001",
        title="StateArrays writes must be paired with mark_dirty",
        rationale=(
            "The incremental dirty-chunk commitment (core/state.py) only "
            "refolds chunks covered by mark_dirty; a column write without "
            "it silently diverges the cached root from the full refold."),
        fix_hint=(
            "call state.mark_dirty(ids) after the write (same function, "
            "same id set), or route through a Tx handler that does"),
        static=True, dynamic=True,
    ),
    Invariant(
        rule="R002",
        title="kernel registry ops carry numpy mirror + >=3 impls + parity test",
        rationale=(
            "kernels/factory.py's contract is that every op has a plain "
            "PyTorch version (the 'torch' impl, the port's "
            "semantics-of-record) and a hand-written CUDA kernel (the "
            "'cuda' impl), held to each other on the CPU by a "
            "tests/test_torch_*.py test and on the card by chip_smoke.py; "
            "an op missing an impl, a parity test or its card check can "
            "drift per device."),
        fix_hint=(
            "register a 'torch' plain version and a 'cuda' kernel for the "
            "op, name the op in a tests/test_torch_*.py parity test and "
            "check it on the card in chip_smoke.py"),
        static=True, dynamic=False,
    ),
    Invariant(
        rule="R003",
        title="no wall-clock/RNG/id() nondeterminism on replay or digest paths",
        rationale=(
            "FusedWindowLoop replays a recorded plan and the state digest "
            "canonicalizes bytes; time.time, datetime.now, unseeded "
            "np.random and id()-keyed ordering make replay != stepped or "
            "digest != digest across processes."),
        fix_hint=(
            "thread the window clock / a seeded Generator through the call "
            "instead, and key orderings by the object (identity hash), "
            "never by id()"),
        static=True, dynamic=False,
    ),
    Invariant(
        rule="R004",
        title="jit hygiene: no host sync or traced-value branching in traced fns",
        rationale=(
            "In the port this is host-sync hygiene.  Inside a function "
            "that torch.func transforms (vmap, grad, grad_and_value, "
            "jacrev, jvp) or torch.compile traces, .item()/.tolist()/"
            ".cpu()/.numpy(), float()/int()/bool() of a parameter and "
            "torch.cuda.synchronize() stall the host on the device every "
            "call (and fail on a batched tensor under vmap), and a Python "
            "if/while on a parameter's value cannot be batched or breaks "
            "the compiled graph.  JAX's donated-buffer half has no torch "
            "counterpart: torch does not donate buffers."),
        fix_hint=(
            "use torch.where for branching, branch only on .shape/.dtype/"
            ".ndim/.device, and keep host pulls outside the transformed "
            "function"),
        static=True, dynamic=False,
    ),
    Invariant(
        rule="R005",
        title="EventLog emissions only through the owning append path",
        rationale=(
            "The log's total order (seq == position) backs cursors, fused "
            "replay equality and receipt status; mutating _events or an "
            "event's seq outside core/events.py breaks every consumer."),
        fix_hint=(
            "emit through EventLog.emit, and splice/renumber through "
            "EventLog.splice — never touch _events or seq directly"),
        static=True, dynamic=True,
    ),
    Invariant(
        rule="R008",
        title="admission decisions are pure functions of spec/sender/pool state",
        rationale=(
            "The serving layer's admission log is the determinism anchor "
            "under concurrency: replaying it must reproduce the admitted "
            "set exactly, and receipts/benchmarks compare runs by it.  A "
            "wall-clock read (time.time and friends) reachable from the "
            "admission path makes the decision depend on host scheduling "
            "instead of the modeled window clock — the one time source "
            "the ledgers run on."),
        fix_hint=(
            "pass the transaction's modeled submit time into the decision "
            "and derive every rate/refill computation from it; wall-clock "
            "timing belongs in the benchmarks, never in admission"),
        static=True, dynamic=False,
    ),
    # -- dynamic-only contracts (no useful AST form) ----------------------------
    Invariant(
        rule="R006",
        title="gas conservation: chain totals equal the sum of their parts",
        rationale=(
            "total_gas is the L1 settlement meter; if it drifts from the "
            "per-block / per-tx sums (or a rollup gas row's total from its "
            "commit+verify+execute parts) the paper's gas accounting is "
            "fiction."),
        fix_hint=(
            "only produce_block/seal may advance gas totals; never adjust "
            "total_gas or gas_log rows out of band"),
        static=False, dynamic=True,
    ),
    Invariant(
        rule="R007",
        title="receipt lifecycle legality: sealed -> proved -> aggregated",
        rationale=(
            "Receipt status is derived from the typed event stream; a "
            "ProofGenerated for a never-sealed batch or a double-proof "
            "makes client receipts lie about finality."),
        fix_hint=(
            "route batches through ProverPipeline.enqueue/pump/"
            "close_session only; never emit proof events by hand"),
        static=False, dynamic=True,
    ),
)}


def fix_hint(rule: str) -> str:
    """The catalog's canonical remediation line for ``rule`` ("" if unknown)."""
    inv = CATALOG.get(rule)
    return inv.fix_hint if inv is not None else ""
