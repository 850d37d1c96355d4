"""Array-native L2 account state and its chunked state commitment.

``StateArrays`` is the fixed-schema structure-of-arrays account state
(balances, stake, reputation, protocol counters) indexed by the ledger's
integer sender ids, held as tensors on the stack's device.  Its commitment
is two-level: the canonical u32 word buffer (field-major over the filled
rows, schema order) is cut into ``STATE_CHUNK_WORDS``-word chunks, each
chunk is xor-mix folded (kernels ``rollup_chunk_digests`` and, for the
chunks a window touched, ``dirty_fold``), and the chunk digest vector is
sealed with one sha256 on the host.  The same rows give the same root as
the JAX package's ``src/repro/core/state.py``.

``account_owner`` is the one partition function of the sharded fabric
(core/shards.py): it routes a sender's txs and assigns its state rows to
the partition root (``StateArrays.partition_roots``) of the same shard.

``canonical_bytes`` is the type-tagged encoding the object Rollup's
dict-state digest hashes (core/rollup.state_digest).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.factory import get_kernel
from repro_torch.kernels.rollup_digest import MASK, mix_u32

# Mixing constants shared with core/engine.py and kernels/rollup_digest.py.
MIX_MULT = np.uint32(0x85EBCA6B)
MIX_SEED = np.uint32(0x9E3779B9)

# chunk size (u32 words) of the state commitment
STATE_CHUNK_WORDS = 2048

#: digest backends: "auto" follows the tensors' device (the CUDA kernels on
#: the card, the plain versions on the CPU); "cuda" and "torch" name a
#: factory impl (kernels/factory.py)
DIGEST_BACKENDS = ("auto", "cuda", "torch")


class Registry:
    """Stable name <-> integer-id mapping (append-only, insertion order).

    The generic form of the engine's ``FnRegistry``; ids are dense and
    never reused, so they index SoA arrays.
    """

    def __init__(self, names: Sequence[str] = ()):
        self.names: List[str] = []
        self._ids: Dict[str, int] = {}
        for n in names:
            self.id(n)

    def id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = len(self.names)
            self._ids[name] = i
            self.names.append(name)
        return i

    def get(self, name: str) -> Optional[int]:
        return self._ids.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._ids

    def __len__(self) -> int:
        return len(self.names)


def account_owner(account_ids: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard of each account id (int64, on the ids' device): the xor-mix
    of the id mod K, computed in int64 and masked to 32 bits (torch on
    the CPU has no ``>>`` on uint32)."""
    return mix_u32(account_ids.to(torch.int64) & MASK) % n_shards


def account_owner_np(account_ids, n_shards: int) -> np.ndarray:
    """``account_owner`` for host callers, on numpy arrays (int64)."""
    s = np.asarray(account_ids).astype(np.uint32)
    mixed = (s ^ (s >> np.uint32(16))) * MIX_MULT
    return (mixed % np.uint32(n_shards)).astype(np.int64)


def group_by(keys: torch.Tensor, n_groups: int):
    """Indices of ``keys`` grouped by key value in ``[0, n_groups)``, in
    their order within each group (a stable sort), and the group sizes on
    the host: one copy of ``n_groups`` counts, not a mask a group."""
    order = torch.sort(keys, stable=True).indices
    counts = torch.bincount(keys, minlength=n_groups).tolist()
    return order, counts


# ---------------------------------------------------------------------------
# canonical byte encoding (the object Rollup's dict-state digest)
# ---------------------------------------------------------------------------
def canonical_bytes(obj: Any) -> bytes:
    """Total, deterministic, type-tagged encoding of a state value (the
    bytes of ``src/repro/core/state.py``'s ``canonical_bytes``).

    Every encoding starts with a one-byte type tag and, where the payload
    is variable-length, a length header, so values of different types or
    shapes never collide byte-wise.  ndarrays encode dtype, shape and the
    full buffer; a tensor encodes as the ndarray it holds, so one value
    gives the same bytes on the card and on the CPU; dataclasses encode
    their field names and values recursively.
    """
    if obj is None:
        return b"N"
    if isinstance(obj, bool):                       # before int (bool is int)
        return b"B1" if obj else b"B0"
    if isinstance(obj, (int, np.integer)):
        b = str(int(obj)).encode()
        return b"I" + len(b).to_bytes(4, "big") + b
    if isinstance(obj, (float, np.floating)):
        # bit pattern, not repr: -0.0 vs 0.0 and precision stay distinct
        return b"F" + np.float64(obj).tobytes()
    if isinstance(obj, str):
        b = obj.encode()
        return b"S" + len(b).to_bytes(4, "big") + b
    if isinstance(obj, (bytes, bytearray)):
        return b"Y" + len(obj).to_bytes(4, "big") + bytes(obj)
    if isinstance(obj, torch.Tensor):
        return canonical_bytes(obj.detach().cpu().numpy())
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            # object arrays hold pointers: encode the elements instead
            head = str(obj.shape).encode()
            body = b"".join(canonical_bytes(v) for v in obj.ravel())
            return (b"P" + len(head).to_bytes(4, "big") + head
                    + len(body).to_bytes(8, "big") + body)
        a = np.ascontiguousarray(obj)
        head = repr(a.dtype.str).encode() + str(a.shape).encode()
        return (b"A" + len(head).to_bytes(4, "big") + head
                + len(a.tobytes()).to_bytes(8, "big") + a.tobytes())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
        body = b"".join(canonical_bytes(k) + canonical_bytes(v)
                        for k, v in items)
        name = type(obj).__name__.encode()
        return (b"C" + len(name).to_bytes(4, "big") + name
                + len(body).to_bytes(8, "big") + body)
    if isinstance(obj, dict):
        enc = sorted((canonical_bytes(k), canonical_bytes(v))
                     for k, v in obj.items())
        body = b"".join(k + v for k, v in enc)
        return b"D" + len(body).to_bytes(8, "big") + body
    if isinstance(obj, (list, tuple)):
        body = b"".join(canonical_bytes(v) for v in obj)
        tag = b"L" if isinstance(obj, list) else b"T"
        return tag + len(body).to_bytes(8, "big") + body
    if isinstance(obj, (set, frozenset)):
        body = b"".join(sorted(canonical_bytes(v) for v in obj))
        return b"E" + len(body).to_bytes(8, "big") + body
    # last resort: repr, tagged so it cannot collide with structured forms
    b = repr(obj).encode()
    return b"R" + len(b).to_bytes(4, "big") + b


# ---------------------------------------------------------------------------
# chunked xor-mix commitment
# ---------------------------------------------------------------------------
def chunk_fold_digests(words: np.ndarray,
                       chunk: int = STATE_CHUNK_WORDS) -> np.ndarray:
    """Per-chunk xor-mix digests on the host: (P,) u32 -> (ceil(P/chunk),)
    u32.  The prover's aggregation fold (one word per proof) uses it; the
    state commitment runs the device op ``rollup_chunk_digests``.  Zero
    padding folds away (zero words mix to zero)."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    if w.size == 0:
        return np.array([MIX_SEED], np.uint32)
    pad = (-w.size) % chunk
    if pad:
        w = np.concatenate([w, np.zeros(pad, np.uint32)])
    mixed = (w ^ (w >> np.uint32(16))) * MIX_MULT
    return MIX_SEED ^ np.bitwise_xor.reduce(mixed.reshape(-1, chunk), axis=1)


def kernel_impl(backend: str) -> Optional[str]:
    """Map a digest backend onto a kernel-factory impl key (``None`` lets
    the factory's own default and environment selection decide)."""
    if backend not in DIGEST_BACKENDS:
        raise ValueError(f"unknown digest backend {backend!r}; "
                         f"choose from {DIGEST_BACKENDS}")
    return None if backend == "auto" else backend


def _fold_digests(words: torch.Tensor, chunk: int,
                  backend: str) -> torch.Tensor:
    """Full per-chunk digest vector (int32 bits, on the words' device)."""
    return get_kernel("rollup_chunk_digests", kernel_impl(backend))(
        words, chunk)


def _seal_many(headers: Sequence[bytes], n_words: Sequence[int],
               digests: Sequence[torch.Tensor]) -> List[str]:
    """One sha256 a chunk digest vector over it and its schema/length
    header; the vectors reach the host in one copy."""
    host = torch.cat(list(digests)).cpu().numpy().view(np.uint32)
    out, at = [], 0
    for header, n, d in zip(headers, n_words, digests):
        h = hashlib.sha256()
        h.update(header)
        h.update(np.uint64(n).tobytes())
        h.update(host[at: at + d.numel()].tobytes())
        out.append(h.hexdigest()[:32])
        at += d.numel()
    return out


def _seal_digests(header: bytes, n_words: int,
                  digests: torch.Tensor) -> str:
    """The root of one digest vector (``_seal_many`` of one)."""
    return _seal_many([header], [n_words], [digests])[0]


def chunked_root(words: torch.Tensor, chunk: int = STATE_CHUNK_WORDS,
                 backend: str = "auto", header: bytes = b"") -> str:
    """Two-level commitment: per-chunk xor-mix digests, sealed with one
    sha256 over the digest vector + a schema/length header (32 hex)."""
    return _seal_digests(header, words.numel(),
                         _fold_digests(words, chunk, backend))


# ---------------------------------------------------------------------------
# fixed-schema SoA account state
# ---------------------------------------------------------------------------
# (name, dtype) in commitment order — the schema IS part of the root header.
STATE_SCHEMA = (
    ("balances", np.float64),         # escrow-visible token balance
    ("stake", np.float64),            # locked collateral
    ("reputation", np.float32),       # R_i (Eq. 9-10), synced at settlement
    ("tasks_published", np.int64),    # publishTask count per account
    ("submissions", np.int64),        # submitLocalModel count per account
    ("rep_events", np.int64),         # calculate*Rep count per account
)
_TORCH_DTYPE = {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.int64): torch.int64}


def _torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPE[np.dtype(dtype)]


class StateArrays:
    """Fixed-schema SoA account state, indexed by ledger sender ids.

    Rows are accounts; the row index is the owning ledger's integer sender
    id, so state handlers scatter straight from a ``TxArrays`` view.
    Tensors grow geometrically; only the filled prefix (``n``) is
    committed.  Every schema dtype is 4 or 8 bytes, so ``.view(int32)`` of
    a field gives the same little-endian words as numpy's
    ``.view(np.uint32)``.

    Handler contract: ``handler(state, txs)`` where the view holds ONLY
    the registered function's transactions, in confirmation order.
    """

    def __init__(self, n_accounts: int = 0, *, device=None):
        self.device = resolve_device(device)
        self.n = 0
        # incremental commitment (opt-in): the committed word buffer and
        # per-chunk digest vector are cached on the device, and only the
        # chunks covering rows marked dirty since the last root refold
        self._track_dirty = False
        self._commit_caches: Dict[Any, Dict[str, Any]] = {}
        cap = max(64, n_accounts)
        for name, dtype in STATE_SCHEMA:
            setattr(self, name, torch.zeros(cap, dtype=_torch_dtype(dtype),
                                            device=self.device))
        if n_accounts:
            self.ensure(n_accounts)

    @property
    def capacity(self) -> int:
        return self.balances.shape[0]

    def ensure(self, n_accounts: int) -> None:
        """Grow the filled prefix to cover account ids < ``n_accounts``."""
        if n_accounts <= self.n:
            return
        if n_accounts > self.capacity:
            cap = max(n_accounts, 2 * self.capacity)
            for name, dtype in STATE_SCHEMA:
                old = getattr(self, name)
                new = torch.zeros(cap, dtype=_torch_dtype(dtype),
                                  device=self.device)
                new[: self.n] = old[: self.n]
                setattr(self, name, new)
        # the commitment is field-major over the filled prefix: growing
        # ``n`` shifts every field's word offset, so cached buffers are
        # layout-stale — drop them and let the next root rebuild in full
        self._commit_caches.clear()
        self.n = n_accounts

    # -- dirty-row tracking ----------------------------------------------------
    def enable_dirty_tracking(self) -> None:
        """Opt into incremental commitment: every later write to the field
        tensors must go through a path that calls ``mark_dirty``."""
        self._track_dirty = True

    def mark_dirty(self, ids: torch.Tensor) -> None:
        """Record account rows whose fields changed since the last root.
        Cheap append; the unique/refold work happens at root time."""
        if not self._track_dirty or not self._commit_caches:
            return
        ids = ids.reshape(-1).to(device=self.device, dtype=torch.int64)
        if ids.numel():
            for cache in self._commit_caches.values():
                cache["pending"].append(ids)

    def ensure_ids(self, ids: torch.Tensor) -> None:
        if ids.numel():
            self.ensure(int(ids.max()) + 1)

    # -- commitment ------------------------------------------------------------
    def word_buffer(self) -> torch.Tensor:
        """Canonical u32 words (int32 bits) of the filled prefix, field
        after field in schema order."""
        return torch.cat([getattr(self, name)[: self.n].view(torch.int32)
                          for name, _ in STATE_SCHEMA])

    def schema_header(self) -> bytes:
        return ";".join(f"{name}:{np.dtype(dt).str}"
                        for name, dt in STATE_SCHEMA).encode()

    def root(self, chunk: int = STATE_CHUNK_WORDS,
             backend: str = "auto") -> str:
        """Chunked state root.

        With dirty tracking on, the word buffer and digest vector are
        cached on the device; only the chunks covering rows touched since
        the last call refold (kernel ``dirty_fold``) before the host seal,
        instead of the whole state (kernel ``rollup_chunk_digests``)."""
        if not self._track_dirty:
            return chunked_root(self.word_buffer(), chunk, backend,
                                header=self.schema_header())
        cache = self._commit_caches.get(("flat", chunk))
        if cache is None:
            words = self.word_buffer()
            cache = {"words": words,
                     "digests": _fold_digests(words, chunk, backend),
                     "pending": []}
            self._commit_caches[("flat", chunk)] = cache
        elif cache["pending"]:
            rows = torch.unique(torch.cat(cache["pending"]))
            cache["pending"].clear()
            rows = rows[rows < self.n]
            if rows.numel():
                touched = self._patch_rows(cache["words"], self.n, rows,
                                           rows)
                dirty = torch.unique(touched // chunk)
                cache["digests"][dirty] = get_kernel(
                    "dirty_fold", kernel_impl(backend))(
                        cache["words"], dirty, chunk)
        return _seal_digests(self.schema_header(), cache["words"].numel(),
                             cache["digests"])

    def _patch_rows(self, words: torch.Tensor, m: int, rows: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        """Overwrite the cached word buffer in place with the CURRENT
        field values of ``rows`` and return the touched word indices.

        ``words`` is a field-major encoding of ``m`` rows (``word_buffer``
        for the flat commitment, ``_rows_words`` for a partition); ``pos``
        is each row's position in that row set.  A row's slot in field
        ``f`` is ``off_f + pos * itemsize//4``."""
        touched = []
        off = 0
        for name, dtype in STATE_SCHEMA:
            isw = np.dtype(dtype).itemsize // 4
            vals = getattr(self, name)[rows].view(torch.int32)
            idx = (off + pos[:, None] * isw
                   + torch.arange(isw, device=pos.device)).reshape(-1)
            words[idx] = vals
            touched.append(idx)
            off += m * isw
        return torch.cat(touched)

    def _rows_words(self, idx: torch.Tensor) -> torch.Tensor:
        """Canonical u32 words (int32 bits) over the selected rows, field
        after field in schema order."""
        return torch.cat([getattr(self, name)[idx].view(torch.int32)
                          for name, _ in STATE_SCHEMA])

    def _shard_headers(self, n_shards: int) -> List[bytes]:
        return [self.schema_header() + f"|shard={k}/{n_shards}".encode()
                for k in range(n_shards)]

    def _shard_rows(self, n_shards: int) -> List[torch.Tensor]:
        """Each shard's account rows, ascending (one ``account_owner``
        pass, one host copy of the K counts)."""
        owner = account_owner(torch.arange(self.n, device=self.device),
                              n_shards)
        order, counts = group_by(owner, n_shards)
        return list(torch.split(order, counts))

    def partition_roots(self, n_shards: int,
                        chunk: int = STATE_CHUNK_WORDS,
                        backend: str = "auto") -> List[str]:
        """All K per-shard roots.  Ownership is ``account_owner``, the
        partition function hash routing uses: the shard that sequenced an
        account's txs is the shard whose root commits it.  Unlike
        ``root()`` these depend on the partition.

        With dirty tracking, each shard's word buffer and digest vector
        are cached under ``("part", K, chunk)``; only the dirty chunks of
        a shard refold (kernel ``dirty_fold``, one launch a shard that
        has dirty rows).  The K digest vectors reach the host in one
        copy."""
        headers = self._shard_headers(n_shards)
        if not self._track_dirty:
            words = [self._rows_words(r) for r in self._shard_rows(n_shards)]
            return _seal_many(headers, [w.numel() for w in words],
                              [_fold_digests(w, chunk, backend)
                               for w in words])
        key = ("part", n_shards, chunk)
        cache = self._commit_caches.get(key)
        if cache is None:
            rows_k = self._shard_rows(n_shards)
            words_k = [self._rows_words(r) for r in rows_k]
            cache = {"rows": rows_k, "words": words_k,
                     "digests": [_fold_digests(w, chunk, backend)
                                 for w in words_k],
                     "pending": []}
            self._commit_caches[key] = cache
        elif cache["pending"]:
            rows = torch.unique(torch.cat(cache["pending"]))
            cache["pending"].clear()
            rows = rows[rows < self.n]
            if rows.numel():
                fold = get_kernel("dirty_fold", kernel_impl(backend))
                order, counts = group_by(account_owner(rows, n_shards),
                                         n_shards)
                for k, rk in enumerate(torch.split(rows[order], counts)):
                    if not counts[k]:
                        continue
                    shard_rows = cache["rows"][k]
                    pos = torch.searchsorted(shard_rows, rk)
                    touched = self._patch_rows(cache["words"][k],
                                               shard_rows.numel(), rk, pos)
                    dirty = torch.unique(touched // chunk)
                    cache["digests"][k][dirty] = fold(cache["words"][k],
                                                      dirty, chunk)
        return _seal_many(headers, [w.numel() for w in cache["words"]],
                          cache["digests"])

    def partition_root(self, shard: int, n_shards: int,
                       chunk: int = STATE_CHUNK_WORDS,
                       backend: str = "auto") -> str:
        """Single-shard form of ``partition_roots``: folds only the
        requested shard's rows, unless a tracked cache already holds all
        K."""
        if self._track_dirty and ("part", n_shards,
                                  chunk) in self._commit_caches:
            return self.partition_roots(n_shards, chunk, backend)[shard]
        owner = account_owner(torch.arange(self.n, device=self.device),
                              n_shards)
        words = self._rows_words(torch.nonzero(owner == shard).reshape(-1))
        return chunked_root(words, chunk, backend,
                            self._shard_headers(n_shards)[shard])

    # -- host exchange -----------------------------------------------------------
    @classmethod
    def from_numpy(cls, fields: Dict[str, np.ndarray],
                   device=None) -> "StateArrays":
        """State from host arrays, one per schema field (all of one
        length), e.g. the JAX package's ``StateArrays`` fields."""
        names = [name for name, _ in STATE_SCHEMA]
        if sorted(fields) != sorted(names):
            raise ValueError(f"fields must be exactly {names}")
        lengths = {len(np.asarray(a)) for a in fields.values()}
        if len(lengths) != 1:
            raise ValueError("all fields must have one length")
        out = cls(device=device)
        out.ensure(lengths.pop())
        for name, dtype in STATE_SCHEMA:
            host = np.ascontiguousarray(fields[name], dtype=dtype)
            getattr(out, name)[: out.n] = torch.from_numpy(host).to(
                out.device)
        return out

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The filled prefix of every field, as host arrays."""
        return {name: getattr(self, name)[: self.n].cpu().numpy()
                for name, _ in STATE_SCHEMA}

    def copy(self) -> "StateArrays":
        out = StateArrays(device=self.device)
        out.ensure(self.n)
        for name, _ in STATE_SCHEMA:
            getattr(out, name)[: self.n] = getattr(self, name)[: self.n]
        return out


# ---------------------------------------------------------------------------
# default protocol state handlers (written once, run on every ledger face)
# ---------------------------------------------------------------------------
def _counter_handler(field: str):
    def handler(state: StateArrays, txs) -> None:
        ids = txs.sender_id.to(torch.int64)
        state.ensure_ids(ids)
        col = getattr(state, field)
        col.index_add_(0, ids, torch.ones_like(ids))
        state.mark_dirty(ids)
    return handler


def default_state_handlers() -> Dict[str, Any]:
    """{fn: handler} for the Table-I protocol functions: pure per-account
    accumulators (commutative, hence partition invariant)."""
    return {
        "publishTask": _counter_handler("tasks_published"),
        "submitLocalModel": _counter_handler("submissions"),
        "calculateObjectiveRep": _counter_handler("rep_events"),
        "calculateSubjectiveRep": _counter_handler("rep_events"),
    }
