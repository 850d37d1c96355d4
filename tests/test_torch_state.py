"""The port's StateArrays commitment against the JAX package's: the same
rows commit to the same root, fully folded, incrementally refolded after
scattered writes, after growth, and when handed over with from_numpy.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import FnRegistry as JaxFns
from repro.core.engine import TxArrays as JaxTxArrays
from repro.core.state import StateArrays as JaxState
from repro.core.state import chunked_root as jax_chunked_root
from repro.core.state import default_state_handlers as jax_handlers
from repro_torch.core.engine import FnRegistry, TxArrays
from repro_torch.core.state import (STATE_SCHEMA, StateArrays,
                                    chunk_fold_digests, chunked_root,
                                    default_state_handlers)

torch.set_num_threads(1)


def _random_fields(rng, n):
    return {"balances": rng.normal(size=n) * 100,
            "stake": rng.random(n),
            "reputation": rng.random(n, dtype=np.float32),
            "tasks_published": rng.integers(0, 50, n),
            "submissions": rng.integers(0, 2**40, n),
            "rep_events": rng.integers(-5, 5, n)}


def _jax_state(fields, track=False):
    s = JaxState(len(fields["balances"]))
    for name, _ in STATE_SCHEMA:
        getattr(s, name)[: s.n] = fields[name]
    if track:
        s.enable_dirty_tracking()
    return s


@pytest.mark.parametrize("n", [0, 1, 64, 187, 1500, 9000])
def test_from_numpy_root_matches_jax(n):
    rng = np.random.default_rng(n)
    fields = _random_fields(rng, n)
    js = _jax_state(fields)
    ts = StateArrays.from_numpy(fields, device="cpu")
    assert ts.n == js.n == n
    np.testing.assert_array_equal(ts.word_buffer().numpy().view(np.uint32),
                                  js.word_buffer())
    assert ts.root() == js.root()
    back = ts.to_numpy()
    for name, dtype in STATE_SCHEMA:
        assert back[name].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(back[name], fields[name])


def test_chunked_root_matches_jax_and_tamper_evident():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, 10_000, dtype=np.uint32)
    t = torch.from_numpy(words.view(np.int32))
    for header in (b"", b"v2"):
        assert chunked_root(t, header=header) == \
            jax_chunked_root(words, backend="numpy", header=header)
    tampered = t.clone()
    tampered[9_999] ^= 1
    assert chunked_root(tampered) != chunked_root(t)


def test_host_chunk_fold_is_the_jax_mirror():
    from repro.core.state import chunk_fold_digests as jax_fold
    rng = np.random.default_rng(4)
    for n, width in ((0, 8), (1, 1), (13, 8), (4097, 2048)):
        d = rng.integers(0, 2**32, n, dtype=np.uint32)
        np.testing.assert_array_equal(chunk_fold_digests(d, width),
                                      jax_fold(d, width))


def test_incremental_root_matches_jax_after_writes_and_growth():
    """Tracked roots after each window of scattered writes (padded tail
    chunk and chunk boundaries included), then after growth, equal the JAX
    package's and the port's own full refold."""
    rng = np.random.default_rng(7)
    fields = _random_fields(rng, 1500)          # ~8 chunks of words
    js = _jax_state(fields, track=True)
    ts = StateArrays.from_numpy(fields, device="cpu")
    ts.enable_dirty_tracking()
    assert ts.root() == js.root()
    for _ in range(5):
        ids = rng.integers(0, 1500, 40)
        bump = rng.random(40, dtype=np.float32)
        js.balances[ids] += 1.5
        js.reputation[ids] = bump
        js.submissions[ids] += 1
        js.mark_dirty(ids)
        tid = torch.from_numpy(ids)
        ts.balances[tid] += 1.5
        ts.reputation[tid] = torch.from_numpy(bump)
        ts.submissions[tid] += 1
        ts.mark_dirty(tid)
        assert ts.root() == js.root() == ts.copy().root()
    assert ts.root() == js.root()               # a no-op window
    for s in (js, ts):
        s.ensure(2100)                          # growth drops the caches
    js.balances[2099] = 9.0
    js.mark_dirty(np.array([2099]))
    ts.balances[2099] = 9.0
    ts.mark_dirty(torch.tensor([2099]))
    assert ts.root() == js.root() == ts.copy().root()


def test_counter_handlers_match_jax():
    rng = np.random.default_rng(9)
    names = ["publishTask", "submitLocalModel", "calculateObjectiveRep",
             "calculateSubjectiveRep"]
    js, ts = JaxState(), StateArrays(device="cpu")
    js.enable_dirty_tracking()
    ts.enable_dirty_tracking()
    jf, tf = JaxFns(names), FnRegistry(names)
    jh, th = jax_handlers(), default_state_handlers()
    for window in range(4):
        n = 300
        fn = rng.integers(0, 4, n).astype(np.int32)
        sender = rng.integers(0, 200 * (window + 1), n).astype(np.int32)
        t = np.sort(rng.random(n))
        gas = np.full(n, 1000, np.int64)
        for fid, name in enumerate(names):
            m = fn == fid
            jh[name](js, JaxTxArrays(t[m], gas[m], fn[m], sender[m], jf))
            th[name](ts, TxArrays.from_numpy(t[m], gas[m], fn[m], sender[m],
                                             tf, device="cpu"))
        assert ts.root() == js.root()
    for name, _ in STATE_SCHEMA:
        np.testing.assert_array_equal(getattr(ts, name)[: ts.n].numpy(),
                                      getattr(js, name)[: js.n])


def test_from_numpy_rejects_bad_fields():
    with pytest.raises(ValueError, match="exactly"):
        StateArrays.from_numpy({"balances": np.zeros(3)}, device="cpu")
    fields = _random_fields(np.random.default_rng(0), 4)
    fields["stake"] = np.zeros(5)
    with pytest.raises(ValueError, match="one length"):
        StateArrays.from_numpy(fields, device="cpu")
