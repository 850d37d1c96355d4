"""Self-check for the port's repro-lint (repro_torch/analysis/lint.py).

The CLI exits nonzero on each known-bad fixture of
``tests/lint_fixtures_torch/`` (one per static rule, R001-R005 and R008,
in the port's forms), zero on the shipped ``src/repro_torch`` tree;
suppression comments work; findings are machine-readable in the JAX
package's record; R002 sees all twelve factory ops through the factory's
loop of registrations; and on the JAX package's framework-neutral
fixtures the port's linter reports the same rules at the same lines as
``repro.analysis.lint``.  Fixtures are referenced by file name only —
naming a fixture's kernel op in a test file would satisfy R002's
parity-test scan and defeat the fixture.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import lint as jax_lint
from repro.analysis.invariants import CATALOG as JAX_CATALOG
from repro_torch.analysis import invariants, lint
from repro_torch.analysis.invariants import CATALOG

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "lint_fixtures_torch")
JAX_FIXTURES = os.path.join(HERE, "lint_fixtures")
SRC = os.path.normpath(os.path.join(HERE, os.pardir, "src"))
SRC_PORT = os.path.join(SRC, "repro_torch")

#: one known-bad fixture per static rule
RULE_FIXTURES = {
    "R001": "bad_r001.py",
    "R002": "bad_r002.py",
    "R003": "bad_r003.py",
    "R004": "bad_r004.py",
    "R005": "bad_r005.py",
    "R008": "bad_r008.py",
}
#: the factory's ops (kernels/factory.py) and the impls each registers
FACTORY_OPS = {
    "batch_seal", "rollup_digest", "rollup_chunk_digests", "dirty_fold",
    "weighted_agg", "model_distance", "block_pack", "flash_attention",
    "flash_attention_bwd", "gmm", "gmm_bwd", "slstm_scan", "slstm_scan_bwd",
    "shard_seal", "ssm_scan", "ssm_scan_bwd"}


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, env=env)


def _rules_at(findings):
    return sorted((f.rule, f.line) for f in findings)


@pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
def test_fixture_triggers_exactly_its_rule(rule):
    findings, n_sup = lint.scan([os.path.join(FIXTURES, RULE_FIXTURES[rule])])
    assert findings, f"fixture for {rule} produced no findings"
    assert {f.rule for f in findings} == {rule}
    assert n_sup == 0
    for f in findings:
        assert f.hint == CATALOG[rule].fix_hint
        assert f.line > 0


def test_catalog_covers_every_rule():
    static = {r for r, inv in CATALOG.items() if inv.static}
    assert static == set(RULE_FIXTURES)
    dynamic = {r for r, inv in CATALOG.items() if inv.dynamic}
    assert dynamic == {"R001", "R005", "R006", "R007"}


def test_catalog_means_the_same_rules_as_the_jax_package():
    assert set(CATALOG) == set(JAX_CATALOG)
    for rule, inv in CATALOG.items():
        ref = JAX_CATALOG[rule]
        assert (inv.title, inv.static, inv.dynamic) == \
            (ref.title, ref.static, ref.dynamic), rule
        if rule not in ("R002", "R004"):       # the port's forms differ
            assert (inv.rationale, inv.fix_hint) == \
                (ref.rationale, ref.fix_hint), rule
    assert "does not donate" in CATALOG["R004"].rationale


def test_catalog_names_exist_in_the_port():
    """The seeds, the event-log owner and the state columns the rules
    name are the port's own."""
    defs = set()
    for base, _dirs, files in os.walk(SRC_PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f), encoding="utf-8") as fh:
                    for node in ast.walk(ast.parse(fh.read())):
                        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
                            defs.add(node.name)
    for name in (invariants.DETERMINISM_SEED_CLASSES
                 + invariants.DETERMINISM_SEED_FUNCS
                 + invariants.ADMISSION_SEED_CLASSES):
        assert name in defs, name
    assert os.path.isfile(os.path.join(SRC_PORT,
                                       invariants.EVENTLOG_OWNER_MODULE))
    from repro_torch.core.state import STATE_SCHEMA
    assert invariants.STATE_COLUMNS == tuple(n for n, _ in STATE_SCHEMA)


def test_shipped_tree_is_clean():
    findings, n_sup = lint.scan([SRC_PORT])
    assert findings == [], "\n".join(f.render() for f in findings)
    # the one line suppression: fl/cohort.round_noise's seeded
    # SeedSequence (CHANGES.md)
    assert n_sup == 1


def test_r002_sees_every_factory_op():
    ops = lint.kernel_ops([SRC_PORT])
    assert set(ops) == FACTORY_OPS
    for op, impls in ops.items():
        assert {"torch", "cuda"} <= set(impls), op
    assert ops["shard_seal"] == ["cuda", "mesh", "torch"]


def test_cli_nonzero_per_fixture_and_zero_on_src(tmp_path):
    for rule, name in sorted(RULE_FIXTURES.items()):
        out = tmp_path / f"{rule}.json"
        res = _run_cli(os.path.join(FIXTURES, name), "--json", str(out))
        assert res.returncode == 1, (rule, res.stdout, res.stderr)
        payload = json.loads(out.read_text())
        assert set(payload) == {"version", "n_findings", "n_suppressed",
                                "findings"}
        assert payload["n_findings"] >= 1
        assert {f["rule"] for f in payload["findings"]} == {rule}
        for f in payload["findings"]:
            assert set(f) == {"file", "line", "col", "rule", "message",
                              "hint"}
    out = tmp_path / "src.json"
    res = _run_cli(SRC_PORT, "--json", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(out.read_text())
    assert payload["n_findings"] == 0 and payload["n_suppressed"] == 1
    assert f"R002 saw {len(FACTORY_OPS)} kernel op(s)" in res.stderr


def test_line_suppression_and_file_suppression(tmp_path):
    body = ("def f(state, ids):\n"
            "    state.balances.index_add_(0, ids, ids){}\n")
    bad = tmp_path / "bad.py"
    bad.write_text(body.format(""))
    findings, n_sup = lint.scan([str(bad)])
    assert [f.rule for f in findings] == ["R001"] and n_sup == 0

    sup = tmp_path / "sup.py"
    sup.write_text(body.format("  # repro-lint: disable=R001"))
    findings, n_sup = lint.scan([str(sup)])
    assert findings == [] and n_sup == 1

    supf = tmp_path / "supf.py"
    supf.write_text("# repro-lint: disable-file=R001\n" + body.format(""))
    findings, n_sup = lint.scan([str(supf)])
    assert findings == [] and n_sup == 1


def test_linter_imports_neither_torch_nor_numpy():
    """Pure stdlib: the linter runs where torch and numpy cannot be
    imported, and never imports the modules it checks."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch.analysis import lint\n"
        f"rc = lint.main([{SRC_PORT!r}, '--quiet'])\n"
        "assert not [m for m in sys.modules if m.startswith("
        "('repro_torch.core', 'repro_torch.kernels'))]\n"
        "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_syntax_error_is_a_hard_finding(tmp_path):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    findings, _ = lint.scan([str(broken)])
    assert [f.rule for f in findings] == ["R000"]
    res = _run_cli(str(broken), "--quiet")
    assert res.returncode == 1


@pytest.mark.parametrize("fixture", ["bad_r001.py", "bad_r003.py",
                                     "bad_r005.py", "bad_r008.py"])
def test_same_findings_as_the_jax_linter(fixture):
    """The framework-neutral fixtures of the JAX package: the same rules
    at the same lines from both linters."""
    path = os.path.join(JAX_FIXTURES, fixture)
    ours, _ = lint.scan([path])
    theirs, _ = jax_lint.scan([path])
    assert ours and _rules_at(ours) == _rules_at(theirs)


# -- R001 ---------------------------------------------------------------------

def test_r001_pairing_is_accepted(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text(
        "import numpy as np\n\n\n"
        "def f(state, ids):\n"
        "    state.balances[ids] += 1.0\n"
        "    np.add.at(state.submissions, ids, 1)\n"
        "    state.stake.index_put_((ids,), ids)\n"
        "    state.mark_dirty(ids)\n\n\n"
        "def handler(state, txs):\n"         # core/state.py's default handler
        "    ids = txs.sender_id\n"
        "    col = getattr(state, 'submissions')\n"
        "    col.index_add_(0, ids, ids)\n"
        "    state.mark_dirty(ids)\n")
    findings, _ = lint.scan([str(ok)])
    assert findings == []


@pytest.mark.parametrize("write", [
    "state.reputation[ids] = rep",
    "state.balances.add_(1.0)",
    "state.rep_events.scatter_add_(0, ids, ids)",
    "state.stake.zero_()",
    "state.tasks_published.fill_(0)",
    "state.balances[:3].mul_(2.0)",
    "getattr(state, name)[ids] = rep",
    "getattr(state, name).sub_(rep)",
    "col = getattr(state, name); col[ids] = rep",
    "col = state.reputation; col.copy_(rep)",
])
def test_r001_catches_the_port_forms(write, tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(f"def f(state, ids, rep, name):\n    {write}\n")
    findings, _ = lint.scan([str(bad)])
    assert [f.rule for f in findings] == ["R001"], write


def test_r001_state_handler_needs_its_mark_dirty(tmp_path):
    """core/state.py's default handler writes a column through a getattr
    alias and is clean because it calls mark_dirty; without that call it
    is a finding.  StateArrays itself stays exempt."""
    with open(os.path.join(SRC_PORT, "core", "state.py"),
              encoding="utf-8") as fh:
        text = fh.read()
    assert lint.scan([os.path.join(SRC_PORT, "core", "state.py")])[0] == []
    line = "        state.mark_dirty(ids)\n    return handler\n"
    assert text.count(line) == 1
    cut = tmp_path / "state.py"
    cut.write_text(text.replace(line, "    return handler\n"))
    findings, _ = lint.scan([str(cut)])
    assert [(f.rule, f.message.split(" via")[0]) for f in findings] == \
        [("R001", "write to StateArrays column 'col.index_add_'")]


# -- R002 ---------------------------------------------------------------------

def _factory_tree(tmp_path, impls, tested=True, carded=True):
    """A repo in ``tmp_path``: a factory registering op ``widen_rows`` in
    the loop form with ``impls``, and optionally its parity test and its
    card check."""
    (tmp_path / "tests").mkdir()
    (tmp_path / "src").mkdir()
    if tested:
        (tmp_path / "tests" / "test_torch_widen.py").write_text(
            "OP = 'widen_rows'\n")
    if carded:
        (tmp_path / "chip_smoke.py").write_text("OP = 'widen_rows'\n")
    body = "".join(f"        register_kernel(op, {impl!r}, fn)\n"
                   for impl in impls)
    src = tmp_path / "src" / "factory.py"
    src.write_text("def register_kernel(op, impl, fn):\n    pass\n\n\n"
                   "def _load():\n"
                   "    for op, fn in (('widen_rows', len),):\n" + body)
    return str(src)


def test_r002_reads_the_factory_loop(tmp_path):
    src = _factory_tree(tmp_path, ("torch", "cuda"))
    assert lint.kernel_ops([src]) == {"widen_rows": ["cuda", "torch"]}
    assert lint.scan([src])[0] == []


@pytest.mark.parametrize("impls,tested,carded,missing", [
    (("cuda",), True, True, "no 'torch' plain PyTorch version"),
    (("torch", "triton"), True, True, "no 'cuda' hand-written kernel"),
    (("torch", "cuda"), False, True, "no parity test"),
    (("torch", "cuda"), True, False, "no card check"),
])
def test_r002_names_what_an_op_misses(impls, tested, carded, missing,
                                      tmp_path):
    src = _factory_tree(tmp_path, impls, tested, carded)
    findings, _ = lint.scan([src])
    assert [f.rule for f in findings] == ["R002"]
    assert missing in findings[0].message


# -- R003 ---------------------------------------------------------------------

@pytest.mark.parametrize("draw", list(invariants.TORCH_RNG_DRAWS))
def test_r003_torch_global_generator(draw, tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\n\n"
                   "def chunked_root(words):\n"
                   f"    return torch.{draw}(words)\n")
    findings, _ = lint.scan([str(bad)])
    assert [f.rule for f in findings] == ["R003"]
    ok = tmp_path / "ok.py"
    ok.write_text("import torch\n\n\n"
                  "def chunked_root(words, g):\n"
                  f"    return torch.{draw}(words, generator=g)\n")
    assert lint.scan([str(ok)])[0] == []


def test_r003_follows_the_factory(tmp_path):
    """``get_kernel("op")`` on the digest path reaches every impl the
    factory registers for the op."""
    src = tmp_path / "m.py"
    src.write_text(
        "import time\n\n\n"
        "def register_kernel(op, impl, fn):\n    pass\n\n\n"
        "def get_kernel(op):\n    pass\n\n\n"
        "def fold_stamp(words):\n    return time.time()\n\n\n"
        "def _load():\n"
        "    for op, fn in (('fold_rows', fold_stamp),):\n"
        "        register_kernel(op, 'torch', fn)\n"
        "        register_kernel(op, 'cuda', fn)\n\n\n"
        "def chunked_root(words):\n"
        "    return get_kernel('fold_rows')(words)\n")
    findings, _ = lint.scan([str(src)])
    assert [(f.rule, f.line) for f in findings] == [("R003", 13)]


# -- R004 ---------------------------------------------------------------------

@pytest.mark.parametrize("body,flagged", [
    ("return x.item()", True),
    ("return x.tolist()", True),
    ("return x.numpy()", True),
    ("return int(x)", True),
    ("return bool(x > 0)", True),
    ("if x.max() > 0:\n        x = -x\n    return x", True),
    ("while x.sum() > 1:\n        x = x / 2\n    return x", True),
    ("if x.shape[0] > 1 and x.dtype == torch.float32:\n"
     "        x = x * 2\n    return x", False),
    ("if x.ndim == 2 and x.device.type == 'cpu':\n"
     "        x = x.T\n    return x", False),
    ("return torch.where(x > 0, x, -x)", False),
])
@pytest.mark.parametrize("transform", ["torch.func.vmap(f)",
                                       "torch.vmap(f)", "grad_and_value(f)",
                                       "torch.compile(f)", "jacrev(f)"])
def test_r004_host_sync_hygiene(body, flagged, transform, tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import torch\n"
                   "from torch.func import grad_and_value, jacrev\n\n\n"
                   f"def f(x):\n    {body}\n\n\ng = {transform}\n")
    findings, _ = lint.scan([str(src)])
    assert [f.rule for f in findings] == (["R004"] if flagged else [])


def test_r004_only_traced_functions(tmp_path):
    """Outside a transform a host sync is fine, and re.compile and
    torch.autograd.grad trace nothing."""
    src = tmp_path / "m.py"
    src.write_text("import re\nimport torch\n\n\n"
                   "def f(x):\n    return x.item()\n\n\n"
                   "pat = re.compile(f)\n\n\n"
                   "def h(loss, x):\n"
                   "    return torch.autograd.grad(f, x)\n")
    assert lint.scan([str(src)])[0] == []


def test_r004_reaches_methods_across_modules(tmp_path):
    """grad_and_value(model.loss) traces every method named ``loss`` in
    the scan set (fl/cohort.py's and fl/client.py's local steps)."""
    (tmp_path / "model.py").write_text(
        "class Net:\n"
        "    def loss(self, p, batch):\n"
        "        return (p * batch).sum().item()\n")
    (tmp_path / "train.py").write_text(
        "from torch.func import grad_and_value\n\n\n"
        "def step(model, p, batch):\n"
        "    return grad_and_value(model.loss)(p, batch)\n")
    findings, _ = lint.scan([str(tmp_path)])
    assert [(os.path.basename(f.file), f.line) for f in findings] == \
        [("model.py", 3)]


# -- R005 / R008 ----------------------------------------------------------------

def test_r005_splice_owner_is_exempt():
    events = os.path.join(SRC_PORT, "core", "events.py")
    findings, _ = lint.scan([events])
    assert findings == []


def test_r008_admission_path_is_clean():
    admission = os.path.join(SRC_PORT, "serve", "admission.py")
    assert lint.scan([admission])[0] == []
    assert {f.rule for f in lint.scan([os.path.join(
        FIXTURES, RULE_FIXTURES["R008"])])[0]} == {"R008"}
