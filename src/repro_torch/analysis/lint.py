"""repro-lint for the port: AST-based static checker of its cross-file
contracts.

Ordinary linters cannot see the stack's real invariants — that a
``StateArrays`` column write (a subscript store or an in-place tensor
method such as ``index_add_``) must be paired with ``mark_dirty`` (R001),
that every kernel-factory op ships a plain PyTorch version and a
hand-written CUDA kernel, pinned by a ``tests/test_torch_*.py`` parity
test and checked on the card by ``chip_smoke.py`` (R002), that nothing
reachable from the fused record/execute or digest paths reads the wall
clock, an unseeded RNG or torch's global generator (R003), that the
functions ``torch.func`` transforms or ``torch.compile`` traces stay free
of host syncs and value branching (R004), that ``EventLog`` internals are
mutated only by their owner (R005), and that mempool admission decisions
never read the wall clock (R008).  This pass does.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch [--json out.json]

Findings are machine-readable (file, line, col, rule id, fix hint);
exit status is nonzero iff any unsuppressed finding remains.  Suppress a
line with ``# repro-lint: disable=R001`` (comma-separate several rules)
or a whole file with ``# repro-lint: disable-file=R003``.  The rule
catalog — shared with the runtime sanitizer — lives in
``analysis/invariants.py``; docs/ANALYSIS_TORCH.md is the human-facing
form.

Pure stdlib on purpose: the linter never imports the modules it checks,
so it runs in any environment without torch.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.invariants import (
    ADMISSION_SEED_CLASSES, ADMISSION_SEED_FUNCS, CARD_CHECK_FILE,
    DETERMINISM_SEED_CLASSES, DETERMINISM_SEED_FUNCS, EVENTLOG_OWNER_MODULE,
    HOST_SYNC_METHODS, INPLACE_TENSOR_METHODS, MIN_IMPLS_PER_OP,
    PARITY_TEST_PREFIX, REQUIRED_KERNEL_IMPL, REQUIRED_MIRROR_IMPL,
    STATE_COLUMNS, TORCH_RNG_DRAWS, TRACING_TRANSFORMS, fix_hint)

# ---------------------------------------------------------------------------
# findings + suppressions


@dataclasses.dataclass(frozen=True)
class Finding:
    """One machine-readable violation."""

    file: str
    line: int
    col: int
    rule: str
    message: str
    hint: str

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: {self.rule} "
                f"{self.message} (hint: {self.hint})")


_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Z0-9, ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*repro-lint:\s*disable-file=([A-Z0-9, ]+)")


@dataclasses.dataclass
class Module:
    """One parsed source file plus its suppression tables."""

    path: str                      # as given (for findings)
    rel: str                       # posix path, for owner-module checks
    tree: ast.Module
    lines: List[str]
    line_suppress: Dict[int, Set[str]]
    file_suppress: Set[str]

    def suppressed(self, rule: str, line: int) -> bool:
        return (rule in self.file_suppress
                or rule in self.line_suppress.get(line, ()))


def _parse_module(path: str) -> Tuple[Optional[Module], Optional[Finding]]:
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return None, Finding(path, e.lineno or 1, e.offset or 0, "R000",
                             f"syntax error: {e.msg}", "fix the parse error")
    line_sup: Dict[int, Set[str]] = {}
    file_sup: Set[str] = set()
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            line_sup[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
        m = _SUPPRESS_FILE_RE.search(text)
        if m:
            file_sup |= {r.strip() for r in m.group(1).split(",") if r.strip()}
    return Module(path, path.replace(os.sep, "/"), tree, lines,
                  line_sup, file_sup), None


# ---------------------------------------------------------------------------
# shared AST helpers


def _iter_functions(tree: ast.Module):
    """Yield (function_node, enclosing_class_name_or_None), including
    nested functions (tagged with their outermost class, if any)."""
    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)


def _safe_unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _callee(node: ast.AST) -> str:
    """The simple name a call target resolves by: ``f`` or ``x.f``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


# ---------------------------------------------------------------------------
# R001: StateArrays writes paired with mark_dirty

#: ufuncs whose ``.at`` form scatters into a column in place
_SCATTER_UFUNCS = {"add", "subtract", "maximum", "minimum", "multiply"}
#: parameter/local names treated as StateArrays by convention
_STATE_NAMES = {"state", "state_arrays"}


def _r001_state_vars(fn: ast.AST) -> Set[str]:
    """Names bound to a StateArrays inside ``fn`` (annotation or
    construction/attribute provenance), beyond the conventional names."""
    out: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        if a.annotation is not None and "StateArrays" in _safe_unparse(a.annotation):
            out.add(a.arg)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        val = node.value
        if isinstance(val, ast.Call):
            if _callee(val.func) == "StateArrays":
                out.add(tgt.id)
        elif isinstance(val, ast.Attribute) and val.attr == "state_arrays":
            out.add(tgt.id)
    return out


def _r001_is_state_base(node: ast.AST, state_vars: Set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in _STATE_NAMES or node.id in state_vars
    if isinstance(node, ast.Attribute):
        return node.attr in ("state_arrays", "state")
    return False


def _r001_column(node: ast.AST, state_vars: Set[str],
                 aliases: Dict[str, str]):
    """If ``node`` denotes a StateArrays column (``state.<col>``,
    ``getattr(state, name)``, a local bound to either, or a subscript of
    one of these), return (base_key, column); else None."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute) and node.attr in STATE_COLUMNS
            and _r001_is_state_base(node.value, state_vars)):
        return _safe_unparse(node.value), node.attr
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "getattr" and node.args
            and _r001_is_state_base(node.args[0], state_vars)):
        return _safe_unparse(node.args[0]), "<getattr>"
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id], node.id
    return None


def _r001_aliases(fn: ast.AST, state_vars: Set[str]) -> Dict[str, str]:
    """Locals bound to a column: ``col = getattr(state, name)`` or
    ``col = state.<col>`` -> {local: base_key}."""
    out: Dict[str, str] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and not isinstance(node.value, ast.Subscript)):
            hit = _r001_column(node.value, state_vars, {})
            if hit:
                out[node.targets[0].id] = hit[0]
    return out


def check_r001(mod: Module) -> List[Finding]:
    findings: List[Finding] = []
    for fn, cls in _iter_functions(mod.tree):
        if cls == "StateArrays":        # the class owns its own caches
            continue
        state_vars = _r001_state_vars(fn)
        aliases = _r001_aliases(fn, state_vars)
        writes: List[Tuple[str, str, int, int]] = []   # base, col, line, col
        marks: List[Tuple[str, int]] = []              # base, line
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    # state.<col>[...] = v, col[...] = v, state.<col> op= v;
                    # rebinding a local name is no write
                    hit = None if isinstance(t, ast.Name) else \
                        _r001_column(t, state_vars, aliases)
                    if hit:
                        writes.append((*hit, node.lineno, node.col_offset))
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == "mark_dirty"):
                    marks.append((_safe_unparse(f.value), node.lineno))
                elif (isinstance(f, ast.Attribute)
                      and f.attr in INPLACE_TENSOR_METHODS):
                    # state.<col>.index_add_(...), col.copy_(...)
                    hit = _r001_column(f.value, state_vars, aliases)
                    if hit:
                        writes.append((hit[0], f"{hit[1]}.{f.attr}",
                                       node.lineno, node.col_offset))
                elif (isinstance(f, ast.Attribute) and f.attr == "at"
                      and isinstance(f.value, ast.Attribute)
                      and f.value.attr in _SCATTER_UFUNCS and node.args):
                    # np.add.at(<col expr>, ids, x) scatter form
                    hit = _r001_column(node.args[0], state_vars, aliases)
                    if hit:
                        writes.append((hit[0], "<scatter>", node.lineno,
                                       node.col_offset))
        for base, col, line, colno in writes:
            if any(mb == base and ml >= line for mb, ml in marks):
                continue
            findings.append(Finding(
                mod.path, line, colno, "R001",
                f"write to StateArrays column {col!r} via {base!r} has no "
                f"matching {base}.mark_dirty(...) later in this function",
                fix_hint("R001")))
    return findings


# ---------------------------------------------------------------------------
# R002: kernel-registry completeness


def _repo_root_of(path: str) -> Optional[str]:
    d = os.path.dirname(os.path.abspath(path))
    while True:
        if os.path.isdir(os.path.join(d, "tests")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


_TEXT_CACHE: Dict[str, str] = {}


def _parity_corpus(repo_root: str) -> str:
    """Concatenated text of the port's parity tests, tests/test_torch_*.py."""
    key = os.path.join(repo_root, PARITY_TEST_PREFIX)
    if key not in _TEXT_CACHE:
        tdir, prefix = os.path.split(key)
        chunks: List[str] = []
        for f in sorted(os.listdir(tdir)):
            if f.startswith(prefix) and f.endswith(".py"):
                with open(os.path.join(tdir, f), encoding="utf-8") as fh:
                    chunks.append(fh.read())
        _TEXT_CACHE[key] = "\n".join(chunks)
    return _TEXT_CACHE[key]


def _card_check(repo_root: str) -> str:
    """Text of the card check, chip_smoke.py ("" where there is none)."""
    path = os.path.join(repo_root, CARD_CHECK_FILE)
    if path not in _TEXT_CACHE:
        text = ""
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
        _TEXT_CACHE[path] = text
    return _TEXT_CACHE[path]


@dataclasses.dataclass
class Registration:
    """Every ``register_kernel`` of one op the scan saw."""

    impls: Set[str]
    fns: Set[str]                      # simple names of the registered fns
    site: Tuple[Module, int, int]      # first registration


def _loop_bindings(node: ast.For) -> List[Tuple[Dict[str, ast.AST], int,
                                                int]]:
    """``for a, b, c in ((x, y, z), ...)`` -> one {name: element} per row
    of the literal, with the row's position; [] for any other loop."""
    tgt, it = node.target, node.iter
    if not (isinstance(tgt, ast.Tuple)
            and all(isinstance(e, ast.Name) for e in tgt.elts)
            and isinstance(it, (ast.Tuple, ast.List))):
        return []
    names = [e.id for e in tgt.elts]
    rows = []
    for row in it.elts:
        if isinstance(row, ast.Tuple) and len(row.elts) == len(names):
            rows.append((dict(zip(names, row.elts)), row.lineno,
                         row.col_offset))
    return rows


def _register_calls(tree: ast.AST):
    """Yield every ``register_kernel(op, impl, fn, ...)`` call with its
    arguments resolved: literal calls as written, and calls in the body of
    a loop over a tuple literal once per row, the loop names bound to the
    row's elements.  Yields (op, impl, fn node, line, col)."""
    looped: Set[ast.AST] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        rows = _loop_bindings(node)
        for stmt in node.body:
            for call in ast.walk(stmt):
                if not (isinstance(call, ast.Call)
                        and _callee(call.func) == "register_kernel"
                        and len(call.args) >= 3):
                    continue
                looped.add(call)
                for bind, line, col in rows:
                    arg = [bind.get(a.id, a) if isinstance(a, ast.Name)
                           else a for a in call.args[:3]]
                    yield (_const_str(arg[0]), _const_str(arg[1]), arg[2],
                           line, col)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node not in looped
                and _callee(node.func) == "register_kernel"
                and len(node.args) >= 2):
            fn = node.args[2] if len(node.args) > 2 else None
            yield (_const_str(node.args[0]), _const_str(node.args[1]), fn,
                   node.lineno, node.col_offset)


def kernel_registrations(mods: Sequence[Module]) -> Dict[str, Registration]:
    """op -> the impls and functions the scanned sources register."""
    regs: Dict[str, Registration] = {}
    for mod in mods:
        for op, impl, fn, line, col in _register_calls(mod.tree):
            if op is None or impl is None:
                continue
            reg = regs.setdefault(op, Registration(set(), set(),
                                                   (mod, line, col)))
            reg.impls.add(impl)
            if fn is not None and _callee(fn):
                reg.fns.add(_callee(fn))
    return regs


def check_r002(mods: Sequence[Module]) -> List[Finding]:
    """One finding an incomplete op, at its first registration, naming
    every part of the contract it misses."""
    findings: List[Finding] = []
    for op, reg in sorted(kernel_registrations(mods).items()):
        mod, line, col = reg.site
        impls = sorted(reg.impls)
        missing = [f"no {want!r} {what}" for want, what in (
            (REQUIRED_MIRROR_IMPL, "plain PyTorch version"),
            (REQUIRED_KERNEL_IMPL, "hand-written kernel"))
            if want not in reg.impls]
        if len(reg.impls) < MIN_IMPLS_PER_OP:
            missing.append(f"fewer than {MIN_IMPLS_PER_OP} impls")
        root = _repo_root_of(mod.path)
        if root is not None:
            if op not in _parity_corpus(root):
                missing.append(f"no parity test (no {PARITY_TEST_PREFIX}*.py "
                               f"mentions it)")
            if op not in _card_check(root):
                missing.append(f"no card check ({CARD_CHECK_FILE} does not "
                               f"mention it)")
        if missing:
            findings.append(Finding(
                mod.path, line, col, "R002",
                f"kernel op {op!r} (impls: {impls}): " + "; ".join(missing),
                fix_hint("R002")))
    return findings


# ---------------------------------------------------------------------------
# R003: determinism on fused-replay / digest paths


def _called_names(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _callee(node.func):
            out.add(_callee(node.func))
    return out


def _factory_edges(fn: ast.AST, regs: Dict[str, Registration]) -> Set[str]:
    """The functions a ``get_kernel("op", ...)`` call in ``fn`` may
    resolve to: every function registered for that op."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and _callee(node.func) == "get_kernel"
                and node.args):
            reg = regs.get(_const_str(node.args[0]))
            if reg is not None:
                out |= reg.fns
    return out


def _reach(mods: Sequence[Module], seed_classes: Sequence[str],
           seed_funcs: Sequence[str]) -> List[Tuple[Module, ast.AST]]:
    """Functions reachable from the seeds, BFS over simple-name call
    edges (conservative: a matching name anywhere in the scan set counts
    as an edge), plus the factory's edges: ``get_kernel("op")`` reaches
    every impl registered for the op.  Shared by the R003 and R008
    sweeps."""
    regs = kernel_registrations(mods)
    index: Dict[str, List[Tuple[Module, ast.AST, Optional[str]]]] = {}
    seeds: List[Tuple[Module, ast.AST]] = []
    for mod in mods:
        for fn, cls in _iter_functions(mod.tree):
            index.setdefault(fn.name, []).append((mod, fn, cls))
            if cls in seed_classes or fn.name in seed_funcs:
                seeds.append((mod, fn))
    # AST nodes hash by identity, so plain node sets give the identity
    # bookkeeping without id() (rule R003 applies to this file too)
    reachable: Set[ast.AST] = set()
    frontier = list(seeds)
    reach_list: List[Tuple[Module, ast.AST]] = []
    while frontier:
        mod, fn = frontier.pop()
        if fn in reachable:
            continue
        reachable.add(fn)
        reach_list.append((mod, fn))
        for name in _called_names(fn) | _factory_edges(fn, regs):
            for tmod, tfn, _cls in index.get(name, ()):
                if tfn not in reachable:
                    frontier.append((tmod, tfn))
    return reach_list


def _wallclock_findings(mod: Module, fn: ast.AST, rule: str) -> List[Finding]:
    """time.time/datetime.now-family calls inside ``fn``, as ``rule``."""
    findings: List[Finding] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        chain = _safe_unparse(f)
        base = f.value
        where = f"on a path reachable from {fn.name!r}"
        if (isinstance(base, ast.Name) and base.id == "time"
                and f.attr in ("time", "time_ns", "perf_counter",
                               "monotonic", "clock")):
            findings.append(Finding(
                mod.path, node.lineno, node.col_offset, rule,
                f"wall-clock read {chain}() {where}", fix_hint(rule)))
        elif f.attr in ("now", "utcnow", "today") and "datetime" in chain:
            findings.append(Finding(
                mod.path, node.lineno, node.col_offset, rule,
                f"wall-clock read {chain}() {where}", fix_hint(rule)))
    return findings


def check_r003(mods: Sequence[Module]) -> List[Finding]:
    findings: List[Finding] = []
    reach_list = _reach(mods, DETERMINISM_SEED_CLASSES,
                        DETERMINISM_SEED_FUNCS)
    for mod, fn in reach_list:
        findings.extend(_wallclock_findings(mod, fn, "R003"))
        has_stdlib_random = any(
            isinstance(n, ast.Import) and any(a.name == "random" for a in n.names)
            for n in ast.walk(mod.tree))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            where = f"on a path reachable from {fn.name!r}"
            if isinstance(f, ast.Attribute):
                chain = _safe_unparse(f)
                base = f.value
                if chain.startswith(("np.random.", "numpy.random.")):
                    if f.attr != "default_rng":
                        findings.append(Finding(
                            mod.path, node.lineno, node.col_offset, "R003",
                            f"unseeded global RNG {chain}() {where}",
                            fix_hint("R003")))
                    elif not node.args and not node.keywords:
                        findings.append(Finding(
                            mod.path, node.lineno, node.col_offset, "R003",
                            f"{chain}() without a seed {where}",
                            fix_hint("R003")))
                elif (chain in {f"torch.{d}" for d in TORCH_RNG_DRAWS}
                      and not any(k.arg == "generator"
                                  for k in node.keywords)):
                    findings.append(Finding(
                        mod.path, node.lineno, node.col_offset, "R003",
                        f"{chain}() draws from torch's global generator "
                        f"(no generator=) {where}", fix_hint("R003")))
                elif (has_stdlib_random and isinstance(base, ast.Name)
                      and base.id == "random"):
                    findings.append(Finding(
                        mod.path, node.lineno, node.col_offset, "R003",
                        f"stdlib random.{f.attr}() {where}", fix_hint("R003")))
            elif isinstance(f, ast.Name) and f.id == "id" and len(node.args) == 1:
                findings.append(Finding(
                    mod.path, node.lineno, node.col_offset, "R003",
                    f"id()-based keying/ordering {where} is process-"
                    f"nondeterministic", fix_hint("R003")))
    return findings


# ---------------------------------------------------------------------------
# R008: admission-path purity (no wall clock in mempool decisions)


def check_r008(mods: Sequence[Module]) -> List[Finding]:
    """Admission decisions are pure functions of (spec, sender state,
    pool state) on MODELED time: nothing reachable from the admission
    seeds (``AdmissionController``/``PendingPool``) may read the wall
    clock — the recorded admission log would stop replaying to the same
    admitted set."""
    findings: List[Finding] = []
    for mod, fn in _reach(mods, ADMISSION_SEED_CLASSES,
                          ADMISSION_SEED_FUNCS):
        findings.extend(_wallclock_findings(mod, fn, "R008"))
    return findings


# ---------------------------------------------------------------------------
# R004: host-sync hygiene in traced functions

#: attribute reads on a tensor that are static metadata, not values
_STATIC_ATTRS = {"dtype", "shape", "ndim", "device", "size", "dim", "numel",
                 "is_cuda"}


def _transform(call: ast.Call) -> bool:
    """True if ``call`` is a torch.func transform (``vmap``, ``grad``,
    ``grad_and_value``, ``jacrev``, ``jvp``; bare or as ``torch.func.X``
    / ``torch.X``) or ``torch.compile`` of a function."""
    f = call.func
    name = _callee(f)
    if name not in TRACING_TRANSFORMS:
        return False
    chain = _safe_unparse(f)
    if name == "compile":
        return chain == "torch.compile"
    return isinstance(f, ast.Name) or (
        chain.startswith(("torch.", "func.")) and "autograd" not in chain)


def _decorator_traces(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        return _transform(dec) or _decorator_traces(dec.func)
    text = _safe_unparse(dec)
    return text == "torch.compile" or bool(
        isinstance(dec, (ast.Name, ast.Attribute))
        and _callee(dec) in TRACING_TRANSFORMS and _callee(dec) != "compile"
        and "autograd" not in text)


def _collect_traced(mod: Module, methods: Dict[str, List[ast.AST]]
                    ) -> List[ast.AST]:
    """Functions (and lambdas) of ``mod`` traced by a transform: those
    decorated with one, and those a transform call takes — a local name,
    a lambda, or ``x.method`` (any method of that name in the scan set,
    which ``methods`` indexes)."""
    fns: Dict[str, ast.AST] = {}
    for fn, _cls in _iter_functions(mod.tree):
        fns[fn.name] = fn
    traced: List[ast.AST] = []
    seen: Set[ast.AST] = set()

    def add(fn):
        if fn not in seen:
            seen.add(fn)
            traced.append(fn)

    for fn, _cls in _iter_functions(mod.tree):
        if any(_decorator_traces(d) for d in fn.decorator_list):
            add(fn)
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call) and _transform(node)
                and node.args):
            continue
        target = node.args[0]
        if isinstance(target, ast.Name) and target.id in fns:
            add(fns[target.id])
        elif isinstance(target, ast.Lambda):
            add(target)
        elif isinstance(target, ast.Attribute):
            for fn in methods.get(target.attr, ()):
                add(fn)
    return traced


def _method_index(mods: Sequence[Module]) -> Dict[str, List[Tuple[Module,
                                                                  ast.AST]]]:
    out: Dict[str, List[Tuple[Module, ast.AST]]] = {}
    for mod in mods:
        for fn, cls in _iter_functions(mod.tree):
            if cls is not None:
                out.setdefault(fn.name, []).append((mod, fn))
    return out


def check_r004(mods: Sequence[Module]) -> List[Finding]:
    index = _method_index(mods)
    owner = {fn: mod for entries in index.values() for mod, fn in entries}
    methods = {name: [fn for _m, fn in entries]
               for name, entries in index.items()}
    findings: List[Finding] = []
    for mod in mods:
        for fn in _collect_traced(mod, methods):
            findings.extend(_traced_findings(owner.get(fn, mod), fn))
    return findings


def _traced_findings(mod: Module, fn: ast.AST) -> List[Finding]:
    findings: List[Finding] = []
    if isinstance(fn, ast.Lambda):
        params = {a.arg for a in fn.args.args}
        body_nodes = [fn.body]
        fname = "<lambda>"
    else:
        params = {a.arg for a in
                  fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs}
        body_nodes = fn.body
        fname = fn.name
    traced_params = params - {"self", "cls"}

    def traced_use(expr) -> Optional[ast.Name]:
        """A bare load of a traced param that is not static metadata."""
        static_heads: Set[ast.AST] = set()
        for n in ast.walk(expr):
            if (isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS
                    and isinstance(n.value, ast.Name)):
                static_heads.add(n.value)
            elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and n.func.id in ("len", "isinstance", "getattr",
                                    "hasattr", "type")):
                for sub in ast.walk(n):
                    if isinstance(sub, ast.Name):
                        static_heads.add(sub)
        for n in ast.walk(expr):
            if (isinstance(n, ast.Name) and n.id in traced_params
                    and n not in static_heads):
                return n
        return None

    for body in body_nodes:
        for node in ast.walk(body):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in HOST_SYNC_METHODS
                    and not node.args and not node.keywords):
                findings.append(Finding(
                    mod.path, node.lineno, node.col_offset, "R004",
                    f".{node.func.attr}() host sync inside traced function "
                    f"{fname!r}", fix_hint("R004")))
            elif (isinstance(node, ast.Call)
                  and _safe_unparse(node.func) == "torch.cuda.synchronize"):
                findings.append(Finding(
                    mod.path, node.lineno, node.col_offset, "R004",
                    f"torch.cuda.synchronize() inside traced function "
                    f"{fname!r}", fix_hint("R004")))
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id in ("float", "int", "bool")
                  and len(node.args) == 1):
                hit = traced_use(node.args[0])
                if hit is not None:
                    findings.append(Finding(
                        mod.path, node.lineno, node.col_offset, "R004",
                        f"{node.func.id}({hit.id}) pulls a traced value to "
                        f"the host inside {fname!r}", fix_hint("R004")))
            elif isinstance(node, (ast.If, ast.While)):
                hit = traced_use(node.test)
                if hit is not None:
                    findings.append(Finding(
                        mod.path, node.lineno, node.col_offset, "R004",
                        f"Python branching on traced value {hit.id!r} "
                        f"inside {fname!r}", fix_hint("R004")))
    return findings


# ---------------------------------------------------------------------------
# R005: EventLog internals owned by core/events.py

_LIST_MUTATORS = {"append", "extend", "insert", "pop", "remove",
                  "clear", "sort", "reverse"}


def check_r005(mod: Module) -> List[Finding]:
    if mod.rel.endswith(EVENTLOG_OWNER_MODULE):
        return []
    findings: List[Finding] = []
    for fn, _cls in _iter_functions(mod.tree):
        aliases: Set[str] = set()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "_events"):
                aliases.add(node.targets[0].id)

        def events_obj(expr) -> bool:
            if isinstance(expr, ast.Attribute) and expr.attr == "_events":
                return True
            return isinstance(expr, ast.Name) and expr.id in aliases

        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if events_obj(base) and not (
                            isinstance(t, ast.Name) and isinstance(
                                node, ast.Assign)):
                        findings.append(Finding(
                            mod.path, node.lineno, node.col_offset, "R005",
                            "direct mutation of EventLog._events outside "
                            "core/events.py", fix_hint("R005")))
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _LIST_MUTATORS and events_obj(f.value)):
                    findings.append(Finding(
                        mod.path, node.lineno, node.col_offset, "R005",
                        f"_events.{f.attr}(...) outside core/events.py",
                        fix_hint("R005")))
                elif (isinstance(f, ast.Attribute) and f.attr == "__setattr__"
                      and isinstance(f.value, ast.Name)
                      and f.value.id == "object" and len(node.args) >= 2
                      and _const_str(node.args[1]) in ("seq", "time")):
                    findings.append(Finding(
                        mod.path, node.lineno, node.col_offset, "R005",
                        f"object.__setattr__(_, {_const_str(node.args[1])!r}, "
                        f"...) renumbers an event outside core/events.py",
                        fix_hint("R005")))
    return findings


# ---------------------------------------------------------------------------
# driver


def _collect_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for base, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(base, f)
                       for f in sorted(files) if f.endswith(".py"))
    return sorted(set(out))


def _parse_all(paths: Sequence[str]) -> Tuple[List[Module], List[Finding]]:
    mods: List[Module] = []
    errors: List[Finding] = []
    for path in _collect_files(paths):
        mod, err = _parse_module(path)
        if err is not None:
            errors.append(err)
        else:
            mods.append(mod)
    return mods, errors


def kernel_ops(paths: Sequence[str]) -> Dict[str, List[str]]:
    """op -> sorted impls of every factory op R002 sees under ``paths``."""
    mods, _ = _parse_all(paths)
    return {op: sorted(reg.impls)
            for op, reg in sorted(kernel_registrations(mods).items())}


def scan(paths: Sequence[str]) -> Tuple[List[Finding], int]:
    """Lint ``paths``; returns (unsuppressed findings, n_suppressed)."""
    mods, findings = _parse_all(paths)
    by_path = {m.path: m for m in mods}
    for mod in mods:
        findings.extend(check_r001(mod))
        findings.extend(check_r005(mod))
    findings.extend(check_r002(mods))
    findings.extend(check_r003(mods))
    findings.extend(check_r004(mods))
    findings.extend(check_r008(mods))
    # dedupe by site+rule (several R003 seeds can reach one call site)
    seen_sites: Set[Tuple[str, int, int, str]] = set()
    unique: List[Finding] = []
    for f in findings:
        site = (f.file, f.line, f.col, f.rule)
        if site not in seen_sites:
            seen_sites.add(site)
            unique.append(f)
    findings = unique
    kept: List[Finding] = []
    n_sup = 0
    for f in findings:
        mod = by_path.get(f.file)
        if f.rule != "R000" and mod is not None and mod.suppressed(f.rule, f.line):
            n_sup += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    return kept, n_sup


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint",
        description="invariant-aware static checker for the port (rules "
                    "R001-R005 + R008; see docs/ANALYSIS_TORCH.md)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write machine-readable findings to FILE")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-finding output (exit status only)")
    ns = ap.parse_args(argv)
    findings, n_sup = scan(ns.paths)
    if not ns.quiet:
        for f in findings:
            print(f.render())
        ops = kernel_ops(ns.paths)
        print(f"repro-lint: {len(findings)} finding(s)"
              f" ({n_sup} suppressed); R002 saw {len(ops)} kernel op(s)"
              f"{': ' + ', '.join(ops) if ops else ''}", file=sys.stderr)
    if ns.json:
        with open(ns.json, "w", encoding="utf-8") as fh:
            json.dump({"version": 1,
                       "n_findings": len(findings),
                       "n_suppressed": n_sup,
                       "findings": [f.to_dict() for f in findings]}, fh,
                      indent=2)
            fh.write("\n")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
