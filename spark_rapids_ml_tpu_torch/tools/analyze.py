"""srml-check for the PyTorch port: the AST analyzer of its contracts.

The port's copy of ``spark_rapids_ml_tpu/tools/analyze.py``, with its rules
remapped to what the port promises: ``_DEVICE_LOCK`` single-files the
daemon's device work and is the innermost lock, nothing blocks the host
under it (an ``nvcc`` build above all), folds are bitwise, ack fields may
only be added, every hand-written kernel keeps its plain version, launch
counter and kernel-ledger record, and the port imports nothing of JAX. It
parses the package with ``ast``, builds the same interprocedural engine as
the JAX tool (:class:`CallGraph`: module-qualified resolution of
``self.``/module/imported names, method dispatch by attribute name over
known classes, bounded by a generic-name skiplist, receiver↔class affinity
and import visibility) with its three fixpoints — may-block (with witness
chains down to the blocking primitive), holds-lock (locks possibly held at
function entry) and thread-reachability — and runs the rules over it.

Where the JAX tool reads jit handles, this one reads the **kernel entry
points** (:class:`KernelRegistry`): the functions of ``ops/kernels.py``
that open a ``_ledger("<name>", route, ...)`` record and reach a library
loader (a function there that calls ``_build.load``: ``_lib``,
``_kmeans_lib``, ``_knn_lib``), directly or through a helper of the same
module.

Rule catalog:

Lock discipline:
  ``device-lock``          in serve/daemon.py and serve/scheduler.py, every
                           call to a kernel entry point, to
                           ``torch.cuda.synchronize`` or to an upload to the
                           device (``.to(<device>)``, ``.cuda()``,
                           ``torch.as_tensor``/``torch.tensor`` with a
                           ``device=``) sits lexically under
                           ``with _DEVICE_LOCK``, and so does every call
                           that leaves these modules for a function that
                           reaches one of them without taking the lock
                           itself (with the call-chain witness);
                           ``*_locked`` helpers are called with the lock
                           held (the caller-holds-the-lock convention).
  ``compile-outside-lock`` no call to the compile path — ``_build.build``,
                           ``_build.build_all``, ``_build.load`` and the
                           library loaders — under ``_DEVICE_LOCK`` in the
                           device modules: an ``nvcc`` build is host work of
                           seconds.
  ``lock-order``           ``_DEVICE_LOCK`` is innermost by contract:
                           lexically acquiring any other lock under it is a
                           deadlock hazard.
  ``lock-graph-cycle``     whole-program lock-order graph over every named
                           lock (edges from lexical nesting AND from call
                           paths that enter a function with a lock held);
                           any cycle is a finding.
  ``blocking-under-device-lock``
                           no transitively blocking call (socket I/O, sleep,
                           future/event waits, subprocess, lock contention)
                           while ``_DEVICE_LOCK`` is held. Two encoded
                           exemptions: blocking on the DEVICE is the lock's
                           purpose (``torch.cuda.synchronize`` and kernel
                           launches are not blocking primitives here), and
                           a library loader PRIMED AT DAEMON START — one
                           that a ``start`` method of serve/daemon.py calls
                           with no lock held, through serve/daemon.py and
                           ops/kernels.py alone — returns its cached library
                           and builds nothing afterwards, so the ``nvcc``
                           chain below it does not propagate.

Threading:
  ``thread-shared-state``  writes to ``self.*``/module globals reachable
                           from ``threading.Thread``/``Timer`` targets with
                           no lock held anywhere on the access path
                           (serve/ and parallel/).

Determinism (over ops/, models/, parallel/ and the daemon's fold paths):
  ``unsorted-iter``        iterating an un-``sorted()`` dict/set.
  ``wallclock-entropy``    ``time.time``, ``random.*``, unseeded
                           ``np.random.*`` and torch's global RNG
                           (``torch.rand*``/``randn``/... without
                           ``generator=``).

Wire contract (the 28 ops of docs/protocol.md, which is read, never
written):
  ``wire-op-clamp``        every op string the daemon dispatches is in
                           ``_KNOWN_OPS`` and docs/protocol.md.
  ``ack-contract``         ack-dict fields may only be added, never removed,
                           versus the port's snapshot
                           (tools/analyze_contract.json).
  ``wire-schema``          per-op request/ack field schemas may only GROW
                           versus that snapshot, and every op keeps its
                           ``### <op>`` docs/protocol.md entry.

Hygiene and the port's ground rules:
  ``bare-print``           no ``print(`` in library code (tools/ and
                           ``__main__`` tails exempt).
  ``bare-collective``      no ``torch.distributed`` collective or
                           point-to-point call (``all_reduce``,
                           ``all_gather``, ``broadcast``, ``reduce_scatter``,
                           ``send``/``recv``, ``isend``/``irecv``,
                           ``batch_isend_irecv``, ``barrier``, ...) outside
                           parallel/.
  ``socket-timeout``       every ``socket.create_connection`` passes an
                           explicit timeout.
  ``kernel-ledger``        the counterpart of the JAX ``jit-ledger``: each
                           kernel launch in ops/kernels.py sits under
                           ``with _ledger("<name>", route, ...)`` with a
                           constant name launched from ONE place, bumps
                           ``LAUNCHES["<name>"]`` (a key of the module's
                           ``LAUNCHES``), has ``<name>_plain`` beside it,
                           and, when its route is computed (more than one
                           body), bumps ``ROUTES[f"<name>/{route}"]``.
  ``hot-path-span``        model fit_*/transform_matrix/kneighbors run under
                           the port's ``trace_span``.
  ``no-jax-import``        no module of the port imports ``jax``,
                           ``jaxlib`` or ``spark_rapids_ml_tpu``.
  ``kernel-fallback``      in ops/ and models/, no ``except`` handler around
                           a kernel launch calls a ``*_plain`` version: a
                           CUDA tensor launches or raises.

``_DEVICE_LOCK`` as the innermost lock (the port's ground rule) is
``lock-order``'s. The JAX tool's ``use-after-donate`` has no counterpart:
the port donates nothing. Its streaming folds write the state IN PLACE
(``ops/gram.py``, ``kernels.gram_colsum``/``linreg_stats`` with
``state=``), so every name stays valid after a fold and holds the folded
value; the wrappers check the state's dtype, shape, device and layout at
run time.

Suppression: an inline ``# srml: disable=<rule>[,<rule>...]`` pragma on the
finding's line suppresses it (give the reason on the same or the previous
line); accepted findings live in tools/analyze_baseline.json keyed by
(rule, file, enclosing symbol, count), so they survive line drift. The
baseline is empty: the gate is "zero unsuppressed findings", and entries
that no longer match anything are reported as stale.

CLI::

    python -m spark_rapids_ml_tpu_torch.tools.analyze            # human output
    python -m spark_rapids_ml_tpu_torch.tools.analyze --json     # machine output
    python -m spark_rapids_ml_tpu_torch.tools.analyze --rule device-lock
    python -m spark_rapids_ml_tpu_torch.tools.analyze --write-baseline
    python -m spark_rapids_ml_tpu_torch.tools.analyze --write-contract
    python -m spark_rapids_ml_tpu_torch.tools.analyze --changed-only HEAD

Exit status: 0 = zero unsuppressed findings, 1 = findings, 2 = usage.
This module imports only the standard library (no torch, no jax, nothing
of either package), so it runs in seconds anywhere.
"""

from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

PKG_ROOT = Path(__file__).resolve().parent.parent
REPO_ROOT = PKG_ROOT.parent
BASELINE_PATH = Path(__file__).resolve().parent / "analyze_baseline.json"
CONTRACT_PATH = Path(__file__).resolve().parent / "analyze_contract.json"

#: Modules whose device dispatch must single-file through _DEVICE_LOCK.
DEVICE_MODULES = ("serve/daemon.py", "serve/scheduler.py")
#: Directories under the bitwise-determinism contract (identical inputs
#: must fold to identical bits on every host/process).
BITWISE_DIRS = ("ops", "models", "parallel")
#: Daemon/scheduler function-name fragments that put a function on the
#: fold/merge path (the daemon's slice of the bitwise contract).
FOLD_NAME_FRAGMENTS = ("merge", "fold", "reduce", "finalize", "commit", "step")
#: The module of the kernel wrappers (their entry points, loaders, plain
#: versions and counters) and the module that builds their libraries.
KERNELS_MODULE = "ops/kernels.py"
BUILD_MODULE = "ops/_build.py"
#: The build module's compile path: each may run ``nvcc``.
BUILD_FUNCS = ("build", "build_all", "load")
#: The ten kernels of the JAX package's ``ops/pallas_kernels.py``: a
#: whole-tree run expects at least this many launch sites.
MIN_KERNELS = 10
#: Import roots the port never loads.
FORBIDDEN_ROOTS = ("jax", "jaxlib", "spark_rapids_ml_tpu")

_PRAGMA_RE = re.compile(r"#\s*srml:\s*disable=([a-z0-9_,\- ]+)")


# ---------------------------------------------------------------------------
# findings, pragmas, baseline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One rule violation: id, location, enclosing symbol, one-line why.

    ``family`` groups rules for machine consumers (lock/
    determinism/wire/threads/hygiene/ledger); ``chain`` is the call-chain
    witness for interprocedural findings — the path from the reported
    site (e.g. a lock acquisition) to the primitive that makes it a
    violation (e.g. a socket recv three calls deep), as
    ``(file, line, note)`` hops. Both are display/JSON payload only:
    baseline keying stays (rule, file, symbol) so accepted findings
    survive chain drift."""

    rule: str
    file: str
    line: int
    symbol: str
    message: str
    family: str = ""
    chain: Tuple[Tuple[str, int, str], ...] = ()

    def format(self) -> str:
        head = f"{self.file}:{self.line}: [{self.rule}] {self.message} (in {self.symbol})"
        for file, line, note in self.chain:
            head += f"\n    via {file}:{line}: {note}"
        return head

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "family": self.family,
            "file": self.file,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "chain": [
                {"file": f, "line": l, "note": n} for f, l, n in self.chain
            ],
        }


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.format() for f in findings)


class Baseline:
    """Accepted legacy findings, keyed (rule, file, symbol) with a count.

    Keying by enclosing symbol instead of line number survives unrelated
    edits above the finding; the count bounds how many findings of one
    rule a symbol may carry, so NEW findings in an already-baselined
    function still fail. ``stale()`` reports entries whose code is gone —
    the baseline is a ratchet and must only ever shrink.
    """

    def __init__(self, entries: Optional[Sequence[Dict[str, Any]]] = None):
        self.entries: Dict[Tuple[str, str, str], int] = {}
        for e in entries or []:
            key = (str(e["rule"]), str(e["file"]), str(e["symbol"]))
            self.entries[key] = self.entries.get(key, 0) + int(e.get("count", 1))
        self._matched: Dict[Tuple[str, str, str], int] = {}

    @classmethod
    def load(cls, path: Path = BASELINE_PATH) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        return cls(data.get("entries", []))

    @classmethod
    def from_findings(cls, findings: Sequence[Finding]) -> "Baseline":
        b = cls()
        for f in findings:
            key = (f.rule, f.file, f.symbol)
            b.entries[key] = b.entries.get(key, 0) + 1
        return b

    def as_json(self) -> str:
        entries = [
            {"rule": r, "file": fp, "symbol": s, "count": c}
            for (r, fp, s), c in sorted(self.entries.items())
        ]
        return json.dumps({"version": 1, "entries": entries}, indent=2) + "\n"

    def suppresses(self, f: Finding) -> bool:
        key = (f.rule, f.file, f.symbol)
        if self._matched.get(key, 0) < self.entries.get(key, 0):
            self._matched[key] = self._matched.get(key, 0) + 1
            return True
        return False

    def stale(self) -> List[str]:
        """Entries (or counts) that matched nothing in the last run."""
        out = []
        for key, cap in sorted(self.entries.items()):
            used = self._matched.get(key, 0)
            if used < cap:
                rule, fp, sym = key
                out.append(
                    f"stale baseline entry: {rule} in {fp} ({sym}) — "
                    f"{cap - used} of {cap} accepted finding(s) no longer "
                    "exist; shrink tools/analyze_baseline.json"
                )
        return out


# ---------------------------------------------------------------------------
# module model
# ---------------------------------------------------------------------------


#: Memoized parse results keyed by (relpath, source hash): the real tree
#: is parsed by several independent Projects per pytest run (the
#: engine gate, the lint invokers, seeded-violation scratch copies that
#: share every unchanged file) and re-parsing ~100 modules each time is
#: the analyzer's single biggest cost. Parent-link stamping is
#: idempotent, so sharing one tree across Module instances is safe —
#: rules only ever READ the AST.
_AST_CACHE: Dict[Tuple[str, int, int], ast.AST] = {}
_AST_CACHE_MAX = 512


def _parse_cached(relpath: str, source: str) -> ast.AST:
    import zlib

    key = (relpath, len(source), zlib.crc32(source.encode()))
    tree = _AST_CACHE.get(key)
    if tree is None:
        tree = ast.parse(source, filename=relpath)
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                child._srml_parent = parent  # type: ignore[attr-defined]
        if len(_AST_CACHE) >= _AST_CACHE_MAX:
            _AST_CACHE.clear()  # tests churn tiny fixtures; bound growth
        _AST_CACHE[key] = tree
    return tree


class Module:
    """One parsed source file plus the lazy per-line pragma map."""

    def __init__(self, relpath: str, source: str, display_path: Optional[str] = None):
        self.relpath = relpath.replace("\\", "/")
        self.source = source
        self.display_path = display_path or self.relpath
        self.tree = _parse_cached(self.relpath, source)
        self.lines = source.split("\n")
        self._pragmas: Optional[Dict[int, Set[str]]] = None

    @property
    def pragmas(self) -> Dict[int, Set[str]]:
        if self._pragmas is None:
            self._pragmas = {}
            for i, line in enumerate(self.lines, start=1):
                m = _PRAGMA_RE.search(line)
                if m:
                    rules = {p.strip() for p in m.group(1).split(",") if p.strip()}
                    self._pragmas[i] = rules
        return self._pragmas

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self.pragmas.get(line)
        return rules is not None and (rule in rules or "all" in rules)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = getattr(node, "_srml_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_srml_parent", None)

    def enclosing_symbol(self, node: ast.AST) -> str:
        parts = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(anc.name)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.insert(0, node.name)
        return ".".join(reversed(parts)) or "<module>"


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def dotted_name(expr: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(expr: ast.AST) -> Optional[str]:
    """The last identifier of a call target: ``x`` for ``a.b.x`` or ``x``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def const_str(expr: ast.AST) -> Optional[str]:
    """Constant-fold an expression to a string where statically possible —
    plain constants, ``"a" + "b"`` concatenation, and constant-only
    f-strings — so wire-op strings cannot dodge the clamp by being built
    instead of written (the hole the old regex gate had)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left, right = const_str(expr.left), const_str(expr.right)
        if left is not None and right is not None:
            return left + right
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue):
                inner = const_str(v.value)
                if inner is None:
                    return None
                parts.append(inner)
            else:
                return None
        return "".join(parts)
    return None


_LOCKISH_RE = re.compile(r"(_lock$|_LOCK$|^lock$|^_cv$|_cond$)")


def lock_name(expr: ast.AST) -> Optional[str]:
    """Normalized lock identity of a ``with`` context expression, or None
    when it does not look like a lock. ``self._models_lock`` →
    ``_models_lock``; ``_DEVICE_LOCK`` → ``_DEVICE_LOCK``."""
    name = terminal_name(expr)
    if name is not None and _LOCKISH_RE.search(name):
        return name
    return None


def in_main_guard(mod: Module, node: ast.AST) -> bool:
    """True when the node sits under ``if __name__ == "__main__":``."""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.If):
            for sub in ast.walk(anc.test):
                if isinstance(sub, ast.Name) and sub.id == "__name__":
                    return True
    return False


def iter_functions(mod: Module) -> Iterator[ast.AST]:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def held_locks(mod: Module, node: ast.AST) -> List[str]:
    """Locks lexically held at ``node``, outermost first (item order of a
    multi-item ``with A, B:`` preserved) — the resolved ``with``-stack
    WITHIN the node's own function. The walk stops at the first function
    boundary: a closure defined under ``with _DEVICE_LOCK`` runs later,
    when the lock is long released, so an enclosing function's ``with``
    must not read as held inside the closure."""
    withs: List[ast.With] = []
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            break
        if isinstance(anc, ast.With):
            withs.append(anc)
    stack: List[str] = []
    for w in reversed(withs):  # outermost with first, items left-to-right
        for item in w.items:
            ln = lock_name(item.context_expr)
            if ln is not None:
                stack.append(ln)
    return stack


# ---------------------------------------------------------------------------
# import resolution
# ---------------------------------------------------------------------------


def _pkg_module_relpath(dotted: str, known: Set[str]) -> Optional[str]:
    """``spark_rapids_ml_tpu_torch.ops.gram`` (or ``ops.gram``) → the
    project relpath ``ops/gram.py`` when that module is in the analyzed
    set."""
    parts = dotted.split(".")
    for start in range(len(parts)):
        rel = "/".join(parts[start:]) + ".py"
        if rel in known:
            return rel
    return None


def module_aliases(mod: Module, known_mods: Set[str]) -> Dict[str, str]:
    """Import aliases that name whole analyzed modules:
    ``from spark_rapids_ml_tpu_torch.ops import gram as gram_ops`` →
    ``{"gram_ops": "ops/gram.py"}``."""
    out: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                src = _pkg_module_relpath(
                    f"{node.module}.{alias.name}", known_mods
                )
                if src is not None:
                    out[alias.asname or alias.name] = src
        elif isinstance(node, ast.Import):
            for alias in node.names:
                src = _pkg_module_relpath(alias.name, known_mods)
                if src is not None:
                    out[alias.asname or alias.name.split(".")[-1]] = src
    return out


def _enclosing_function(mod: Module, node: ast.AST) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _enclosing_class(mod: Module, node: ast.AST) -> Optional[ast.ClassDef]:
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.ClassDef):
            return anc
    return None


# ---------------------------------------------------------------------------
# interprocedural engine: whole-package call graph + dataflow fixpoints
# ---------------------------------------------------------------------------
#
# The per-function lexical rules above can see a blocking call only when
# it sits in the same function as the lock that makes it dangerous. The
# package's real hazards cross call edges: `finalize()` holds
# `_DEVICE_LOCK` and delegates to `_finalize_locked()`, which delegates
# again before anything touches a socket. This section builds the
# whole-package call graph (module-qualified resolution of `self.` /
# module / imported names, plus method dispatch by attribute name over
# known classes) and runs the dataflow fixpoints the interprocedural
# rule families consume: MAY-BLOCK (does calling this function possibly
# block on socket/sleep/future/subprocess/lock-acquire?), HOLDS-LOCK
# (which locks may be held when this function is entered?), and
# THREAD-REACHABILITY (can a `threading.Thread` target reach this
# function, and does some path arrive with no lock held?).
#
# Honesty: resolution is name-based, not type-based. `self.m()` resolves within the enclosing
# class (plus by-name base classes); `alias.f()` resolves through
# import aliases; a bare `obj.m()` falls back to EVERY known class
# method named `m` — an over-approximation bounded by the generic-name
# skiplist below. Calls through variables holding functions, getattr,
# and callbacks are invisible.
#
# One port-specific fact joins the fixpoints: the library loaders PRIMED
# at daemon start (see _primed_loaders). A primed loader returns its
# cached library, so the nvcc chain below it does not make its callers
# block.

#: Attribute names too generic for by-name method dispatch: linking
#: `d.get(...)` to every class that defines `get` would wire the graph
#: to dict/set/list/logger/metrics traffic and drown the dataflow in
#: false edges. `self.`/`cls.` receivers bypass this list (their class
#: is known).
_GENERIC_ATTR_SKIP = frozenset((
    "get", "set", "add", "pop", "popleft", "append", "appendleft",
    "extend", "remove", "discard", "clear", "copy", "update", "items",
    "keys", "values", "sort", "index", "count", "insert", "reverse",
    "join", "split", "strip", "format", "encode", "decode", "read",
    "write", "readline", "flush", "open",
    "inc", "dec", "observe", "info", "debug", "warning", "error",
    "exception", "log", "search", "match", "group", "findall", "sub",
    "put", "send", "recv", "close", "acquire", "release", "wait",
    "notify", "notify_all", "result", "done", "cancel", "start",
))


@dataclass
class FuncNode:
    """One function/method in the analyzed set."""

    mod: Module
    fn: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str  # e.g. "Daemon._op_feed" / "fit_streaming"
    cls: Optional[str]  # enclosing class name, None for module level

    @property
    def key(self) -> Tuple[str, str]:
        return (self.mod.relpath, self.qualname)

    @property
    def name(self) -> str:
        return self.fn.name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{self.mod.relpath}:{self.qualname}>"


@dataclass
class CallSite:
    """One resolved call edge: caller → callee at a source location,
    with the lock stack lexically held at the call expression."""

    caller: Tuple[str, str]
    callee: Tuple[str, str]
    mod: Module
    call: ast.Call
    held: Tuple[str, ...]  # lexical lock ids at the call site


def _lock_id(mod: Module, name: str) -> str:
    """Lock identity for the whole-program lock graph. `_DEVICE_LOCK` is
    the one process-global lock shared across modules; everything else
    is scoped per module (the existing lock-order convention) — two
    `self._lock`s in different files never alias, at the cost of not
    linking one lock object passed across modules (documented)."""
    if name == "_DEVICE_LOCK":
        return "_DEVICE_LOCK"
    return f"{mod.relpath}:{name}"


class CallGraph:
    """Whole-package call graph + the fixpoint dataflow facts."""

    #: Fixpoint iteration cap (outer sweeps). Every fact domain here is
    #: finite and monotone, so convergence is guaranteed in at most
    #: O(nodes) sweeps; the cap is a backstop against a future
    #: non-monotone edit looping forever — hitting it is itself a
    #: diagnostic (a loud note, surfaced by the CLI and the perf gate).
    MAX_FIXPOINT_SWEEPS = 64

    def __init__(self, project: "Project"):
        self.project = project
        self.nodes: Dict[Tuple[str, str], FuncNode] = {}
        #: method name → nodes (methods only), for attr-name dispatch
        self.methods_by_name: Dict[str, List[FuncNode]] = {}
        #: (relpath, class) → {method name → node}
        self.class_methods: Dict[Tuple[str, str], Dict[str, FuncNode]] = {}
        #: (relpath, class) → base class names (unresolved strings)
        self.class_bases: Dict[Tuple[str, str], List[str]] = {}
        #: relpath → {module-level def name → node}
        self.module_funcs: Dict[str, Dict[str, FuncNode]] = {}
        #: relpath → {imported name → (src relpath, src name)}
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: relpath → {alias → module relpath} (whole-module imports)
        self.module_aliases: Dict[str, Dict[str, str]] = {}
        #: relpath → every analyzed module it imports anything from
        self.module_imports: Dict[str, Set[str]] = {}
        #: (relpath, id(enclosing fn node)) → {nested def name → node}
        self.local_defs: Dict[Tuple[str, int], Dict[str, FuncNode]] = {}
        #: caller key → outgoing call sites (resolved edges only)
        self.calls_out: Dict[Tuple[str, str], List[CallSite]] = {}
        #: callee key → incoming call sites
        self.calls_in: Dict[Tuple[str, str], List[CallSite]] = {}
        self.notes: List[str] = []
        self._index()
        self._link()
        #: the library loaders of ops/kernels.py, and those a daemon's
        #: start() primes (their nvcc chain is exempt from may-block)
        self.loaders: Set[Tuple[str, str]] = self._loaders()
        self.primed_loaders: Set[Tuple[str, str]] = self._primed_loaders()
        # dataflow facts, computed by _solve()
        self.may_block: Dict[Tuple[str, str], Tuple[Tuple[str, str, int, str], ...]] = {}
        self.entered_holding: Dict[Tuple[str, str], Set[str]] = {}
        self.thread_entries: List[Tuple[FuncNode, Module, ast.AST]] = []
        self.thread_reachable: Set[Tuple[str, str]] = set()
        self.unlocked_reachable: Set[Tuple[str, str]] = set()
        self._solve()

    # -- indexing ----------------------------------------------------------

    def _index(self) -> None:
        known = self.project._known_mods
        for mod in self.project.modules:
            mf = self.module_funcs.setdefault(mod.relpath, {})
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = mod.enclosing_symbol(node)
                    cls = _enclosing_class(mod, node)
                    fn = FuncNode(mod, node, qual, cls.name if cls else None)
                    self.nodes[fn.key] = fn
                    encl = _enclosing_function(mod, node)
                    if encl is not None:
                        # a nested def is NOT a method/module function:
                        # it resolves only through its enclosing scope
                        # (resolve_call's local-def lookup)
                        self.local_defs.setdefault(
                            (mod.relpath, id(encl)), {}
                        ).setdefault(node.name, fn)
                        continue
                    if cls is not None:
                        cm = self.class_methods.setdefault(
                            (mod.relpath, cls.name), {}
                        )
                        # first def wins (conditional redefs are rare)
                        cm.setdefault(node.name, fn)
                        self.methods_by_name.setdefault(node.name, []).append(fn)
                    else:
                        mf.setdefault(node.name, fn)
                elif isinstance(node, ast.ClassDef):
                    bases = [
                        terminal_name(b) for b in node.bases
                        if terminal_name(b) is not None
                    ]
                    self.class_bases[(mod.relpath, node.name)] = bases
            # import resolution (functions by name, modules by alias)
            imports: Dict[str, Tuple[str, str]] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ImportFrom) and node.module:
                    src = _pkg_module_relpath(node.module, known)
                    if src is None:
                        continue
                    for alias in node.names:
                        imports[alias.asname or alias.name] = (src, alias.name)
            self.from_imports[mod.relpath] = imports
            self.module_aliases[mod.relpath] = module_aliases(mod, known)
            self.module_imports[mod.relpath] = {
                src for src, _name in imports.values()
            } | set(self.module_aliases[mod.relpath].values())

    def _method_in_class(
        self, relpath: str, cls: str, name: str, _seen: Optional[Set] = None
    ) -> Optional[FuncNode]:
        """Method lookup through the by-name MRO: the class itself, then
        base classes resolved within the module (or through imports)."""
        seen = _seen if _seen is not None else set()
        if (relpath, cls) in seen:
            return None
        seen.add((relpath, cls))
        fn = self.class_methods.get((relpath, cls), {}).get(name)
        if fn is not None:
            return fn
        for base in self.class_bases.get((relpath, cls), []):
            base_rel = relpath
            base_name = base
            # an imported base resolves to its ORIGINAL name in the
            # source module, not the local alias it was imported under
            imp = self.from_imports.get(relpath, {}).get(base)
            if imp is not None:
                base_rel, base_name = imp[0], imp[1]
            fn = self._method_in_class(base_rel, base_name, name, seen)
            if fn is not None:
                return fn
        return None

    def resolve_call(
        self, mod: Module, caller_fn: Optional[ast.AST], call: ast.Call
    ) -> List[FuncNode]:
        """Every FuncNode this call may enter (empty = external/opaque)."""
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            # nearest enclosing function's directly-nested defs first
            scope = caller_fn
            while scope is not None:
                local = self.local_defs.get((mod.relpath, id(scope)), {})
                if name in local:
                    return [local[name]]
                scope = _enclosing_function(mod, scope)
            fn = self.module_funcs.get(mod.relpath, {}).get(name)
            if fn is not None:
                return [fn]
            imp = self.from_imports.get(mod.relpath, {}).get(name)
            if imp is not None:
                target = self.module_funcs.get(imp[0], {}).get(imp[1])
                return [target] if target else []
            return []
        if not isinstance(func, ast.Attribute):
            return []
        name = func.attr
        recv = func.value
        recv_name = terminal_name(recv)
        # self./cls. → the enclosing class's method (by-name MRO)
        if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
            cls = _enclosing_class(mod, call)
            if cls is not None:
                fn = self._method_in_class(mod.relpath, cls.name, name)
                return [fn] if fn else []
            return []
        # module alias → that module's function
        src = self.module_aliases.get(mod.relpath, {}).get(recv_name or "")
        if src is not None:
            target = self.module_funcs.get(src, {}).get(name)
            return [target] if target else []
        # by-name method dispatch over known classes (bounded)
        if name in _GENERIC_ATTR_SKIP:
            return []
        # Visibility: a by-name candidate must live in a module the
        # caller's module is import-related to (either direction — the
        # scheduler never imports daemon.py, but daemon.py imports the
        # scheduler and hands it _ServedModel instances). An object of a
        # class from a module neither side references cannot plausibly
        # be this receiver.
        candidates = [
            c
            for c in self.methods_by_name.get(name, [])
            if c.mod.relpath == mod.relpath
            or c.mod.relpath in self.module_imports.get(mod.relpath, ())
            or mod.relpath in self.module_imports.get(c.mod.relpath, ())
        ]
        # Receiver↔class affinity: `timer.stop()` should dispatch to
        # Timer.stop, not every class that defines a stop() — when the
        # receiver name textually matches some candidate's class name
        # (`self._scheduler` ↔ RequestScheduler, `served` ↔
        # _ServedModel), restrict to the matches; with no match (or a
        # too-short receiver like `m`) keep the full over-approximation.
        if recv_name is not None:
            r = re.sub(r"[^a-z]", "", recv_name.lower())
            if len(r) >= 3:
                hits = []
                for c in candidates:
                    cl = re.sub(r"[^a-z]", "", (c.cls or "").lower())
                    if cl and (r in cl or cl in r):
                        hits.append(c)
                if hits:
                    candidates = hits
        # Never self-dispatch by attribute name: `self.model.kneighbors()`
        # inside _ServedModel.kneighbors is a DIFFERENT object's method —
        # a by-name self-edge would feed the holds-lock fixpoint a
        # fictitious recursion under whatever locks the body holds.
        encl = _enclosing_class(mod, call)
        enc_fn = _enclosing_function(mod, call)
        if encl is not None and enc_fn is not None:
            candidates = [
                c
                for c in candidates
                if not (
                    c.mod.relpath == mod.relpath
                    and c.cls == encl.name
                    and c.fn is enc_fn
                )
            ]
        return candidates

    def _link(self) -> None:
        for key, fn in sorted(self.nodes.items()):
            sites = self.calls_out.setdefault(key, [])
            for node in ast.walk(fn.fn):
                if not isinstance(node, ast.Call):
                    continue
                # a call inside a nested def belongs to the nested node
                if _enclosing_function(fn.mod, node) is not fn.fn:
                    continue
                targets = self.resolve_call(fn.mod, fn.fn, node)
                if not targets:
                    continue
                held = tuple(
                    _lock_id(fn.mod, l) for l in held_locks(fn.mod, node)
                )
                for target in targets:
                    site = CallSite(key, target.key, fn.mod, node, held)
                    sites.append(site)
                    self.calls_in.setdefault(target.key, []).append(site)

    # -- blocking primitives ----------------------------------------------

    _SOCKET_METHODS = frozenset(
        ("recv", "recv_into", "recvfrom", "sendall", "accept", "connect")
    )
    _SOCKETISH_RECV_RE = re.compile(r"(sock|conn)", re.IGNORECASE)
    _SUBPROCESS_CALLS = frozenset(
        ("run", "call", "check_call", "check_output", "communicate")
    )

    @classmethod
    def blocking_primitive(
        cls, mod: Module, call: ast.Call
    ) -> Optional[Tuple[str, str]]:
        """(kind, description) when this very call blocks the thread.

        Kinds: sleep | socket | future | thread-join | subprocess |
        lock-acquire. Device waits (`torch.cuda.synchronize`, a kernel
        launch, a copy off the card) are deliberately NOT here: blocking
        on the device *is the point* of holding `_DEVICE_LOCK`, so
        counting them would flag every legal dispatch (the encoded
        exemption the blocking-under-device-lock rule documents)."""
        dn = dotted_name(call.func)
        name = terminal_name(call.func)
        if dn == "time.sleep" or (name == "sleep" and dn == "sleep"):
            return ("sleep", "time.sleep() blocks the thread")
        if dn == "select.select":
            return ("socket", "select.select() waits on socket readiness")
        if dn == "socket.create_connection" or (
            name == "create_connection"
            and terminal_name(getattr(call.func, "value", ast.Name(id="")))
            == "socket"
        ):
            return ("socket", "socket.create_connection() performs a TCP handshake")
        if isinstance(call.func, ast.Attribute):
            recv = terminal_name(call.func.value)
            if name in cls._SOCKET_METHODS:
                if recv is not None and cls._SOCKETISH_RECV_RE.search(recv):
                    return ("socket", f"{recv}.{name}() is blocking socket I/O")
            if name == "result":
                return ("future", f"{recv or '<expr>'}.result() waits on a future")
            if name == "wait":
                return (
                    "future",
                    f"{recv or '<expr>'}.wait() parks the thread on an "
                    "event/condition",
                )
            if name == "join" and recv is not None and "thread" in recv.lower():
                return ("thread-join", f"{recv}.join() waits for a thread")
            if name in cls._SUBPROCESS_CALLS and recv == "subprocess":
                return ("subprocess", f"subprocess.{name}() waits on a child process")
            if name == "communicate":
                return ("subprocess", f"{recv or '<expr>'}.communicate() waits on a child")
            if name == "acquire":
                ln = lock_name(call.func.value)
                nonblocking = any(
                    kw.arg == "blocking"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in call.keywords
                ) or (
                    call.args
                    and isinstance(call.args[0], ast.Constant)
                    and call.args[0].value is False
                )
                if ln is not None and not nonblocking:
                    return ("lock-acquire", f"{ln}.acquire() blocks on lock contention")
        return None

    # -- the library loaders ------------------------------------------------

    def _loaders(self) -> Set[Tuple[str, str]]:
        """Module-level functions of ops/kernels.py that load a library
        (call ``_build.load``): ``_lib``, ``_kmeans_lib``, ``_knn_lib``."""
        out: Set[Tuple[str, str]] = set()
        for name, fn in self.module_funcs.get(KERNELS_MODULE, {}).items():
            for node in ast.walk(fn.fn):
                if not isinstance(node, ast.Call):
                    continue
                if _enclosing_function(fn.mod, node) is not fn.fn:
                    continue
                dn = dotted_name(node.func) or ""
                targets = self.resolve_call(fn.mod, fn.fn, node)
                if dn.endswith("_build.load") or any(
                    t.key == (BUILD_MODULE, "load") for t in targets
                ):
                    out.add(fn.key)
                    break
        return out

    def _primed_loaders(self) -> Set[Tuple[str, str]]:
        """Loaders a ``start`` method of serve/daemon.py calls with no lock
        held, through serve/daemon.py and ops/kernels.py alone: the daemon
        loads them before it listens, so a later call under
        ``_DEVICE_LOCK`` finds its library cached and builds nothing."""
        seen: Set[Tuple[str, str]] = set()
        work = [
            fn.key
            for (rel, _cls), methods in sorted(self.class_methods.items())
            if rel == "serve/daemon.py"
            for name, fn in sorted(methods.items())
            if name == "start"
        ]
        seen.update(work)
        while work:
            key = work.pop()
            for site in self.calls_out.get(key, ()):
                if site.held or site.callee in seen:
                    continue
                if site.callee[0] not in ("serve/daemon.py", KERNELS_MODULE):
                    continue
                seen.add(site.callee)
                work.append(site.callee)
        return seen & self.loaders

    def blocks(self, key: Tuple[str, str]):
        """The may-block witness of a callee, None for a primed loader."""
        if key in self.primed_loaders:
            return None
        return self.may_block.get(key)

    # -- fixpoints ---------------------------------------------------------

    def _sweep(self, step, what: str) -> None:
        """Run ``step()`` (returns True while anything changed) to
        convergence, capped and LOUD on cap: a hit means the lattice is
        broken and facts may be incomplete — surfaced as a note so CI
        shows it instead of silently under-reporting."""
        for _ in range(self.MAX_FIXPOINT_SWEEPS):
            if not step():
                return
        self.notes.append(
            f"fixpoint cap hit while solving {what} "
            f"({self.MAX_FIXPOINT_SWEEPS} sweeps): dataflow facts may be "
            "incomplete — this is an analyzer bug, report it"
        )

    def _solve(self) -> None:
        # MAY-BLOCK, round 1: seed with direct primitives, propagate up
        # the graph. The witness chain records (file, symbol, line,
        # note) hops from the function's own call down to the primitive.
        for key, fn in sorted(self.nodes.items()):
            for node in ast.walk(fn.fn):
                if not isinstance(node, ast.Call):
                    continue
                if _enclosing_function(fn.mod, node) is not fn.fn:
                    continue
                prim = self.blocking_primitive(fn.mod, node)
                if prim is not None:
                    self.may_block[key] = (
                        (fn.mod.display_path, fn.qualname, node.lineno, prim[1]),
                    )
                    break

        def block_step() -> bool:
            changed = False
            for key in sorted(self.nodes):
                if key in self.may_block:
                    continue
                for site in self.calls_out.get(key, ()):
                    sub = self.blocks(site.callee)
                    if sub is None:
                        continue
                    fn = self.nodes[key]
                    callee = self.nodes[site.callee]
                    hop = (
                        fn.mod.display_path,
                        fn.qualname,
                        site.call.lineno,
                        f"calls {callee.qualname}()",
                    )
                    self.may_block[key] = (hop,) + sub
                    changed = True
                    break
            return changed

        self._sweep(block_step, "may-block")

        # MAY-BLOCK, round 2: contended `with <lock>:` acquisitions.
        # A lock acquisition is the codebase's universal blocking
        # spelling, but flagging EVERY `with lock:` would drown the
        # rules in micro-critical-sections (config.get's registry lock
        # is held for a dict read). The honest middle: a lock is
        # LONG-HELD when some holder's `with` body itself transitively
        # blocks (socket/sleep/future/subprocess — not merely another
        # lock); only acquiring a long-held lock can stall unboundedly,
        # so only those seed may-block. One level deep by design: a
        # lock long-held solely because its body acquires another
        # contended lock is not re-derived (documented honesty gap).
        long_held: Dict[str, Tuple[Tuple[str, str, int, str], ...]] = {}
        for key, fn in sorted(self.nodes.items()):
            for node in ast.walk(fn.fn):
                if not isinstance(node, ast.With):
                    continue
                if _enclosing_function(fn.mod, node) is not fn.fn:
                    continue
                locks_here = [
                    lock_name(item.context_expr)
                    for item in node.items
                    if lock_name(item.context_expr) is not None
                ]
                if not locks_here:
                    continue
                # does the with body block (directly or through calls)?
                witness: Optional[Tuple] = None
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        # a call inside a nested def runs LATER, after
                        # the lock is released — it must not mark the
                        # lock long-held (same rule as held_locks)
                        if _enclosing_function(fn.mod, sub) is not fn.fn:
                            continue
                        prim = self.blocking_primitive(fn.mod, sub)
                        if prim is not None and prim[0] != "lock-acquire":
                            witness = (
                                (fn.mod.display_path, fn.qualname,
                                 sub.lineno, prim[1]),
                            )
                            break
                        for t in self.resolve_call(fn.mod, fn.fn, sub):
                            w = self.blocks(t.key)
                            if w is not None:
                                witness = (
                                    (fn.mod.display_path, fn.qualname,
                                     sub.lineno,
                                     f"calls {t.qualname}() while holding it"),
                                ) + w
                                break
                        if witness:
                            break
                    if witness:
                        break
                if witness is None:
                    continue
                for ln in locks_here:
                    if ln == "_DEVICE_LOCK":
                        continue  # device-lock stalls are their own rules
                    long_held.setdefault(_lock_id(fn.mod, ln), witness)
        if long_held:
            for key, fn in sorted(self.nodes.items()):
                if key in self.may_block:
                    continue
                for node in ast.walk(fn.fn):
                    if not isinstance(node, ast.With):
                        continue
                    if _enclosing_function(fn.mod, node) is not fn.fn:
                        continue
                    hit = None
                    for item in node.items:
                        ln = lock_name(item.context_expr)
                        if ln is None:
                            continue
                        lid = _lock_id(fn.mod, ln)
                        if lid in long_held:
                            hit = (ln, lid)
                            break
                    if hit is not None:
                        ln, lid = hit
                        self.may_block[key] = (
                            (fn.mod.display_path, fn.qualname, node.lineno,
                             f"`with {ln}:` can wait on a holder that "
                             "blocks inside the critical section"),
                        ) + long_held[lid]
                        break
            self._sweep(block_step, "may-block(contended-locks)")

        # HOLDS-LOCK: which locks MAY be held when a function is entered
        # — the union over call sites of (locks lexically held at the
        # site) ∪ (locks held when the CALLER was entered).
        def lock_step() -> bool:
            changed = False
            for key in sorted(self.nodes):
                for site in self.calls_out.get(key, ()):
                    incoming = set(site.held)
                    incoming |= self.entered_holding.get(key, set())
                    have = self.entered_holding.setdefault(site.callee, set())
                    if not incoming <= have:
                        have |= incoming
                        changed = True
            return changed

        self._sweep(lock_step, "holds-lock")

        # THREAD ENTRIES: threading.Thread(target=X) — keyword or the
        # positional form Thread(None, X) — and threading.Timer's
        # callable, which is the POSITIONAL `function` parameter
        # (Timer takes no `target=`): Timer(5.0, X) / function=X.
        for key, fn in sorted(self.nodes.items()):
            for node in ast.walk(fn.fn):
                if not isinstance(node, ast.Call):
                    continue
                ctor = terminal_name(node.func)
                if ctor not in ("Thread", "Timer"):
                    continue
                target = None
                want_kw = "target" if ctor == "Thread" else "function"
                for kw in node.keywords:
                    if kw.arg == want_kw:
                        target = kw.value
                if target is None and len(node.args) >= 2:
                    target = node.args[1]
                if target is None:
                    continue
                fake = ast.Call(func=target, args=[], keywords=[])
                fake._srml_parent = getattr(node, "_srml_parent", None)  # type: ignore[attr-defined]
                for resolved in self.resolve_call(fn.mod, fn.fn, fake):
                    self.thread_entries.append((resolved, fn.mod, node))

        # THREAD REACHABILITY + UNLOCKED REACHABILITY: what a spawned
        # thread can reach, and which of those functions some path
        # reaches with NO lock held anywhere along it.
        for entry, _, _ in self.thread_entries:
            self.thread_reachable.add(entry.key)
            self.unlocked_reachable.add(entry.key)

        def reach_step() -> bool:
            changed = False
            for key in sorted(self.thread_reachable):
                for site in self.calls_out.get(key, ()):
                    if site.callee not in self.thread_reachable:
                        self.thread_reachable.add(site.callee)
                        changed = True
                    if (
                        key in self.unlocked_reachable
                        and not site.held
                        and site.callee not in self.unlocked_reachable
                    ):
                        self.unlocked_reachable.add(site.callee)
                        changed = True
            return changed

        self._sweep(reach_step, "thread-reachability")


# ---------------------------------------------------------------------------
# kernel entry points (the counterpart of the JAX tool's jit-handle registry)
# ---------------------------------------------------------------------------


def _ledger_call(expr: ast.AST) -> Optional[ast.Call]:
    """The ``_ledger(...)`` call of a ``with`` item, else None."""
    if isinstance(expr, ast.Call) and terminal_name(expr.func) == "_ledger":
        return expr
    return None


@dataclass
class LaunchSite:
    """One ``with _ledger(name, route, ...)`` block whose body calls a
    library loader: where a kernel launches."""

    fn: FuncNode
    node: ast.With
    name: Optional[str]  # the constant ledger name, None when built
    route: Optional[str]  # the constant route, None when computed


@dataclass
class KernelRegistry:
    """The kernel entry points of ops/kernels.py and their launch sites.

    ``entries``: function key → ledger name, for each function of the
    module that opens a ``_ledger("<name>", ...)`` record and reaches a
    library loader (``CallGraph.loaders``), directly or through a helper
    of the same module (``newton_stats`` → ``newton_stats_launch`` →
    ``_lib``). A call that resolves to one of them is a kernel launch on a
    CUDA tensor. ``launches``: every launch site, for ``kernel-ledger``."""

    entries: Dict[Tuple[str, str], str] = field(default_factory=dict)
    launches: List[LaunchSite] = field(default_factory=list)

    @classmethod
    def build(cls, graph: CallGraph) -> "KernelRegistry":
        reg = cls()
        funcs = [
            fn for key, fn in sorted(graph.nodes.items())
            if key[0] == KERNELS_MODULE
        ]
        reaches: Set[Tuple[str, str]] = set()
        changed = True
        while changed:
            changed = False
            for fn in funcs:
                if fn.key in reaches:
                    continue
                for site in graph.calls_out.get(fn.key, ()):
                    if site.callee in graph.loaders or site.callee in reaches:
                        reaches.add(fn.key)
                        changed = True
                        break
        for fn in funcs:
            names = []
            for node in ast.walk(fn.fn):
                if _enclosing_function(fn.mod, node) is not fn.fn:
                    continue
                call = _ledger_call(node)
                if call is not None and call.args:
                    name = const_str(call.args[0])
                    if name is not None:
                        names.append(name)
                if isinstance(node, ast.With):
                    site = reg._launch_site(graph, fn, node)
                    if site is not None:
                        reg.launches.append(site)
            if names and fn.key in reaches:
                reg.entries[fn.key] = names[0]
        return reg

    @staticmethod
    def _launch_site(graph: CallGraph, fn: FuncNode, node: ast.With) -> Optional[LaunchSite]:
        ledger = None
        for item in node.items:
            ledger = ledger or _ledger_call(item.context_expr)
        if ledger is None:
            return None
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                if any(
                    t.key in graph.loaders
                    for t in graph.resolve_call(fn.mod, fn.fn, sub)
                ):
                    name = const_str(ledger.args[0]) if ledger.args else None
                    route = (
                        const_str(ledger.args[1]) if len(ledger.args) > 1 else None
                    )
                    return LaunchSite(fn, node, name, route)
        return None

    def entry_of(self, targets: Sequence[FuncNode]) -> Optional[FuncNode]:
        for t in targets:
            if t.key in self.entries:
                return t
        return None


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

RULES: Dict[str, "Rule"] = {}


@dataclass
class Rule:
    id: str
    summary: str
    check: Callable[["Project"], List[Finding]]
    family: str = "misc"


def rule(rule_id: str, summary: str, family: str = "misc"):
    def deco(fn: Callable[["Project"], List[Finding]]) -> Callable:
        RULES[rule_id] = Rule(rule_id, summary, fn, family)
        return fn

    return deco


class Project:
    """The analyzed file set plus its cross-module context.

    ``files`` maps package-relative posix paths (``serve/daemon.py``) to
    source text, so tests can assemble synthetic projects; ``from_package``
    loads the real tree. ``protocol_doc``/``contract`` feed the wire rules
    and are optional for fixtures. ``strict_floors`` arms the self-check
    floors (minimum dispatched-op counts etc.) that only make sense
    against the real package.
    """

    def __init__(
        self,
        files: Dict[str, str],
        protocol_doc: Optional[str] = None,
        contract: Optional[Dict[str, Any]] = None,
        strict_floors: bool = False,
        display_prefix: str = "",
    ):
        self.modules: List[Module] = []
        for rel in sorted(files):
            self.modules.append(
                Module(rel, files[rel], display_path=display_prefix + rel)
            )
        self.protocol_doc = protocol_doc
        self.contract = contract
        self.strict_floors = strict_floors
        self._known_mods = {m.relpath for m in self.modules}
        self._graph: Optional[CallGraph] = None
        self._kernels: Optional["KernelRegistry"] = None
        self._dispatch: Optional[Dict[Tuple[str, str], Tuple]] = None
        #: report scope: when set (package-relative paths/prefixes), only
        #: findings in matching files are reported — analysis itself is
        #: always whole-program.
        self.report_filter: Optional[List[str]] = None
        #: non-fatal remarks (stale baseline entries land here too)
        self.notes: List[str] = []

    @property
    def graph(self) -> CallGraph:
        """The interprocedural engine, built lazily ONCE per Project:
        call graph + may-block/holds-lock/thread-reachability fixpoints.
        Its diagnostics (fixpoint-cap hits) surface through run()'s
        notes."""
        if self._graph is None:
            self._graph = CallGraph(self)
        return self._graph

    @property
    def kernels(self) -> "KernelRegistry":
        """The kernel entry points and launch sites, built once."""
        if self._kernels is None:
            self._kernels = KernelRegistry.build(self.graph)
        return self._kernels

    @property
    def dispatch(self) -> Dict[Tuple[str, str], Tuple]:
        """Functions that may touch the device without taking
        ``_DEVICE_LOCK`` on the way (:func:`_dispatch_facts`), each with
        its witness chain, built once."""
        if self._dispatch is None:
            self._dispatch = _dispatch_facts(self)
        return self._dispatch

    @staticmethod
    def package_files(pkg_root: Path = PKG_ROOT) -> Dict[str, str]:
        """The real package's sources keyed by relpath — the raw material
        for from_package and for tests that seed a deliberate violation
        into a scratch copy of one module."""
        files: Dict[str, str] = {}
        for p in sorted(pkg_root.rglob("*.py")):
            rel = p.relative_to(pkg_root).as_posix()
            if "__pycache__" in rel:
                continue
            files[rel] = p.read_text()
        return files

    @classmethod
    def from_package(
        cls,
        pkg_root: Path = PKG_ROOT,
        contract_path: Path = CONTRACT_PATH,
        paths: Optional[Sequence[str]] = None,
    ) -> "Project":
        """The real tree. ``paths`` restricts which files findings are
        REPORTED for — the whole package is still parsed, because the
        rules are whole-program (the kernel entry points of ops/ are what a
        serve/-only run resolves the daemon's device calls against)."""
        files = cls.package_files(pkg_root)
        doc_path = pkg_root.parent / "docs" / "protocol.md"
        protocol_doc = doc_path.read_text() if doc_path.exists() else None
        contract = None
        if contract_path.exists():
            contract = json.loads(contract_path.read_text())
        project = cls(
            files,
            protocol_doc=protocol_doc,
            contract=contract,
            strict_floors=True,
            display_prefix=pkg_root.name + "/",
        )
        if paths:
            project.report_filter = list(paths)
        return project

    # -- scoping -----------------------------------------------------------

    def device_modules(self) -> List[Module]:
        return [m for m in self.modules if m.relpath in DEVICE_MODULES]

    def bitwise_scope(self, mod: Module, node: ast.AST) -> bool:
        """Whether ``node`` is under the bitwise-determinism contract:
        anywhere in ops//models//parallel/, or on a daemon/scheduler
        fold/merge path (function name carries a fold fragment)."""
        top = mod.relpath.split("/", 1)[0]
        if top in BITWISE_DIRS:
            return True
        if mod.relpath in DEVICE_MODULES:
            for anc in [node, *mod.ancestors(node)]:
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    name = anc.name.lower()
                    if any(f in name for f in FOLD_NAME_FRAGMENTS):
                        return True
        return False

    # -- running -----------------------------------------------------------

    def run_raw(self, rules: Optional[Sequence[str]] = None) -> List[Finding]:
        """All findings before pragma/baseline suppression."""
        selected = sorted(set(rules)) if rules else sorted(RULES)
        unknown = [r for r in selected if r not in RULES]
        if unknown:
            raise KeyError(f"unknown rule(s): {', '.join(unknown)}")
        # Notes are per-run state (rules append as they check): reset so
        # a Project reused across runs reports only this run's notes.
        self.notes = []
        out: List[Finding] = []
        for rid in selected:
            out.extend(RULES[rid].check(self))
        if self._graph is not None:
            self.notes.extend(self._graph.notes)
        if self.report_filter is not None:
            out = [f for f in out if self.in_report_scope(f.file)]
        out.sort(key=lambda f: (f.file, f.line, f.rule))
        return out

    def in_report_scope(self, display_path: str) -> bool:
        if self.report_filter is None:
            return True
        rel = display_path
        for m in self.modules:
            if m.display_path == display_path:
                rel = m.relpath
                break
        return any(
            rel == q or rel.startswith(q.rstrip("/") + "/")
            for q in self.report_filter
        )

    def run(
        self,
        rules: Optional[Sequence[str]] = None,
        baseline: Optional[Baseline] = None,
    ) -> List[Finding]:
        """Findings after inline pragmas and the baseline; stale-baseline
        warnings land in ``self.notes``."""
        raw = self.run_raw(rules)
        if baseline is not None:
            # A Baseline is reusable across runs: matched counts are
            # per-run state, reset here so a second run suppresses again.
            baseline._matched = {}
        by_display = {m.display_path: m for m in self.modules}
        kept: List[Finding] = []
        for f in raw:
            mod = by_display.get(f.file)
            if mod is not None and mod.suppressed(f.rule, f.line):
                continue
            if baseline is not None and baseline.suppresses(f):
                continue
            kept.append(f)
        if baseline is not None:
            self.notes.extend(baseline.stale())
        return kept

    def finding(
        self,
        mod: Module,
        node: ast.AST,
        rule_id: str,
        message: str,
        chain: Sequence[Tuple[str, int, str]] = (),
    ) -> Finding:
        registered = RULES.get(rule_id)
        return Finding(
            rule=rule_id,
            file=mod.display_path,
            line=getattr(node, "lineno", 1),
            symbol=mod.enclosing_symbol(node),
            message=message,
            family=registered.family if registered else "misc",
            chain=tuple(chain),
        )


# ---------------------------------------------------------------------------
# rule family 1: lock discipline
# ---------------------------------------------------------------------------

#: Functions of torch that copy host data to the device with a device=.
_UPLOAD_CTORS = frozenset(("torch.as_tensor", "torch.tensor"))
_DEVICEISH_RE = re.compile(r"(device|dev)$")


def _deviceish(expr: ast.AST) -> bool:
    """Whether an argument names a device: ``self.device``, ``dev``,
    ``a.device``, ``self._device``, or a ``"cuda..."`` constant."""
    name = terminal_name(expr)
    if name is not None and _DEVICEISH_RE.search(name.lower()):
        return True
    s = const_str(expr)
    return s is not None and s.startswith("cuda")


def _direct_device_call(
    project: Project, mod: Module, fn: Optional[ast.AST], call: ast.Call
) -> Optional[str]:
    """Why this very call touches the device, or None: a kernel entry
    point, ``torch.cuda.synchronize``, or an upload (``.to(<device>)``,
    ``.cuda()``, ``torch.as_tensor``/``torch.tensor`` with a device)."""
    dn = dotted_name(call.func) or ""
    name = terminal_name(call.func)
    if name is None:
        return None
    if dn == "torch.cuda.synchronize" or dn.endswith(".cuda.synchronize"):
        return "torch.cuda.synchronize() waits on the device"
    if isinstance(call.func, ast.Attribute):
        if name == "cuda":
            return ".cuda() copies to the device"
        if name == "to":
            args = list(call.args[:1]) + [
                kw.value for kw in call.keywords if kw.arg == "device"
            ]
            if any(_deviceish(a) for a in args):
                return ".to(<device>) copies to the device"
    if dn in _UPLOAD_CTORS and any(
        kw.arg == "device" and _deviceish(kw.value) for kw in call.keywords
    ):
        return f"{dn}(..., device=) copies to the device"
    entry = project.kernels.entry_of(project.graph.resolve_call(mod, fn, call))
    if entry is not None:
        return (
            f"{entry.qualname}() is a kernel entry point "
            f"({project.kernels.entries[entry.key]})"
        )
    return None


def _named_receiver(call: ast.Call) -> bool:
    """False for a method call on an expression's result (``super().m()``,
    ``self._get_job(req).m()``): by-name dispatch resolves those to every
    visible method ``m``, too loose to carry a device obligation."""
    func = call.func
    return not isinstance(func, ast.Attribute) or dotted_name(func.value) is not None


def _dispatch_facts(project: Project) -> Dict[Tuple[str, str], Tuple]:
    """Functions that may touch the device with no ``_DEVICE_LOCK`` taken
    on the way: those with a direct device call (:func:`_direct_device_call`)
    outside the lock, and, to a fixpoint, their callers through call sites
    that do not hold it. ``*_locked`` helpers carry no fact (their call
    sites answer for the lock), and a call on an expression's result
    carries none (:func:`_named_receiver`). Each fact is a witness chain of
    (file, symbol, line, note) hops down to the device call."""
    graph = project.graph
    facts: Dict[Tuple[str, str], Tuple] = {}
    for key, fn in sorted(graph.nodes.items()):
        if fn.name.endswith("_locked"):
            continue
        for node in ast.walk(fn.fn):
            if not isinstance(node, ast.Call):
                continue
            if _enclosing_function(fn.mod, node) is not fn.fn:
                continue
            if "_DEVICE_LOCK" in held_locks(fn.mod, node):
                continue
            why = _direct_device_call(project, fn.mod, fn.fn, node)
            if why is not None:
                facts[key] = ((fn.mod.display_path, fn.qualname, node.lineno, why),)
                break

    def step() -> bool:
        changed = False
        for key in sorted(graph.nodes):
            fn = graph.nodes[key]
            if key in facts or fn.name.endswith("_locked"):
                continue
            for site in graph.calls_out.get(key, ()):
                sub = facts.get(site.callee)
                if sub is None or "_DEVICE_LOCK" in site.held:
                    continue
                if not _named_receiver(site.call):
                    continue
                callee = graph.nodes[site.callee]
                facts[key] = (
                    (fn.mod.display_path, fn.qualname, site.call.lineno,
                     f"calls {callee.qualname}()"),
                ) + sub
                changed = True
                break
        return changed

    graph._sweep(step, "may-dispatch")
    return facts


def _in_locked_helper(mod: Module, node: ast.AST) -> bool:
    """Whether the node sits in a ``*_locked``-suffixed function — the
    package convention for "the caller already holds the lock" (e.g.
    ``_Job._fold_locked`` runs under fold()'s _DEVICE_LOCK)."""
    fn = _enclosing_function(mod, node)
    while fn is not None:
        if fn.name.endswith("_locked"):
            return True
        fn = _enclosing_function(mod, fn)
    return False


@rule(
    "device-lock",
    "in serve/daemon.py and serve/scheduler.py every kernel launch, "
    "torch.cuda.synchronize and upload to the device — directly or through "
    "a function outside these modules that reaches one without taking the "
    "lock — runs lexically under `with _DEVICE_LOCK` (and `*_locked` "
    "helpers are called with a lock held)",
    family="lock",
)
def _check_device_lock(project: Project) -> List[Finding]:
    graph = project.graph
    facts = project.dispatch
    out: List[Finding] = []
    for mod in project.device_modules():
        # *_locked helpers whose bodies touch the device outside the lock:
        # their call sites need _DEVICE_LOCK specifically, not just some
        # lock — a job lock alone must not smuggle a launch past the gate.
        # A helper that takes _DEVICE_LOCK itself (the suffix then names
        # the job lock) leaves its callers no device obligation.
        dispatching_helpers: Set[str] = set()
        for fn_node in iter_functions(mod):
            if not fn_node.name.endswith("_locked"):
                continue
            for sub in ast.walk(fn_node):
                if not isinstance(sub, ast.Call):
                    continue
                if "_DEVICE_LOCK" in held_locks(mod, sub):
                    continue
                if _direct_device_call(project, mod, fn_node, sub) or (
                    _named_receiver(sub)
                    and any(
                        t.mod.relpath not in DEVICE_MODULES and t.key in facts
                        for t in graph.resolve_call(mod, fn_node, sub)
                    )
                ):
                    dispatching_helpers.add(fn_node.name)
                    break
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node.func)
            # The *_locked convention, checked from the caller's side: a
            # helper that documents "caller holds the lock" in its name
            # must see the lock lexically held at its call site — the
            # DEVICE lock when the helper touches the device, any lock
            # otherwise — unless the caller is itself a *_locked helper.
            if name is not None and name.endswith("_locked"):
                if _in_locked_helper(mod, node):
                    continue
                held = held_locks(mod, node)
                if name in dispatching_helpers and "_DEVICE_LOCK" not in held:
                    out.append(
                        project.finding(
                            mod,
                            node,
                            "device-lock",
                            f"call to {name}() without _DEVICE_LOCK held — "
                            "the helper touches the device, and its _locked "
                            "suffix makes THIS call site responsible for "
                            "the lock",
                        )
                    )
                elif not held:
                    out.append(
                        project.finding(
                            mod,
                            node,
                            "device-lock",
                            f"call to {name}() with no lock held — the "
                            "_locked suffix documents a caller-holds-the-"
                            "lock contract",
                        )
                    )
                continue
            if "_DEVICE_LOCK" in held_locks(mod, node):
                continue
            if _in_locked_helper(mod, node):
                continue  # caller holds the lock (checked at its call site)
            fn = _enclosing_function(mod, node)
            why = _direct_device_call(project, mod, fn, node)
            chain: Sequence[Tuple[str, int, str]] = ()
            if why is None and _named_receiver(node):
                for target in graph.resolve_call(mod, fn, node):
                    if target.mod.relpath in DEVICE_MODULES:
                        continue  # its own device calls are checked there
                    witness = facts.get(target.key)
                    if witness is not None:
                        why = (
                            f"{target.qualname}() reaches "
                            f"{witness[-1][3].split(' (')[0]} without taking "
                            "the lock (see the call-chain witness)"
                        )
                        chain = [(f, l, f"[{q}] {n}") for f, q, l, n in witness]
                        break
            if why is None:
                continue
            out.append(
                project.finding(
                    mod,
                    node,
                    "device-lock",
                    f"device work outside _DEVICE_LOCK: {why}; the daemon's "
                    "threads share one card and must single-file their "
                    "launches and copies (daemon threading contract)",
                    chain=chain,
                )
            )
    return out


def _compile_path_call(graph: CallGraph, mod: Module, fn, call: ast.Call) -> Optional[str]:
    """The compile-path function this call enters, or None: ``_build.build``,
    ``_build.build_all``, ``_build.load`` or a library loader."""
    dn = dotted_name(call.func) or ""
    for f in BUILD_FUNCS:
        if dn.endswith(f"_build.{f}"):
            return dn
    for t in graph.resolve_call(mod, fn, call):
        if t.key in graph.loaders or (
            t.mod.relpath == BUILD_MODULE and t.qualname in BUILD_FUNCS
        ):
            return f"{t.mod.relpath}:{t.qualname}"
    return None


@rule(
    "compile-outside-lock",
    "no call to the compile path (_build.build/build_all/load, the library "
    "loaders) under _DEVICE_LOCK in the device modules — an nvcc build is "
    "host work of seconds and would stall serving",
    family="lock",
)
def _check_compile_outside_lock(project: Project) -> List[Finding]:
    graph = project.graph
    out: List[Finding] = []
    for mod in project.device_modules():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if "_DEVICE_LOCK" not in held_locks(mod, node):
                continue
            target = _compile_path_call(
                graph, mod, _enclosing_function(mod, node), node
            )
            if target is None:
                continue
            out.append(
                project.finding(
                    mod,
                    node,
                    "compile-outside-lock",
                    f"compile-path call {target}() under _DEVICE_LOCK: a "
                    "build is host work of seconds (nvcc) — holding the "
                    "device lock through one stalls every live dispatch; "
                    "load the libraries before the daemon listens",
                )
            )
    return out


@rule(
    "lock-order",
    "_DEVICE_LOCK is innermost by contract: lexically acquiring any "
    "other lock under it risks deadlock (interprocedural orderings and "
    "general inversions are lock-graph-cycle's job)",
    family="lock",
)
def _check_lock_order(project: Project) -> List[Finding]:
    # Lexical only, by design: interprocedural orderings (a caller holds
    # _DEVICE_LOCK into a function that locks) are lock-graph-cycle's
    # job — there they are edges, and only a CYCLE is a finding, which
    # keeps the by-name call-resolution over-approximation from flagging
    # every lock ever taken downstream of a device section.
    out: List[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            inner_names = [
                lock_name(item.context_expr)
                for item in node.items
                if lock_name(item.context_expr) is not None
            ]
            if not inner_names:
                continue
            enclosing = held_locks(mod, node)
            for i, inner in enumerate(inner_names):
                # `with A, B:` acquires B while holding A — earlier items
                # of the same statement are part of the held stack.
                outer_stack = enclosing + inner_names[:i]
                if "_DEVICE_LOCK" not in outer_stack or inner == "_DEVICE_LOCK":
                    continue
                out.append(
                    project.finding(
                        mod,
                        node,
                        "lock-order",
                        f"acquires {inner} while holding _DEVICE_LOCK; "
                        "_DEVICE_LOCK is the INNERMOST lock by contract "
                        "(after any job/model lock, never before one)",
                    )
                )
    return out


@rule(
    "lock-graph-cycle",
    "whole-program lock-order graph over every named lock (edges from "
    "lexical nesting AND from call paths that enter a function with a "
    "lock held); any cycle is a deadlock an interleaving can reach",
    family="lock",
)
def _check_lock_graph_cycle(project: Project) -> List[Finding]:
    graph = project.graph
    #: edge (outer lock id → inner lock id) → first witnessing site
    edges: Dict[Tuple[str, str], Tuple[Module, ast.AST, str]] = {}
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            inner_names = [
                lock_name(item.context_expr)
                for item in node.items
                if lock_name(item.context_expr) is not None
            ]
            if not inner_names:
                continue
            enclosing = [_lock_id(mod, l) for l in held_locks(mod, node)]
            fn = _enclosing_function(mod, node)
            entered: Set[str] = set()
            if fn is not None:
                key = (mod.relpath, mod.enclosing_symbol(fn))
                entered = graph.entered_holding.get(key, set())
            for i, inner in enumerate(inner_names):
                inner_id = _lock_id(mod, inner)
                lexical = enclosing + [_lock_id(mod, l) for l in inner_names[:i]]
                for outer_id in lexical:
                    if outer_id != inner_id:
                        edges.setdefault(
                            (outer_id, inner_id), (mod, node, "nested with")
                        )
                for outer_id in sorted(entered):
                    if outer_id != inner_id and outer_id not in lexical:
                        edges.setdefault(
                            (outer_id, inner_id),
                            (mod, node, "lock held by a caller on the path here"),
                        )
    # Cycle detection: iterative DFS over the lock digraph; every back
    # edge closes a cycle. Reported once per cycle (canonicalized by its
    # sorted member set) at the back edge's witness site, with the full
    # edge chain as the finding's witness.
    adj: Dict[str, List[str]] = {}
    for outer, inner in edges:
        adj.setdefault(outer, []).append(inner)
    for vals in adj.values():
        vals.sort()
    out: List[Finding] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def bare(lock_id: str) -> str:
        return lock_id.rsplit(":", 1)[-1]

    for start in sorted(adj):
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        visited_from_start: Set[str] = set()
        while stack:
            node_id, path = stack.pop()
            for nxt in adj.get(node_id, ()):  # sorted → deterministic
                if nxt == start:
                    cycle = tuple(path)
                    canon = tuple(sorted(cycle))
                    if canon in seen_cycles:
                        continue
                    seen_cycles.add(canon)
                    closing = edges[(node_id, start)]
                    chain = []
                    hops = list(zip(cycle, cycle[1:] + (cycle[0],)))
                    for outer, inner in hops:
                        wmod, wnode, how = edges[(outer, inner)]
                        chain.append(
                            (
                                wmod.display_path,
                                getattr(wnode, "lineno", 1),
                                f"{bare(outer)} → {bare(inner)} ({how})",
                            )
                        )
                    mod, node, _ = closing
                    pretty = " → ".join(bare(l) for l in cycle + (cycle[0],))
                    out.append(
                        project.finding(
                            mod,
                            node,
                            "lock-graph-cycle",
                            f"lock-order cycle {pretty}: two threads walking "
                            "this ring from different entry points deadlock; "
                            "break the cycle by ordering the acquisitions",
                            chain=chain,
                        )
                    )
                elif nxt not in path and nxt not in visited_from_start:
                    visited_from_start.add(nxt)
                    stack.append((nxt, path + [nxt]))
    out.sort(key=lambda f: (f.file, f.line, f.message))
    return out


@rule(
    "blocking-under-device-lock",
    "no call that TRANSITIVELY blocks (socket I/O, time.sleep, "
    "future/event waits, subprocess, contended Lock.acquire) may execute "
    "while _DEVICE_LOCK is held — the whole serving plane single-files "
    "on that lock, so one blocked holder stalls every dispatch",
    family="lock",
)
def _check_blocking_under_device_lock(project: Project) -> List[Finding]:
    # Encoded exemptions, not pragmas: blocking on the DEVICE (kernel
    # launches, torch.cuda.synchronize, copies) under _DEVICE_LOCK is the
    # lock's entire purpose — CallGraph.blocking_primitive deliberately
    # excludes device waits, so only host-side blocking (sockets, sleeps,
    # futures, subprocess, lock contention) reaches this rule; and a
    # library loader primed at daemon start builds nothing afterwards
    # (CallGraph.blocks).
    graph = project.graph
    out: List[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if "_DEVICE_LOCK" not in held_locks(mod, node):
                continue
            prim = CallGraph.blocking_primitive(mod, node)
            if prim is not None:
                kind, why = prim
                out.append(
                    project.finding(
                        mod,
                        node,
                        "blocking-under-device-lock",
                        f"{why} while _DEVICE_LOCK is held ({kind}); every "
                        "device dispatch in the process stalls behind it",
                    )
                )
                continue
            fn = _enclosing_function(mod, node)
            caller_key = (
                (mod.relpath, mod.enclosing_symbol(fn)) if fn is not None else None
            )
            for target in graph.resolve_call(mod, fn, node):
                witness = graph.blocks(target.key)
                if witness is None:
                    continue
                # Self-recursive edge: the blocking site is in THIS
                # function and already reported directly above.
                if caller_key is not None and target.key == caller_key:
                    continue
                chain = [(f, l, f"[{q}] {n}") for f, q, l, n in witness]
                out.append(
                    project.finding(
                        mod,
                        node,
                        "blocking-under-device-lock",
                        f"calls {target.qualname}() while _DEVICE_LOCK is "
                        "held, and that call can block on "
                        f"{witness[-1][3].split('(')[0].strip()} (see the "
                        "call-chain witness); host-side blocking under the "
                        "device lock stalls every dispatch in the process",
                        chain=chain,
                    )
                )
                break  # one finding per call site, not per candidate target
    out.sort(key=lambda f: (f.file, f.line))
    return out


@rule(
    "thread-shared-state",
    "a write to self.*/module-global state in code reachable from a "
    "threading.Thread target with NO lock held anywhere on the call path "
    "races every other thread that touches the same attribute",
    family="threads",
)
def _check_thread_shared_state(project: Project) -> List[Finding]:
    graph = project.graph
    out: List[Finding] = []
    #: Concurrency-plane modules: the daemon/scheduler/router/fleet/
    #: membership surfaces that actually run multi-threaded. utils/ and
    #: model code execute on these threads too but under the callers'
    #: locks/single-owner conventions — scoping keeps the rule's
    #: signal/noise honest.
    def in_scope(mod: Module) -> bool:
        top = mod.relpath.split("/", 1)[0]
        return top in ("serve", "parallel")

    for key in sorted(graph.thread_reachable):
        fn = graph.nodes.get(key)
        if fn is None or not in_scope(fn.mod):
            continue
        if key not in graph.unlocked_reachable:
            continue  # every path into this function holds some lock
        if fn.name == "__init__" or fn.name.endswith("_locked"):
            # __init__ runs before the object is published to other
            # threads; *_locked helpers document caller-holds-the-lock
            # (their call sites are the device-lock rule's job).
            continue
        mod = fn.mod
        #: module-global names this function declares with `global`
        declared_global: Set[str] = {
            name
            for node in ast.walk(fn.fn)
            if isinstance(node, ast.Global)
            for name in node.names
        }
        for node in ast.walk(fn.fn):
            if _enclosing_function(mod, node) is not fn.fn:
                continue
            target: Optional[str] = None
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                if (
                    isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                ):
                    target = f"self.{node.attr}"
            elif isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                if node.id in declared_global:
                    target = node.id
            if target is None:
                continue
            if held_locks(mod, node):
                continue  # lexically locked at the write
            out.append(
                project.finding(
                    mod,
                    node,
                    "thread-shared-state",
                    f"unlocked write to {target} in {fn.qualname}(), which "
                    "a threading.Thread target reaches with no lock held "
                    "on the path — concurrent readers/writers race on it; "
                    "hold the owning lock or move the write under one",
                )
            )
    out.sort(key=lambda f: (f.file, f.line))
    return out


# ---------------------------------------------------------------------------
# rule family 2: determinism
# ---------------------------------------------------------------------------

_DICT_ITER_METHODS = frozenset(("items", "keys", "values"))


def _is_local_literal_dict(mod: Module, loop_node: ast.AST, name: str) -> bool:
    """Whether ``name`` is assigned a dict literal in the same function
    before the loop — its iteration order is then fixed by construction
    (identical on every process), not by runtime insertion history."""
    fn = _enclosing_function(mod, loop_node)
    if fn is None:
        return False
    loop_line = getattr(loop_node, "lineno", 0)
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and getattr(node, "lineno", 0) <= loop_line
            and isinstance(node.value, ast.Dict)
            and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets
            )
        ):
            return True
    return False


def _is_keyed_rebuild(node: ast.AST, gen: "ast.comprehension") -> bool:
    """``{k: f(v) for k, v in d.items()}`` — a key-addressed dict→dict
    rebuild, not a fold: the result is consumed by key, and any later
    ORDERED iteration of it gets its own finding at that site."""
    if not isinstance(node, ast.DictComp):
        return False
    tgt = gen.target
    if isinstance(tgt, ast.Tuple) and tgt.elts and isinstance(tgt.elts[0], ast.Name):
        return (
            isinstance(node.key, ast.Name) and node.key.id == tgt.elts[0].id
        )
    return False


@rule(
    "unsorted-iter",
    "iterating an un-sorted() dict/set in the bitwise-contract modules "
    "(ops/, models/, parallel/, daemon fold/merge paths) makes fold order "
    "process-dependent",
    family="determinism",
)
def _check_unsorted_iter(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        iters: List[Tuple[ast.AST, ast.AST, Optional[ast.comprehension]]] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append((node, node.iter, None))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    iters.append((node, gen.iter, gen))
        for node, it, gen in iters:
            if not project.bitwise_scope(mod, node):
                continue
            what = None
            if isinstance(it, ast.Call):
                fn = it.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _DICT_ITER_METHODS
                    and not it.args
                ):
                    what = f".{fn.attr}()"
                    base = fn.value
                    if isinstance(base, ast.Name) and _is_local_literal_dict(
                        mod, node, base.id
                    ):
                        continue  # literal-ordered by construction
                elif isinstance(fn, ast.Name) and fn.id == "set":
                    what = "set(...)"
            elif isinstance(it, ast.Set):
                what = "a set literal"
            if what is None:
                continue
            if gen is not None and _is_keyed_rebuild(node, gen):
                continue
            out.append(
                project.finding(
                    mod,
                    node,
                    "unsorted-iter",
                    f"iterates {what} without sorted() on a bitwise-contract "
                    "path — insertion/hash order varies across processes, so "
                    "the fold is not reproducible; wrap the iterable in "
                    "sorted()",
                )
            )
    return out


_SEEDED_RNG_CTORS = frozenset(
    ("default_rng", "Generator", "RandomState", "SeedSequence", "PRNGKey", "key")
)
#: torch's draws from its global generator unless given ``generator=``.
_TORCH_RNG_DRAWS = frozenset((
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
))


@rule(
    "wallclock-entropy",
    "time.time / random.* / unseeded np.random.* / torch's global RNG in "
    "the bitwise-contract modules injects wall-clock or global-RNG entropy "
    "into paths that must be bitwise-reproducible",
    family="determinism",
)
def _check_wallclock_entropy(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func)
            if dn is None:
                continue
            if not project.bitwise_scope(mod, node):
                continue
            parts = dn.split(".")
            bad = None
            if dn == "time.time":
                bad = "time.time() is wall-clock entropy"
            elif parts[0] == "random" and len(parts) > 1:
                bad = f"{dn}() draws from the global stdlib RNG"
            elif (
                len(parts) >= 3
                and parts[-2] == "random"
                and parts[0] in ("np", "numpy")
                and parts[-1] not in _SEEDED_RNG_CTORS
            ):
                bad = f"{dn}() draws from the global numpy RNG"
            elif (
                len(parts) == 2
                and parts[0] == "torch"
                and parts[1] in _TORCH_RNG_DRAWS
                and not any(kw.arg == "generator" for kw in node.keywords)
            ):
                bad = f"{dn}() without generator= draws from torch's global RNG"
            if bad is None:
                continue
            out.append(
                project.finding(
                    mod,
                    node,
                    "wallclock-entropy",
                    f"{bad} on a bitwise-contract path; thread a seeded "
                    "np.random.default_rng(seed) (or a seeded torch.Generator) "
                    "through instead",
                )
            )
    return out


# ---------------------------------------------------------------------------
# rule family 3: wire contract
# ---------------------------------------------------------------------------


def collect_dispatched_ops(mod: Module) -> Dict[str, int]:
    """op strings the daemon dispatches on: ``op == "x"`` comparisons and
    ``op in ("x", "y")`` membership tests against a name ending in "op",
    with constant folding so concatenation/f-strings can't dodge."""
    ops: Dict[str, int] = {}

    def is_op_name(e: ast.AST) -> bool:
        tn = terminal_name(e)
        return tn is not None and (tn == "op" or tn.endswith("_op"))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left, *node.comparators]
        if not any(is_op_name(o) for o in operands):
            continue
        for o, cmp_op in zip(operands[1:], node.ops):
            if isinstance(cmp_op, (ast.Eq, ast.NotEq)):
                s = const_str(o)
                if s is None and is_op_name(o):
                    s = const_str(node.left)
                if s is not None:
                    ops.setdefault(s, node.lineno)
            elif isinstance(cmp_op, (ast.In, ast.NotIn)) and isinstance(
                o, (ast.Tuple, ast.List, ast.Set)
            ):
                for elt in o.elts:
                    s = const_str(elt)
                    if s is not None:
                        ops.setdefault(s, node.lineno)
    return ops


def collect_known_ops(mod: Module) -> Optional[Set[str]]:
    """The ``_KNOWN_OPS = frozenset((...))`` clamp literal, AST-parsed."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(terminal_name(t) == "_KNOWN_OPS" for t in node.targets):
            continue
        known: Set[str] = set()
        for sub in ast.walk(node.value):
            s = const_str(sub)
            if s is not None:
                known.add(s)
        return known
    return None


@rule(
    "wire-op-clamp",
    "every op string the daemon dispatches must appear in _KNOWN_OPS (the "
    "metrics-label clamp) and docs/protocol.md (the frozen wire contract)",
    family="wire",
)
def _check_wire_op_clamp(project: Project) -> List[Finding]:
    out: List[Finding] = []
    daemons = [m for m in project.modules if m.relpath == "serve/daemon.py"]
    for mod in daemons:
        dispatched = collect_dispatched_ops(mod)
        known = collect_known_ops(mod)
        if project.strict_floors and len(dispatched) < 15:
            out.append(
                Finding(
                    "wire-op-clamp",
                    mod.display_path,
                    1,
                    "<module>",
                    f"only {len(dispatched)} dispatched ops found — the "
                    "dispatch shape or the op collector regressed",
                )
            )
        if known is None:
            out.append(
                Finding(
                    "wire-op-clamp",
                    mod.display_path,
                    1,
                    "<module>",
                    "_KNOWN_OPS frozenset literal not found in serve/daemon.py",
                )
            )
            continue
        for op, line in sorted(dispatched.items()):
            if op not in known:
                out.append(
                    Finding(
                        "wire-op-clamp",
                        mod.display_path,
                        line,
                        "<module>",
                        f'op "{op}" is dispatched but missing from the '
                        "_KNOWN_OPS metrics-label clamp (its telemetry would "
                        'record under op="unknown")',
                    )
                )
            if project.protocol_doc is not None and not re.search(
                rf"\b{re.escape(op)}\b", project.protocol_doc
            ):
                out.append(
                    Finding(
                        "wire-op-clamp",
                        mod.display_path,
                        line,
                        "<module>",
                        f'op "{op}" is dispatched but absent from '
                        "docs/protocol.md (the frozen wire contract)",
                    )
                )
    return out


def _dict_return_keys(mod: Module) -> Dict[str, Set[str]]:
    """def name → constant keys of returned dict literals, for resolving
    ``**helper()`` expansions one level deep."""
    returns: Dict[str, Set[str]] = {}
    for fn_node in iter_functions(mod):
        keys: Set[str] = set()
        for ret in ast.walk(fn_node):
            if isinstance(ret, ast.Return) and isinstance(ret.value, ast.Dict):
                for k in ret.value.keys:
                    s = const_str(k) if k is not None else None
                    if s is not None:
                        keys.add(s)
        if keys:
            returns.setdefault(fn_node.name, set()).update(keys)
    return returns


def _scrape_ack_call(
    mod: Module,
    node: ast.Call,
    returns: Dict[str, Set[str]],
    fields: Set[str],
) -> bool:
    """When ``node`` is an ack send (``send_json`` arg 1 /
    ``_send_arrays_counted`` arg 3), add its constant dict keys to
    ``fields`` and return True. Inline literals AND acks built in a
    local variable first (its dict-literal assignment and
    ``payload["k"] = ...`` grows in the same function) are resolved, plus
    ``**helper()`` expansions one level into same-module helper returns.
    Subscript stores on UNRELATED dicts are deliberately not counted:
    over-collection would mask a removed ack field behind any
    identically-named key (the gate must err toward reporting)."""
    name = terminal_name(node.func)
    if name == "send_json" and len(node.args) >= 2:
        arg = node.args[1]
    elif name == "_send_arrays_counted" and len(node.args) >= 4:
        arg = node.args[3]
    else:
        return False

    def scrape_dict(d: ast.Dict) -> None:
        for k, v in zip(d.keys, d.values):
            if k is None:  # ** expansion
                if isinstance(v, ast.Call):
                    helper = terminal_name(v.func)
                    fields.update(returns.get(helper, set()))
                continue
            s = const_str(k)
            if s is not None:
                fields.add(s)

    if isinstance(arg, ast.Dict):
        scrape_dict(arg)
        return True
    sender = _enclosing_function(mod, node)
    if not isinstance(arg, ast.Name) or sender is None:
        return True
    # Ack built in a local first: scrape its dict-literal assignment
    # and every constant subscript-store on THAT name.
    for sub in ast.walk(sender):
        if (
            isinstance(sub, ast.AnnAssign)
            and isinstance(sub.target, ast.Name)
            and sub.target.id == arg.id
            and isinstance(sub.value, ast.Dict)
        ):
            scrape_dict(sub.value)
        elif isinstance(sub, ast.Assign):
            if (
                any(
                    isinstance(t, ast.Name) and t.id == arg.id
                    for t in sub.targets
                )
                and isinstance(sub.value, ast.Dict)
            ):
                scrape_dict(sub.value)
            elif (
                len(sub.targets) == 1
                and isinstance(sub.targets[0], ast.Subscript)
                and isinstance(sub.targets[0].value, ast.Name)
                and sub.targets[0].value.id == arg.id
            ):
                s = const_str(sub.targets[0].slice)
                if s is not None:
                    fields.add(s)
    return True


def collect_ack_fields(mod: Module) -> Set[str]:
    """Constant ack-dict field names the daemon answers with, module-wide
    (see :func:`_scrape_ack_call` for the resolution rules)."""
    returns = _dict_return_keys(mod)
    fields: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            _scrape_ack_call(mod, node, returns, fields)
    return fields


def _contract_ack_union(contract: Dict[str, Any]) -> Set[str]:
    """Every ack field the snapshot promises, across formats: the v1
    flat list, or the union of the v2 per-op + common schemas."""
    want = set(contract.get("ack_fields", []))
    for schema in contract.get("ops", {}).values():
        want.update(schema.get("ack", []))
    want.update(contract.get("common", {}).get("ack", []))
    return want


@rule(
    "ack-contract",
    "ack-dict fields are an additive wire contract: a field in the "
    "checked-in snapshot (tools/analyze_contract.json) may never disappear "
    "from the daemon's answers",
    family="wire",
)
def _check_ack_contract(project: Project) -> List[Finding]:
    out: List[Finding] = []
    if project.contract is None:
        return out
    want = _contract_ack_union(project.contract)
    daemons = [m for m in project.modules if m.relpath == "serve/daemon.py"]
    if not daemons:
        return out
    have: Set[str] = set()
    for mod in daemons:
        have |= collect_ack_fields(mod)
    for fieldname in sorted(want - have):
        out.append(
            Finding(
                "ack-contract",
                daemons[0].display_path,
                1,
                "<module>",
                f'ack field "{fieldname}" is in the wire-contract snapshot '
                "but no longer answered by the daemon — ack fields may only "
                "be ADDED (clients key on them); restore it or version the "
                "protocol",
            )
        )
    new = sorted(have - want)
    if new:
        project.notes.append(
            "new ack field(s) not yet in tools/analyze_contract.json "
            f"(additive, allowed): {', '.join(new)} — run "
            "`python -m spark_rapids_ml_tpu_torch.tools.analyze --write-contract`"
        )
    return out


def _req_reads_in(
    nodes: Sequence[ast.AST], req_names: Set[str], fields: Set[str]
) -> None:
    """Request fields read in ``nodes`` (already-walked AST nodes — this
    does NOT recurse): ``req["k"]``, ``req.get("k")``, and
    ``_opt(req, "k", default)`` for any request-dict alias in
    ``req_names``."""
    for node in nodes:
        if isinstance(node, ast.Subscript):
            base = node.value
            if isinstance(base, ast.Name) and base.id in req_names:
                s = const_str(node.slice)
                if s is not None:
                    fields.add(s)
        elif isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "get"
                and isinstance(fn.value, ast.Name)
                and fn.value.id in req_names
                and node.args
            ):
                s = const_str(node.args[0])
                if s is not None:
                    fields.add(s)
            elif (
                terminal_name(fn) == "_opt"
                and len(node.args) >= 2
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in req_names
            ):
                s = const_str(node.args[1])
                if s is not None:
                    fields.add(s)


def collect_op_schemas(
    project: Project, mod: Module
) -> Tuple[Dict[str, Dict[str, Set[str]]], Dict[str, Set[str]]]:
    """Per-op wire schemas, statically extracted from the daemon's
    ``_dispatch`` chain: for every ``op == "x"`` / ``op in (...)`` arm,
    the request fields the handler READS (``req["k"]`` / ``req.get`` /
    ``_opt``) and the ack fields it ANSWERS (``send_json`` /
    ``_send_arrays_counted`` dicts), followed through helper calls that
    receive ``req``/``conn`` (``self._op_feed(conn, req)``,
    ``_recv_arrays_aligned(conn, req)``, ``self._get_job(req)``, …) to a
    fixpoint over the call graph. Returns ``(ops, common)`` where
    ``common`` holds the pre-dispatch surface every op shares (auth,
    version fence, busy shedding, the error ack)."""
    graph = project.graph
    returns = _dict_return_keys(mod)
    dispatch_fn = None
    for fn_node in iter_functions(mod):
        if fn_node.name == "_dispatch" and _enclosing_class(mod, fn_node):
            dispatch_fn = fn_node
            break
    if dispatch_fn is None:
        return {}, {"req": set(), "ack": set()}

    def scan_scope(
        owner_fn: ast.AST,
        stmts: Sequence[ast.AST],
        req_names: Set[str],
        req_fields: Set[str],
        ack_fields: Set[str],
        visited: Set[Tuple[str, str]],
        depth: int = 0,
    ) -> None:
        """One handler scope: direct reads + acks, then follow helper
        calls that receive the request dict or the connection."""
        all_nodes = [sub for stmt in stmts for sub in ast.walk(stmt)]
        _req_reads_in(all_nodes, req_names, req_fields)
        for node in all_nodes:
            if not isinstance(node, ast.Call):
                continue
            _scrape_ack_call(mod, node, returns, ack_fields)
            if depth >= 6:
                continue
            # Which positional args carry the request dict / conn?
            passed: List[Tuple[int, str]] = []
            for i, arg in enumerate(node.args):
                if isinstance(arg, ast.Name) and (
                    arg.id in req_names or arg.id == "conn"
                ):
                    passed.append((i, arg.id))
            if not passed:
                continue
            for target in graph.resolve_call(mod, owner_fn, node):
                if target.mod.relpath != mod.relpath:
                    continue  # the wire surface lives in the daemon
                if target.key in visited:
                    continue
                visited.add(target.key)
                params = [
                    a.arg for a in target.fn.args.args if a.arg != "self"
                ]
                callee_req: Set[str] = set()
                for pos, argname in passed:
                    if argname == "conn":
                        continue
                    if pos < len(params):
                        callee_req.add(params[pos])
                # default: the package convention names it `req`
                callee_req.add("req")
                scan_scope(
                    target.fn,
                    target.fn.body,
                    callee_req,
                    req_fields,
                    ack_fields,
                    visited,
                    depth + 1,
                )

    # --- the op arms -------------------------------------------------------
    def arm_ops(test: ast.AST) -> List[str]:
        if not isinstance(test, ast.Compare) or len(test.ops) != 1:
            return []
        names = [test.left, *test.comparators]
        if not any(
            (terminal_name(n) or "").split(".")[-1] in ("op",)
            or (terminal_name(n) or "").endswith("_op")
            for n in names
        ):
            return []
        op_strs: List[str] = []
        cmp_op = test.ops[0]
        if isinstance(cmp_op, ast.Eq):
            for side in names:
                s = const_str(side)
                if s is not None:
                    op_strs.append(s)
        elif isinstance(cmp_op, ast.In) and isinstance(
            test.comparators[0], (ast.Tuple, ast.List, ast.Set)
        ):
            for elt in test.comparators[0].elts:
                s = const_str(elt)
                if s is not None:
                    op_strs.append(s)
        return op_strs

    ops: Dict[str, Dict[str, Set[str]]] = {}
    arm_stmt_ids: Set[int] = set()
    for node in ast.walk(dispatch_fn):
        if not isinstance(node, ast.If):
            continue
        if _enclosing_function(mod, node) is not dispatch_fn:
            continue  # _drain_payload-style nested helpers
        for op in arm_ops(node.test):
            schema = ops.setdefault(op, {"req": set(), "ack": set()})
            visited: Set[Tuple[str, str]] = set()
            scan_scope(
                dispatch_fn,
                node.body,
                {"req"},
                schema["req"],
                schema["ack"],
                visited,
            )
        if arm_ops(node.test):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    arm_stmt_ids.add(id(sub))

    # --- the common pre-dispatch surface -----------------------------------
    common = {"req": set(), "ack": set()}  # type: Dict[str, Set[str]]
    serve_fns = [dispatch_fn]
    for fn_node in iter_functions(mod):
        if fn_node.name in ("_serve_conn_inner", "_op_trace"):
            serve_fns.append(fn_node)
    for fn_node in serve_fns:
        nodes = [
            n
            for n in ast.walk(fn_node)
            if id(n) not in arm_stmt_ids
            and _enclosing_function(mod, n) is fn_node
        ]
        # scan without following calls: the followed helpers belong to
        # the per-op schemas; common is the literal shared preamble
        _req_reads_in(nodes, {"req"}, common["req"])
        for node in nodes:
            if isinstance(node, ast.Call):
                _scrape_ack_call(mod, node, returns, common["ack"])
    return ops, common


@rule(
    "wire-schema",
    "per-op wire schemas (request fields read + ack fields answered by "
    "every daemon op handler) may only ever GROW versus the checked-in "
    "snapshot, and every dispatched op keeps its docs/protocol.md "
    "catalog entry — field removal and doc drift both fail",
    family="wire",
)
def _check_wire_schema(project: Project) -> List[Finding]:
    out: List[Finding] = []
    daemons = [m for m in project.modules if m.relpath == "serve/daemon.py"]
    if not daemons:
        return out
    mod = daemons[0]
    ops, common = collect_op_schemas(project, mod)
    if project.strict_floors and len(ops) < 15:
        out.append(
            Finding(
                "wire-schema",
                mod.display_path,
                1,
                "<module>",
                f"only {len(ops)} op handlers extracted from _dispatch — "
                "the dispatch shape or the schema extractor regressed",
                family="wire",
            )
        )
    # Doc-catalog drift: every dispatched op must keep its own `### <op>`
    # heading in docs/protocol.md (wire-op-clamp only requires a MENTION;
    # deleting the catalog entry while the word survives in prose is the
    # drift this closes).
    if project.protocol_doc is not None:
        for op in sorted(ops):
            if not re.search(
                rf"(?m)^###\s+{re.escape(op)}\b", project.protocol_doc
            ):
                out.append(
                    Finding(
                        "wire-schema",
                        mod.display_path,
                        1,
                        "<module>",
                        f'op "{op}" is dispatched but has no "### {op}" '
                        "catalog entry in docs/protocol.md — the per-op "
                        "contract section third-party clients read",
                        family="wire",
                    )
                )
    contract = project.contract
    if contract is None or "ops" not in contract:
        return out
    snap_common = contract.get("common", {})
    for fieldname in sorted(
        set(snap_common.get("ack", [])) - common["ack"]
    ):
        out.append(
            Finding(
                "wire-schema",
                mod.display_path,
                1,
                "<module>",
                f'common ack field "{fieldname}" (answered on every op\'s '
                "shared path per the snapshot) is no longer emitted",
                family="wire",
            )
        )
    new_bits: List[str] = []
    for op, snap in sorted(contract["ops"].items()):
        if op not in ops:
            out.append(
                Finding(
                    "wire-schema",
                    mod.display_path,
                    1,
                    "<module>",
                    f'op "{op}" is in the wire-schema snapshot but no '
                    "longer dispatched — removing an op breaks every "
                    "client that speaks it; restore it or version the "
                    "protocol",
                    family="wire",
                )
            )
            continue
        have = ops[op]
        for fieldname in sorted(set(snap.get("ack", [])) - have["ack"]):
            out.append(
                Finding(
                    "wire-schema",
                    mod.display_path,
                    1,
                    "<module>",
                    f'op "{op}" no longer answers ack field "{fieldname}" '
                    "(per-op wire-schema snapshot) — ack fields may only "
                    "be ADDED; restore it or version the protocol",
                    family="wire",
                )
            )
        for fieldname in sorted(set(snap.get("req", [])) - have["req"]):
            out.append(
                Finding(
                    "wire-schema",
                    mod.display_path,
                    1,
                    "<module>",
                    f'op "{op}" no longer reads request field '
                    f'"{fieldname}" (per-op wire-schema snapshot) — a '
                    "request option silently became a no-op for every "
                    "client that sets it",
                    family="wire",
                )
            )
        grown_ack = sorted(have["ack"] - set(snap.get("ack", [])))
        grown_req = sorted(have["req"] - set(snap.get("req", [])))
        if grown_ack or grown_req:
            new_bits.append(
                f"{op} (+ack: {', '.join(grown_ack) or '-'}; "
                f"+req: {', '.join(grown_req) or '-'})"
            )
    for op in sorted(set(ops) - set(contract["ops"])):
        new_bits.append(f"new op {op}")
    if new_bits:
        project.notes.append(
            "per-op wire schemas grew (additive, allowed): "
            + "; ".join(new_bits)
            + " — refresh with `python -m spark_rapids_ml_tpu_torch.tools."
            "analyze --write-contract`"
        )
    return out


# ---------------------------------------------------------------------------
# ported regex gates (the engine's first rules)
# ---------------------------------------------------------------------------


@rule(
    "bare-print",
    "library code logs through the package logger, never print() — stdout "
    "belongs to the host application (and Spark's worker protocol); "
    "tools/ and `if __name__ == '__main__'` tails are exempt",
    family="hygiene",
)
def _check_bare_print(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if mod.relpath.split("/", 1)[0] == "tools":
            continue
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                if in_main_guard(mod, node):
                    continue
                out.append(
                    project.finding(
                        mod,
                        node,
                        "bare-print",
                        "bare print() in library code — use the package "
                        "logger (utils/logging.py) or record a metric",
                    )
                )
    return out


#: torch.distributed's collective and point-to-point calls.
_COLLECTIVES = frozenset((
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "gather",
    "gather_object", "scatter", "scatter_object_list", "send", "recv",
    "isend", "irecv", "batch_isend_irecv", "barrier", "monitored_barrier",
))


def _distributed_names(mod: Module) -> Tuple[Set[str], Set[str]]:
    """(module aliases of ``torch.distributed``, collectives imported by
    name from it) in one module: ``import torch.distributed as dist``,
    ``from torch import distributed as td``, ``from torch.distributed
    import all_reduce``."""
    aliases: Set[str] = set()
    direct: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch.distributed" and alias.asname:
                    aliases.add(alias.asname)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                if node.module == "torch" and alias.name == "distributed":
                    aliases.add(alias.asname or alias.name)
                elif node.module == "torch.distributed" and alias.name in _COLLECTIVES:
                    direct.add(alias.asname or alias.name)
    return aliases, direct


@rule(
    "bare-collective",
    "torch.distributed collectives and point-to-point calls go through "
    "parallel/ (mapreduce, distributed) — a bare dist.all_reduce/send/"
    "barrier outside parallel/ bypasses the mesh's groups, the gloo "
    "staging of CUDA tensors and the collective-trace accounting",
    family="hygiene",
)
def _check_bare_collective(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if mod.relpath.split("/", 1)[0] == "parallel":
            continue
        aliases, direct = _distributed_names(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            what = None
            if isinstance(fn, ast.Attribute) and fn.attr in _COLLECTIVES:
                base = dotted_name(fn.value)
                if base == "torch.distributed" or base in aliases:
                    what = f"{base}.{fn.attr}"
            elif isinstance(fn, ast.Name) and fn.id in direct:
                what = fn.id
            if what is None:
                continue
            out.append(
                project.finding(
                    mod,
                    node,
                    "bare-collective",
                    f"bare collective {what}() outside parallel/ — route it "
                    "through parallel.mapreduce/distributed so the mesh's "
                    "groups and the collective accounting see it",
                )
            )
    return out


@rule(
    "socket-timeout",
    "socket.create_connection without an explicit timeout inherits the "
    "global default (None = block forever); one unreachable daemon would "
    "hang its caller instead of failing into the retry/healing path",
    family="hygiene",
)
def _check_socket_timeout(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func) != "socket.create_connection" and not (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "create_connection"
                and terminal_name(node.func.value) == "socket"
            ):
                continue
            has_timeout = len(node.args) >= 2 or any(
                kw.arg == "timeout" or kw.arg is None for kw in node.keywords
            )
            if not has_timeout:
                out.append(
                    project.finding(
                        mod,
                        node,
                        "socket-timeout",
                        "socket.create_connection without an explicit "
                        "timeout= — the default (None) blocks forever on an "
                        "unreachable peer",
                    )
                )
    return out


def _module_dict_keys(mod: Module, name: str) -> Optional[Set[str]]:
    """Constant keys of a module-level ``NAME = {...}`` dict literal."""
    for node in mod.tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(terminal_name(t) == name for t in node.targets)
            and isinstance(node.value, ast.Dict)
        ):
            return {s for k in node.value.keys if k is not None
                    for s in [const_str(k)] if s is not None}
    return None


def _counter_bumps(fn_node: ast.AST, counter: str) -> List[ast.AST]:
    """The subscripts of ``COUNTER[<key>] += ...`` in one function."""
    return [
        node.target.slice
        for node in ast.walk(fn_node)
        if isinstance(node, ast.AugAssign)
        and isinstance(node.target, ast.Subscript)
        and terminal_name(node.target.value) == counter
    ]


def _fstring_prefix(expr: ast.AST) -> Optional[str]:
    """The constant head of an f-string (``"gram/"`` of f"gram/{route}")."""
    if isinstance(expr, ast.JoinedStr) and expr.values:
        head = expr.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    return const_str(expr)


@rule(
    "kernel-ledger",
    "every kernel launch in ops/kernels.py runs under `with "
    "_ledger(\"<name>\", route, ...)` with a constant name launched from "
    "one place, bumps LAUNCHES[\"<name>\"] (a key of the module's "
    "LAUNCHES), has <name>_plain beside it, and a routed launch bumps "
    "ROUTES[f\"<name>/{route}\"] — an unledgered launch is invisible to the "
    "kernel ledger and to the launch counts every card run is checked with",
    family="ledger",
)
def _check_kernel_ledger(project: Project) -> List[Finding]:
    out: List[Finding] = []
    mods = [m for m in project.modules if m.relpath == KERNELS_MODULE]
    if not mods:
        return out
    mod = mods[0]
    reg = project.kernels
    launches_keys = _module_dict_keys(mod, "LAUNCHES") or set()
    plains = set(project.graph.module_funcs.get(KERNELS_MODULE, {}))
    first: Dict[str, LaunchSite] = {}
    for site in reg.launches:
        node = site.node
        if site.name is None:
            out.append(project.finding(
                mod, node, "kernel-ledger",
                "kernel launch under a _ledger record whose name is not a "
                "constant — the ledger, LAUNCHES and the card's checks key "
                "on the kernel's name",
            ))
            continue
        name = site.name
        if name in first:
            out.append(project.finding(
                mod, node, "kernel-ledger",
                f'kernel "{name}" is launched here and in '
                f"{first[name].fn.qualname}() — one launch site a kernel, "
                "so its ledger record and launch count mean one thing",
            ))
            continue
        first[name] = site
        bumps = [const_str(k) for k in _counter_bumps(site.fn.fn, "LAUNCHES")]
        if name not in bumps:
            out.append(project.finding(
                mod, node, "kernel-ledger",
                f'{site.fn.qualname}() launches "{name}" without '
                f'LAUNCHES["{name}"] += 1 — the card run cannot show the '
                "main path went through the kernel",
            ))
        if name not in launches_keys:
            out.append(project.finding(
                mod, node, "kernel-ledger",
                f'"{name}" is not a key of the module\'s LAUNCHES dict',
            ))
        if f"{name}_plain" not in plains:
            out.append(project.finding(
                mod, node, "kernel-ledger",
                f'kernel "{name}" has no {name}_plain() beside it — the plain '
                "PyTorch version the kernel is held against and the CPU runs",
            ))
        if site.route is None:
            prefixes = [
                _fstring_prefix(k) for k in _counter_bumps(site.fn.fn, "ROUTES")
            ]
            if not any(p is not None and p.startswith(f"{name}/") for p in prefixes):
                out.append(project.finding(
                    mod, node, "kernel-ledger",
                    f'kernel "{name}" has a computed route but no '
                    f'ROUTES[f"{name}/{{route}}"] += 1 — which body ran is '
                    "unrecorded",
                ))
    # Every constant ledger name of the module (the CPU branch's "plain"
    # records included) names a launched kernel.
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or terminal_name(node.func) != "_ledger":
            continue
        name = const_str(node.args[0]) if node.args else None
        if name is not None and name not in first:
            out.append(project.finding(
                mod, node, "kernel-ledger",
                f'_ledger record "{name}" names no launched kernel — a '
                "typo splits one kernel's accounting in two",
            ))
    if project.strict_floors and len(first) < MIN_KERNELS:
        out.append(
            Finding(
                "kernel-ledger",
                mod.display_path,
                1,
                "<module>",
                f"only {len(first)} ledgered kernel launch sites found in "
                f"{KERNELS_MODULE} (expected {MIN_KERNELS}) — the launch "
                "pattern or this collector regressed",
                family="ledger",
            )
        )
    return out


@rule(
    "hot-path-span",
    "every model hot path (module-level fit_* functions, "
    "transform_matrix/kneighbors methods in models/) runs under a "
    "trace_span — spans are the ONLY source of the per-phase breakdown, "
    "so an unspanned hot path is invisible to every dashboard and every "
    "perf PR",
    family="ledger",
)
def _check_hot_path_span(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if mod.relpath.split("/", 1)[0] != "models":
            continue
        if mod.relpath.endswith("__init__.py"):
            continue
        for fn_node in iter_functions(mod):
            cls = _enclosing_class(mod, fn_node)
            is_fit = (
                cls is None
                and _enclosing_function(mod, fn_node) is None
                and fn_node.name.startswith("fit_")
            )
            is_hot_method = cls is not None and fn_node.name in (
                "transform_matrix",
                "kneighbors",
            )
            if not (is_fit or is_hot_method):
                continue
            spanned = any(
                isinstance(sub, ast.Call)
                and terminal_name(sub.func) == "trace_span"
                for sub in ast.walk(fn_node)
            )
            if not spanned:
                out.append(
                    project.finding(
                        mod,
                        fn_node,
                        "hot-path-span",
                        f"model hot path {fn_node.name}() has no "
                        "trace_span — the phase breakdown (metrics "
                        "histogram + run journal) cannot see it",
                    )
                )
    return out


@rule(
    "no-jax-import",
    "the port imports nothing of JAX: no module imports jax, jaxlib or "
    "spark_rapids_ml_tpu (whose __init__ imports jax), not even a "
    "stdlib-only module of it — the card's machine has no jax",
    family="hygiene",
)
def _check_no_jax_import(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            names: List[str] = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            elif isinstance(node, ast.Call) and node.args and (
                dotted_name(node.func) in ("importlib.import_module", "__import__")
            ):
                s = const_str(node.args[0])
                names = [s] if s is not None else []
            for name in names:
                if name.split(".")[0] in FORBIDDEN_ROOTS:
                    out.append(project.finding(
                        mod, node, "no-jax-import",
                        f"imports {name} — the port keeps its own copy of "
                        "whatever it needs from the JAX package",
                    ))
    return out


@rule(
    "kernel-fallback",
    "in ops/ and models/ no except handler around a kernel launch calls a "
    "*_plain version: a CUDA tensor launches its kernel or raises — a "
    "silent fallback hides a kernel that does not build or launch",
    family="ledger",
)
def _check_kernel_fallback(project: Project) -> List[Finding]:
    graph = project.graph
    reg = project.kernels
    out: List[Finding] = []
    for mod in project.modules:
        if mod.relpath.split("/", 1)[0] not in ("ops", "models"):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try) or not node.handlers:
                continue
            fn = _enclosing_function(mod, node)
            launch = None
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    targets = graph.resolve_call(mod, fn, sub)
                    entry = reg.entry_of(targets)
                    if entry is not None:
                        launch = entry.qualname
                    elif any(t.key in graph.loaders for t in targets):
                        launch = terminal_name(sub.func)
                    if launch:
                        break
                if launch:
                    break
            if launch is None:
                continue
            for handler in node.handlers:
                for sub in ast.walk(handler):
                    if (
                        isinstance(sub, ast.Call)
                        and (terminal_name(sub.func) or "").endswith("_plain")
                    ):
                        out.append(project.finding(
                            mod, sub, "kernel-fallback",
                            f"except handler around {launch}() calls "
                            f"{terminal_name(sub.func)}() — a failed launch "
                            "must raise, never fall back to the plain version",
                        ))
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def rewrite_baseline(
    project: Project,
    old: Optional[Baseline],
    new_findings: Sequence[Finding],
    selected_rules: Optional[Sequence[str]] = None,
) -> Baseline:
    """The --write-baseline merge: this run's new findings become
    accepted, still-live accepted entries keep their MATCHED counts
    (stale ones fall off — the ratchet), and entries a restricted run
    never evaluated (``--rule`` not selecting them, or a path filter
    excluding their file) are preserved verbatim — a partial run must
    not silently un-accept what it did not look at."""
    merged = Baseline.from_findings(new_findings)
    if old is None:
        return merged
    selected = set(selected_rules) if selected_rules else None
    known_files = {m.display_path for m in project.modules}
    for key, cap in old.entries.items():
        rule_id, file_, _sym = key
        if (
            (selected is not None and rule_id not in selected)
            or file_ not in known_files
            or not project.in_report_scope(file_)
        ):
            merged.entries[key] = merged.entries.get(key, 0) + cap
        else:
            used = old._matched.get(key, 0)
            if used:
                merged.entries[key] = merged.entries.get(key, 0) + used
    return merged


def write_contract(project: Project, path: Path = CONTRACT_PATH) -> Dict[str, Any]:
    """Refresh the wire-contract snapshot (v2, per-op): for every daemon
    op, the request fields its handler reads and the ack fields it
    answers; ``common`` is the shared pre-dispatch surface; the flat
    ``ack_fields`` union (the module-wide scrape — a superset of the
    per-op walk, catching sends outside the dispatch chain) stays for
    the ack-contract ratchet."""
    fields: Set[str] = set()
    ops: Dict[str, Dict[str, Set[str]]] = {}
    common: Dict[str, Set[str]] = {"req": set(), "ack": set()}
    for mod in project.modules:
        if mod.relpath == "serve/daemon.py":
            fields |= collect_ack_fields(mod)
            ops, common = collect_op_schemas(project, mod)
    contract = {
        "version": 2,
        "ack_fields": sorted(fields),
        "common": {
            "req": sorted(common["req"]),
            "ack": sorted(common["ack"]),
        },
        "ops": {
            op: {
                "req": sorted(schema["req"]),
                "ack": sorted(schema["ack"]),
            }
            for op, schema in sorted(ops.items())
        },
    }
    path.write_text(json.dumps(contract, indent=2) + "\n")
    return contract


def reverse_dependents(
    project: Project, relpaths: Sequence[str]
) -> List[str]:
    """``relpaths`` plus every module that transitively IMPORTS one of
    them — the reverse import closure. The interprocedural rules read
    whole-program facts, so a change in ops/gram.py can surface a
    finding in serve/daemon.py: restricting a --changed-only run to the
    changed files alone would miss exactly the cross-module findings
    this engine exists to catch."""
    importers: Dict[str, Set[str]] = {}
    for mod_rel, imports in project.graph.module_imports.items():
        for src in imports:
            importers.setdefault(src, set()).add(mod_rel)
    out: Set[str] = {r for r in relpaths if r in project._known_mods}
    work = sorted(out)
    while work:
        cur = work.pop()
        for dep in sorted(importers.get(cur, ())):
            if dep not in out:
                out.add(dep)
                work.append(dep)
    return sorted(out)


def _git_changed_package_files(ref: str, pkg_root: Path = PKG_ROOT) -> List[str]:
    """Package-relative paths of *.py files changed versus ``ref``:
    committed, staged, and unstaged (`git diff <ref>` covers all three
    against the working tree) PLUS untracked files (`git ls-files
    --others`) — the pre-commit loop runs exactly when new modules have
    not been `git add`ed yet, and a brand-new file with a finding must
    not scope itself out of its own report."""
    import subprocess

    out: List[str] = []
    prefix = pkg_root.name + "/"
    for cmd in (
        ["git", "diff", "--name-only", ref, "--", str(pkg_root)],
        ["git", "ls-files", "--others", "--exclude-standard", "--",
         str(pkg_root)],
    ):
        proc = subprocess.run(
            cmd,
            capture_output=True,
            text=True,
            cwd=str(pkg_root.parent),
            timeout=30,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd[:3])} failed: {proc.stderr.strip()}"
            )
        for line in proc.stdout.splitlines():
            line = line.strip().replace("\\", "/")
            if line.startswith(prefix) and line.endswith(".py"):
                out.append(line[len(prefix):])
    return sorted(set(out))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m spark_rapids_ml_tpu_torch.tools.analyze",
        description="srml-check for the PyTorch port: AST invariant "
        "analyzer for the lock/determinism/wire/kernel contracts",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="package-relative paths to restrict REPORTING to (e.g. "
        "'serve' or 'ops/gram.py'); the whole package is always parsed "
        "for cross-module context. Default: report everything",
    )
    parser.add_argument("--json", action="store_true", help="machine output")
    parser.add_argument(
        "--rule",
        action="append",
        dest="rules",
        metavar="RULE",
        help="run only this rule (repeatable)",
    )
    parser.add_argument(
        "--baseline",
        type=Path,
        default=BASELINE_PATH,
        help="baseline JSON path (default: tools/analyze_baseline.json)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring the baseline",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept the current unsuppressed findings into the baseline",
    )
    parser.add_argument(
        "--write-contract",
        action="store_true",
        help="refresh the wire-contract snapshot (v2: per-op request/ack schemas + the flat ack-field union)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--changed-only",
        metavar="GIT_REF",
        default=None,
        help="report only findings in modules whose files changed versus "
        "GIT_REF, plus their reverse import-graph dependents (analysis is "
        "still whole-program) — the fast pre-commit mode (CONTRIBUTING.md)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid:26s} [{RULES[rid].family}] {RULES[rid].summary}")
        return 0

    if args.changed_only and args.paths:
        print(
            "srml-check: --changed-only and explicit paths are mutually "
            "exclusive",
            file=sys.stderr,
        )
        return 2

    try:
        project = Project.from_package(paths=args.paths or None)
    except SyntaxError as e:
        print(f"srml-check: cannot parse {e.filename}:{e.lineno}: {e.msg}", file=sys.stderr)
        return 2

    if args.changed_only:
        try:
            changed = _git_changed_package_files(args.changed_only)
        except RuntimeError as e:
            print(f"srml-check: {e}", file=sys.stderr)
            return 2
        scope = reverse_dependents(project, changed)
        project.report_filter = scope
        print(
            f"srml-check: --changed-only {args.changed_only}: "
            f"{len(changed)} changed file(s) → reporting on {len(scope)} "
            "module(s) (changed + reverse dependents)",
            file=sys.stderr,
        )

    if args.write_contract:
        contract = write_contract(project)
        print(
            f"wrote {CONTRACT_PATH} ({len(contract['ack_fields'])} ack fields)"
        )
        project.contract = contract

    baseline = None if args.no_baseline else Baseline.load(args.baseline)
    try:
        findings = project.run(rules=args.rules, baseline=baseline)
    except KeyError as e:
        print(f"srml-check: {e.args[0]}", file=sys.stderr)
        return 2

    if args.write_baseline:
        # run() already consumed the old baseline, so `findings` are
        # exactly the NEW ones; rewrite_baseline keeps still-live accepted
        # entries (and preserves what a --rule/path-restricted run never
        # evaluated), dropping only the stale.
        merged = rewrite_baseline(project, baseline, findings, args.rules)
        args.baseline.write_text(merged.as_json())
        print(f"wrote {args.baseline} ({sum(merged.entries.values())} accepted findings)")
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in findings],
                    "notes": project.notes,
                    "rules": sorted(args.rules or RULES),
                    "ok": not findings,
                },
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f.format())
        for note in project.notes:
            print(f"note: {note}", file=sys.stderr)
        if not findings:
            n = len(args.rules) if args.rules else len(RULES)
            print(
                f"srml-check: OK — {len(project.modules)} files, {n} rules, "
                "zero unsuppressed findings"
            )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
