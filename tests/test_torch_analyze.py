"""srml-check of the port (``spark_rapids_ml_tpu_torch/tools/analyze.py``).

Four layers:

1. PARITY with the JAX analyzer. The synthetic fixtures of
   ``tests/test_analyze.py`` (copied here, not imported) go through JAX
   ``Project`` and the port's: every rule whose id and meaning carry over
   gives the same (rule, path, line, symbol) findings, and the engine gives
   the same call graph, witness chains, holds-lock sets and thread
   reachability.
2. The REMAPPED and PORT-ONLY rules (``device-lock``,
   ``compile-outside-lock``, ``bare-collective``, ``kernel-ledger``,
   ``kernel-fallback``, ``no-jax-import``), each with a flagged case and a
   clean one, and the ``nvcc`` chain the port's daemon had: fold → kernel
   entry → loader → ``_build.load`` → ``subprocess.run`` under
   ``_DEVICE_LOCK``, exempt only once the daemon primes its loaders.
3. The DAEMON's start-up prime: on a card it loads the three kernel
   libraries before it listens and outside every lock; on the CPU it loads
   nothing.
4. The WHOLE PORT, analyzed once for this module: zero unsuppressed
   findings, no stale baseline entry, a reason beside every pragma, the
   port's own wire snapshot, and the CLI.
"""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from spark_rapids_ml_tpu.tools import analyze as jax_analyze
from spark_rapids_ml_tpu_torch.tools import analyze
from spark_rapids_ml_tpu_torch.tools.analyze import Baseline, Project

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "spark_rapids_ml_tpu_torch"

#: Rules whose id and meaning are the JAX analyzer's.
SAME_RULES = (
    "lock-order", "lock-graph-cycle", "blocking-under-device-lock",
    "thread-shared-state", "unsorted-iter", "wallclock-entropy", "wire-op-clamp",
    "ack-contract", "wire-schema", "bare-print", "socket-timeout", "hot-path-span",
)
#: The port's rules that remap a JAX rule or are the port's own.
PORT_RULES = ("device-lock", "compile-outside-lock", "bare-collective", "kernel-ledger",
              "kernel-fallback", "no-jax-import")


def run_rules(files, *rules, **kw):
    project = Project(files=dict(files), **kw)
    return project, project.run_raw(rules=list(rules))


def keys(findings):
    return [(f.rule, f.file, f.line, f.symbol) for f in findings]


# ---------------------------------------------------------------------------
# the JAX analyzer's fixtures (tests/test_analyze.py)
# ---------------------------------------------------------------------------

GRAM_FIXTURE = '''
import functools
from spark_rapids_ml_tpu.utils.xprof import ledgered_jit

def streaming_update(mesh):
    @functools.partial(ledgered_jit, "gram.streaming_update", donate_argnums=(0,))
    def update(state, x, mask):
        return state
    return update
'''


def _daemon(src: str) -> dict:
    return {"ops/gram.py": GRAM_FIXTURE, "serve/daemon.py": src}


DAEMON_WIRE = '''
_KNOWN_OPS = frozenset(("ping", "feed"))

def dispatch(op, conn):
    if op == "ping":
        protocol.send_json(conn, {"ok": True})
    elif op == "fe" + "ed":
        protocol.send_json(conn, {"ok": True, "rows": 1})
    elif op == f"fin{'alize'}":
        protocol.send_json(conn, {"ok": True})
'''

WIRE_SCHEMA_DAEMON = '''
class Daemon:
    def _dispatch(self, conn, req):
        op = req.get("op")
        if op == "ping":
            protocol.send_json(conn, {"ok": True, "v": 1})
        elif op == "feed":
            self._op_feed(conn, req)

    def _op_feed(self, conn, req):
        rows = int(req["rows"])
        batch = req.get("batch_id")
        protocol.send_json(conn, {"ok": True, "rows": rows})
'''

WIRE_SCHEMA_DOC = "### ping\n\n### feed\n"


def _wire_contract(**ops):
    return {"version": 2, "common": {"req": [], "ack": []}, "ops": ops}


CALLGRAPH_FILES = {
    "ops/util.py": '''
def leaf():
    import time
    time.sleep(0.1)

def mid():
    leaf()
''',
    "models/user.py": '''
from spark_rapids_ml_tpu.ops import util as util_ops
from spark_rapids_ml_tpu.ops.util import mid

class Runner:
    def run_all(self):
        self.helper()

    def helper(self):
        mid()

    def aliased(self):
        util_ops.leaf()

    def local(self):
        def inner():
            mid()
        inner()
''',
}

#: name → (files, Project keyword arguments).
FIXTURES = {
    "device-lock-outside": (_daemon('''
import threading
from spark_rapids_ml_tpu.ops.gram import streaming_update
_DEVICE_LOCK = threading.Lock()

class Job:
    def __init__(self, mesh):
        self.update = streaming_update(mesh)
    def fold(self, state, xs, ms):
        state = self.update(state, xs, ms)
        return state
'''), {}),
    "locked-helper-convention": (_daemon('''
import threading
import jax
_DEVICE_LOCK = threading.Lock()

class Job:
    lock = threading.Lock()
    def _finalize_locked(self):
        return jax.device_get(self.state)
    def _prune_locked(self):
        self.stale = None
    def finalize(self):
        with self.lock:
            with _DEVICE_LOCK:
                return self._finalize_locked()
    def model_lock_only(self):
        with self.lock:
            return self._finalize_locked()
    def broken(self):
        return self._finalize_locked()
    def prune(self):
        with self.lock:
            self._prune_locked()
'''), {}),
    "lock-order-device": (_daemon('''
import threading
_DEVICE_LOCK = threading.Lock()

class D:
    _models_lock = threading.Lock()
    def bad(self):
        with _DEVICE_LOCK:
            with self._models_lock:
                pass
    def good(self):
        with self._models_lock:
            with _DEVICE_LOCK:
                pass
'''), {}),
    "lock-order-multi-item": (_daemon('''
import threading
_DEVICE_LOCK = threading.Lock()

class D:
    _models_lock = threading.Lock()
    def bad(self):
        with _DEVICE_LOCK, self._models_lock:
            pass
'''), {}),
    "lock-cycle-lexical": ({"serve/fleet.py": '''
import threading

class F:
    _a_lock = threading.Lock()
    _b_lock = threading.Lock()
    def one(self):
        with self._a_lock:
            with self._b_lock:
                pass
    def two(self):
        with self._b_lock:
            with self._a_lock:
                pass
'''}, {}),
    "lock-cycle-none": ({"serve/fleet.py": '''
import threading

class F:
    _a_lock = threading.Lock()
    _b_lock = threading.Lock()
    def one(self):
        with self._a_lock:
            with self._b_lock:
                pass
    def two(self):
        with self._a_lock:
            with self._b_lock:
                pass
'''}, {}),
    "lock-cycle-call-edges": ({"serve/fleet.py": '''
import threading

class F:
    _a_lock = threading.Lock()
    _b_lock = threading.Lock()
    def path_one(self):
        with self._a_lock:
            self._grab_b()
    def _grab_b(self):
        with self._b_lock:
            pass
    def path_two(self):
        with self._b_lock:
            self._grab_a()
    def _grab_a(self):
        with self._a_lock:
            pass
'''}, {}),
    "closure-under-lock": (_daemon('''
import threading
from spark_rapids_ml_tpu.ops.gram import streaming_update
_DEVICE_LOCK = threading.Lock()

class Job:
    def __init__(self, mesh):
        self.update = streaming_update(mesh)
    def defer(self, schedule, s, x, m):
        with _DEVICE_LOCK:
            def cb():
                return self.update(s, x, m)
            schedule(cb)
'''), {}),
    "unsorted-bad": ({"ops/fold.py": '''
def merge(parts):
    total = 0
    for k, v in parts.items():
        total += v
    return total
'''}, {}),
    "unsorted-good": ({"ops/fold.py": '''
def merge(parts):
    total = 0
    for k, v in sorted(parts.items()):
        total += v
    return total
'''}, {}),
    "unsorted-scope": ({
        "serve/client.py": '''
def render(d):
    return [v for _, v in d.items()]
''',
        "ops/tables.py": '''
def build(arrays):
    want = {"a": 1, "b": 2}
    out = []
    for name, shape in want.items():
        out.append((name, shape))
    rekeyed = {k: float(v) for k, v in arrays.items()}
    return out, rekeyed
''',
    }, {}),
    "unsorted-set-fold": ({"serve/daemon.py": '''
def merge_peers(peers):
    acc = []
    for p in set(peers):
        acc.append(p)
    return acc
'''}, {}),
    "wallclock-bad": ({"models/kmeans.py": '''
import time
import numpy as np

def fit(x):
    t = time.time()
    noise = np.random.rand(4)
    return t, noise
'''}, {}),
    "wallclock-good": ({"models/kmeans.py": '''
import numpy as np

def fit(x, seed):
    rng = np.random.default_rng(seed)
    return rng.random(4)
'''}, {}),
    "wallclock-off-contract": ({"serve/client.py": '''
import time

def backoff():
    return time.time()
'''}, {}),
    "wire-clamp": ({"serve/daemon.py": DAEMON_WIRE}, {"protocol_doc": "ping feed"}),
    "wire-clamp-clean": (
        {"serve/daemon.py": DAEMON_WIRE.replace('("ping", "feed")',
                                                '("ping", "feed", "finalize")')},
        {"protocol_doc": "ping feed finalize"}),
    "ack-removed": ({"serve/daemon.py": '''
def _identity(self):
    return {"id": 1, "boot_id": 2}

def answer(self, conn):
    protocol.send_json(conn, {"ok": True, "rows": 3, **self._identity()})
'''}, {"contract": {"version": 1, "ack_fields": ["ok", "rows", "id", "boot_id", "gone"]}}),
    "ack-additive": ({"serve/daemon.py": '''
def _identity(self):
    return {"id": 1, "boot_id": 2}

def answer(self, conn):
    protocol.send_json(conn, {"ok": True, "rows": 3, **self._identity()})
'''}, {"contract": {"version": 1, "ack_fields": ["ok", "rows"]}}),
    "bare-print": ({
        "core/x.py": 'def f():\n    print("hi")\n',
        "tools/cli.py": 'def f():\n    print("hi")\n',
        "spark/entry.py": 'if __name__ == "__main__":\n    print("hi")\n',
    }, {}),
    "socket-timeout": ({"serve/client.py": '''
import socket

def bad(addr):
    return socket.create_connection(addr)

def good(addr):
    return socket.create_connection(addr, timeout=5.0)

def also_good(addr, t):
    return socket.create_connection(addr, t)
'''}, {}),
    "callgraph": (CALLGRAPH_FILES, {}),
    "attr-dispatch": ({
        "serve/a.py": '''
class Timer:
    def halt(self):
        pass

class Daemon:
    def halt(self):
        import time
        time.sleep(5)

def use(timer):
    timer.halt()
''',
        "spark/far.py": '''
class Unrelated:
    def halt(self):
        import time
        time.sleep(5)
''',
    }, {}),
    "inherited-alias": ({
        "ops/base.py": '''
class Base:
    def blocky(self):
        import time
        time.sleep(1)
''',
        "serve/child.py": '''
from spark_rapids_ml_tpu.ops.base import Base as RenamedBase

class Child(RenamedBase):
    def go(self):
        self.blocky()
''',
    }, {}),
    "long-held-closure": (_daemon('''
import threading
import time
_DEVICE_LOCK = threading.Lock()

class D:
    _cb_lock = threading.Lock()
    def defer(self, schedule):
        with self._cb_lock:
            def later():
                time.sleep(1)
            schedule(later)
    def bump(self):
        with self._cb_lock:
            self.n = 1
    def fold(self):
        with _DEVICE_LOCK:
            self.bump()
'''), {}),
    "entered-holding": ({"serve/d.py": '''
import threading

class D:
    _a_lock = threading.Lock()
    def outer(self):
        with self._a_lock:
            self.inner()
    def inner(self):
        pass
'''}, {}),
    "blocking-direct-transitive": (_daemon('''
import threading
import time
_DEVICE_LOCK = threading.Lock()

class D:
    def direct(self):
        with _DEVICE_LOCK:
            time.sleep(0.5)
    def transitive(self):
        with _DEVICE_LOCK:
            self._notify()
    def _notify(self):
        self._sock.sendall(b"x")
'''), {}),
    "blocking-contended": (_daemon('''
import threading
import time
_DEVICE_LOCK = threading.Lock()

class D:
    _stats_lock = threading.Lock()
    def flush(self):
        with self._stats_lock:
            self._sock.sendall(b"stats")
    def bump(self):
        with self._stats_lock:
            self.n = 1
    def fold(self):
        with _DEVICE_LOCK:
            self.bump()
'''), {}),
    "blocking-micro-lock": (_daemon('''
import threading
_DEVICE_LOCK = threading.Lock()

class D:
    _stats_lock = threading.Lock()
    def bump(self):
        with self._stats_lock:
            self.n = 1
    def fold(self):
        with _DEVICE_LOCK:
            self.bump()
'''), {}),
    "blocking-device-waits": (_daemon('''
import threading
import jax
_DEVICE_LOCK = threading.Lock()

class D:
    def dispatch(self, out):
        with _DEVICE_LOCK:
            return jax.block_until_ready(out)
    def unlocked_sleep(self):
        import time
        time.sleep(0.5)
'''), {}),
    "thread-timer": ({"serve/worker.py": '''
import threading

class W:
    def arm(self):
        threading.Timer(5.0, self._tick).start()
    def _tick(self):
        self.n = 1
'''}, {}),
    "thread-bad": ({"serve/worker.py": '''
import threading

class W:
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()
    def _loop(self):
        self.count = 0
'''}, {}),
    "thread-good": ({"serve/worker.py": '''
import threading

class W:
    _lock = threading.Lock()
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()
    def _loop(self):
        with self._lock:
            self.count = 0
'''}, {}),
    "thread-lock-on-path": ({"serve/worker.py": '''
import threading

class W:
    _lock = threading.Lock()
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()
    def _loop(self):
        with self._lock:
            self._flush()
    def _flush(self):
        self.pending = []
'''}, {}),
    "thread-globals": ({"serve/worker.py": '''
import threading

_COUNTER = 0

class W:
    def __init__(self):
        self.ok = True  # pre-publication: exempt
    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()
    def _loop(self):
        global _COUNTER
        _COUNTER += 1
'''}, {}),
    "wire-schema-additive": ({"serve/daemon.py": WIRE_SCHEMA_DAEMON}, {
        "contract": _wire_contract(ping={"req": [], "ack": ["ok"]},
                                   feed={"req": ["rows"], "ack": ["ok"]}),
        "protocol_doc": WIRE_SCHEMA_DOC}),
    "wire-schema-removed-fields": ({"serve/daemon.py": WIRE_SCHEMA_DAEMON}, {
        "contract": _wire_contract(ping={"req": [], "ack": ["ok", "v", "boot_id"]},
                                   feed={"req": ["rows", "batch_id", "pass_id"],
                                         "ack": ["ok", "rows"]}),
        "protocol_doc": WIRE_SCHEMA_DOC}),
    "wire-schema-removed-op-doc-drift": ({"serve/daemon.py": WIRE_SCHEMA_DAEMON}, {
        "contract": _wire_contract(ping={"req": [], "ack": ["ok"]},
                                   feed={"req": [], "ack": ["ok"]},
                                   legacy={"req": [], "ack": ["ok"]}),
        "protocol_doc": "### ping\n\nfeed is mentioned only in prose\n"}),
    "hot-path-bad": ({"models/thing.py": '''
def fit_thing(x):
    return x

class ThingModel:
    def transform_matrix(self, x):
        return x
'''}, {}),
    "hot-path-good": ({"models/thing.py": '''
from spark_rapids_ml_tpu.utils.profiling import trace_span

def fit_thing(x):
    with trace_span("fit"):
        return x

class ThingModel:
    def transform_matrix(self, x):
        with trace_span("transform"):
            return x

def plan_thing(x):
    return x
'''}, {}),
    "pragma": ({"ops/fold.py": '''
def merge(parts):
    total = 0
    for k, v in parts.items():  # srml: disable=unsorted-iter
        total += v
    for k, v in parts.items():
        total += v
    return total
'''}, {}),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_same_id_rules_find_what_the_jax_analyzer_finds(name):
    """Every rule whose id carries over, on every fixture: the same raw
    findings and the same findings after pragmas, and the same notes."""
    files, kw = FIXTURES[name]
    jp = jax_analyze.Project(files=dict(files), **kw)
    pp = Project(files=dict(files), **kw)
    assert keys(pp.run_raw(rules=list(SAME_RULES))) == keys(
        jp.run_raw(rules=list(SAME_RULES)))
    assert keys(pp.run(rules=list(SAME_RULES))) == keys(jp.run(rules=list(SAME_RULES)))
    # The notes name each package's own CLI.
    assert [n.replace("spark_rapids_ml_tpu_torch.", "spark_rapids_ml_tpu.")
            for n in pp.notes] == jp.notes


def _graph_facts(project):
    g = project.graph
    edges = sorted((s.caller, s.callee, s.call.lineno, s.held)
                   for sites in g.calls_out.values() for s in sites)
    return {
        "edges": edges,
        "may_block": dict(sorted(g.may_block.items())),
        "entered_holding": {k: sorted(v) for k, v in sorted(g.entered_holding.items())},
        "thread_entries": sorted((e.key, m.relpath, n.lineno) for e, m, n in g.thread_entries),
        "thread_reachable": sorted(g.thread_reachable),
        "unlocked_reachable": sorted(g.unlocked_reachable),
    }


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_engine_builds_the_jax_analyzers_graph_and_fixpoints(name):
    """Call resolution, witness chains, holds-lock propagation and thread
    reachability equal the JAX engine's on every fixture."""
    files, kw = FIXTURES[name]
    assert _graph_facts(Project(files=dict(files), **kw)) == _graph_facts(
        jax_analyze.Project(files=dict(files), **kw))


def test_the_engine_resolves_and_chains_as_the_jax_tests_pin():
    """The JAX tests' engine assertions, on the port's engine."""
    g = Project(files=dict(CALLGRAPH_FILES)).graph
    callees = lambda key: sorted(s.callee for s in g.calls_out.get(key, []))  # noqa: E731
    assert callees(("models/user.py", "Runner.run_all")) == [("models/user.py", "Runner.helper")]
    assert callees(("models/user.py", "Runner.aliased")) == [("ops/util.py", "leaf")]
    assert callees(("models/user.py", "Runner.local")) == [
        ("models/user.py", "Runner.local.inner")]
    chain = g.may_block[("models/user.py", "Runner.run_all")]
    assert "time.sleep" in chain[-1][3] and len(chain) >= 3
    assert analyze.reverse_dependents(Project(files=dict(CALLGRAPH_FILES)), ["ops/util.py"]) == [
        "models/user.py", "ops/util.py"]
    files, _ = FIXTURES["blocking-direct-transitive"]
    _, found = run_rules(files, "blocking-under-device-lock")
    assert found[1].chain and "sendall" in found[1].chain[-1][2]
    assert found[1].as_dict()["family"] == "lock"


def test_baseline_round_trip_stale_warning_and_rewrite_as_jax():
    bad = {"ops/fold.py": "def merge(parts):\n    return [v for k, v in parts.items()]\n"}
    clean = {"ops/fold.py": "def merge(parts):\n    return [v for k, v in sorted(parts.items())]\n"}
    raw = Project(files=bad).run(rules=["unsorted-iter"])
    assert len(raw) == 1
    accepted = Baseline.from_findings(raw)
    for _ in range(2):  # a Baseline is reusable across runs
        project = Project(files=bad)
        assert project.run(rules=["unsorted-iter"], baseline=accepted) == []
        assert project.notes == []
    project = Project(files=clean)
    assert project.run(rules=["unsorted-iter"], baseline=Baseline.from_findings(raw)) == []
    assert any("stale baseline entry" in n for n in project.notes)
    project = Project(files=bad)
    old = Baseline(entries=[
        {"rule": "device-lock", "file": "serve/daemon.py", "symbol": "Job.fold", "count": 2},
        {"rule": "unsorted-iter", "file": "ops/fold.py", "symbol": "merge", "count": 1},
        {"rule": "unsorted-iter", "file": "ops/fold.py", "symbol": "gone_fn", "count": 1},
    ])
    found = project.run(rules=["unsorted-iter"], baseline=old)
    merged = analyze.rewrite_baseline(project, old, found, selected_rules=["unsorted-iter"])
    assert merged.entries == {
        ("device-lock", "serve/daemon.py", "Job.fold"): 2,
        ("unsorted-iter", "ops/fold.py", "merge"): 1,
    }
    assert json.loads(merged.as_json())["version"] == 1


# ---------------------------------------------------------------------------
# the remapped and port-only rules
# ---------------------------------------------------------------------------

BUILD_FIXTURE = '''
import functools
import subprocess
import threading

_lock = threading.Lock()

def build(name):
    subprocess.run(["nvcc", name], capture_output=True)
    return name

def build_all():
    return [build(n) for n in ("gram", "knn")]

@functools.lru_cache(maxsize=None)
def load(name):
    with _lock:
        return build(name)
'''

KERNELS_FIXTURE = '''
import functools
from spark_rapids_ml_tpu_torch.ops import _build

LAUNCHES = {"gram_colsum": 0, "dist_topk": 0}
ROUTES = {"gram_colsum/wgmma": 0, "gram_colsum/ffma": 0}

def _ledger(name, route, *args):
    return None

@functools.lru_cache(maxsize=None)
def _lib():
    return _build.load("gram")

@functools.lru_cache(maxsize=None)
def _knn_lib():
    return _build.load("knn")

def load_libraries():
    _lib()
    _knn_lib()

def gram_colsum_plain(x, n_valid, state=None):
    return state

def gram_colsum(x, n_valid, state=None):
    if x.device.type == "cpu":
        with _ledger("gram_colsum", "plain"):
            return gram_colsum_plain(x, n_valid, state)
    route = "wgmma" if x.dtype == "bf16" else "ffma"
    with _ledger("gram_colsum", route):
        rc = _lib().srml_gram_colsum(x)
    LAUNCHES["gram_colsum"] += 1
    ROUTES[f"gram_colsum/{route}"] += 1
    return state

def dist_topk_plain(q, db, k):
    return q

def dist_topk(q, db, k):
    with _ledger("dist_topk", "ffma"):
        lib = _knn_lib()
        rc = lib.srml_dist_topk(q, db, k)
    LAUNCHES["dist_topk"] += 1
    return q
'''

GRAM_OPS_FIXTURE = '''
from spark_rapids_ml_tpu_torch.ops import kernels

def streaming_update_rows(state, x, n_valid):
    _fold_rows(state, x, n_valid)
    return state

def _fold_rows(state, x, rows):
    kernels.gram_colsum(x, rows, state=state)
'''

NVCC_DAEMON = '''
import threading
from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
from spark_rapids_ml_tpu_torch.ops import kernels

_DEVICE_LOCK = threading.Lock()

class _Job:
    lock = threading.Lock()
    def fold(self, x):
        with self.lock:
            with _DEVICE_LOCK:
                self._fold_locked(x)
    def _fold_locked(self, x):
        gram_ops.streaming_update_rows(self.state, x, len(x))

class DataPlaneDaemon:
    _conns_lock = threading.Lock()
    def start(self):
        PRIME
        return self
'''


def _port_files(daemon: str, **extra) -> dict:
    files = {"ops/_build.py": BUILD_FIXTURE, "ops/kernels.py": KERNELS_FIXTURE,
             "ops/gram.py": GRAM_OPS_FIXTURE, "serve/daemon.py": daemon}
    files.update(extra)
    return files


def test_the_nvcc_chain_under_the_device_lock_is_flagged_with_its_witness():
    """The chain the analyzer found in the port's daemon: a fold under
    _DEVICE_LOCK → the Gram fold → the kernel entry → its loader →
    _build.load → nvcc. A daemon that does not prime its loaders builds
    there on a cold build directory."""
    files = _port_files(NVCC_DAEMON.replace("PRIME", "pass"))
    project, found = run_rules(files, "blocking-under-device-lock")
    assert keys(found) == [("blocking-under-device-lock", "serve/daemon.py", 13, "_Job.fold")]
    hops = [n for _, _, n in found[0].chain]
    assert [h.split("]")[0] + "]" for h in hops] == [
        "[_Job._fold_locked]", "[streaming_update_rows]", "[_fold_rows]", "[gram_colsum]",
        "[_lib]", "[load]", "[build]"]
    assert "subprocess.run() waits on a child process" in hops[-1]
    assert project.graph.primed_loaders == set()


@pytest.mark.parametrize("prime,flagged", [
    ("kernels.load_libraries()", False),
    ("if self.cuda:\n            kernels.load_libraries()", False),
    ("kernels._lib()\n        kernels._knn_lib()", False),
    ("kernels._knn_lib()", True),  # the Gram library is not primed
    ("with self._conns_lock:\n            kernels.load_libraries()", True),
])
def test_a_loader_primed_at_daemon_start_is_the_encoded_exemption(prime, flagged):
    """``blocking-under-device-lock`` exempts a loader that a ``start``
    method of serve/daemon.py calls with no lock held: its library is
    cached before the first connection, so nothing builds under the lock."""
    files = _port_files(NVCC_DAEMON.replace("PRIME", prime))
    project, found = run_rules(files, "blocking-under-device-lock")
    assert bool(found) is flagged
    primed = {k[1] for k in project.graph.primed_loaders}
    assert ("_lib" in primed) is (not flagged)


DEVICE_DAEMON = '''
import threading
import torch
from spark_rapids_ml_tpu_torch.ops import gram as gram_ops
from spark_rapids_ml_tpu_torch.ops import kernels

_DEVICE_LOCK = threading.Lock()

class _Job:
    lock = threading.Lock()
    def good(self, x):
        with _DEVICE_LOCK:
            xd = x.to(self.device)
            kernels.gram_colsum(xd, 1)
            gram_ops.streaming_update_rows(self.state, xd, 1)
            torch.cuda.synchronize()
        return x.to(torch.float32)
    def launch(self, x):
        return kernels.gram_colsum(x, 1)
    def upload(self, x):
        return torch.as_tensor(x, device=self.device)
    def sync(self):
        torch.cuda.synchronize()
    def through_ops(self, x):
        gram_ops.streaming_update_rows(self.state, x, 1)
    def _upload_locked(self, x):
        self.state = x.cuda()
    def _takes_it_locked(self, x):
        with _DEVICE_LOCK:
            self.state = x.cuda()
    def job_lock_only(self, x):
        with self.lock:
            self._upload_locked(x)
            self._takes_it_locked(x)
    def device_lock(self, x):
        with self.lock:
            with _DEVICE_LOCK:
                self._upload_locked(x)
'''


def test_device_lock_flags_launches_syncs_uploads_and_calls_into_the_device_layer():
    _, found = run_rules(_port_files(DEVICE_DAEMON), "device-lock")
    assert [(f.symbol, f.line) for f in found] == [
        ("_Job.launch", 19), ("_Job.upload", 21), ("_Job.sync", 23),
        ("_Job.through_ops", 25), ("_Job.job_lock_only", 33)]
    by = {f.symbol: f for f in found}
    assert "kernel entry point" in by["_Job.launch"].message
    assert "copies to the device" in by["_Job.upload"].message
    assert "synchronize" in by["_Job.sync"].message
    # The call into ops/ carries the chain down to the kernel entry.
    assert [n.split("]")[0] + "]" for _, _, n in by["_Job.through_ops"].chain] == [
        "[streaming_update_rows]", "[_fold_rows]"]
    assert "kernel entry point" in by["_Job.through_ops"].chain[-1][2]
    assert "_upload_locked" in by["_Job.job_lock_only"].message


def test_device_lock_is_clean_when_everything_sits_under_the_lock():
    clean = DEVICE_DAEMON.split("    def launch")[0]
    _, found = run_rules(_port_files(clean), "device-lock")
    assert found == []


def test_compile_outside_lock_flags_the_build_path_under_the_device_lock():
    bad = '''
import threading
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.ops import kernels
_DEVICE_LOCK = threading.Lock()

def warm():
    with _DEVICE_LOCK:
        kernels._lib()
        _build.build_all()
        _build.load("knn")
'''
    good = bad.replace("    with _DEVICE_LOCK:\n", "    if True:\n")
    _, found = run_rules(_port_files(bad), "compile-outside-lock")
    assert [f.line for f in found] == [9, 10, 11]
    assert "ops/kernels.py:_lib()" in found[0].message
    _, found = run_rules(_port_files(good), "compile-outside-lock")
    assert found == []


def test_bare_collective_flags_torch_distributed_outside_parallel():
    src = '''
import torch
import torch.distributed as dist
from torch import distributed as td
from torch.distributed import barrier, get_rank

def f(x):
    dist.all_reduce(x)
    td.broadcast(x, 0)
    torch.distributed.send(x, 1)
    dist.batch_isend_irecv([])
    barrier()
    return dist.get_rank(), get_rank()
'''
    _, found = run_rules({"ops/gram.py": src, "parallel/mapreduce.py": src,
                          "ops/doc.py": '"""mentions dist.all_reduce in prose only"""\n'},
                         "bare-collective")
    assert [(f.file, f.line) for f in found] == [
        ("ops/gram.py", 8), ("ops/gram.py", 9), ("ops/gram.py", 10), ("ops/gram.py", 11),
        ("ops/gram.py", 12)]


BAD_KERNELS = '''
import functools
from spark_rapids_ml_tpu_torch.ops import _build

LAUNCHES = {"gram": 0, "gram_colsum": 0}
ROUTES = {}

def _ledger(name, route, *args):
    return None

@functools.lru_cache(maxsize=None)
def _lib():
    return _build.load("gram")

def gram_plain(x):
    return x

def gram(x):
    with _ledger("grm", "plain"):
        pass
    route = "wgmma"
    with _ledger("gram", route):
        _lib().srml_gram(x)
    LAUNCHES["gram"] += 1
    return x

def gram_again(x):
    with _ledger("gram", "ffma"):
        _lib().srml_gram(x)
    LAUNCHES["gram"] += 1

def gram_colsum(x):
    with _ledger("gram_colsum", "ffma"):
        _lib().srml_gram_colsum(x)
    return x

def lloyd_step(x):
    name = "lloyd_step"
    with _ledger(name, "ffma"):
        _lib().srml_lloyd_step(x)
'''


def test_kernel_ledger_flags_each_broken_piece_of_the_contract():
    _, found = run_rules(_port_files(DEVICE_DAEMON, **{"ops/kernels.py": BAD_KERNELS}),
                         "kernel-ledger")
    msgs = [(f.symbol, f.message.split(" — ")[0]) for f in found]
    assert msgs == [
        ("gram", '_ledger record "grm" names no launched kernel'),
        ("gram", 'kernel "gram" has a computed route but no ROUTES[f"gram/{route}"] += 1'),
        ("gram_again", 'kernel "gram" is launched here and in gram()'),
        ("gram_colsum", 'gram_colsum() launches "gram_colsum" without '
                        'LAUNCHES["gram_colsum"] += 1'),
        ("gram_colsum", 'kernel "gram_colsum" has no gram_colsum_plain() beside it'),
        ("lloyd_step", "kernel launch under a _ledger record whose name is not a constant"),
    ]


def test_kernel_ledger_is_clean_on_the_contracts_shape_and_counts_entries():
    project, found = run_rules(_port_files(DEVICE_DAEMON), "kernel-ledger")
    assert found == []
    assert sorted(project.kernels.entries.values()) == ["dist_topk", "gram_colsum"]
    assert sorted(k[1] for k in project.graph.loaders) == ["_knn_lib", "_lib"]
    # A whole-tree run expects the ten kernels.
    _, found = run_rules(_port_files(DEVICE_DAEMON), "kernel-ledger", strict_floors=True)
    assert [f.message.split(" (")[0] for f in found] == [
        "only 2 ledgered kernel launch sites found in ops/kernels.py"]


def test_kernel_fallback_flags_a_plain_version_in_a_handler():
    bad = '''
from spark_rapids_ml_tpu_torch.ops import kernels

def fold(x, n, state):
    try:
        return kernels.gram_colsum(x, n, state)
    except RuntimeError:
        return kernels.gram_colsum_plain(x, n, state)
'''
    good = '''
from spark_rapids_ml_tpu_torch.ops import kernels
from spark_rapids_ml_tpu_torch.utils.logging import get_logger

def fold(x, n, state):
    try:
        return kernels.gram_colsum(x, n, state)
    except RuntimeError:
        get_logger().error("gram_colsum failed")
        raise

def host(x):
    try:
        return x.numpy()
    except TypeError:
        return kernels.gram_colsum_plain(x, 1)
'''
    _, found = run_rules(_port_files(DEVICE_DAEMON, **{"models/pca.py": bad}), "kernel-fallback")
    assert keys(found) == [("kernel-fallback", "models/pca.py", 8, "fold")]
    _, found = run_rules(_port_files(DEVICE_DAEMON, **{"models/pca.py": good}),
                         "kernel-fallback")
    assert found == []


def test_no_jax_import_flags_jax_and_the_jax_package_only():
    bad = '''
import jax
import jax.numpy as jnp
from jaxlib import xla_client
from spark_rapids_ml_tpu.tools import analyze
import importlib
m = importlib.import_module("spark_rapids_ml_tpu.ops.gram")
'''
    good = '''
import importlib
import torch
from spark_rapids_ml_tpu_torch.tools import analyze
from . import gram
m = importlib.import_module("spark_rapids_ml_tpu_torch.ops.gram")
"""jax and spark_rapids_ml_tpu in prose only"""
'''
    _, found = run_rules({"ops/bad.py": bad, "ops/good.py": good}, "no-jax-import")
    assert [(f.file, f.line) for f in found] == [
        ("ops/bad.py", 2), ("ops/bad.py", 3), ("ops/bad.py", 4), ("ops/bad.py", 5),
        ("ops/bad.py", 7)]


# ---------------------------------------------------------------------------
# the daemon's start-up prime
# ---------------------------------------------------------------------------


class _FakeLib:
    """Stands in for a loaded CDLL: its functions take attributes."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


@pytest.fixture
def recorded_loads(monkeypatch):
    from spark_rapids_ml_tpu_torch.ops import _build, kernels
    from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod

    loads = []
    owner = {}

    def fake_load(name):
        d = owner.get("daemon")
        loads.append((name, daemon_mod._DEVICE_LOCK.locked(),
                      None if d is None else (d._sock, d._accept_thread)))
        return _FakeLib()

    loaders = (kernels._lib, kernels._kmeans_lib, kernels._knn_lib)
    for loader in loaders:
        loader.cache_clear()
    monkeypatch.setattr(_build, "load", fake_load)
    try:
        yield loads, owner
    finally:
        for loader in loaders:
            loader.cache_clear()


def test_a_daemon_on_a_card_loads_its_libraries_before_it_listens(recorded_loads, monkeypatch):
    import torch

    from spark_rapids_ml_tpu_torch.serve import daemon as daemon_mod

    loads, owner = recorded_loads
    monkeypatch.setattr(daemon_mod, "resolve_device", lambda _arg: torch.device("cuda", 0))
    d = daemon_mod.DataPlaneDaemon(serve_batching=False)
    owner["daemon"] = d
    d.start()
    try:
        assert sorted(name for name, _, _ in loads) == ["gram", "kmeans", "knn"]
        # Outside _DEVICE_LOCK, before the socket was bound or accepted on.
        assert all(not held and state == (None, None) for _, held, state in loads)
        from spark_rapids_ml_tpu_torch.ops import kernels

        assert all(f.cache_info().currsize == 1
                   for f in (kernels._lib, kernels._kmeans_lib, kernels._knn_lib))
    finally:
        d.stop()


def test_a_cpu_daemon_loads_nothing(recorded_loads):
    from spark_rapids_ml_tpu_torch.serve import DataPlaneClient, DataPlaneDaemon

    loads, _ = recorded_loads
    d = DataPlaneDaemon(device="cpu", serve_batching=False).start()
    try:
        with DataPlaneClient(*d.address) as c:
            assert c.ping()
    finally:
        d.stop()
    assert loads == []


# ---------------------------------------------------------------------------
# the whole port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_project():
    """The real tree, parsed and analyzed once for this module."""
    project = Project.from_package()
    findings = project.run(baseline=Baseline.load())
    return project, findings, list(project.notes)


def test_the_whole_port_has_zero_unsuppressed_findings(port_project):
    _, findings, notes = port_project
    assert findings == [], "\n" + analyze.format_findings(findings)
    assert [n for n in notes if "fixpoint cap" in n] == []


def test_the_baseline_is_empty_and_has_no_stale_entries(port_project):
    _, _, notes = port_project
    assert json.loads(analyze.BASELINE_PATH.read_text()) == {"version": 1, "entries": []}
    assert [n for n in notes if "stale baseline entry" in n] == []


def test_every_pragma_in_the_port_carries_its_reason():
    """A pragma has a comment on its own line after the rule list, or a
    comment line right above it."""
    pragmas = 0
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "analyze.py":
            continue
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if "# srml: disable=" not in line:
                continue
            pragmas += 1
            before = lines[i - 1].strip() if i else ""
            after = line.split("# srml: disable=", 1)[1].split(" ", 1)
            assert before.startswith("#") or (len(after) > 1 and after[1].strip()), (
                f"{path.relative_to(REPO)}:{i + 1} has a pragma without a reason")
    assert pragmas == 9


def test_the_port_registry_has_the_ten_kernels_and_primes_every_loader(port_project):
    project, _, _ = port_project
    names = sorted({s.name for s in project.kernels.launches})
    assert names == sorted(["gram", "gram_colsum", "linreg_stats", "lloyd_step",
                            "assign_min_dist", "newton_stats", "softmax_curvature",
                            "dist_topk", "probe_select", "ivf_scan_select"])
    assert len(project.kernels.launches) == 10
    g = project.graph
    assert sorted(k[1] for k in g.loaders) == ["_kmeans_lib", "_knn_lib", "_lib"]
    assert g.primed_loaders == g.loaders


def test_the_daemon_thread_does_not_reach_the_clients_op_ids(port_project):
    """The analyzer once reached ``DataPlaneClient._op_id`` from the
    daemon's connection threads: ``self._get_job(req).step(...)`` has a
    call's result as receiver, so by-name dispatch took every visible
    ``step``, the client's included. No client is shared between threads;
    the daemon now binds the job first (as the JAX daemon does), and the
    step arm resolves to ``_Job.step`` alone."""
    project, _, _ = port_project
    g = project.graph
    assert ("serve/client.py", "DataPlaneClient._op_id") not in g.thread_reachable
    steps = {s.callee for s in g.calls_out[("serve/daemon.py", "DataPlaneDaemon._dispatch")]
             if s.callee[1].endswith(".step")}
    assert steps == {("serve/daemon.py", "_Job.step")}


def test_write_contract_reproduces_the_checked_in_snapshot(port_project, tmp_path):
    project, _, _ = port_project
    out = tmp_path / "contract.json"
    contract = analyze.write_contract(project, out)
    assert out.read_text() == analyze.CONTRACT_PATH.read_text()
    assert contract["version"] == 2 and len(contract["ops"]) == 28


def test_the_port_snapshot_differs_from_the_jax_one_as_documented():
    """The port never compiles ahead of time, so ``model_status`` has no
    ``aot``; it adds the raw frames (``arrays``, and the ``op`` their
    receive helper labels its bytes with) on ``seed``, ``transform`` and
    ``kneighbors``, and ``status``'s ``iteration`` and ``pass_rows``."""
    port = json.loads(analyze.CONTRACT_PATH.read_text())
    ref = json.loads(jax_analyze.CONTRACT_PATH.read_text())
    assert port["common"] == ref["common"]
    assert sorted(port["ops"]) == sorted(ref["ops"])
    diff = {}
    for op in sorted(ref["ops"]):
        for part in ("req", "ack"):
            lost = set(ref["ops"][op][part]) - set(port["ops"][op][part])
            gained = set(port["ops"][op][part]) - set(ref["ops"][op][part])
            if lost or gained:
                diff[(op, part)] = (sorted(lost), sorted(gained))
    assert diff == {
        ("kneighbors", "req"): ([], ["arrays", "op"]),
        ("model_status", "ack"): (["aot"], []),
        ("seed", "req"): ([], ["arrays", "op"]),
        ("status", "ack"): ([], ["iteration", "pass_rows"]),
        ("transform", "req"): ([], ["arrays", "op"]),
    }
    assert sorted(set(ref["ack_fields"]) ^ set(port["ack_fields"])) == ["aot", "iteration"]


def test_every_rule_is_documented_in_the_module_and_the_readme():
    readme = (REPO / "README.md").read_text()
    port_section = readme.split("## The PyTorch/CUDA port", 1)[1].split("\n## ", 1)[0]
    assert len(analyze.RULES) == 18
    assert set(SAME_RULES) | set(PORT_RULES) == set(analyze.RULES)
    for rid in analyze.RULES:
        assert f"``{rid}``" in analyze.__doc__, rid
        assert f"`{rid}`" in port_section, rid
    assert "use-after-donate" not in analyze.RULES and "jit-ledger" not in analyze.RULES


def test_the_cli_exits_as_the_jax_cli(capsys):
    """0 with zero findings, 2 on an unknown rule; --list-rules."""
    assert analyze.main(["--rule", "no-jax-import", "--rule", "bare-print", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload == {"findings": [], "notes": [], "rules": ["bare-print", "no-jax-import"],
                       "ok": True}
    assert analyze.main(["--rule", "use-after-donate"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    assert analyze.main(["--changed-only", "HEAD", "serve"]) == 2
    capsys.readouterr()
    assert analyze.main(["--list-rules"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 18


def test_changed_only_reports_the_changed_files_and_their_dependents(tmp_path):
    """``--changed-only`` in a git repository of its own: a small package
    carrying a copy of the analyzer, committed, then one module changed and
    one file added. Only they and the module importing the changed one are
    reported on (an unchanged module's finding is not), and the new file's
    finding fails the run."""
    git = shutil.which("git")
    if git is None:
        pytest.skip("git is not installed")
    root = tmp_path / "repo"
    pkg = root / PORT.name
    (pkg / "tools").mkdir(parents=True)
    for rel in ("__init__.py", "tools/__init__.py", "ops/__init__.py", "serve/__init__.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text("")
    shutil.copy(PORT / "tools" / "analyze.py", pkg / "tools" / "analyze.py")
    shutil.copy(analyze.BASELINE_PATH, pkg / "tools" / "analyze_baseline.json")
    (pkg / "ops" / "base.py").write_text("def f():\n    return 1\n")
    (pkg / "ops" / "user.py").write_text(
        f"from {PORT.name}.ops.base import f\n\ndef g():\n    return f()\n")
    (pkg / "serve" / "far.py").write_text('def h():\n    print("unchanged")\n')
    env = {k: v for k, v in os.environ.items() if not k.startswith("GIT_")}
    env.update(GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t", GIT_COMMITTER_NAME="t",
               GIT_COMMITTER_EMAIL="t@t", HOME=str(tmp_path), PYTHONPATH=str(root))
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-q", "-m", "base"]):
        subprocess.run([git, *cmd], cwd=root, env=env, check=True, timeout=60)
    (pkg / "ops" / "base.py").write_text("def f():\n    return 2\n")
    (pkg / "ops" / "scratch_fold.py").write_text(
        "def merge(parts):\n    return [v for k, v in parts.items()]\n")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT.name}.tools.analyze", "--changed-only", "HEAD", "--json"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert ("--changed-only HEAD: 2 changed file(s) → reporting on 3 module(s)"
            in proc.stderr), proc.stderr
    payload = json.loads(proc.stdout)
    assert [(f["rule"], f["file"], f["line"]) for f in payload["findings"]] == [
        ("unsorted-iter", f"{PORT.name}/ops/scratch_fold.py", 2)]
    # Without the scope the unchanged module's finding shows too.
    proc = subprocess.run([sys.executable, "-m", f"{PORT.name}.tools.analyze", "--json"],
                          cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert sorted(f["rule"] for f in json.loads(proc.stdout)["findings"]) == [
        "bare-print", "unsorted-iter"]
