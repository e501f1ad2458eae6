"""The port's elastic fit across daemon processes: a peer daemon process is
killed with SIGKILL in the middle of a KMeans fit and never restarted.

The port of the JAX flagship ``tests/test_elastic.py:315``. Three port
daemons, each its own process (``tests/torch_daemon_worker.py``, which
imports only the port): none is in another's membership registry, so every
pass reduces through the driver's hub. The topology and the rows are
``tests/torch_elastic_common.py``'s: partition 1 feeds the victim and fails
over to the primary. The victim dies by SIGKILL at the pass-0 boundary,
after its rows were exported into the primary and before the driver pushes
it the stepped centres. With tolerance 1 the fit probes it dead,
quarantines it and replays pass 0 on the two survivors; the model equals
the survivors' fit bitwise, with no row lost.
"""

import os
import signal
import subprocess
import sys

import torch

from sparksim import SimDataFrame
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_elastic_common import (  # noqa: F401 - the fixture
    counter_total,
    elastic_env,
    failover_env,
    kmeans_oracle_fit,
    same_kmeans,
    session,
    sim_df,
    spark_kmeans,
)

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class _Worker:
    """A daemon process's handle: ``address`` as the helpers read it."""

    def __init__(self, proc):
        self.proc = proc
        line = proc.stdout.readline().strip()
        assert line.startswith("READY "), line
        self.address = ("127.0.0.1", int(line.split()[1]))


def _spawn(n):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SRML_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    # All spawned before any READY is read: the imports overlap.
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_daemon_worker.py")],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT, env=env,
                              text=True) for _ in range(n)]
    return [_Worker(p) for p in procs]


def test_a_peer_daemon_process_killed_mid_fit_degrades_to_the_survivors_fit(monkeypatch):
    a, b, c = workers = _spawn(3)
    try:
        oracle = kmeans_oracle_fit(a, c)
        monkeypatch.setenv("SRML_FIT_DAEMON_LOSS_TOLERANCE", "1")
        killed = []
        real_sync = port_est._DaemonFit.sync_peers

        def sync_peers(fit, push=True):
            if not killed:  # the pass-0 boundary: the victim's rows are merged
                b.proc.send_signal(signal.SIGKILL)
                b.proc.wait(timeout=30)
                killed.append(b.proc.returncode)
            return real_sync(fit, push)

        monkeypatch.setattr(port_est._DaemonFit, "sync_peers", sync_peers)
        losses0 = counter_total(port_est._M_DAEMON_LOSSES)
        hub0 = port_est._M_MESH_PATHS.value(path="hub")
        m = spark_kmeans(sim_df(session(a, (a, b, c)), failover_env(b, a, c)))
        assert killed == [-signal.SIGKILL]
        same_kmeans(m, oracle)
        assert counter_total(port_est._M_DAEMON_LOSSES) == losses0 + 1
        # Separate processes: every reduce took the hub (pass 0 twice).
        assert port_est._M_MESH_PATHS.value(path="hub") == hub0 + m.summary.numIter + 2
    finally:
        for w in workers:
            if w.proc.poll() is None:
                try:
                    w.proc.stdin.close()
                    w.proc.wait(timeout=10)
                except Exception:
                    w.proc.kill()
