"""Shared pieces of the port's elastic-fit tests (tests/test_torch_elastic*.py).

The topology of the port of ``tests/test_elastic.py``, cut to four
partitions: the primary ``a`` and the surviving peer ``c`` (module
fixtures), and a third daemon ``b`` for one test (the doomed peer, or the
joiner). Partition 0 feeds the primary, partition 1 ``b`` first with a
failover to the primary on its next attempt (Spark rescheduling a lost
host's task, or a newcomer refusing feeds it has no job for), and
partitions 2 and 3 the survivor. The rows are integer blobs: every
statistic is an exact float32 sum, so fits on different topologies agree
bitwise and a lost, doubled or twice-merged row shows as a mismatch.
"""

import numpy as np
import pytest

from sparksim import SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu_torch.models import kmeans as port_km
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from spark_rapids_ml_tpu_torch.utils import faults
from torch_port_helpers import daemon_addr, direct_fit

K, D, PER_BLOB, PARTS = 3, 5, 40, 4
MAX_ITER = 2
SEED = 5


def int_blobs():
    """K integer blobs; each blob's noise is rows and their negatives, so a
    blob's mean is its integer centre exactly."""
    rng = np.random.default_rng(18)
    centres = rng.integers(-12, 13, size=(K, D)) * 4
    noise = rng.integers(-1, 2, size=(K, PER_BLOB // 2, D))
    noise = np.concatenate([noise, -noise], axis=1)
    x = (centres[:, None, :] + noise).reshape(-1, D).astype(np.float64)
    return x[rng.permutation(len(x))]


X = int_blobs()


@pytest.fixture(autouse=True)
def elastic_env(monkeypatch):
    """Bounded dead-daemon retries (the JAX suite's settings), no policy
    or routing left over, no plan leaked."""
    for name in ("SRML_DAEMON_ADDRESS", "SRML_DAEMON_ADDRESSES", "SRML_FIT_RECOVERY_ATTEMPTS",
                 "SRML_FIT_DAEMON_LOSS_TOLERANCE", "SRML_FIT_DAEMON_JOIN_POLICY",
                 "SRML_FIT_DAEMON_JOIN_LIMIT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SRML_DAEMON_OP_ATTEMPTS", "2")
    monkeypatch.setenv("SRML_FIT_DAEMON_DEATH_TIMEOUT_S", "2")
    yield
    faults.deactivate()
    daemon_session.shutdown()


@pytest.fixture(scope="module")
def survivors():
    """The primary and the surviving peer."""
    with DataPlaneDaemon(device="cpu", ttl=600.0) as a, \
            DataPlaneDaemon(device="cpu", ttl=600.0) as c:
        yield a, c


@pytest.fixture
def third():
    """The doomed peer, or the joiner."""
    b = DataPlaneDaemon(device="cpu", ttl=600.0).start()
    yield b
    b.stop()


def failover_env(b, a, c):
    """Partition 1 feeds ``b``, failing over to the primary on its next
    attempt; 2 and 3 feed the survivor; 0 the primary."""
    return {1: [{"SRML_DAEMON_ADDRESS": daemon_addr(b)}, {"SRML_DAEMON_ADDRESS": daemon_addr(a)}],
            2: {"SRML_DAEMON_ADDRESS": daemon_addr(c)}, 3: {"SRML_DAEMON_ADDRESS": daemon_addr(c)}}


def survivor_env(c):
    """The static topology: partition 1 on the primary."""
    return {2: {"SRML_DAEMON_ADDRESS": daemon_addr(c)}, 3: {"SRML_DAEMON_ADDRESS": daemon_addr(c)}}


def session(primary, addresses=(), **conf):
    return SimSparkSession({"spark.srml.daemon.address": daemon_addr(primary),
                            "spark.srml.daemon.addresses": ",".join(
                                daemon_addr(d) for d in addresses), **conf})


def sim_df(sess, env_plan, **kw):
    return simdf_from_numpy(X, n_partitions=PARTS, session=sess, env_plan=env_plan, **kw)


def spark_kmeans(df):
    return port_est.SparkKMeans(device="cpu").setK(K).setMaxIter(MAX_ITER).setSeed(SEED).fit(df)


def spark_pca(df):
    return port_est.SparkPCA(device="cpu").setInputCol("features").setK(3).fit(df)


def kmeans_oracle_fit(a, c):
    """The KMeans fit on the static topology, its tasks run in this process
    (the driver's prefix sample is the first rows, as the wrapper's)."""
    core = port_km.KMeans(device="cpu").setK(K).setMaxIter(MAX_ITER).setSeed(SEED)
    sample = X[:port_est._kmeans_seed_rows(K)]
    return direct_fit(lambda f, rp: port_est._drive_kmeans(f, rp, core, sample), a, X, PARTS,
                      "kmeans", routes={2: c, 3: c}, spark=session(a, (a, c)))


def counter_total(c) -> float:
    return sum(v for _, v in c._samples())


def same_kmeans(m, ref):
    np.testing.assert_array_equal(m.centers, ref.centers)
    assert m.summary.trainingCost == ref.summary.trainingCost
    assert m.summary.numIter == ref.summary.numIter
    assert m.summary.n_rows == X.shape[0]  # no row lost, none doubled


def same_pca(m, ref):
    for attr in ("pc", "explainedVariance", "mean"):
        np.testing.assert_array_equal(np.asarray(getattr(m, attr), np.float64),
                                      np.asarray(getattr(ref, attr), np.float64))


def no_jobs(*daemons):
    assert all(d._jobs == {} for d in daemons)
