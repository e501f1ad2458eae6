"""The port's ``SparkLogisticRegression`` and ``SparkRandomForestClassifier``
across daemons, through sparksim.

The upper half of the partitions feed a second port daemon
(``device="cpu"``, in this process) named in their executors' env.
LogisticRegression finds its peers in pass 0's acks (every daemon opens at
the zero iterate); the forest installs its bin edges and empty trees on
every daemon of ``spark.srml.daemon.addresses`` before the first scan. The
port of the logreg cases of ``tests/test_spark_multidaemon.py`` and the
forest's of ``tests/test_forest.py``:

* binomial and multinomial LogisticRegression over two daemons match the
  JAX package's stream fit of the same rows (``fit_logistic_stream``,
  ``fit_multinomial_stream``, the same passes, in float64) and the port's
  one-daemon fit, within the reference tests' 1e-5 (float64 daemons: the
  sigmoid and softmax sums are not exact, so the fold order moves them by
  rounding), in the same number of passes;
* an executor whose partitions are all empty creates no job on its daemon,
  which is then no peer;
* the forest classifier over two daemons equals, bitwise and every table,
  the JAX wrapper's fit of the same DataFrame on a JAX daemon and the
  port's one-daemon fit: its class counts are integer sums, and its bags
  are keyed by the rows' (partition, offset), whichever daemon folds
  them.
"""

import contextlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from sparksim import SimDataFrame, SimSparkSession, simdf_from_numpy
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.models import logistic_regression as jax_lg
from spark_rapids_ml_tpu.serve import DataPlaneDaemon as JaxDaemon
from spark_rapids_ml_tpu.spark import estimator as jax_est
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.bridge.arrow import matrix_to_list_column
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.spark import daemon_session
from spark_rapids_ml_tpu_torch.spark import estimator as port_est
from torch_port_helpers import daemon_addr, jax_ledger_off, split_routing

torch.set_num_threads(2)

port_est.register_dataframe_type(SimDataFrame)
jax_est.register_dataframe_type(SimDataFrame)

N, D, C = 600, 6, 3
TOL = 1e-5  # tests/test_spark_multidaemon.py:174-220


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SRML_DAEMON_ADDRESS", "SRML_DAEMON_ADDRESSES", "SRML_FIT_RECOVERY_ATTEMPTS"):
        monkeypatch.delenv(name, raising=False)
    yield
    daemon_session.shutdown()


def _f64():
    """Both packages in float64, the JAX one with its ledger off."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax_ledger_off())
    for cfg in (jax_config, config):
        stack.enter_context(cfg.option("compute_dtype", "float64"))
        stack.enter_context(cfg.option("accum_dtype", "float64"))
    return stack


@pytest.fixture
def two_daemons():
    with _f64():
        with DataPlaneDaemon(device="cpu") as a, DataPlaneDaemon(device="cpu") as b:
            yield a, b


def _data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, D))
    w = rng.normal(size=D)
    centres = rng.normal(size=(C, D)) * 2.0
    return {
        "x": x,
        "binomial": (x @ w > 0).astype(np.float64),
        "multinomial": np.argmin(((x[:, None, :] - centres[None]) ** 2).sum(-1),
                                 axis=1).astype(np.float64),
    }


DATA = _data()


def _one_daemon_df(a, label, **kw):
    return simdf_from_numpy(DATA["x"], n_partitions=4, label=label, session=SimSparkSession(
        {"spark.srml.daemon.address": daemon_addr(a)}), **kw)


def _split_df(a, b, label, conf=None):
    session, env_plan = split_routing(a, b, conf=conf)
    return simdf_from_numpy(DATA["x"], n_partitions=4, label=label, session=session,
                            env_plan=env_plan)


def _logreg():
    return port_est.SparkLogisticRegression(device="cpu").setRegParam(1e-2).setMaxIter(2)


def _jax_logreg(kind, mesh):
    """The JAX stream fit of the same rows, at the wrapper's settings:
    the four partitions as its batches."""
    x, y = DATA["x"], DATA[kind]
    batches = list(zip(np.array_split(x, 4), np.array_split(y, 4)))
    if kind == "multinomial":
        return jax_lg.fit_multinomial_stream(lambda: iter(batches), D, C, reg=1e-2, max_iter=2,
                                             mesh=mesh)
    return jax_lg.fit_logistic_stream(lambda: iter(batches), D, reg=1e-2, max_iter=2, mesh=mesh)


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_logreg_over_two_daemons_matches_one_daemon(kind, two_daemons, mesh8):
    a, b = two_daemons
    one = _logreg().fit(_one_daemon_df(a, DATA[kind]))
    split = _split_df(a, b, DATA[kind])
    two = _logreg().fit(split)
    assert split.sparkSession.driver_rows_materialized == 0
    shape = (C, D) if kind == "multinomial" else (D,)
    assert np.asarray(two.coefficients).shape == shape
    ref = _jax_logreg(kind, mesh8)
    for want in (ref, one):
        np.testing.assert_allclose(np.asarray(two.coefficients),
                                   np.asarray(want.coefficients).reshape(shape), atol=TOL)
        np.testing.assert_allclose(np.asarray(two.intercept), np.asarray(want.intercept),
                                   atol=TOL)
    assert two.summary.numIter == one.summary.numIter == ref.n_iter >= 2
    assert a._jobs == {} and b._jobs == {}


def test_an_executor_of_empty_partitions_is_no_peer(two_daemons):
    a, b = two_daemons
    x, y = DATA["x"][:450], DATA["binomial"][:450]
    parts = [pa.table({"features": matrix_to_list_column(xi), "label": pa.array(yi)})
             for xi, yi in zip(np.array_split(x, 3), np.array_split(y, 3))]
    parts.append(pa.table({"features": matrix_to_list_column(np.zeros((0, D))),
                           "label": pa.array(np.zeros(0))}))  # partition 3, routed to b
    df = SimDataFrame(parts, session=SimSparkSession({"spark.srml.daemon.address":
                                                      daemon_addr(a)}),
                      env_plan={3: {"SRML_DAEMON_ADDRESS": daemon_addr(b)}})
    model = port_est.SparkLogisticRegression(device="cpu").setMaxIter(2).fit(df)
    assert model.summary.numIter == 2 and model.summary.n_rows == 450
    assert not b._jobs and not a._jobs


def _forest():
    return port_est.SparkRandomForestClassifier(device="cpu").setNumTrees(3).setMaxDepth(2) \
        .setMaxBins(8).setSeed(7)


def test_the_forest_over_two_daemons_equals_one_daemon_bitwise(two_daemons, mesh8):
    a, b = two_daemons
    with JaxDaemon(mesh=mesh8) as jd:
        jax_df = simdf_from_numpy(DATA["x"], n_partitions=4, label=DATA["multinomial"],
                                  session=SimSparkSession({"spark.srml.daemon.address":
                                                           daemon_addr(jd)}))
        ref = jax_est.SparkRandomForestClassifier().setNumTrees(3).setMaxDepth(2) \
            .setMaxBins(8).setSeed(7).fit(jax_df)
    one = _forest().fit(_one_daemon_df(a, DATA["multinomial"]))
    conf = {"spark.srml.daemon.addresses": f"{daemon_addr(a)},{daemon_addr(b)}"}
    two = _forest().fit(_split_df(a, b, DATA["multinomial"], conf=conf))
    for want in (ref, one):
        assert sorted(two.arrays) == sorted(want.arrays)
        for k in want.arrays:
            np.testing.assert_array_equal(np.asarray(two.arrays[k]), np.asarray(want.arrays[k]),
                                          err_msg=k)
    assert two.totalNumNodes > two.getNumTrees()  # the trees split
    assert a._jobs == {} and b._jobs == {}
