"""Math of the port: the fused Gram statistics (``gram.py``, through the
hand-written kernels of ``kernels.py``), the eigensolve (``eigh.py``),
distances and SPD solves. The JAX package's re-exports, less
``sharded_stats_2d``: the all-gather form of the feature-sharded Gram,
which the port replaces by the ring (``gram.sharded_stats_ring``)."""

from spark_rapids_ml_tpu_torch.ops.gram import (
    local_stats,
    sharded_stats,
    finalize_gram,
    mm_precision,
)
from spark_rapids_ml_tpu_torch.ops.eigh import (
    eigh_descending,
    sign_flip,
    explained_variance_reference,
    explained_variance_ratio,
    pca_from_gram,
)
from spark_rapids_ml_tpu_torch.ops.distances import sq_euclidean
from spark_rapids_ml_tpu_torch.ops.linalg import solve_spd

__all__ = [
    "local_stats",
    "sharded_stats",
    "finalize_gram",
    "mm_precision",
    "eigh_descending",
    "sign_flip",
    "explained_variance_reference",
    "explained_variance_ratio",
    "pca_from_gram",
    "sq_euclidean",
    "solve_spd",
]
