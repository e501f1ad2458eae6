"""Carry state across from the JAX package, as numpy arrays.

The two packages hold the same numbers in different array types. These
helpers build the port's objects from what the JAX package hands out as
numpy, so a model or a streaming state can move from one package to the
other (and the tests can compute in both from the same numbers).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.ops.gram import Stats
from spark_rapids_ml_tpu_torch.parallel.sharding import as_tensor


def pca_model_from_jax(data: Dict[str, np.ndarray], device=None) -> PCAModel:
    """A port ``PCAModel`` from the JAX ``PCAModel._model_data()`` dict
    (``pc``, and ``explainedVariance``/``mean`` when present)."""
    return PCAModel(
        pc=data["pc"],
        explained_variance=data.get("explainedVariance"),
        mean=data.get("mean"),
        device=device,
    )


def stats_from_jax(state: Tuple, device="cpu") -> Stats:
    """A JAX streaming state ``(count, colsum, gram)`` as the port's
    tensors on ``device``, dtypes kept."""
    return tuple(as_tensor(np.asarray(a)).to(device) for a in state)
