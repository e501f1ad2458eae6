"""Dense solves for the normal-equations model family.

The port of ``spark_rapids_ml_tpu/ops/linalg.py``: SPD solves of the d×d
system (XᵀX + λI)w = Xᵀy by Cholesky, with a diagonal-jitter retry for
near-singular systems. The JAX version is branchless (it factors twice and
picks); here ``cholesky_ex`` reports the failure and only then is the
jittered matrix factored. The result is the same.
"""

from __future__ import annotations

import torch


def solve_spd(a: torch.Tensor, b: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Solve (a + reg·I) x = b for symmetric positive (semi-)definite a."""
    d = a.shape[0]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    a_reg = a + reg * eye
    chol, info = torch.linalg.cholesky_ex(a_reg)
    if int(info) != 0:
        jitter = 1e-6 * max(float(a_reg.diagonal().abs().max()), 1.0)
        chol, _ = torch.linalg.cholesky_ex(a_reg + jitter * eye)
    y = torch.linalg.solve_triangular(chol, b[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0]
