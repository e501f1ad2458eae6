"""Dense solves for the normal-equations and Newton model families.

The port of ``spark_rapids_ml_tpu/ops/linalg.py``: SPD solves of the d×d
system (XᵀX + λI)w = Xᵀy by Cholesky, with a diagonal-jitter retry for
near-singular systems. The JAX version is branchless (it factors twice and
picks); here ``cholesky_ex`` reports the failure and only then is the
jittered matrix factored. The result is the same.

Also the Newton solve of LogisticRegression (the JAX package's
``models/logistic_regression._solve_newton_system`` and the per-class
``solve_c`` of its multinomial step, ``jax.vmap``-ed there): here one
function batched over any leading (class) axis, on ``cholesky_ex`` /
``cholesky_solve`` (cuSOLVER on the card, LAPACK on the CPU). These are
library calls for work that XLA did outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

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


def _floored_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of a + eps·I, eps = 1e3·eps(dtype)·trace(a)/m +
    1e-12 per matrix of the batch (m its order): the floor clears the
    accumulation noise of summed statistics (their negative eigenvalues
    reach a few ulps of the trace) and is a minimum-norm tiebreak far
    below any meaningful curvature."""
    m = a.shape[-1]
    noise = 1e3 * torch.finfo(a.dtype).eps
    eps = noise * torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / m + 1e-12
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    return torch.linalg.cholesky_ex(a + eps[..., None, None] * eye)[0]


def solve_newton_system(
    h_ww: torch.Tensor,
    h_wb: torch.Tensor,
    h_bb: torch.Tensor,
    grad_w: torch.Tensor,
    grad_b: torch.Tensor,
    reg: float,
    fit_intercept: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct solve of the (optionally bordered) Newton system
    [h_ww h_wb; h_wbᵀ h_bb][dw; db] = [grad_w; grad_b] → (dw, db), batched
    over any leading axes: h_ww (..., d, d), h_wb and grad_w (..., d),
    h_bb and grad_b (...).

    reg > 0: h_ww is symmetric PD — one Cholesky with both right-hand
    sides, then block elimination for the intercept (Schur complement
    floored at 1e-12); the JAX package's binomial form solves the same
    system by LU, its multinomial form by this Cholesky. reg == 0: the
    Hessian is only PSD (collinear, one-hot or dead columns; one-hot
    columns plus an intercept add a null direction of the bordered
    system), so the whole system being solved gets the floored Cholesky.
    Without an intercept db is 0."""
    d = h_ww.shape[-1]
    zero_b = torch.zeros_like(h_bb)
    if reg > 0.0:
        chol = torch.linalg.cholesky_ex(h_ww)[0]
        if not fit_intercept:
            return torch.cholesky_solve(grad_w[..., None], chol)[..., 0], zero_b
        sol = torch.cholesky_solve(torch.stack([h_wb, grad_w], dim=-1), chol)
        hinv_hwb, hinv_gw = sol[..., 0], sol[..., 1]
        schur = torch.clamp(h_bb - (h_wb * hinv_hwb).sum(-1), min=1e-12)
        db = (grad_b - (h_wb * hinv_gw).sum(-1)) / schur
        return hinv_gw - hinv_hwb * db[..., None], db
    if not fit_intercept:
        return torch.cholesky_solve(grad_w[..., None], _floored_cholesky(h_ww))[..., 0], zero_b
    joint = h_ww.new_zeros(h_ww.shape[:-2] + (d + 1, d + 1))
    joint[..., :d, :d] = h_ww
    joint[..., :d, d] = h_wb
    joint[..., d, :d] = h_wb
    joint[..., d, d] = h_bb
    rhs = torch.cat([grad_w, grad_b[..., None]], dim=-1)
    sol = torch.cholesky_solve(rhs[..., None], _floored_cholesky(joint))[..., 0]
    return sol[..., :d], sol[..., d]
