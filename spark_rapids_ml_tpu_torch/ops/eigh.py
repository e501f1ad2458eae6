"""Eigendecomposition finalize stage: the reference's ``calSVD`` in PyTorch.

The port of ``spark_rapids_ml_tpu/ops/eigh.py``. The reference's native
``calSVD`` (rapidsml_jni.cu:215-269) runs cuSOLVER ``eigDC`` on the n×n
Gram → column reversal to descending order → ``seqRoot`` (σ = √λ) →
``signFlip``. Here that is ``torch.linalg.eigh`` (cuSOLVER on the card,
LAPACK on the CPU) plus the reorder, square root and sign flip. For a Gram
over the per-device budget, :func:`pca_from_gram_model_sharded` runs the
randomized solver on a model-sharded Gram: each rank holds a (d/n_model,
d) row slab and only (d, k+p) panels are ever replicated.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.parallel import mapreduce as mr
from spark_rapids_ml_tpu_torch.parallel.mesh import MODEL_AXIS

Eig = Tuple[torch.Tensor, torch.Tensor]


def eigh_descending(a: torch.Tensor) -> Eig:
    """Symmetric eigendecomposition, eigenvalues descending.

    Equivalent of eigDC + colReverse/rowReverse (rapidsml_jni.cu:251-253);
    ``torch.linalg.eigh`` returns ascending order, so flip."""
    w, v = torch.linalg.eigh(a)
    return w.flip(0), v.flip(1)


def sign_flip(u: torch.Tensor) -> torch.Tensor:
    """Deterministic eigenvector signs: flip any column whose largest-|x|
    element is negative.

    The reference's Thrust kernel (rapidsml_jni.cu:35-61) scans with strict
    ``>``, so the FIRST of equal maxima wins. The index is taken as the
    smallest row holding the column maximum, which pins that rule on every
    device instead of relying on ``argmax`` tie behaviour. An all-zero
    column is left alone."""
    a = u.abs()
    rows = torch.arange(u.shape[0], device=u.device)[:, None].expand_as(a)
    at_max = a == a.max(dim=0, keepdim=True).values
    idx = torch.where(at_max, rows, u.shape[0]).min(dim=0).values
    vals = u.gather(0, idx[None, :])[0]
    signs = torch.where(vals < 0, -1.0, 1.0).to(u.dtype)
    return u * signs[None, :]


def explained_variance_reference(eigvals: torch.Tensor) -> Eig:
    """Reference semantics: σ = √λ (clipped at 0), ratio = σᵢ / Σσ
    (seqRoot at rapidsml_jni.cu:254, RapidsRowMatrix.scala:91-93)."""
    s = torch.sqrt(torch.clamp(eigvals, min=0.0))
    return s, s / torch.sum(s)


def explained_variance_ratio(eigvals: torch.Tensor) -> torch.Tensor:
    """Spark MLlib / sklearn semantics: λᵢ / Σλ (for cross-checking)."""
    w = torch.clamp(eigvals, min=0.0)
    return w / torch.sum(w)


def pca_from_gram(gram: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gram → (pc (d, k), explained variance (k,), σ (d,)).

    The contract of computePrincipalComponentsAndExplainedVariance
    (RapidsRowMatrix.scala:59-102): top-k eigenvector columns, sign-flipped;
    explained variance = σ/Σσ sliced to k."""
    w, v = eigh_descending(gram)
    v = sign_flip(v)
    s, ev = explained_variance_reference(w)
    return v[:, :k], ev[:k], s


def _subspace(matvec: Callable, d: int, like: torch.Tensor, k: int, oversample: int,
              iters: int, seed: int) -> Eig:
    """Blocked subspace iteration with ``matvec(v) = G @ v`` for a PSD G of
    width d (``like`` gives the device and dtype)."""
    m = min(k + oversample, d)
    generator = torch.Generator(device=like.device).manual_seed(seed)
    v0 = torch.randn((d, m), generator=generator, device=like.device, dtype=like.dtype)
    v = torch.linalg.qr(v0).Q
    for _ in range(iters):
        v = torch.linalg.qr(matvec(v)).Q
    b = v.T @ matvec(v)
    b = 0.5 * (b + b.T)
    wb, qb = eigh_descending(b)  # m×m — tiny
    return wb, v @ qb


def topk_eig_subspace(
    gram: torch.Tensor,
    k: int,
    oversample: int = 32,
    iters: int = 12,
    seed: int = 0,
) -> Eig:
    """Top-(k+p) eigenpairs of a PSD matrix by blocked subspace iteration
    (randomized PCA, Halko et al. 2011, alg. 4.4 specialised to a Gram).

    The start block is drawn from a ``torch.Generator`` on the Gram's
    device seeded with ``seed``; it does not reproduce the JAX package's
    random bits, only its algorithm.
    Returns ``(ritz_vals (m,) descending, vectors (d, m))`` with
    m = k+oversample clamped to d."""
    return _subspace(lambda v: gram @ v, gram.shape[0], gram, k, oversample, iters, seed)


def _randomized_contract(wb: torch.Tensor, u: torch.Tensor, trace: torch.Tensor, k: int):
    """Ritz pairs and the trace → the :func:`pca_from_gram` contract."""
    d, m = u.shape[0], wb.shape[0]
    u = sign_flip(u)
    w_top = torch.clamp(wb, min=0.0)
    s_top = torch.sqrt(w_top)
    resid = torch.clamp(trace - torch.sum(w_top), min=0.0)
    n_tail = max(d - m, 0)
    tail_each = torch.sqrt(resid / max(n_tail, 1)) if n_tail else torch.zeros_like(resid)
    sigma_sum = torch.sum(s_top) + n_tail * tail_each
    ev = s_top / torch.clamp(sigma_sum, min=torch.finfo(wb.dtype).tiny)
    s_full = torch.cat([s_top, tail_each.expand(n_tail)])
    return u[:, :k], ev[:k], s_full


def pca_from_gram_randomized(
    gram: torch.Tensor,
    k: int,
    oversample: int = 32,
    iters: int = 12,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pca_from_gram` contract via :func:`topk_eig_subspace`.

    The reference-semantics explained variance (σᵢ/Σσ over ALL d values)
    needs the unseen tail of the spectrum; it is estimated from the trace —
    the residual Σλ spread uniformly over the d−m tail (the JAX package's
    estimate). Returned σ is (d,) with the tail filled by that estimate."""
    wb, u = topk_eig_subspace(gram, k, oversample, iters, seed)
    return _randomized_contract(wb, u, torch.trace(gram), k)


def pca_from_gram_model_sharded(
    slab: torch.Tensor,
    k: int,
    mesh,
    oversample: int = 32,
    iters: int = 12,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model-parallel finalize: the (d, d) Gram stays sharded over the
    mesh's ``model`` axis through the whole eigensolve. This rank holds
    the (d/n_model, d) row slab at its model index (what
    ``ops/gram.sharded_stats_ring`` produces); ``G @ V`` runs as
    ``all_concat(slab @ V)`` over ``model``, whose (d, k+p) result is the
    only full-width panel ever replicated, and the Rayleigh–Ritz system
    is m×m. The trace for the σ tail is the sum of each slab's diagonal
    block. The start block comes from the same seeded generator on every
    rank, so the replicated panels agree bit for bit. Same seed, same
    contract as :func:`pca_from_gram_randomized` of the gathered Gram."""
    d_local, d = slab.shape
    r0 = mesh.axis_index(MODEL_AXIS) * d_local
    trace = mr.reduce_sum(slab[:, r0:r0 + d_local].diagonal().sum().reshape(1), MODEL_AXIS,
                          mesh=mesh)[0]
    wb, u = _subspace(lambda v: mr.all_concat(slab @ v, MODEL_AXIS, axis=0, mesh=mesh), d, slab,
                      k, oversample, iters, seed)
    return _randomized_contract(wb, u, trace, k)


def pca_from_gram_host(gram, k: int):
    """Host (numpy/LAPACK, float64) version of :func:`pca_from_gram`."""
    a = np.asarray(gram, dtype=np.float64)
    w, v = np.linalg.eigh(a)
    w, v = w[::-1], v[:, ::-1]
    idx = np.argmax(np.abs(v), axis=0)  # numpy: first maximum wins
    signs = np.where(v[idx, np.arange(v.shape[1])] < 0, -1.0, 1.0)
    v = v * signs
    s = np.sqrt(np.clip(w, 0, None))
    ev = s / max(s.sum(), 1e-300)
    return v[:, :k], ev[:k], s
