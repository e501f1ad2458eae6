"""Binned-feature histograms for tree ensembles.

The port of ``spark_rapids_ml_tpu/ops/histogram.py``, in PyTorch tensor
code on an explicit device: the reference's histogram is plain XLA (no
Pallas kernel), so the port's is plain PyTorch.

* **Quantile binning**: :func:`quantile_bin_edges` on the host (numpy, as
  the reference), :func:`bin_matrix` on the device. Features quantize to
  bin ids ``sum(x > edges)`` against per-feature edges, so a node's split
  search is a dense histogram over a fixed bin axis.

* **Per-depth histogram update** (:func:`hist_update`): descend every row
  to its frontier node in every tree, weight it (open node, bootstrap bag),
  and add its stat row into the ``(tree, node, feature, bin, stat)``
  tensor. The reference writes the add as a one-hot contraction (an einsum
  over rows); here it is a scatter: (tree, node, feature, bin) flatten to
  one key per (tree, row, feature) and ``index_add_`` adds the weighted
  stat row at it. Rows go in chunks so the int64 keys stay bounded.
  Classification adds small-integer weights, exact in float32 while a bin
  holds under 2²⁴ of weight, so its histogram does not depend on the add
  order; float regression sums do, in their last bits (on the card the
  adds are atomics, not run-to-run bitwise).

* **Vectorized split scoring** (:func:`best_splits`): cumulative sums
  along the bin axis give every (feature, threshold) candidate's left and
  right statistics at once; Gini and variance gains share the
  ``Σg²/n`` form, scored and arg-maxed for every frontier node of every
  tree at once.

Stat layout (the ``S`` axis): classification keeps per-class counts
(``S = n_classes``), regression ``(count, Σy, Σy²)`` (``S = 3``). Bootstrap
resampling is a per-(tree, row) Poisson(1) weight from a counter-based
hash of the row's identity key, so a bag never depends on chunking.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: Node-table sentinels (models/random_forest.py's dense (tree, node) heap
#: layout): an OPEN node is on the frontier awaiting its split; a LEAF is
#: closed (or was never created). Internal nodes hold the split feature.
OPEN = -2
LEAF = -1

#: Poisson(1) CDF at 0..5: a uniform hash inverts it to a bootstrap weight
#: (w = number of values below u, at most 6).
_POISSON1_CDF = (
    0.36787944117144233,
    0.7357588823428847,
    0.9196986029286058,
    0.9810118431238462,
    0.9963401531726563,
    0.9994058151824183,
)

_U32 = 0xFFFFFFFF

#: Rows per chunk of a histogram update: the (tree, row, feature) keys of a
#: chunk stay under this many (int64, 1 GiB; a few GiB of transients in
#: all), so a level over 11M rows x 28 features x 20 trees is 46 chunks.
KEY_BUDGET = 1 << 27

#: Compares per chunk of :func:`bin_matrix` (a bool each).
BIN_BUDGET = 1 << 28


def quantile_bin_edges(sample: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature quantile bin edges from a host-side sample: ``(d,
    max_bins - 1)`` float64 interior edges; bin id = ``sum(x > edges)`` in
    [0, max_bins). Duplicate edges (skewed or constant features) leave some
    bins empty, which the split scorer never picks."""
    sample = np.asarray(sample, dtype=np.float64)
    if sample.ndim != 2 or sample.shape[0] == 0:
        raise ValueError(f"edge sample must be (n, d) with n > 0, got {sample.shape}")
    if not 2 <= int(max_bins) <= 256:
        raise ValueError(f"max_bins = {max_bins} out of range [2, 256] (bin ids are uint8)")
    qs = np.linspace(0.0, 1.0, int(max_bins) + 1)[1:-1]
    edges = np.quantile(sample, qs, axis=0).T  # (d, B-1)
    return np.ascontiguousarray(edges, dtype=np.float64)


def bin_matrix(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``(n, d)`` values against ``(d, B-1)`` edges (both on one device, in
    one dtype) → ``(n, d)`` int32 bin ids ``sum(x > edge)``, in row chunks
    of at most :data:`BIN_BUDGET` compares. (For sorted edges this is
    ``torch.searchsorted(edges, x, right=False)``; the compare needs no
    order.)"""
    n, d = x.shape
    out = torch.empty((n, d), dtype=torch.int32, device=x.device)
    step = max(1, BIN_BUDGET // max(1, d * edges.shape[1]))
    for i in range(0, n, step):
        xc = x[i: i + step]
        out[i: i + step] = (xc[:, :, None] > edges[None, :, :]).sum(-1, dtype=torch.int32)
    return out


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h · c mod 2³²`` for int64 ``h`` in [0, 2³²): the product split at
    16 bits of ``c``, so no partial product passes 2⁴⁹."""
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (h * (c & 0xFFFF) + hi) & _U32


def _hash_u32(h: torch.Tensor) -> torch.Tensor:
    """The reference's splitmix-style avalanche on uint32 lanes, computed in
    int64 with every product and xor-shift kept to its low 32 bits (torch
    has few uint32 ops). Values in [0, 2³²)."""
    h = h.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x846CA68B)
    return h ^ (h >> 16)


def bootstrap_weights(row_key: torch.Tensor, n_trees: int, seed: int) -> torch.Tensor:
    """Poisson(1) bootstrap weights, ``(T, n)`` float32, from per-row uint32
    identity keys (an int64 tensor of values in [0, 2³²)): tree t's bag is a
    pure function of (seed, t, row identity). The hash becomes float32 by
    round-to-nearest, times float32(2⁻³²), against the float32 CDF, as in
    the reference."""
    dev = row_key.device
    t = torch.arange(n_trees, dtype=torch.int64, device=dev)[:, None]
    tweak = (_mul_u32(t, 0x9E3779B1) + (int(seed) & _U32)) & _U32
    u = _hash_u32((row_key.to(torch.int64) & _U32)[None, :] ^ _hash_u32(tweak))
    u = u.to(torch.float32) * torch.tensor(1.0 / 4294967296.0, dtype=torch.float32)
    cdf = torch.tensor(_POISSON1_CDF, dtype=torch.float32, device=dev)
    return (u[:, :, None] > cdf).sum(-1, dtype=torch.int32).to(torch.float32)


def descend_to_frontier(bins: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
                        depth: int):
    """Every row's heap node index at ``depth`` in every tree.

    ``bins``: (n, d) integer; ``feature``/``threshold``: (T, N) integer
    node tables (heap layout: the children of i are 2i+1 and 2i+2;
    OPEN/LEAF < 0). Returns ``(idx (T, n) int64, alive (T, n) bool)``;
    ``alive`` is False for a row that reached a leaf above ``depth``."""
    T = feature.shape[0]
    n, d = bins.shape
    feature = feature.to(torch.int64)
    threshold = threshold.to(torch.int64)
    idx = torch.zeros((T, n), dtype=torch.int64, device=bins.device)
    alive = torch.ones((T, n), dtype=torch.bool, device=bins.device)
    for _ in range(depth):
        f = feature.gather(1, idx)
        internal = f >= 0
        bin_at = bins.gather(1, f.clamp(0, d - 1).T).T.to(torch.int64)
        go_right = (bin_at > threshold.gather(1, idx)).to(torch.int64)
        idx = torch.where(internal, 2 * idx + 1 + go_right, idx)
        alive &= internal
    return idx, alive


def zero_hist(n_trees: int, depth: int, n_cols: int, max_bins: int, n_stats: int,
              dtype: torch.dtype, device) -> torch.Tensor:
    """Zero (T, 2^depth, d, B, S) accumulator of one frontier pass."""
    return torch.zeros((n_trees, 1 << depth, n_cols, max_bins, n_stats), dtype=dtype,
                       device=device)


def hist_update(hist: torch.Tensor, bins: torch.Tensor, feature: torch.Tensor,
                threshold: torch.Tensor, y: torch.Tensor, mask, row_key: torch.Tensor,
                depth: int, n_classes: int, bootstrap: bool, seed: int) -> torch.Tensor:
    """Add one batch of binned rows into the depth-``depth`` frontier
    histogram ``hist`` (T, W, d, B, S), in place, and return it.

    A row contributes to tree t when it is unmasked, not settled at a
    shallower leaf, and stands on a node that is OPEN this pass, with its
    bootstrap weight when ``bootstrap``. ``n_classes`` = 0 adds the
    regression stats (w, w·y, w·y²) in ``hist``'s dtype; otherwise w at
    the row's class (``y`` cast to an integer, clipped to the classes).
    ``mask``: (n,) or None (every row valid). All tensors on one device."""
    T, W, d, B, S = hist.shape
    n = bins.shape[0]
    accum = hist.dtype
    flat = hist.view(-1) if n_classes > 0 else hist.view(-1, S)
    col = torch.arange(d, dtype=torch.int64, device=bins.device) * B
    step = max(1, KEY_BUDGET // (T * d))
    for i in range(0, n, step):
        b = bins[i: i + step]
        idx, alive = descend_to_frontier(b, feature, threshold, depth)
        w = alive & (feature.to(torch.int64).gather(1, idx) == OPEN)
        if mask is not None:
            w &= (mask[i: i + step] > 0)[None, :]
        w = w.to(accum)
        if bootstrap:
            w *= bootstrap_weights(row_key[i: i + step], T, seed).to(accum)
        # Only the (tree, row) pairs of weight > 0 add anything (adding a
        # zero leaves every sum as it is): about 37 % of a Poisson(1) bag
        # and every row settled at a shallower leaf drop out here.
        t, r = (w > 0).nonzero(as_tuple=True)
        wv = w[t, r]
        node = t * W + (idx[t, r] - (W - 1)).clamp(0, W - 1)
        key = (node * (d * B))[:, None] + col[None, :] + b[r].to(torch.int64)  # (nnz, d)
        if n_classes > 0:
            cls = y[i: i + step].to(torch.int64).clamp(0, n_classes - 1)
            key = key * S + cls[r][:, None]
            src = wv[:, None].expand(-1, d)
        else:
            ya = y[i: i + step].to(accum)[r]
            src = torch.stack([wv, wv * ya, wv * (ya * ya)], dim=1)[:, None, :].expand(-1, d, 3)
        _index_add_by_tree(flat, key, src, t, T)
    return hist


def _index_add_by_tree(flat: torch.Tensor, key: torch.Tensor, src: torch.Tensor,
                       t: torch.Tensor, n_trees: int) -> None:
    """``flat.index_add_`` of each (tree, row) pair's ``d`` keys and stat
    rows (``key`` (nnz, d), ``src`` (nnz, d[, S]), the pairs tree-major as
    ``nonzero`` lists them). On the CPU, whose ``index_add_`` is serial, a
    tree a thread: each tree adds into its own slice of the histogram, in
    the same order as one call would."""
    tail = src.shape[2:]
    if flat.device.type != "cpu" or n_trees == 1:
        flat.index_add_(0, key.reshape(-1), src.reshape((-1,) + tail))
        return
    ends = torch.bincount(t, minlength=n_trees).cumsum(0).tolist()
    spans = [(s, e) for s, e in zip([0] + ends[:-1], ends) if e > s]
    with ThreadPoolExecutor(max_workers=min(len(spans), torch.get_num_threads())) as pool:
        list(pool.map(lambda se: flat.index_add_(0, key[se[0]:se[1]].reshape(-1),
                                                 src[se[0]:se[1]].reshape((-1,) + tail)),
                      spans))


def feature_subset_mask(n_trees: int, width: int, depth: int, n_cols: int, m: int, seed: int,
                        device="cpu") -> torch.Tensor:
    """Deterministic per-node feature subset (featureSubsetStrategy):
    ``(T, W, d)`` bool with exactly ``min(m, d)`` True per (tree, node),
    chosen by ranking counter-based hashes of (seed, tree, global node id,
    feature). Ranks by two stable sorts, as the reference's ``argsort``."""
    if m >= n_cols:
        return torch.ones((n_trees, width, n_cols), dtype=torch.bool, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    t = torch.arange(n_trees, **i64)[:, None, None]
    node = (width - 1) + torch.arange(width, **i64)[None, :, None]
    f = torch.arange(n_cols, **i64)[None, None, :]
    r = _hash_u32(
        f
        ^ _hash_u32(_mul_u32(node, 0x85EBCA6B))
        ^ _hash_u32((_mul_u32(t, 0xC2B2AE35) + (int(seed) & _U32)) & _U32)
    )
    order = torch.argsort(r, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank < m


def best_splits(hist: torch.Tensor, depth: int, n_classes: int, subset_m: int, seed: int,
                min_instances: int):
    """The split scorer of one frontier: ``hist (T, W, d, B, S) → (score,
    feature, bin, left, right, total)``, ``score (T, W)`` the best impurity
    improvement over every (feature, threshold bin) candidate in the node's
    feature subset, ``left``/``right``/``total (T, W, S)`` the chosen
    split's child and node statistics.

    Maximizing the Gini or variance gain is maximizing ``Σg²(left)/n(left)
    + Σg²(right)/n(right)`` (g = class counts, or Σy), less the node's own
    term so that a score > 0 is a gain. Degenerate candidates (an empty
    side, under ``min_instances``, outside the subset) score −inf. The best
    is the first maximum over the flattened (feature, bin) axis."""
    T, W, d, B, S = hist.shape
    cum = hist.cumsum(3)
    tot = cum[:, :, 0, B - 1, :]  # (T, W, S): identical per feature
    left = cum[:, :, :, : B - 1, :]  # (T, W, d, B-1, S)
    right = tot[:, :, None, None, :] - left
    if n_classes > 0:
        n_l, n_r = left.sum(-1), right.sum(-1)
        g_l, g_r = (left * left).sum(-1), (right * right).sum(-1)
        g_t, n_t = (tot * tot).sum(-1), tot.sum(-1)
    else:
        n_l, n_r = left[..., 0], right[..., 0]
        g_l, g_r = left[..., 1] * left[..., 1], right[..., 1] * right[..., 1]
        g_t, n_t = tot[..., 1] * tot[..., 1], tot[..., 0]
    score = g_l / n_l.clamp_min(1) + g_r / n_r.clamp_min(1)
    score = score - (g_t / n_t.clamp_min(1))[:, :, None, None]
    valid = (n_l >= float(min_instances)) & (n_r >= float(min_instances))
    valid &= feature_subset_mask(T, W, depth, d, subset_m, seed, device=hist.device)[..., None]
    score = torch.where(valid, score, torch.full_like(score, -float("inf")))
    flat = score.reshape(T, W, d * (B - 1))
    best = flat.argmax(-1)
    best_score = flat.gather(-1, best[:, :, None])[..., 0]
    best_f, best_b = best // (B - 1), best % (B - 1)

    def pick(a):
        at_f = a.gather(2, best_f[:, :, None, None, None].expand(T, W, 1, B - 1, S))
        return at_f.gather(3, best_b[:, :, None, None, None].expand(T, W, 1, 1, S))[:, :, 0, 0, :]

    return best_score, best_f, best_b, pick(left), pick(right), tot
