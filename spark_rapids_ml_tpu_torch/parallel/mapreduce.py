"""Map/reduce primitives over the world of ranks — the port's one
collective layer.

The port of ``spark_rapids_ml_tpu/parallel/mapreduce.py``. There, mapped
per-shard compute composes with named-axis reductions lowered to
``psum``/``all_gather``/``ppermute`` inside one SPMD program. Here one rank
is one process with one device (``parallel/mesh.py``), a rank's tensors
are its shard, and the reductions are ``torch.distributed`` collectives
over the group of a mesh axis (``parallel/mesh.py``: the data group, the
ranks of one model column; the model group, the ranks of one data row):
:func:`reduce_sum` is ``all_reduce(SUM)``, :func:`all_concat`
``all_gather`` (blocks in axis-position order) and :func:`ring_shift`
``batch_isend_irecv`` (its permutation in axis positions, as
``lax.ppermute``'s, sent to the global ranks at those positions). Over an
axis one rank wide, and without a process group (the world of one), each
is the identity. Every device-plane collective of the port goes through
these wrappers; :func:`host_concat` assembles host blocks over the axis's
gloo group.

A backend takes the tensors of some devices only. NCCL takes CUDA
tensors. Gloo takes CPU tensors, and CUDA tensors for the collectives in
:data:`GLOO_CUDA` (measured on the card, ``PERF.md``). Any other pairing
is staged: copied to the host (gloo) or to the rank's device (NCCL), run
there and copied back, chosen by the backend before the call — never by
catching a failure — and counted in :data:`STAGED`.

The counter ``srml_parallel_collective_traces_total`` keeps the JAX
package's name and labels (``kind`` psum | all_gather | ppermute,
``axis``). Eager PyTorch has no trace: it counts calls. Every sum that
crosses a process group runs inside a ``trace_span("collective reduce")``
(its host seconds per call in ``utils/profiling.span_totals``; blocking
for gloo, whose collectives return when done), every gather inside a
``trace_span("collective gather")`` and every ring step inside a
``trace_span("collective shift")``.

Not here: the control plane's host gathers of scalars
(``parallel/distributed.process_allgather`` over the gloo group).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops import selection as sel
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, default_mesh
from spark_rapids_ml_tpu_torch.utils import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.utils.profiling import trace_span

__all__ = [
    "map_fn",
    "reduce_sum",
    "all_concat",
    "ring_shift",
    "reduce_topk",
    "host_concat",
]

_M_COLLECTIVE_TRACES = metrics_mod.counter(
    "srml_parallel_collective_traces_total",
    "Collective calls (eager PyTorch has no trace: every call books one), by "
    "kind (psum|all_gather|ppermute) and mesh axis",
)

#: The collectives gloo runs on CUDA tensors (it copies them through the
#: host itself); every other collective of a CUDA tensor is staged.
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather"})

#: Collective calls staged because the backend does not take the tensors'
#: device, per collective; per process, like ``kernels.LAUNCHES``.
STAGED: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "send_recv": 0}


def _book(kind: str, axis_name: str) -> None:
    _M_COLLECTIVE_TRACES.inc(kind=kind, axis=str(axis_name))


def _check_axis(axis_name: str) -> None:
    if axis_name not in (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"unknown mesh axis {axis_name!r} ({DATA_AXIS!r} or {MODEL_AXIS!r})")


def _spans(mesh: Mesh, axis_name: str) -> bool:
    """Whether a collective over ``axis_name`` crosses a process group: a
    started world and an axis wider than one rank — or the data axis of a
    (data, 1) mesh, the world's group, of one rank too (an NCCL world of
    one runs its collectives)."""
    _check_axis(axis_name)
    if not mesh.collective:
        return False
    if axis_name == DATA_AXIS and mesh.shape[MODEL_AXIS] == 1:
        return True
    return mesh.axis_group(axis_name) is not None


def _home(mesh: Mesh, t: torch.Tensor, kind: str) -> Optional[torch.device]:
    """Where a collective of ``t`` must run when the backend does not take
    its device, else None."""
    if mesh.backend == "nccl":
        return None if t.device.type == "cuda" else mesh.device
    if t.device.type == "cpu" or (t.device.type == "cuda" and kind in GLOO_CUDA):
        return None
    return torch.device("cpu")


def map_fn(fn, mesh: Mesh, in_specs=None, out_specs=None):
    """Map ``fn`` over the mesh's shards (the DrJAX ``map_fn``): a rank
    holds exactly its shard, so the mapped function is ``fn`` on this
    rank's arguments, its tensors placed on the rank's device first (when
    the world has one). The specs are the JAX signature's; the placement
    they describe is the caller's rows on this rank."""

    @functools.wraps(fn)
    def mapped(*args):
        if mesh.device is not None:
            args = tuple(a.to(mesh.device) if isinstance(a, torch.Tensor) else a for a in args)
        return fn(*args)

    return mapped


def reduce_sum(x: torch.Tensor, axis_name: str = DATA_AXIS, *,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Cross-rank sum over a mesh axis (``all_reduce(SUM)``), IN PLACE:
    the returned tensor is ``x`` holding the sum, the same bits on every
    rank. Gram/moment partials, k-means and Newton statistics combine
    through this. Accumulator dtypes only (float32/float64, integers): a
    bfloat16/float16 sum would round every partial."""
    import torch.distributed as dist

    _book("psum", axis_name)
    mesh = mesh or default_mesh()
    if x.dtype in (torch.bfloat16, torch.float16):
        raise TypeError(f"reduce_sum of a {x.dtype} tensor: reduce accumulators "
                        "(float32/float64) only")
    if not _spans(mesh, axis_name):
        return x
    home = _home(mesh, x, "all_reduce")
    group = mesh.axis_group(axis_name)
    with trace_span("collective reduce"):
        if home is None:
            dist.all_reduce(x, group=group)
            return x
        staged = x.to(home)
        dist.all_reduce(staged, group=group)
        STAGED["all_reduce"] += 1
        return x.copy_(staged)


def _all_gather(x: torch.Tensor, axis_name: str, mesh: Mesh) -> List[torch.Tensor]:
    import torch.distributed as dist

    home = _home(mesh, x, "all_gather")
    xs = x.contiguous() if home is None else x.to(home).contiguous()
    outs = [torch.empty_like(xs) for _ in mesh.axis_ranks(axis_name)]
    with trace_span("collective gather"):
        dist.all_gather(outs, xs, group=mesh.axis_group(axis_name))
    if home is None:
        return outs
    STAGED["all_gather"] += 1
    return [o.to(x.device) for o in outs]


def all_concat(x: torch.Tensor, axis_name: str = DATA_AXIS, *, axis: int = 0,
               tiled: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The blocks (one shape on all ranks) of the ranks along the mesh axis
    concatenated along tensor dim ``axis`` in axis-position order
    (``tiled``), or stacked on a new dim ``axis`` (not tiled) —
    ``all_gather``."""
    _book("all_gather", axis_name)
    mesh = mesh or default_mesh()
    parts = _all_gather(x, axis_name, mesh) if _spans(mesh, axis_name) else [x]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ring_shift(x: torch.Tensor, axis_name: str, perm: Sequence[Tuple[int, int]], *,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Send ``x`` along the (source, destination) pairs of ``perm``, in axis
    positions as ``lax.ppermute``'s: a rank gets the block of the position
    that names it as destination, or zeros when none does. Peers are the
    global ranks at those positions (``Mesh.axis_ranks``), as ``P2POp``
    takes them. One block in flight per step: the pipelined alternative
    to :func:`all_concat`."""
    import torch.distributed as dist

    _book("ppermute", axis_name)
    mesh = mesh or default_mesh()
    if not _spans(mesh, axis_name):
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    pos = mesh.axis_index(axis_name)
    ranks = mesh.axis_ranks(axis_name)
    dst = [d for s, d in perm if s == pos]
    src = [s for s, d in perm if d == pos]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {list(perm)} is not a permutation: position {pos} appears twice")
    home = _home(mesh, x, "send_recv")
    xs = x.contiguous() if home is None else x.to(home).contiguous()
    out = torch.zeros_like(xs)
    group = mesh.axis_group(axis_name)
    ops = []
    if dst and dst[0] != pos:
        ops.append(dist.P2POp(dist.isend, xs, ranks[dst[0]], group=group))
    if src and src[0] != pos:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src[0]], group=group))
    elif src:
        out.copy_(xs)
    if ops:
        with trace_span("collective shift"):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    if home is None:
        return out
    STAGED["send_recv"] += 1
    return out.to(x.device)


def reduce_topk(dists: torch.Tensor, ids: torch.Tensor, k: int,
                axis_name: str = DATA_AXIS, *, mesh: Optional[Mesh] = None):
    """Merge every rank's ascending (q, k_local) candidate pool into the
    global top-k on every rank: the pools, padded to k with (+inf, the
    largest id), gathered in rank order and selected by (distance, id)
    (``ops/selection.lex_topk``), so equal distances go to the lowest id
    — the order ``lax.top_k`` over rank-ordered pools gives the JAX
    package. Exact when each rank contributed its local top-min(k, rows).
    Returns ``(dists (q, k) ascending, ids (q, k))``."""
    q, kl = dists.shape
    if kl < k:
        pad_id = torch.iinfo(ids.dtype).max
        dists = torch.cat([dists, dists.new_full((q, k - kl), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((q, k - kl), pad_id)], dim=1)
    cand_d = all_concat(dists, axis_name, axis=1, mesh=mesh)
    cand_i = all_concat(ids, axis_name, axis=1, mesh=mesh)
    return sel.lex_topk(cand_d, cand_i, k)


def host_concat(x: torch.Tensor, axis_name: str, *, mesh: Mesh) -> torch.Tensor:
    """The host blocks of the ranks along the mesh axis, concatenated on
    dim 0 in axis-position order over the axis's gloo group: the host-side
    assembly of a model-sharded matrix, whose whole never reaches a
    device. ``x`` is copied to the host first."""
    import torch.distributed as dist

    _book("all_gather", axis_name)
    xs = x.detach().cpu().contiguous()
    if not _spans(mesh, axis_name):
        return xs
    outs = [torch.empty_like(xs) for _ in mesh.axis_ranks(axis_name)]
    with trace_span("collective gather"):
        dist.all_gather(outs, xs, group=mesh.axis_cpu_group(axis_name))
    return torch.cat(outs, dim=0)
