"""The mesh of the port: the world of ``torch.distributed`` ranks.

The port of ``spark_rapids_ml_tpu/parallel/mesh.py``. In the JAX package a
mesh names devices of one process or of many (``jax.distributed``), and
partials meet in ``psum`` over its ``data`` axis. Here one rank is one
process with one device (``cuda:{local_rank % device_count}``, or the CPU
when asked), and a (data, model) mesh lays the world's ranks out as the
JAX package lays out its devices, ``np.array(devs).reshape(data, model)``:
rank ``r`` sits at ``(r // model, r % model)``.

* ``data`` — rows; the ranks of one model column (the **data group**) hold
  different rows and their partials meet in the collectives of
  ``parallel/mapreduce.py``. With ``model`` 1 the data group is the
  world's group.
* ``model`` — features; the ranks of one data row (the **model group**)
  hold the same rows, each its own block of columns, and meet in the
  feature-sharded Gram (``ops/gram.sharded_stats_ring``) and the
  model-sharded eigensolve (``ops/eigh.pca_from_gram_model_sharded``).

The groups are ``torch.distributed`` groups, built the first time a rank
asks for a mesh of that shape. ``dist.new_group`` is collective over the
world, so every rank builds every group of the shape (those it is not in
too) in one fixed order: every rank must ask for a (data, model) mesh
with model above 1 at the same point of its program. Beside each group of
an NCCL world sits a gloo group over the same ranks for host tensors (the
host-side assembly of a model-sharded Gram).

No process group (the tests, a local run) is the world of one: a mesh of
one rank whose collectives are the identity and whose device is the
entry point's (``device=``, the card by default). ``initialize_cluster``
(``parallel/distributed.py``) starts a world; this module keeps it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_ml_tpu_torch import config

DATA_AXIS = "data"
MODEL_AXIS = "model"


class World(NamedTuple):
    """A started ``torch.distributed`` world as this process sees it.

    ``group``: the data plane's group (the backend's default group);
    ``cpu_group``: a gloo group over the same ranks for the control plane
    (host scalars: lockstep flags, row counts, the init sample), so an
    NCCL group is never handed a host tensor; ``device``: this rank's."""

    group: Optional[object]
    cpu_group: Optional[object]
    backend: Optional[str]
    device: Optional[torch.device]
    rank: int
    size: int


#: The world of one: no process group.
SOLO = World(None, None, None, None, 0, 1)

_world = SOLO


def world() -> World:
    return _world


def set_world(w: World) -> None:
    """Install the world ``initialize_cluster`` started (or :data:`SOLO`)."""
    global _world
    with _mesh_lock:
        _world = w
        _axis_groups.clear()


def process_index() -> int:
    return _world.rank


def process_count() -> int:
    return _world.size


class Mesh:
    """A (data, model) mesh over every rank of a world.

    ``shape`` maps axis name to size, as a JAX mesh's does; ``backend``
    and ``device`` are the world's (``device`` None in the
    world of one: the entry point decides). ``coords`` is this rank's
    (data index, model index). ``collective``: whether partials meet over
    a process group — true in any started world, of one rank too, so an
    NCCL world of one runs its collectives."""

    def __init__(self, data: int, model: int, w: World, axes: Optional[Dict] = None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.world = w
        self.coords = (w.rank // model, w.rank % model)
        # axis -> (global ranks along the axis through this rank, device
        # group, host group); groups None where the axis is one rank wide.
        self._axes = axes or {
            DATA_AXIS: (list(range(w.size)), w.group, w.cpu_group),
            MODEL_AXIS: ([w.rank], None, None),
        }

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def backend(self) -> Optional[str]:
        return self.world.backend

    @property
    def device(self) -> Optional[torch.device]:
        return self.world.device

    @property
    def collective(self) -> bool:
        return self.world.group is not None

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[0 if axis == DATA_AXIS else 1]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in position
        order (a P2P peer is a global rank, not a position)."""
        return list(self._axes[axis][0])

    def axis_group(self, axis: str):
        """The device collectives' group of ``axis`` (None: one rank)."""
        return self._axes[axis][1]

    def axis_cpu_group(self, axis: str):
        """A gloo group over the same ranks, for host tensors."""
        return self._axes[axis][2]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"backend={self.backend}, device={self.device})")


_default_mesh: Optional[Mesh] = None
_default_mesh_key: Optional[tuple] = None
#: (data, model) -> the axis groups of this rank, built once per world.
_axis_groups: Dict[Tuple[int, int], Dict] = {}
#: Guards the default-mesh cache and the world: daemon connection threads
#: reach default_mesh() through the fit and serve paths under different
#: locks, so the check-then-build below must be one critical section.
_mesh_lock = threading.RLock()


def _build_axis_groups(data: int, model: int, w: World) -> Dict:
    """Every data column's and data row's groups, created on every rank in
    one order (``new_group`` is collective over the world); returns this
    rank's. Groups of one rank are not created: nothing crosses them."""
    import torch.distributed as dist

    columns = [[d * model + m for d in range(data)] for m in range(model)]
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    mine = {}
    for axis, lines in ((DATA_AXIS, columns), (MODEL_AXIS, rows)):
        for ranks in lines:
            group = cpu_group = None
            if len(ranks) > 1:
                group = dist.new_group(ranks=ranks)
                cpu_group = group if w.backend == "gloo" else dist.new_group(ranks=ranks,
                                                                             backend="gloo")
            if w.rank in ranks:
                mine[axis] = (ranks, group, cpu_group)
    return mine


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, model) mesh over the given ranks (default: the
    world's; one device a rank). The port's mesh spans its whole world:
    rank r at (r // model, r % model), the JAX layout. With model above 1
    every rank must make this call at the same point (the first one of a
    shape builds its groups, collectively)."""
    w = _world
    ranks = list(devices) if devices is not None else list(range(w.size))
    n = len(ranks)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if data * model != w.size:
        raise ValueError(
            f"mesh {data}x{model} covers {data * model} of the world's {w.size} ranks; the "
            "port's mesh spans the whole world (one rank, one device)"
        )
    if model == 1:
        return Mesh(data, model, w)
    with _mesh_lock:
        if (data, model) not in _axis_groups:
            _axis_groups[(data, model)] = _build_axis_groups(data, model, w)
        return Mesh(data, model, w, _axis_groups[(data, model)])


def default_mesh() -> Mesh:
    """Process-wide default mesh: every rank on the data axis unless the
    config's ``mesh_data_axis``/``mesh_model_axis`` say otherwise.

    Rebuilt when the axis config changes or the world changes (a world
    started or shut down since it was built: the JAX package's rule that
    a mesh whose devices are no longer the live ones is stale)."""
    global _default_mesh, _default_mesh_key
    key = (config.get("mesh_data_axis"), config.get("mesh_model_axis") or 1)
    with _mesh_lock:
        if _default_mesh is None or key != _default_mesh_key or _mesh_is_stale(_default_mesh):
            _default_mesh = make_mesh(data=key[0], model=key[1])
            _default_mesh_key = key
        return _default_mesh


def _mesh_is_stale(mesh: Mesh) -> bool:
    return mesh.world is not _world


def reset_default_mesh() -> None:
    global _default_mesh, _default_mesh_key
    with _mesh_lock:
        _default_mesh = None
        _default_mesh_key = None


def mesh_shape(mesh: Mesh) -> tuple:
    return tuple(mesh.shape[a] for a in (DATA_AXIS, MODEL_AXIS))
