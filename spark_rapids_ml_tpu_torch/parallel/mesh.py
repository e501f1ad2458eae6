"""The mesh of the port: the world of ``torch.distributed`` ranks.

The port of ``spark_rapids_ml_tpu/parallel/mesh.py``. In the JAX package a
mesh names devices of one process or of many (``jax.distributed``), and
partials meet in ``psum`` over its ``data`` axis. Here one rank is one
process with one device (``cuda:{local_rank % device_count}``, or the CPU
when asked), and the ``data`` axis is the world of ranks:

* ``data`` — rows; each rank holds its own rows and the partials meet in
  the collectives of ``parallel/mapreduce.py`` over the world's group;
* ``model`` — features. The feature-sharded Gram is a later slice, so a
  model axis above 1 raises ``NotImplementedError``.

No process group (the tests, a local run) is the world of one: a mesh of
one rank whose collectives are the identity and whose device is the
entry point's (``device=``, the card by default). ``initialize_cluster``
(``parallel/distributed.py``) starts a world; this module keeps it.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

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


def process_index() -> int:
    return _world.rank


def process_count() -> int:
    return _world.size


class Mesh:
    """A (data, model) mesh over every rank of a world.

    ``shape`` maps axis name to size, as a JAX mesh's does; ``group``,
    ``backend`` and ``device`` are the world's (``device`` None in the
    world of one: the entry point decides). ``collective``: whether
    partials meet over a process group — true in any started world, of
    one rank too, so an NCCL world of one runs its collectives."""

    def __init__(self, data: int, model: int, w: World):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.world = w

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    @property
    def group(self):
        return self.world.group

    @property
    def backend(self) -> Optional[str]:
        return self.world.backend

    @property
    def device(self) -> Optional[torch.device]:
        return self.world.device

    @property
    def collective(self) -> bool:
        return self.world.group is not None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"backend={self.backend}, device={self.device})")


_default_mesh: Optional[Mesh] = None
_default_mesh_key: Optional[tuple] = None
#: Guards the default-mesh cache and the world: daemon connection threads
#: reach default_mesh() through the fit and serve paths under different
#: locks, so the check-then-build below must be one critical section.
_mesh_lock = threading.RLock()


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, model) mesh over the given ranks (default: the
    world's; one device a rank). The port's mesh spans its whole world,
    whose group its collectives run on."""
    w = _world
    ranks = list(devices) if devices is not None else list(range(w.size))
    n = len(ranks)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if model > 1:
        raise NotImplementedError(
            f"a model axis of {model}: the feature-sharded Gram (sharded_stats_2d, "
            "sharded_stats_ring, pca_from_gram_model_sharded) is a later slice of the "
            "port (ROADMAP.md Queue 1 item 5); use model=1"
        )
    if data != w.size:
        raise ValueError(
            f"mesh {data}x{model} covers {data} of the world's {w.size} ranks; the port's "
            "mesh spans the whole world (one rank, one device)"
        )
    return Mesh(data, model, w)


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
