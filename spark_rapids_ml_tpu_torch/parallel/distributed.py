"""Multi-process runtime: start a ``torch.distributed`` world.

The port of ``spark_rapids_ml_tpu/parallel/distributed.py``. Every process
of a fit calls :func:`initialize_cluster` with a shared coordinator, its
rank and the world size; after it, :func:`global_mesh` is the (data,
model) mesh over every rank, and the fits' partials meet in the
collectives of ``parallel/mapreduce.py``:

* one rank, one device: ``cuda:{local_rank % device_count}`` (the local
  rank is ``$LOCAL_RANK`` when a launcher sets it, else the rank), or the
  CPU when the caller passes ``device="cpu"``;
* the backend is NCCL for a CUDA device and gloo for the CPU, unless the
  caller passes ``backend=`` (two ranks that share one card must take
  gloo: NCCL refuses two ranks on one device);
* beside the backend's group, a gloo group over the same ranks carries
  the control plane (lockstep flags, row counts, the k-means init sample,
  the checkpoint visibility check) as host tensors: :func:`process_allgather`.

The arguments default from the JAX package's environment names
(``SRML_TPU_COORDINATOR``, ``SRML_TPU_NUM_PROCS``, ``SRML_TPU_PROC_ID``),
which are deployment-facing: one executor launcher starts either
package. Single process (no coordinator, one process) is a no-op that
returns 0: the world of one.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.parallel import mesh as mesh_mod
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from spark_rapids_ml_tpu_torch.utils.logging import get_logger

_logger = get_logger(__name__)
_initialized = False


def is_initialized() -> bool:
    return _initialized


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _rank_device(device, process_id: int) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the rank on the CPU"
        )
    local = _env_int("LOCAL_RANK")
    local = process_id if local is None else local
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> int:
    """Start (or join) the world; returns this process's rank.

    ``coordinator_address``: ``host:port`` of rank 0 (or a full
    ``tcp://`` init method). ``backend``: None → NCCL on a CUDA device,
    gloo on the CPU. ``device``: this rank's device, None → the card
    (``cuda:{local_rank % device_count}``). A process group the caller
    started already is adopted when its rank and size agree."""
    import torch.distributed as dist

    global _initialized
    coordinator_address = coordinator_address or os.environ.get("SRML_TPU_COORDINATOR")
    num_processes = num_processes or _env_int("SRML_TPU_NUM_PROCS")
    process_id = process_id if process_id is not None else _env_int("SRML_TPU_PROC_ID")

    if coordinator_address is None and num_processes in (None, 1) and not dist.is_initialized():
        # Single process: the world of one, no process group.
        _initialized = True
        return 0

    dev = _rank_device(device, process_id or 0)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (num_processes not in (None, dist.get_world_size())
                or process_id not in (None, dist.get_rank())):
            raise ValueError(
                f"the running process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {process_id} of {num_processes}"
            )
        backend = dist.get_backend()
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "a multi-process world needs coordinator_address, num_processes and "
                "process_id (or SRML_TPU_COORDINATOR, SRML_TPU_NUM_PROCS, SRML_TPU_PROC_ID)"
            )
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=init, world_size=int(num_processes),
                                rank=int(process_id))
    cpu_group = dist.new_group(backend="gloo")
    mesh_mod.set_world(mesh_mod.World(
        group=dist.group.WORLD, cpu_group=cpu_group, backend=backend, device=dev,
        rank=dist.get_rank(), size=dist.get_world_size(),
    ))
    _initialized = True
    _logger.info("distributed runtime up: rank %d/%d on %s, backend %s",
                 dist.get_rank(), dist.get_world_size(), dev, backend)
    return dist.get_rank()


def shutdown_cluster() -> None:
    """Leave the world (destroying its process groups): back to the world
    of one. A no-op when no world was started."""
    import torch.distributed as dist

    global _initialized
    if mesh_mod.world().group is not None and dist.is_initialized():
        dist.destroy_process_group()
    mesh_mod.set_world(mesh_mod.SOLO)
    _initialized = False


def global_mesh(model: int = 1):
    """(data, model) mesh over every rank of the world (rank r at
    (r // model, r % model)); with ``model`` above 1 every rank makes this
    call at the same point (``parallel/mesh.make_mesh``)."""
    return make_mesh(model=model)


def process_local_rows(n_rows: int) -> tuple:
    """[start, stop) row range this process should feed, for host-sharded
    data loading: each rank materializes only its slice (the ceil split)."""
    p = mesh_mod.process_index()
    count = mesh_mod.process_count()
    per = (n_rows + count - 1) // count
    return min(p * per, n_rows), min((p + 1) * per, n_rows)


def process_allgather(x) -> np.ndarray:
    """Every rank's ``x`` (a host array of one shape on all ranks) stacked
    in rank order: ``(world, *x.shape)``, over the control plane's gloo
    group — the port's ``multihost_utils.process_allgather``."""
    import torch.distributed as dist

    a = np.ascontiguousarray(np.asarray(x))
    w = mesh_mod.world()
    if w.group is None:
        return a[None]
    t = torch.from_numpy(a.copy())
    outs = [torch.empty_like(t) for _ in range(w.size)]
    dist.all_gather(outs, t, group=w.cpu_group)
    return torch.stack(outs).numpy()


def per_data_index(values: np.ndarray, mesh, what: str) -> np.ndarray:
    """Per-rank values gathered over the world (rank order, first dim) →
    one per data index of a (data, model) mesh. The ranks of one data row
    hold the same rows, so they must agree; where they do not, every rank
    raises the same ValueError (each sees the whole gather), never a
    hang in a later collective. A (data, 1) mesh: the values as given."""
    model = mesh.shape[MODEL_AXIS]
    if model == 1 or values.shape[0] == 1:
        return values
    grid = values.reshape((mesh.shape[DATA_AXIS], model) + values.shape[1:])
    for i, row in enumerate(grid):
        if not (row == row[:1]).all():
            raise ValueError(
                f"the ranks of data index {i} passed different {what} "
                f"({row.tolist()}): every rank of one data index passes the same rows "
                "at full width"
            )
    return grid[:, 0]


def row_counts(n_local: int, mesh=None) -> np.ndarray:
    """Every rank's local row count, in rank order (int64). Given a mesh
    with a model axis above 1: one count per data index (its ranks hold
    the same rows, counted once; :func:`per_data_index`)."""
    counts = process_allgather(np.asarray([int(n_local)], dtype=np.int64)).reshape(-1)
    return counts if mesh is None else per_data_index(counts, mesh, "row counts")
