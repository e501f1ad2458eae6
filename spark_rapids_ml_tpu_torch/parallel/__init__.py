"""Distributed execution layer of the port: the mesh of ranks, placement,
collectives.

The port of ``spark_rapids_ml_tpu/parallel``: rows are split over the
``data`` axis, which here is the world of ``torch.distributed`` ranks (one
process, one device each; ``mesh.py``), and partials combine with the
collectives of ``mapreduce.py`` (``all_reduce`` for ``psum``).
``distributed.initialize_cluster`` starts a world; without one, every
entry point runs as the world of one.
"""

from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    default_mesh,
    make_mesh,
    mesh_shape,
)
from spark_rapids_ml_tpu_torch.parallel.mapreduce import (
    all_concat,
    map_fn,
    reduce_sum,
    reduce_topk,
    ring_shift,
)
from spark_rapids_ml_tpu_torch.parallel.membership import MeshMembership, registry
from spark_rapids_ml_tpu_torch.parallel.sharding import (
    pad_rows,
    shard_rows,
    replicated,
    row_sharding,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "MeshMembership",
    "all_concat",
    "default_mesh",
    "make_mesh",
    "map_fn",
    "mesh_shape",
    "pad_rows",
    "reduce_sum",
    "reduce_topk",
    "registry",
    "replicated",
    "ring_shift",
    "row_sharding",
    "shard_rows",
]
