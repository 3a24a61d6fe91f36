"""Data parallelism over cards on torch.distributed (port of salve_tpu.parallel).

One process per card; batches are split along one 'data' axis and the
parameters are replicated (parallel/mesh.py).
"""

from salve_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    launch,
    make_mesh,
    replicate,
    shard_batch,
)
