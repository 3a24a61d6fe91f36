"""A data-parallel mesh on torch.distributed, one process per card.

Port of salve_tpu/parallel/mesh.py. There a `jax.sharding.Mesh` lays the
devices on one 'data' axis, batches are sharded along it, the parameters
are replicated, and XLA inserts the collectives a global-batch program
needs. Here each rank is a process that owns one card (or a CPU share), a
`Mesh` names its process group, rank, size and `torch.device`, and the
callers issue the collectives themselves (pipeline/fused_inference.py,
training/train.py, models/resnet.py).

* `make_mesh` joins the process group that is already initialized (by
  `launch` below, or by `torchrun`); with none it is a world of one.
* `shard_batch` takes this rank's contiguous rows of a global batch, as
  `P("data")` splits it: rank r gets rows r*k:(r+1)*k.
* `replicate` broadcasts rank 0's parameters and buffers.
* `all_gather_rows`, `all_reduce_sum` and `broadcast_` are the collectives
  the callers use. With a gloo group they stage CUDA tensors through the
  host (gloo's collectives are host collectives); the compute stays on
  the card. NCCL runs them on the card.
* `launch(fn, n)` starts n ranks (torch.multiprocessing, spawn) joined by
  a `file://` store in a fresh temporary directory, so no TCP port is
  taken, and returns each rank's result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from salve_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One 'data' axis over the ranks of a process group.

    `group` is None for a world of one started outside torch.distributed;
    then every collective is the identity.
    """

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes files."""
        return self.rank == 0


def make_mesh(mesh_shape: Optional[Sequence[int]] = None, device: DeviceLike = None) -> Mesh:
    """This process's place on the mesh.

    `mesh_shape` None means the whole world (as `jax.devices()` does for
    salve_tpu's `make_mesh`); otherwise its product must be the world size.
    `device` None means the CUDA card (raises without one), "cpu" the
    host. A CUDA rank takes the card `LOCAL_RANK` names (as torchrun and
    `launch` set it; else the current device) and makes it current before
    any launch.
    """
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, None
    if mesh_shape is not None and math.prod(mesh_shape) != size:
        if group is None:
            raise ValueError(
                f"mesh_shape {tuple(mesh_shape)} asks for {math.prod(mesh_shape)} processes, but no process "
                "group is initialized: start the ranks with salve_tpu_torch.parallel.launch, or with torchrun "
                f"--nproc_per_node {math.prod(mesh_shape)}")
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not match the world of {size} processes")
    if dev.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())) if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} asks for cuda:{index}, but {torch.cuda.device_count()} card(s) exist")
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    return Mesh(size=size, rank=rank, device=dev, group=group, backend=backend)


def _rows(mesh: Mesh, x):
    n = x.shape[0] if hasattr(x, "shape") else len(x)
    if n % mesh.size:
        raise ValueError(f"batch of {n} not divisible by mesh size {mesh.size}")
    k = n // mesh.size
    return x[mesh.rank * k : (mesh.rank + 1) * k]


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's contiguous rows of a global batch (an array, a tensor, a
    list, or a tuple/list/dict of them): rows r*k:(r+1)*k of rank r."""
    if isinstance(batch, dict):
        return {key: shard_batch(mesh, v) for key, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(mesh, v) for v in batch)
    return _rows(mesh, batch)


def _host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, in place; every rank gets the same
    bits."""
    if mesh.group is None:
        return t
    if _host_staged(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, group=mesh.group)
        return t.copy_(h)
    dist.all_reduce(t, group=mesh.group)
    return t


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-shaped `t` concatenated along dim 0 in rank order."""
    if mesh.group is None:
        return t
    src = t.cpu() if _host_staged(mesh, t) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return torch.cat(out).to(t.device)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` on every rank, in place."""
    if mesh.group is None:
        return t
    if _host_staged(mesh, t):
        h = t.cpu()
        dist.broadcast(h, src, group=mesh.group)
        return t.copy_(h)
    dist.broadcast(t, src, group=mesh.group)
    return t


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def main_rank_first(mesh: Mesh) -> Iterator[None]:
    """Rank 0 runs the block before the others do (it fills a cache the
    others then read)."""
    if not mesh.is_main:
        barrier(mesh)
    yield
    if mesh.is_main:
        barrier(mesh)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (one broadcast a dtype, of the tensors flattened)."""
    if mesh.group is None:
        return module
    tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            same = [t for t in tensors if t.dtype == dtype]
            flat = broadcast_(mesh, torch.cat([t.reshape(-1) for t in same]))
            for t, f in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(f.view_as(t))
    return module


# ---------------------------------------------------------------------------
# Starting the ranks.
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, args: tuple, n: int, backend: str, store: str, device_ids,
               num_threads: Optional[int], timeout_s: Optional[float]) -> None:
    if num_threads is not None:
        torch.set_num_threads(num_threads)
    if device_ids is not None:
        os.environ["LOCAL_RANK"] = str(device_ids[rank])
        torch.cuda.set_device(device_ids[rank])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n))
    timeout = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=rank, **timeout)
    try:
        result = fn(*args)
        torch.save(result, Path(store).parent / f"result_{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, device: DeviceLike = None, backend: Optional[str] = None,
           device_ids: Optional[Sequence[int]] = None, num_threads: Optional[int] = None,
           timeout_s: Optional[float] = None) -> List[Any]:
    """Run `fn(*args)` in `n` new processes joined in one process group;
    return each rank's result (pickled through torch.save), in rank order.

    `fn` must be importable by name (a module-level function); it calls
    `make_mesh` to join the group. The backend is NCCL for a CUDA `device`
    and gloo for the CPU unless named. Rank r takes card `device_ids[r]`
    (default r; raises when fewer cards exist). Two ranks on one card need
    `backend="gloo"`: NCCL refuses them. CPU ranks share this process's
    torch threads (`num_threads` each, default an n-th of them): ranks that
    each take every core slow one another several times over. A collective
    that waits longer than `timeout_s` (default torch's) raises. A rank that
    raises makes the call raise; every process it started has ended when it
    returns.
    """
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        device_ids = list(range(n)) if device_ids is None else list(device_ids)
        if len(device_ids) != n or max(device_ids) >= torch.cuda.device_count():
            raise ValueError(f"{n} ranks on cards {device_ids}, but {torch.cuda.device_count()} card(s) exist")
    else:
        device_ids = None
        num_threads = num_threads or max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(prefix="salve_mesh_") as tmp:
        store = str(Path(tmp) / "store")
        mp.start_processes(_rank_main, args=(fn, args, n, backend, store, device_ids, num_threads, timeout_s),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(Path(tmp) / f"result_{r}.pt", weights_only=False) for r in range(n)]

