"""Device-resident training corpus (port of salve_tpu/training/device_corpus.py).

The host streams a batch of JPEG decodes every step otherwise. A resized
BEV-pair split is small (uint8, a few hundred KB a pair), so for
multi-epoch training the split is decoded once, uploaded once as one uint8
tensor, and every batch is a `torch.index_select` on the device: the host
then sends only indices and labels.

On a mesh of N ranks (parallel/mesh.py) the corpus follows salve_tpu's
sharding, the DistributedSampler contract: it is padded to a multiple of N
by wrapping around, rank r holds the contiguous shard r, and every epoch
each rank draws its batch rows from a fresh local permutation of its own
shard. All ranks draw the N permutations from one
`np.random.default_rng(seed)` in rank order and use their own, so the
labels, tuples and `valid` mask of a batch are the global batch's on every
rank. One card is a mesh of one: no padding rows, one shard.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

_UPLOAD_CHUNK = 512  # tuples decoded per host staging step


def estimated_corpus_bytes(dataset) -> int:
    """uint8 bytes of the whole resized split (matches the decoded-cache
    estimate in dataset/bev_pairs.py)."""
    if len(dataset) == 0 or dataset.n_imgs == 0:
        return 0
    a = dataset.args
    return len(dataset) * dataset.n_imgs * a.resize_h * a.resize_w * 3


class DeviceCorpus:
    """A BEVPairDataset decoded once, uploaded to `device`, batch-gathered there.

    Exposes BEVPairDataset's `iter_batches(batch_size, shuffle, seed)` so
    the training loop can swap it in; yielded images are this rank's rows,
    device tensors. With `mesh`, this rank holds only its shard.
    """

    def __init__(self, dataset, device: torch.device, mesh: Optional[Mesh] = None) -> None:
        self.dataset = dataset
        self.device = torch.device(device)
        self.n_devices = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        n = len(dataset)
        if n == 0:
            raise ValueError("DeviceCorpus over an empty dataset")

        # Pad to a multiple of the mesh size by wrapping around (the
        # DistributedSampler padding rule) so every shard is equal-sized.
        n_pad = -(-n // self.n_devices) * self.n_devices
        self._src_index = np.arange(n_pad, dtype=np.int64) % n
        self.shard_size = n_pad // self.n_devices
        self._labels = np.array([dataset.data_list[i][-1] for i in self._src_index], dtype=np.int32)

        a = dataset.args
        shard = self._src_index[self.rank * self.shard_size : (self.rank + 1) * self.shard_size]
        shape = (self.shard_size, dataset.n_imgs, a.resize_h, a.resize_w, 3)
        t0 = time.time()
        self.corpus = torch.empty(shape, dtype=torch.uint8, device=self.device)
        for s in range(0, self.shard_size, _UPLOAD_CHUNK):
            chunk = dataset._load_tuples([dataset.data_list[i] for i in shard[s : s + _UPLOAD_CHUNK]])
            self.corpus[s : s + len(chunk)].copy_(torch.from_numpy(chunk))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info(
            "DeviceCorpus: %d pairs (%d padded) x %d imgs @ %dpx, shard %d of %d = %.2f GB on %s; "
            "decode+upload %.1fs",
            n, n_pad, dataset.n_imgs, a.resize_h, self.rank, self.n_devices, np.prod(shape) / 1e9, self.device,
            time.time() - t0,
        )

    def __len__(self) -> int:
        return len(self.dataset)

    def gather(self, rows: np.ndarray) -> torch.Tensor:
        """Images of this rank's shard rows `rows`: (len(rows), N, H, W, 3) u8 on the device."""
        idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)).to(self.device, non_blocking=True)
        return torch.index_select(self.corpus, 0, idx)

    def iter_batches(
        self, batch_size: int, shuffle: bool, seed: int = 0
    ) -> Iterator[Tuple[torch.Tensor, np.ndarray, List[Tuple], np.ndarray]]:
        """Yields (this rank's imgs on the device, labels host i32, tuples,
        valid host bool), the last three for the global batch.

        Each rank draws `batch_size / n_devices` rows a step from its own
        shard (a local permutation when `shuffle`); partial tail steps are
        dropped so every step has one shape. `valid` is False on the
        wrap-around padding rows, which the metric fold masks.
        """
        if batch_size % self.n_devices:
            raise ValueError(
                f"batch_size {batch_size} not divisible by mesh size {self.n_devices} "
                "(required for the per-shard gather)"
            )
        k = batch_size // self.n_devices
        steps = self.shard_size // k
        if steps == 0:
            raise ValueError(
                f"shard size {self.shard_size} < per-device batch {k}: shrink the batch or stream from host instead"
            )
        rng = np.random.default_rng(seed)
        local_orders = [
            rng.permutation(self.shard_size) if shuffle else np.arange(self.shard_size)
            for _ in range(self.n_devices)
        ]
        for t in range(steps):
            global_rows = np.concatenate(
                [s * self.shard_size + order[t * k : (t + 1) * k] for s, order in enumerate(local_orders)]
            )
            tuples = [self.dataset.data_list[self._src_index[g]] for g in global_rows]
            valid = global_rows < len(self.dataset)
            yield self.gather(local_orders[self.rank][t * k : (t + 1) * k]), self._labels[global_rows], tuples, valid
