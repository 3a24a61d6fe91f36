"""Device-resident training corpus on one card (port of salve_tpu/training/device_corpus.py).

The host streams a batch of JPEG decodes every step otherwise. A resized
BEV-pair split is small (uint8, a few hundred KB a pair), so for
multi-epoch training the split is decoded once, uploaded once as one uint8
tensor, and every batch is a `torch.index_select` on the device: the host
then sends only indices and labels.

One card is a mesh of size 1 in the reference's terms: no padding rows, one
shard, and the order of `np.random.default_rng(seed).permutation` for that
shard; partial tail batches are dropped, and the `valid` mask is all true.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, List, Tuple

import numpy as np
import torch

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
    the training loop can swap it in; yielded images are device tensors.
    """

    def __init__(self, dataset, device: torch.device) -> None:
        self.dataset = dataset
        self.device = torch.device(device)
        n = len(dataset)
        if n == 0:
            raise ValueError("DeviceCorpus over an empty dataset")
        self._labels = np.array([t[-1] for t in dataset.data_list], dtype=np.int32)

        a = dataset.args
        shape = (n, dataset.n_imgs, a.resize_h, a.resize_w, 3)
        t0 = time.time()
        self.corpus = torch.empty(shape, dtype=torch.uint8, device=self.device)
        for s in range(0, n, _UPLOAD_CHUNK):
            chunk = dataset._load_tuples(dataset.data_list[s : s + _UPLOAD_CHUNK])
            self.corpus[s : s + len(chunk)].copy_(torch.from_numpy(chunk))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info(
            "DeviceCorpus: %d pairs x %d imgs @ %dpx = %.2f GB on %s; decode+upload %.1fs",
            n, dataset.n_imgs, a.resize_h, np.prod(shape) / 1e9, self.device, time.time() - t0,
        )

    def __len__(self) -> int:
        return len(self.dataset)

    def gather(self, rows: np.ndarray) -> torch.Tensor:
        """Images of corpus rows `rows`: (len(rows), N, H, W, 3) u8 on the device."""
        idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)).to(self.device, non_blocking=True)
        return torch.index_select(self.corpus, 0, idx)

    def iter_batches(
        self, batch_size: int, shuffle: bool, seed: int = 0
    ) -> Iterator[Tuple[torch.Tensor, np.ndarray, List[Tuple], np.ndarray]]:
        """Yields (imgs on the device, labels host i32, tuples, valid host bool).

        Tail batches are always dropped so every step has one shape, as on
        the reference's mesh; `valid` is all true (no padding rows on one
        card).
        """
        n = len(self.dataset)
        steps = n // batch_size
        if steps == 0:
            raise ValueError(
                f"corpus size {n} < batch {batch_size}: shrink the batch or stream from host instead"
            )
        rng = np.random.default_rng(seed)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for t in range(steps):
            rows = order[t * batch_size : (t + 1) * batch_size]
            tuples = [self.dataset.data_list[g] for g in rows]
            yield self.gather(rows), self._labels[rows], tuples, np.ones(len(rows), dtype=bool)
