"""Dataset over rendered BEV texture-map pairs (port of salve_tpu/dataset/bev_pairs.py).

Example discovery is filename-driven: tuples are grouped by the
`pair_{idx}___...` grammar, labels come from the directory name
(gt_alignment_approx=1, incorrect_alignment=0), and a tuple holds 2/4/6
images by modality set. Tuples, labels and batch order equal salve_tpu's on
a sorted directory listing. salve_tpu takes each floor's files in `glob`'s
order, which follows the filesystem's listing, so one corpus gave other
batches, and another trained model, on another machine; the port sorts the
listing, so one corpus gives one order everywhere.

Pixels equal what salve_tpu's native loader gives (native/jpeg_loader.cpp:
libjpeg, its float bilinear resize, then np.clip(np.round(x), 0, 255) to
u8): the port decodes with its own codec and repeats that resize in C, one
batch call on a pool of threads (native/jpeg.py:decode_resize_batch). A
file the codec refuses raises; there is no other decoder to fall back on.
"""

from __future__ import annotations

import glob
import random
from collections import defaultdict
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.native.jpeg import decode_resize_batch
from salve_tpu_torch.training.config import TrainingConfig

LABEL_DICT = {"gt_alignment_approx": 1, "incorrect_alignment": 0}
FLOOR_IDS = ["floor_00", "floor_01", "floor_02", "floor_03", "floor_04"]


def pair_idx_from_fpath(fpath: str) -> int:
    """Parse the pair index from `pair_{idx}___...` (zind_data.py:53)."""
    return int(Path(fpath).stem.split("___")[0].split("_")[1])


def pano_id_from_fpath(fpath: str) -> int:
    """Parse the pano ID from the trailing `..._pano_{id}` (zind_data.py:61)."""
    return int(Path(fpath).stem.split("_")[-1])


def get_tuples_from_fpath_list(fpaths: List[str], label_idx: int, args: TrainingConfig) -> List[Tuple]:
    """Group one floor's rendered files into (fpaths..., label) tuples.

    Parity: salve/dataset/zind_data.py:71-180, including the skip-if-
    incomplete rule (a pair must have all 4 renderings) and the
    ceiling-first sort order within each tuple.
    """
    pairidx_to_fpath_dict = defaultdict(list)
    for fpath in fpaths:
        pairidx_to_fpath_dict[pair_idx_from_fpath(fpath)].append(fpath)

    mset = set(args.modalities)
    layout_only = mset == {"layout"}
    expected_n_files = 2 if layout_only else 4

    tuples: List[Tuple] = []
    for pair_idx, pair_fpaths in pairidx_to_fpath_dict.items():
        if len(pair_fpaths) != expected_n_files:
            continue
        pair_fpaths.sort()

        if layout_only:
            fp1l, fp2l = pair_fpaths
            tuples.append((fp1l, fp2l, label_idx))
            continue

        fp1c, fp2c, fp1f, fp2f = pair_fpaths
        if "layout" in mset:
            fp1l = fp1f.replace(args.data_root, args.layout_data_root)
            fp2l = fp2f.replace(args.data_root, args.layout_data_root)
            if not (Path(fp1l).exists() and Path(fp2l).exists()):
                continue

        if mset == {"ceiling_rgb_texture"}:
            tuples.append((fp1c, fp2c, label_idx))
        elif mset == {"floor_rgb_texture"}:
            tuples.append((fp1f, fp2f, label_idx))
        elif mset == {"ceiling_rgb_texture", "floor_rgb_texture"}:
            tuples.append((fp1c, fp2c, fp1f, fp2f, label_idx))
        elif mset == {"ceiling_rgb_texture", "floor_rgb_texture", "layout"}:
            tuples.append((fp1c, fp2c, fp1f, fp2f, fp1l, fp2l, label_idx))
        else:
            raise RuntimeError(f"Unsupported modalities {args.modalities}")
    return tuples


def get_available_building_ids(dataset_root: str) -> List[str]:
    building_ids = [Path(p).stem for p in glob.glob(f"{dataset_root}/*") if Path(p).is_dir()]
    return sorted(building_ids, key=lambda x: int(x))


def make_dataset(split: str, data_root: str, args: TrainingConfig) -> List[Tuple]:
    """All (fpaths..., label) tuples of a split (zind_data.py:198)."""
    if not Path(data_root).exists():
        raise RuntimeError(f"Dataset root {data_root} does not exist.")

    data_list: List[Tuple] = []
    available = get_available_building_ids(f"{data_root}/gt_alignment_approx")
    members = set(DATASET_SPLITS[split]).intersection(available)
    if args.split_overrides:
        # Reassign overridden buildings: drop the ones moved out of this
        # split, pull in the ones moved into it (config.py:split_overrides).
        members = {b for b in members if args.split_overrides.get(b, split) == split}
        members |= {b for b, s in args.split_overrides.items() if s == split and b in available}
    split_building_ids = sorted(members, key=int)

    for label_name, label_idx in LABEL_DICT.items():
        for building_id in split_building_ids:
            for floor_id in FLOOR_IDS:
                fpaths = sorted(glob.glob(f"{data_root}/{label_name}/{building_id}/pair_*___*_rgb_{floor_id}_*.jpg"))
                if fpaths:
                    data_list.extend(get_tuples_from_fpath_list(fpaths, label_idx, args))
    return data_list


class BEVPairDataset:
    """Batch loader over rendered BEV pairs.

    Decodes each tuple's JPEGs and resizes them to (resize_h, resize_w) on
    the host, on `workers` C threads, and returns uint8 arrays of shape
    (B, n_imgs, resize_h, resize_w, 3); cropping, flips, upcast and
    normalize run on the device afterwards (training/transforms.py). When
    the resized corpus fits `decoded_cache_gb`, the u8 stacks stay in RAM,
    so every epoch after the first skips disk and decode.
    """

    def __init__(self, split: str, args: TrainingConfig, workers: int = 8) -> None:
        self.args = args
        self.split = split
        self.workers = workers
        self.data_list = make_dataset(split, args.data_root, args)
        self.n_imgs = len(self.data_list[0]) - 1 if self.data_list else 0
        cache_gb = getattr(args, "decoded_cache_gb", 0.0) or 0.0
        est_bytes = len(self.data_list) * self.n_imgs * args.resize_h * args.resize_w * 3
        self._cache = {} if 0 < est_bytes <= cache_gb * 1e9 else None

    def __len__(self) -> int:
        return len(self.data_list)

    def load_batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, List[Tuple]]:
        """Returns (imgs (B, N, H, W, 3) u8, labels (B,) i32, tuples)."""
        tuples = [self.data_list[i] for i in indices]
        labels = np.array([t[-1] for t in tuples], dtype=np.int32)

        if self._cache is None:
            return self._load_tuples(tuples), labels, tuples
        miss = [i for i in indices if i not in self._cache]
        if miss:
            loaded = self._load_tuples([self.data_list[i] for i in miss])
            for j, i in enumerate(miss):
                self._cache[i] = loaded[j]
        imgs = np.stack([self._cache[i] for i in indices])
        return imgs, labels, tuples

    def _load_tuples(self, tuples: List[Tuple]) -> np.ndarray:
        """Decode + resize each tuple's images: (len(tuples), N, H, W, 3) u8."""
        n_imgs = len(tuples[0]) - 1
        flat_paths = [fp for t in tuples for fp in t[:-1]]
        imgs = decode_resize_batch(flat_paths, self.args.resize_h, self.args.resize_w, num_threads=self.workers)
        return imgs.reshape(len(tuples), n_imgs, self.args.resize_h, self.args.resize_w, 3)

    def iter_batches(
        self, batch_size: int, shuffle: bool, seed: int = 0
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, List[Tuple]]]:
        """Yields load_batch's triples in order, or in `random.Random(seed)`'s
        shuffle of it; the tail batch is kept (the reference's training loop
        does not drop it)."""
        order = list(range(len(self.data_list)))
        if shuffle:
            random.Random(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            yield self.load_batch(order[start : start + batch_size])
