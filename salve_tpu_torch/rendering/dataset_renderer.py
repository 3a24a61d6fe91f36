"""Dataset-scale BEV rendering: the file-contract Stage B renderer.

Port of salve_tpu/rendering/dataset_renderer.py. Each floor's hypothesis
pairs are rendered in batches against one pano bank on the card: the unique
panos are decoded and resized once (a host thread pool), staged on the
device once, and every pair and surface streams through the batch renderer.
The output files, their names and the resume contract (a pair whose two
outputs exist is skipped) are the reference's, byte for byte: the JPEGs
come from the port's encoder (native/jpeg.py), whose bytes are cv2's.

Two arms, as in the reference:
  * warp (the default on the card): each pano is rendered once per surface,
    a 501^2 identity render (every pair's img2) and a 1001^2 extended bank
    (packed rgb888), both fetched to the host once a floor; each pair's
    img1 is the host NN warp of the bank (`warp_bank_sim2_nn_host`, a
    batch split over the IO threads), and img2's bytes are encoded once per
    (surface, pano) and reused;
  * direct (the default on the CPU): both panos of every pair are splatted
    in one 2B batch a surface, and batch k's copy to pinned host memory
    overlaps batch k+1's render.

The reference pads the pano bank to a multiple of 8 and the last batch to
the full batch size to bound JAX's compiles; neither changes an output, and
the port has no compiles to bound, so it leaves both out.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch import device as device_mod
from salve_tpu_torch.dataset.zind_partition import DATASET_SPLITS
from salve_tpu_torch.depth.cache import infer_depth_if_nonexistent
from salve_tpu_torch.geometry.sim2 import Sim2
from salve_tpu_torch.native import jpeg
from salve_tpu_torch.ops import warp as warp_ops
from salve_tpu_torch.rendering import bev_pair
from salve_tpu_torch.rendering import layout as layout_render
from salve_tpu_torch.utils import profiler

logger = logging.getLogger(__name__)

DEFAULT_BATCH_SIZE = 8
# The warp arm's per-pair cost is one host resample instead of a splat and
# fill, so it takes larger batches.
WARP_BATCH_SIZE = 64
# quality=95: default JPEG quality (75) adds ~5/255 of noise, comparable to
# the aligned-vs-misaligned texture signal the verifier trains on.
JPEG_QUALITY = 95


def resolve_corpus_warp_default(dev: torch.device) -> bool:
    """Warp default of the corpus renderer: on for the card, as the
    reference is on for its accelerator, and off on the CPU."""
    return dev.type == "cuda"


def panoid_from_fpath(fpath: str) -> int:
    return int(Path(fpath).stem.split("_")[-1])


def write_jpg(fpath: str, img: np.ndarray, quality: int = JPEG_QUALITY) -> None:
    """Write an (H, W, 3) uint8 RGB image as the reference's cv2.imwrite does."""
    jpeg.write_jpeg(fpath, img, quality)


def encode_jpg_bytes(img: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """In-memory JPEG encode, byte-identical to write_jpg's file."""
    return jpeg.encode_jpeg_bytes(img, quality)


def _pano_fpaths_for_building(raw_dataset_dir: str, building_id: str) -> Dict[int, str]:
    img_fpaths = glob.glob(f"{raw_dataset_dir}/{building_id}/panos/*.jpg")
    return {panoid_from_fpath(fp): fp for fp in img_fpaths}


def render_building_floor_pairs(
    depth_save_root: str,
    bev_save_root: str,
    hypotheses_save_root: str,
    raw_dataset_dir: str,
    building_id: str,
    floor_id: str,
    layout_save_root: Optional[str] = None,
    render_modalities: List[str] = ["rgb_texture"],
    floor_pose_graph=None,
    batch_size: int = DEFAULT_BATCH_SIZE,
    io_workers: int = 8,
    use_warp: Optional[bool] = None,
    device=None,
) -> int:
    """Render all hypothesis pairs of one building floor; returns #pairs rendered.

    `device=None` means the CUDA card (raises without one); `use_warp=None`
    means `resolve_corpus_warp_default(device)`.
    """
    dev = device_mod.resolve_device(device)
    if use_warp is None:
        use_warp = resolve_corpus_warp_default(dev)
    img_fpaths_dict = _pano_fpaths_for_building(raw_dataset_dir, building_id)
    num_rendered = 0

    label_fpaths = {
        label_type: sorted(glob.glob(f"{hypotheses_save_root}/{building_id}/{floor_id}/{label_type}/*.json"))
        for label_type in ["gt_alignment_approx", "incorrect_alignment"]
    }

    if "rgb_texture" in render_modalities and any(label_fpaths.values()):
        # Both label types share one pano bank: the same panos, the same renders.
        with profiler.stage_timer("render/texture_pairs"):
            num_rendered += _render_texture_pairs_batched(
                label_fpaths, img_fpaths_dict, depth_save_root, bev_save_root, building_id, batch_size,
                io_workers, use_warp, dev)

    if "layout" in render_modalities and floor_pose_graph is not None:
        for label_type, pair_fpaths in label_fpaths.items():
            if pair_fpaths:
                num_rendered += _render_layout_pairs(
                    pair_fpaths, img_fpaths_dict, layout_save_root, label_type, building_id, floor_pose_graph, dev)
    return num_rendered


def _parse_pair_fpath(pair_fpath: str) -> Tuple[int, int, str]:
    """(i1, i2, pair_uuid) from a hypothesis JSON path."""
    stem = Path(pair_fpath).stem
    i1, i2 = (int(x) for x in stem.split("_")[:2])
    pair_uuid = stem.split("__")[-1]
    return i1, i2, pair_uuid


def _render_texture_pairs_batched(
    label_fpaths: Dict[str, List[str]],
    img_fpaths_dict: Dict[int, str],
    depth_save_root: str,
    bev_save_root: str,
    building_id: str,
    batch_size: int,
    io_workers: int,
    use_warp: bool,
    dev: torch.device,
) -> int:
    """RGB texture modality: both surfaces and both label types, batched on
    the device against one shared pano bank (module docstring)."""
    # Work items: (hypothesis fpath, i1, i2, surface, out1, out2), skipping
    # pairs whose outputs exist (resume contract).
    work = []
    needed_panos = set()
    for label_type, pair_fpaths in label_fpaths.items():
        if not pair_fpaths:
            continue
        building_bev_save_dir = f"{bev_save_root}/{label_type}/{building_id}"
        os.makedirs(building_bev_save_dir, exist_ok=True)
        for pair_idx, pair_fpath in enumerate(pair_fpaths):
            i1, i2, pair_uuid = _parse_pair_fpath(pair_fpath)
            if i1 not in img_fpaths_dict or i2 not in img_fpaths_dict:
                continue
            for surface_type in ["floor", "ceiling"]:
                fname1 = bev_pair.bev_fname_from_img_fpath(pair_idx, pair_uuid, surface_type, img_fpaths_dict[i1])
                fname2 = bev_pair.bev_fname_from_img_fpath(pair_idx, pair_uuid, surface_type, img_fpaths_dict[i2])
                out1 = f"{building_bev_save_dir}/{fname1}"
                out2 = f"{building_bev_save_dir}/{fname2}"
                if Path(out1).exists() and Path(out2).exists():
                    continue
                work.append((pair_fpath, i1, i2, surface_type, out1, out2))
                needed_panos.update([i1, i2])
    if not work:
        return 0

    # Stage the pano bank (unique panos only): depth and resized rgb.
    t0 = time.time()
    pano_ids = sorted(needed_panos)
    id2bank = {pid: k for k, pid in enumerate(pano_ids)}

    def load_pano(pid: int):
        img_fpath = img_fpaths_dict[pid]
        depth_fpath = infer_depth_if_nonexistent(depth_save_root, building_id, img_fpath)
        return bev_pair.load_depth_mm(depth_fpath), bev_pair.load_pano_rgb(img_fpath)

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        loaded = list(pool.map(load_pano, pano_ids))
    # uint16 mm -> float32 is exact; the bank is staged on the device once.
    depths_d = torch.as_tensor(np.stack([d for d, _ in loaded]).astype(np.float32), device=dev)
    rgbs_d = torch.as_tensor(np.stack([c for _, c in loaded]).astype(np.float32), device=dev)
    profiler.record_stage("render/pano_load", time.time() - t0)

    render_cfg = bev_pair.BEVRenderConfig()
    warp_banks, ident_banks = {}, {}
    ident_jpg_cache: Dict[Tuple[str, int], bytes] = {}
    if use_warp:
        t0 = time.time()
        bank_px = 2 * render_cfg.img_px
        batch_size = max(batch_size, WARP_BATCH_SIZE)
        for surface_type in ("floor", "ceiling"):
            z_range = bev_pair._z_range_for_surface(surface_type)
            # One full render per pano per surface: the identity render (img2
            # of every pair touching this pano) and the 2x-extent warp source
            # (packed rgb888), fetched to the host once a floor.
            ident, bank = bev_pair.render_identity_banks(depths_d, rgbs_d, z_range, render_cfg, bank_px)
            ident_banks[surface_type], warp_banks[surface_type] = ident.cpu().numpy(), bank.cpu().numpy()
        profiler.record_stage("render/warp_bank_stage", time.time() - t0)

        # Encode each identity render once per (surface, pano): every pair
        # writes the same img2 bytes under its own name (commit 07f3dd9).
        t0 = time.time()
        for surface_type in ("floor", "ceiling"):
            bank = ident_banks[surface_type]
            for k in range(len(pano_ids)):
                ident_jpg_cache[(surface_type, k)] = encode_jpg_bytes(bank[k])
        profiler.record_stage("render/ident_encode", time.time() - t0)

    writer_pool = ThreadPoolExecutor(max_workers=io_workers)
    warp_pool = ThreadPoolExecutor(max_workers=io_workers) if use_warp else None
    write_futures: list = []
    count = 0

    def write_bytes(fpath: str, data: bytes) -> None:
        with open(fpath, "wb") as f:
            f.write(data)

    def encode_and_write(fpath: str, img) -> None:
        t0 = time.time()
        write_jpg(fpath, img)
        profiler.record_stage("render/jpg_encode", time.time() - t0)

    def flush(pending):
        """Queue the JPG writes of a batch that has reached the host."""
        chunk, imgs1, imgs2, bank_k2, event = pending
        if event is not None:
            event.synchronize()
        imgs1 = imgs1.numpy() if isinstance(imgs1, torch.Tensor) else imgs1
        imgs2 = imgs2.numpy() if isinstance(imgs2, torch.Tensor) else imgs2
        for k, w in enumerate(chunk):
            write_futures.append(writer_pool.submit(encode_and_write, w[4], imgs1[k]))
            if bank_k2 is not None:
                # Warp arm: img2 is the pano's identity render, encoded once.
                write_futures.append(writer_pool.submit(write_bytes, w[5], ident_jpg_cache[(w[3], int(bank_k2[k]))]))
            else:
                write_futures.append(writer_pool.submit(encode_and_write, w[5], imgs2[k]))

    def to_host(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    try:
        pending = None
        for surface_type in ["floor", "ceiling"]:
            surf_work = [w for w in work if w[3] == surface_type]
            for start in range(0, len(surf_work), batch_size):
                chunk = surf_work[start : start + batch_size]
                t0 = time.time()
                pair_indices = np.array([[id2bank[w[1]], id2bank[w[2]]] for w in chunk], dtype=np.int64)
                sims = [Sim2.from_json(w[0]) for w in chunk]
                rotations = np.stack([s.rotation for s in sims]).astype(np.float32)
                translations = np.stack([s.translation for s in sims]).astype(np.float32)
                profiler.record_stage("render/hyp_parse", time.time() - t0)

                if use_warp:
                    t0 = time.time()
                    imgs1 = _host_warp(warp_pool, io_workers, warp_banks[surface_type], rotations,
                                       translations * bev_pair.HOHO_S_ZIND_SCALE_FACTOR, pair_indices[:, 0])
                    profiler.record_stage("render/host_warp", time.time() - t0)
                    flush((chunk, imgs1, None, pair_indices[:, 1], None))
                    count += len(chunk)
                    continue

                imgs1_d, imgs2_d = bev_pair.render_bev_pairs_batch_device(
                    depths_d, rgbs_d, pair_indices, rotations, translations, surface_type, render_cfg)
                # Start the copies now, so that they overlap the next batch's render.
                imgs1_h, imgs2_h = to_host(imgs1_d), to_host(imgs2_d)
                event = None
                if dev.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
                if pending is not None:
                    flush(pending)
                pending = (chunk, imgs1_h, imgs2_h, None, event)
                count += len(chunk)
        if pending is not None:
            flush(pending)
    finally:
        writer_pool.shutdown(wait=True)
        if warp_pool is not None:
            warp_pool.shutdown(wait=True)
    # Surface any write failure: a silently missing JPG would later shrink
    # the dataset (bev_pairs skips incomplete tuples) with no error anywhere.
    for fut in write_futures:
        fut.result()
    return count


def _host_warp(pool: ThreadPoolExecutor, n_parts: int, bank: np.ndarray, rotations: np.ndarray,
               translations_scaled: np.ndarray, bank_idx: np.ndarray) -> np.ndarray:
    """`warp_bank_sim2_nn_host` of a batch, split into `n_parts` over the
    pool's threads (numpy releases the GIL): each image is computed alone,
    so the split changes no pixel."""
    parts = [p for p in np.array_split(np.arange(len(bank_idx)), n_parts) if len(p)]
    futs = [pool.submit(warp_ops.warp_bank_sim2_nn_host, bank, rotations[p], translations_scaled[p], bank_idx=bank_idx[p])
            for p in parts]
    return np.concatenate([f.result() for f in futs])


def _render_layout_pairs(
    pair_fpaths: List[str],
    img_fpaths_dict: Dict[int, str],
    layout_save_root: str,
    label_type: str,
    building_id: str,
    floor_pose_graph,
    dev: torch.device,
) -> int:
    """Layout modality: rasterized room layouts ('floor' surface only)."""
    building_layout_save_dir = f"{layout_save_root}/{label_type}/{building_id}"
    os.makedirs(building_layout_save_dir, exist_ok=True)

    jobs, out_fpaths = [], []
    count = 0
    for pair_idx, pair_fpath in enumerate(pair_fpaths):
        i1, i2, pair_uuid = _parse_pair_fpath(pair_fpath)
        if i1 not in floor_pose_graph.nodes or i2 not in floor_pose_graph.nodes:
            continue
        if i1 not in img_fpaths_dict or i2 not in img_fpaths_dict:
            continue
        fname1 = bev_pair.bev_fname_from_img_fpath(pair_idx, pair_uuid, "floor", img_fpaths_dict[i1])
        fname2 = bev_pair.bev_fname_from_img_fpath(pair_idx, pair_uuid, "floor", img_fpaths_dict[i2])
        out1 = f"{building_layout_save_dir}/{fname1}"
        out2 = f"{building_layout_save_dir}/{fname2}"
        if Path(out1).exists() and Path(out2).exists():
            continue
        i2Ti1 = Sim2.from_json(pair_fpath)
        job1, job2 = layout_render.layout_pair_inputs(i2Ti1, floor_pose_graph.nodes[i1], floor_pose_graph.nodes[i2])
        jobs += [job1, job2]
        out_fpaths += [out1, out2]
        count += 1

    if jobs:
        # Each chunk goes to the writer pool as it lands, so that encoding
        # and disk IO overlap the next chunk's render.
        write_futures = []
        with ThreadPoolExecutor(max_workers=8) as pool:

            def write_chunk(start, imgs):
                for k in range(imgs.shape[0]):
                    write_futures.append(pool.submit(write_jpg, out_fpaths[start + k], imgs[k]))

            layout_render.rasterize_layout_batch(jobs, on_chunk=write_chunk, device=dev)
        for fut in write_futures:  # surface write failures, never shrink silently
            fut.result()
    return count


def render_pairs(
    depth_save_root: str,
    bev_save_root: str,
    raw_dataset_dir: str,
    hypotheses_save_root: str,
    layout_save_root: Optional[str],
    render_modalities: List[str],
    split: Optional[str] = None,
    building_id: Optional[str] = None,
    mhnet_predictions_data_root: Optional[str] = None,
    batch_size: int = DEFAULT_BATCH_SIZE,
    use_warp: Optional[bool] = None,
    device=None,
) -> int:
    """Render all pairs of a split or of one building; returns #pairs rendered."""
    from salve_tpu_torch.dataset import hnet_prediction_loader

    dev = device_mod.resolve_device(device)
    building_ids = [building_id] if building_id is not None else sorted(DATASET_SPLITS[split])

    total = 0
    for bid in building_ids:
        floor_dirs = sorted(glob.glob(f"{hypotheses_save_root}/{bid}/floor*"))
        if not floor_dirs:
            continue

        floor_pose_graphs = None
        if "layout" in render_modalities:
            floor_pose_graphs = hnet_prediction_loader.load_inferred_floor_pose_graphs(
                building_id=bid, raw_dataset_dir=raw_dataset_dir, predictions_data_root=mhnet_predictions_data_root)

        for floor_dir in floor_dirs:
            floor_id = Path(floor_dir).name
            fpg = floor_pose_graphs.get(floor_id) if floor_pose_graphs else None
            total += render_building_floor_pairs(
                depth_save_root=depth_save_root,
                bev_save_root=bev_save_root,
                hypotheses_save_root=hypotheses_save_root,
                raw_dataset_dir=raw_dataset_dir,
                building_id=bid,
                floor_id=floor_id,
                layout_save_root=layout_save_root,
                render_modalities=render_modalities,
                floor_pose_graph=fpg,
                batch_size=batch_size,
                use_warp=use_warp,
                device=dev,
            )
    return total
