"""Depth-net training on layout-raycast supervision (port of salve_tpu/training/depth.py).

Every ZInD pano carries its GT room geometry and camera height, so
`synthesize_depth_from_layout` gives dense metric depth to supervise
PanoDepthNet. The loss is the masked log-depth L1 of the original,
sum(|log1p(pred) - log1p(gt)| * valid) / max(sum(valid), 1); the
optimizer is optax.adam(lr) (`OptaxAdam` with no weight decay and a
constant rate); batch norm moves its running statistics by Flax's rule
(`FlaxBatchNorm2d`). The batch order, the synthetic textures and the
metrics are the original's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np
import torch

from salve_tpu_torch.device import DeviceLike, deterministic_algorithms, resolve_device
from salve_tpu_torch.models.depth_net import (PANO_H, PANO_W, PanoDepthNet, init_flax_style,
                                               synthesize_depth_from_layout)
from salve_tpu_torch.training.train import OptaxAdam


@dataclass
class DepthTrainState:
    """The model (parameters and batch statistics), its Adam, the steps taken."""

    model: PanoDepthNet
    optimizer: OptaxAdam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.model.refine2.weight.device


def make_depth_optimizer(model: PanoDepthNet, learning_rate: float) -> OptaxAdam:
    """optax.adam(learning_rate): no weight decay, a constant rate."""
    return OptaxAdam(list(model.parameters()), 0.0, lambda count: learning_rate)


def create_depth_train_state(
    gen: torch.Generator,
    num_layers: int = 50,
    learning_rate: float = 1e-4,
    input_hw: Tuple[int, int] = (PANO_H, PANO_W),
    embed_dim: int = 512,
    num_blocks: int = 4,
    compute_dtype: str = "bfloat16",
    device: DeviceLike = None,
) -> DepthTrainState:
    """A fresh PanoDepthNet with Flax's initializers drawn from `gen` (a CPU
    generator: the same weights on every device) on `device` (None: the
    card), and a fresh Adam."""
    dev = resolve_device(device)
    model = PanoDepthNet(num_layers=num_layers, embed_dim=embed_dim, num_blocks=num_blocks,
                         compute_dtype=compute_dtype, input_hw=input_hw)
    model = init_flax_style(model, gen).to(dev)
    return DepthTrainState(model=model, optimizer=make_depth_optimizer(model, learning_rate))


def depth_loss(pred: torch.Tensor, depth_gt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked log-depth L1 (salve_tpu/training/depth.py:58-60)."""
    err = torch.abs(torch.log1p(pred) - torch.log1p(depth_gt)) * valid
    return err.sum() / torch.clamp_min(valid.sum(), 1.0)


def make_depth_train_step():
    """Returns step(state, rgb (B,H,W,3), depth_gt (B,H,W), valid (B,H,W))
    -> (state, loss): the forward in train mode, the loss, the backward and
    the Adam update. Inputs are host arrays or tensors; the loss stays on
    the device; after the step each parameter's `.grad` holds its gradient.
    The step runs under `device.deterministic_algorithms()`, so one state and
    batch give the same bits on every run."""

    @deterministic_algorithms()
    def step(state: DepthTrainState, rgb, depth_gt, valid):
        dev, dtype = state.device, state.model.refine2.weight.dtype
        rgb, depth_gt, valid = (torch.as_tensor(a).to(dev, dtype, non_blocking=True) for a in (rgb, depth_gt, valid))
        model = state.model.train()
        for p in model.parameters():
            p.grad = None
        loss = depth_loss(model(rgb), depth_gt, valid)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def save_depth_checkpoint(fpath: str, state: DepthTrainState) -> str:
    """Write {"model": state_dict, "config": PanoDepthNet's arguments,
    "step"} to `fpath` atomically (a temporary file, then os.replace)."""
    os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
    payload = {"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
               "config": state.model.config(), "step": state.step}
    tmp = fpath + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, fpath)
    return fpath


def collect_depth_examples(raw_dataset_dir: str, building_ids):
    """(img_fpath, pano, camera_height_m) triples for every GT pano available."""
    from salve_tpu_torch.common import posegraph2d

    examples = []
    for bid in building_ids:
        try:
            floors = posegraph2d.compute_available_floors_for_building(bid, raw_dataset_dir)
        except (FileNotFoundError, KeyError):
            continue
        for floor_id in floors:
            pg = posegraph2d.get_gt_pose_graph(bid, floor_id, raw_dataset_dir)
            for i, pano in pg.nodes.items():
                img_fpath = f"{raw_dataset_dir}/{bid}/panos/{Path(pano.image_path).name}"
                examples.append((img_fpath, pano, pg.get_camera_height_m(i)))
    return examples


def load_depth_example(
    img_fpath: str,
    pano,
    cam_h: float,
    synthetic_rgb: bool = False,
    hw: Tuple[int, int] = (PANO_H, PANO_W),
    seed: int = 0,
    depth_cache_root: str = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (rgb float32 in [0, 1], depth float32 meters) supervision pair.

    Room vertices are the ego-normalized layout times the camera height.
    With synthetic_rgb the pano is ray-cast from the same layout
    (rendering/synthetic.py); else it is read from disk, and with
    depth_cache_root the GT depth comes from the cached u16 mm PNG when
    one exists, the single-room layout raycast otherwise (ceiling at twice
    the camera height).
    """
    from salve_tpu_torch.rendering.synthetic import render_synthetic_pano

    h, w = hw
    verts_m = np.asarray(pano.room_vertices_local_2d, dtype=np.float64) * float(cam_h)
    if synthetic_rgb:
        out = render_synthetic_pano(verts_m, camera_height_m=cam_h, h=h, w=w, seed=seed)
        return out["rgb"].astype(np.float32) / 255.0, out["depth"].astype(np.float32)
    from salve_tpu_torch.rendering.bev_pair import load_pano_rgb

    rgb = load_pano_rgb(img_fpath)
    if depth_cache_root is not None:
        from salve_tpu_torch.depth.cache import depth_fpath_for_pano
        from salve_tpu_torch.native import png

        building_id = Path(img_fpath).parent.parent.name
        depth_fpath = depth_fpath_for_pano(depth_cache_root, building_id, img_fpath)
        if Path(depth_fpath).exists():
            depth_mm = png.read_png(depth_fpath)
            return rgb.astype(np.float32), depth_mm.astype(np.float32) / 1000.0
    depth = synthesize_depth_from_layout(verts_m, camera_height_m=cam_h, ceiling_height_m=2 * cam_h, h=h, w=w)
    return rgb.astype(np.float32), depth.astype(np.float32)


# Prerendered synthetic supervision, keyed by (img_fpath, hw, variant): a
# few texture variants a pano make multi-epoch training cheap on the host.
_SYNTH_CACHE: dict = {}


def iter_layout_depth_batches(
    raw_dataset_dir: str,
    building_ids,
    batch_size: int,
    seed: int = 0,
    synthetic_rgb: bool = False,
    hw: Tuple[int, int] = (PANO_H, PANO_W),
    cache_variants: int = 0,
    depth_cache_root: str = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (rgb, depth_gt, valid) batches of ZInD panos and layout
    raycasts, in `np.random.default_rng(seed)`'s permutation; the tail
    short of a batch is dropped. Without synthetic_rgb, panos whose image
    is missing are skipped; with it every GT pano counts. cache_variants > 0
    memoizes that many texture variants a pano (u8 RGB, float16 depth), the
    epoch seed cycling through them."""
    rng = np.random.default_rng(seed)
    examples = collect_depth_examples(raw_dataset_dir, building_ids)
    if not synthetic_rgb:
        examples = [e for e in examples if Path(e[0]).exists()]

    order = rng.permutation(len(examples))
    batch_rgb, batch_depth = [], []
    for k in order:
        img_fpath, pano, cam_h = examples[k]
        if synthetic_rgb and cache_variants > 0:
            variant = seed % cache_variants
            key = (img_fpath, hw, variant)
            if key not in _SYNTH_CACHE:
                import zlib

                stable = zlib.crc32(img_fpath.encode())
                rgb, depth = load_depth_example(img_fpath, pano, cam_h, synthetic_rgb=True, hw=hw,
                                                seed=(stable ^ (variant * 7919)) & 0x7FFFFFFF)
                _SYNTH_CACHE[key] = (np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8), depth.astype(np.float16))
            rgb_u8, depth_f16 = _SYNTH_CACHE[key]
            rgb = rgb_u8.astype(np.float32) / 255.0
            depth = depth_f16.astype(np.float32)
        else:
            rgb, depth = load_depth_example(img_fpath, pano, cam_h, synthetic_rgb=synthetic_rgb, hw=hw,
                                            seed=(seed * 100003 + int(k)) & 0x7FFFFFFF,
                                            depth_cache_root=depth_cache_root)
        batch_rgb.append(rgb)
        batch_depth.append(depth)
        if len(batch_rgb) == batch_size:
            rgb_b = np.stack(batch_rgb)
            depth_b = np.stack(batch_depth)
            valid = np.isfinite(depth_b) & (depth_b > 0.1) & (depth_b < 64.0)
            yield rgb_b, depth_b, valid.astype(np.float32)
            batch_rgb, batch_depth = [], []


def evaluate_depth(
    predict_fn,
    raw_dataset_dir: str,
    building_ids,
    synthetic_rgb: bool = True,
    hw: Tuple[int, int] = (PANO_H, PANO_W),
    max_panos: int = None,
    seed: int = 999331,
    depth_cache_root: str = None,
) -> dict:
    """Depth-error metrics over held-out panos, in float64 on the host.

    predict_fn: (H, W, 3) float32 RGB -> (H, W) depth in meters.
    Returns {'rmse_m', 'abs_rel', 'log10', 'delta1', 'n_panos'} over the
    valid pixels (finite GT in (0.1, 64) m and a prediction above 1 mm).
    """
    examples = collect_depth_examples(raw_dataset_dir, building_ids)
    if not synthetic_rgb:
        examples = [e for e in examples if Path(e[0]).exists()]
    if max_panos is not None:
        examples = examples[:max_panos]

    sq_err = abs_rel = log10 = d1 = n = 0.0
    for k, (img_fpath, pano, cam_h) in enumerate(examples):
        rgb, gt = load_depth_example(img_fpath, pano, cam_h, synthetic_rgb=synthetic_rgb, hw=hw,
                                     seed=(seed + k), depth_cache_root=depth_cache_root)
        pred = np.asarray(predict_fn(rgb), dtype=np.float64)
        gt = gt.astype(np.float64)
        valid = np.isfinite(gt) & (gt > 0.1) & (gt < 64.0) & (pred > 1e-3)
        p, g = pred[valid], gt[valid]
        sq_err += float(((p - g) ** 2).sum())
        abs_rel += float((np.abs(p - g) / g).sum())
        log10 += float(np.abs(np.log10(p) - np.log10(g)).sum())
        d1 += float((np.maximum(p / g, g / p) < 1.25).sum())
        n += float(valid.sum())
    n = max(n, 1.0)
    return {
        "rmse_m": float(np.sqrt(sq_err / n)),
        "abs_rel": float(abs_rel / n),
        "log10": float(log10 / n),
        "delta1": float(d1 / n),
        "n_panos": len(examples),
    }
