"""Plain float32 scoring of hypotheses by the ceiling + floor RGB + layout
verifier: six images, in the order the verifier trains on (ceiling 1,
ceiling 2, floor 1, floor 2, layout 1, layout 2).

The renders and warps are reference/score.py's, the layouts
reference/layout.py's (pano 1's moved into pano 2's frame by the
hypothesis), the verifier reference/model.py's over 6 x 3 input channels.
`precision="fp8"` rounds the verifier's products (reference/model.py),
`layout_precision="bf16"` the layouts' vertices (reference/layout.py).
Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import layout as ref_layout
from benchmark.reference import render
from benchmark.reference.model import ReferenceVerifier, fp32_products
from benchmark.reference.score import BATCH, rotations


def verifier_input(images: List[torch.Tensor], resize_px: int, crop_px: int) -> List[torch.Tensor]:
    """(B, d, d, 3) u8 images -> as many (B, 3, crop, crop) float32 images:
    reference/render.py:verifier_input's resize, crop and normalisation."""
    x = torch.stack(images, dim=1)
    b, n, h, w, _ = x.shape
    x = x.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).to(torch.float32)
    x = F.interpolate(x, size=(resize_px, resize_px), mode="bilinear", align_corners=False, antialias=True)
    off = (resize_px - crop_px) // 2
    x = x[:, :, off:off + crop_px, off:off + crop_px]
    mean = torch.tensor(render.IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(render.IMAGENET_STD, device=x.device)[:, None, None]
    x = ((x - mean) / std).reshape(b, n, 3, crop_px, crop_px)
    return [x[:, i] for i in range(n)]


@torch.no_grad()
@fp32_products()
def logits(config: Dict, state: Dict[str, torch.Tensor], depths: np.ndarray, rgbs: np.ndarray, layouts: List,
           pairs: np.ndarray, theta_deg: np.ndarray, t: np.ndarray, device, precision: str = "fp32",
           layout_precision: str = "fp32", rasters: Optional[tuple] = None) -> torch.Tensor:
    """(H, 2) float32 logits of the hypotheses, on `device`; `layouts` holds
    the floor's layout a pano. `rasters`, where given, is the (pano 1 a
    hypothesis, pano 2 a pano) pair of layout rasters to use in place of the
    reference's own (reference/layout.py:pair_rasters)."""
    dev = torch.device(device)
    px, mpp = config["img_px"], config["meters_per_px"]
    d = torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev)
    c = torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev)
    id_ceil, id_floor, ext_ceil, ext_floor = render.render_banks(d, c, px, mpp, 2 * px)
    del d, c
    if rasters is None:
        rasters = ref_layout.pair_rasters(layouts, pairs, theta_deg, t, px, mpp, config["layout_line_px"], dev,
                                          layout_precision)
    lay1, lay2 = rasters
    model = ReferenceVerifier(state, config["num_layers"], config["n_images"], config["num_classes"], precision)
    R_all = torch.as_tensor(rotations(theta_deg), device=dev)
    t_all = torch.as_tensor(np.asarray(t, dtype=np.float32), device=dev) * render.HOHONET_TO_ZIND_SCALE
    i1_all = torch.as_tensor(pairs[:, 0], device=dev, dtype=torch.long)
    i2_all = torch.as_tensor(pairs[:, 1], device=dev, dtype=torch.long)
    out = []
    for s in range(0, len(pairs), BATCH):
        sl = slice(s, s + BATCH)
        i1, i2, R, tt = i1_all[sl], i2_all[sl], R_all[sl], t_all[sl]
        ceil1 = render.warp(ext_ceil[i1], R, tt, px, mpp)
        floor1 = render.warp(ext_floor[i1], R, tt, px, mpp)
        x = verifier_input([ceil1, id_ceil[i2], floor1, id_floor[i2], lay1[sl].to(dev), lay2[i2].to(dev)],
                           config["resize_px"], config["crop_px"])
        out.append(model.forward(x, train=False))
    return torch.cat(out)


def positive_probs(*args, **kwargs) -> np.ndarray:
    """float64 probabilities of the positive class (softmax in float32);
    the arguments are `logits`'s."""
    return torch.softmax(logits(*args, **kwargs), dim=1)[:, 1].double().cpu().numpy()


def margins(*args, **kwargs) -> np.ndarray:
    """float64 log-odds of the positive class; the arguments are `logits`'s."""
    z = logits(*args, **kwargs).double()
    return (z[:, 1] - z[:, 0]).cpu().numpy()
