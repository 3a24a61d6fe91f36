"""Plain float32 scoring of hypotheses: renders, warps, the verifier.

For a floor's panos and a list of hypotheses (i1, i2, theta, t), the
probability that each is a true alignment: pano 1's renders warped into
pano 2's frame by (R(theta), 1.5 t) beside pano 2's own renders, ceiling
and floor, resized and normalised, through the reference verifier in eval
mode. `precision="fp8"` is the control (reference/model.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import render
from benchmark.reference.model import ReferenceVerifier, fp32_products

BATCH = 32


def rotations(theta_deg: np.ndarray) -> np.ndarray:
    """(H, 2, 2) float32 rotation matrices, formed in float64."""
    th = np.deg2rad(np.asarray(theta_deg, dtype=np.float64))
    c, s = np.cos(th), np.sin(th)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2).astype(np.float32)


@torch.no_grad()
@fp32_products()
def logits(config: Dict, state: Dict[str, torch.Tensor], depths: np.ndarray, rgbs: np.ndarray,
           pairs: np.ndarray, theta_deg: np.ndarray, t: np.ndarray, device, precision: str) -> torch.Tensor:
    """(H, 2) float32 logits of the hypotheses, on `device`."""
    dev = torch.device(device)
    d = torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev)
    c = torch.as_tensor(np.asarray(rgbs, dtype=np.float32), device=dev)
    px, mpp = config["img_px"], config["meters_per_px"]
    id_ceil, id_floor, ext_ceil, ext_floor = render.render_banks(d, c, px, mpp, 2 * px)
    del d, c
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
        x = render.verifier_input(ceil1, id_ceil[i2], floor1, id_floor[i2], config["resize_px"], config["crop_px"])
        out.append(model.forward(x, train=False))
    return torch.cat(out)


def positive_probs(*args, **kwargs) -> np.ndarray:
    """float64 probabilities of the positive class (softmax in float32);
    the arguments are `logits`'s."""
    return torch.softmax(logits(*args, **kwargs), dim=1)[:, 1].double().cpu().numpy()


def margins(*args, **kwargs) -> np.ndarray:
    """float64 log-odds of the positive class, logit 1 - logit 0; the
    arguments are `logits`'s."""
    z = logits(*args, **kwargs).double()
    return (z[:, 1] - z[:, 0]).cpu().numpy()
