"""Plain float32 training steps of the verifier: the released recipe.

SALVe's recipe (salve/train_utils.py; configs/1200ffbe47d836557d88fef052952337.yaml):
random 224 crop of the 234 px tuple (one offset per tuple), random
horizontal and vertical flips (one decision per tuple), ImageNet
normalisation, cross-entropy over 2 classes averaged over the batch, batch
norm on the batch's statistics, and Adam with L2 weight decay added to the
gradient (optax's `chain(add_decayed_weights, adam)`) under a polynomial
learning rate base * (1 - step / max_iter) ** power.

The augmentation is drawn from a CPU `torch.Generator` in the order
offsets (rows, columns), h-flips, v-flips: the benchmark hands the program
a generator seeded alike, so both sides crop and flip every tuple the same.

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import ReferenceVerifier, fp32_products
from benchmark.reference.render import IMAGENET_MEAN, IMAGENET_STD

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def draw_augment(gen: torch.Generator, b: int, size: int, crop: int):
    off_h = torch.randint(0, size - crop + 1, (b,), generator=gen)
    off_w = torch.randint(0, size - crop + 1, (b,), generator=gen)
    hflip = torch.rand(b, generator=gen) < 0.5
    vflip = torch.rand(b, generator=gen) < 0.5
    return off_h, off_w, hflip, vflip


def augment(imgs: torch.Tensor, aug, crop: int) -> List[torch.Tensor]:
    """(B, N, S, S, 3) u8 tuples -> N images of (B, 3, crop, crop) float32."""
    off_h, off_w, hflip, vflip = (t.to(imgs.device) for t in aug)
    b, n = imgs.shape[:2]
    r = torch.arange(crop, device=imgs.device)
    rows = (off_h[:, None] + r)[:, None, :, None]
    cols = (off_w[:, None] + r)[:, None, None, :]
    bi = torch.arange(b, device=imgs.device)[:, None, None, None]
    ni = torch.arange(n, device=imgs.device)[None, :, None, None]
    x = imgs[bi, ni, rows, cols].to(torch.float32)  # (B, N, crop, crop, 3)
    x = torch.where(hflip[:, None, None, None, None], x.flip(3), x)
    x = torch.where(vflip[:, None, None, None, None], x.flip(2), x)
    x = (x - torch.tensor(IMAGENET_MEAN, device=x.device)) / torch.tensor(IMAGENET_STD, device=x.device)
    return [x[:, i].permute(0, 3, 1, 2) for i in range(n)]


def poly_lr(base_lr: float, power: float, max_iter: int, count: int) -> float:
    frac = np.float32(1.0) - np.float32(min(max(count, 0), max_iter)) / np.float32(max_iter)
    return float(np.float32(base_lr) * frac ** np.float32(power))


@fp32_products()
def train_steps(state: Dict[str, torch.Tensor], arch: Dict, recipe: Dict, batches, gen: torch.Generator,
                precision: str = "fp32") -> Dict:
    """Run len(batches) steps from `state` on `batches` [(imgs u8 (B, N, S,
    S, 3), labels (B,)), ...] on their device.

    Returns {"loss": [each step's loss], "first_margins": the first step's
    log-odds of the positive class, row by row, "grad_norms": {leaf: norm of the
    first step's gradient with the weight decay added, as Adam takes it},
    "change_norms": {leaf: norm of (leaf after the last step - leaf
    before the first)}}.
    """
    model = ReferenceVerifier(dict(state), arch["num_layers"], arch["n_images"], arch["num_classes"],
                              precision=precision, checkpoint_blocks=True)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.parameters().items()}
    model.state.update(params)
    start = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out: Dict = {"loss": []}
    for step, (imgs, labels) in enumerate(batches, start=1):
        aug = draw_augment(gen, imgs.shape[0], imgs.shape[2], recipe["train_px"])
        logits = model.forward(augment(imgs, aug, recipe["train_px"]), train=True)
        loss = F.cross_entropy(logits, labels.to(logits.device).long())
        grads = torch.autograd.grad(loss, list(params.values()))
        out["loss"].append(float(loss.detach()))
        if step == 1:
            out["first_margins"] = (logits[:, 1] - logits[:, 0]).detach().double().cpu().numpy()
        lr = poly_lr(recipe["base_lr"], recipe["poly_lr_power"], recipe["max_iter"], step - 1)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                g = g + recipe["weight_decay"] * p
                if step == 1:
                    out.setdefault("grad_norms", {})[k] = float(g.norm())
                mu[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                nu[k].mul_(ADAM_B2).add_(g * g, alpha=1 - ADAM_B2)
                u = (mu[k] / (1 - ADAM_B1**step)) / ((nu[k] / (1 - ADAM_B2**step)).sqrt() + ADAM_EPS)
                p.add_(u, alpha=-lr)
    with torch.no_grad():
        out["change_norms"] = {k: float((p - start[k]).norm()) for k, p in params.items()}
    return out
