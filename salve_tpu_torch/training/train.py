"""Verifier train/eval steps and checkpointing (port of salve_tpu/training/train.py).

Parity targets, through salve_tpu:
  * salve/train_utils.py:18 (cross_entropy_forward), :57 (poly LR),
    :163-226 (optimizer/model factories);
  * scripts/train.py:40-167 (best-val_mAcc checkpointing, results JSONs).

One train step takes a (B, N, H, W, 3) uint8 batch, augments it on the
device, runs the forward in train mode (bf16 under autocast when the config
says so), the loss, the backward and the update. The optimizer is optax's
`chain(add_decayed_weights(wd), adam(schedule))` written out in optax's
order of operations (`OptaxAdam`), so one step from the same weights lands
where salve_tpu's does; the schedule is optax's polynomial schedule.

On a mesh of N > 1 ranks (parallel/mesh.py) a step has the semantics of
salve_tpu's jitted step on a batch sharded over its mesh: the loss is the
mean over the global batch, batch norm uses the global batch's statistics
(models/resnet.py:global_batch_statistics), the class-balanced weights
count the global batch's classes, the augmentation is drawn for the global
batch from the one generator (each rank takes its rows), the gradients are
all-reduced as a mean over the equal shards, and the metrics come back
global.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from salve_tpu_torch.models.early_fusion import EarlyFusionCEResnet, init_flax_style
from salve_tpu_torch.models.resnet import global_batch_statistics
from salve_tpu_torch.models.weights import read_verifier_checkpoint
from salve_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from salve_tpu_torch.training import transforms
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.utils import profiler

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

Schedule = Callable[[int], float]


def make_poly_schedule(cfg: TrainingConfig, max_iter: int) -> Schedule:
    """optax.polynomial_schedule(base_lr, 0, power, max_iter) in float32:
    lr = base_lr * (1 - clip(count, 0, max_iter) / max_iter) ** power,
    counted from 0 (train_utils.py:57)."""
    if max_iter <= 0:
        return lambda count: float(np.float32(cfg.base_lr))
    init = np.float32(cfg.base_lr)
    power = np.float32(cfg.poly_lr_power)

    def schedule(count: int) -> float:
        c = np.float32(min(max(int(count), 0), max_iter))
        frac = np.float32(1.0) - c / np.float32(max_iter)
        return float(init * frac**power + np.float32(0.0))

    return schedule


class OptaxAdam:
    """`optax.chain(add_decayed_weights(wd), adam(lr_schedule))` over `params`.

    Per parameter p with gradient g, in optax's order:
        g  = g + wd * p
        mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
        count += 1
        u  = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
        p  = p + (-lr(schedule_count)) * u;  schedule_count += 1
    The scalars (bias corrections, rate) are in the parameters' float type,
    as optax computes them in JAX's: float32, or float64 for a model cast
    with `.double()` (JAX with x64 on).
    `torch.optim.Adam` computes the same quantities in another order (a
    lerp for mu, the bias corrections folded into the step size and the
    denominator), so it is written out here.
    """

    def __init__(self, params: List[torch.nn.Parameter], weight_decay: float, schedule: Schedule) -> None:
        self.params = list(params)
        self.weight_decay = weight_decay
        self.schedule = schedule
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.schedule_count = 0

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        g = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g, 1.0 - ADAM_B1)
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, g)
        torch._foreach_mul_(g2, 1.0 - ADAM_B2)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_add_(self.nu, g2)
        self.count += 1
        ft = np.float64 if self.params[0].dtype == torch.float64 else np.float32
        bc1 = float(ft(1.0) - ft(ADAM_B1) ** ft(self.count))
        bc2 = float(ft(1.0) - ft(ADAM_B2) ** ft(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        u = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(u, denom)
        torch._foreach_mul_(u, -float(ft(self.schedule(self.schedule_count))))
        self.schedule_count += 1
        torch._foreach_add_(self.params, u)

    def state_dict(self, names: List[str]) -> Dict[str, Any]:
        return {
            "count": self.count,
            "schedule_count": self.schedule_count,
            "mu": {n: t.detach().cpu() for n, t in zip(names, self.mu)},
            "nu": {n: t.detach().cpu() for n, t in zip(names, self.nu)},
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any], names: List[str]) -> None:
        for n, mu, nu in zip(names, self.mu, self.nu):
            mu.copy_(state["mu"][n])
            nu.copy_(state["nu"][n])
        self.count = int(state["count"])
        self.schedule_count = int(state["schedule_count"])


def make_optimizer(cfg: TrainingConfig, max_iter: int, model: torch.nn.Module) -> OptaxAdam:
    """Adam with L2 weight decay folded into the gradients, over `model`'s parameters."""
    if cfg.optimizer_algo != "adam":
        raise RuntimeError(f"Unknown optimizer {cfg.optimizer_algo}")
    if cfg.lr_annealing_strategy == "poly":
        schedule = make_poly_schedule(cfg, max_iter)
    else:
        schedule = lambda count: float(np.float32(cfg.base_lr))  # noqa: E731
    return OptaxAdam(list(model.parameters()), cfg.weight_decay, schedule)


@dataclass
class TrainState:
    """The model (parameters and batch statistics), its optimizer with the
    LR schedule, and the count of steps taken."""

    model: EarlyFusionCEResnet
    optimizer: OptaxAdam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.model.conv1.weight.device

    def param_names(self) -> List[str]:
        return [n for n, _ in self.model.named_parameters()]


def build_model(cfg: TrainingConfig) -> EarlyFusionCEResnet:
    return EarlyFusionCEResnet(
        num_layers=cfg.num_layers,
        num_classes=cfg.num_ce_classes,
        modalities=tuple(cfg.modalities),
        compute_dtype=cfg.compute_dtype,
        append_pair_difference=cfg.append_pair_difference,
    )


def create_train_state(cfg: TrainingConfig, gen: torch.Generator, max_iter: int, device: torch.device) -> TrainState:
    """A fresh model with Flax's initializers drawn from `gen` (a CPU
    generator: the same weights on every device), and a fresh optimizer."""
    model = init_flax_style(build_model(cfg), gen).to(device)
    return TrainState(model=model, optimizer=make_optimizer(cfg, max_iter, model))


def split_images(batch: torch.Tensor) -> List[torch.Tensor]:
    """(B, N, H, W, 3) -> N images of (B, 3, H, W) for the model."""
    return [batch[:, i].permute(0, 3, 1, 2) for i in range(batch.shape[1])]


def _as_device_batch(imgs, labels, device: torch.device):
    imgs = torch.as_tensor(imgs).to(device, non_blocking=True)
    labels = torch.as_tensor(np.asarray(labels) if not torch.is_tensor(labels) else labels)
    return imgs, labels.to(device, non_blocking=True).long()


def _sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def _rank_rows(params: transforms.AugmentParams, mesh: Mesh) -> transforms.AugmentParams:
    """This rank's rows of the global batch's augmentation parameters."""
    k = params.off_h.shape[0] // mesh.size
    rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
    p = params.photometric
    if p is not None:
        p = transforms.PhotometricParams(*(t[rows] for t in (p.brightness, p.contrast, p.saturation, p.hue)))
    return transforms.AugmentParams(*(t[rows] for t in (params.off_h, params.off_w, params.do_hflip,
                                                         params.do_vflip)), photometric=p)


def _all_reduce_mean_grads(mesh: Mesh, params: List[torch.nn.Parameter]) -> None:
    """Each parameter's `.grad` becomes the mean over the ranks, in one
    all-reduce of the flattened gradients."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum(mesh, flat).div_(mesh.size)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])


def make_train_step(cfg: TrainingConfig, mesh: Optional[Mesh] = None):
    """Returns train_step(state, imgs, labels, aug) -> (state, metrics).

    imgs: (B, N, resize_h, resize_w, 3) uint8 (host array or device
    tensor); labels: (B,) ints; aug: a CPU `torch.Generator` to draw the
    augmentation from, or drawn `transforms.AugmentParams`. The metrics
    ("loss", "accuracy", "probs") stay on the device; after the step each
    parameter's `.grad` holds this step's gradient.

    With a mesh of N > 1, imgs and labels are this rank's rows of a global
    batch of N * B (parallel/mesh.py:shard_batch) and `aug` is drawn (or
    given) for the global batch; the metrics are the global batch's and
    `.grad` the global gradient on every rank.

    Spans (utils/profiler.py): `step` (its id the state's step count before
    it) with `augment` (the batch on the device, the draw and
    `apply_augment`), `forward` (train mode, the model and the loss),
    `backward` and `optimizer` inside it; the mesh's collectives between
    them are in `step` alone.
    """
    sharded = _sharded(mesh)

    def train_step(state: TrainState, imgs, labels, aug: Union[torch.Generator, transforms.AugmentParams]):
        with profiler.annotate("step", id=state.step):
            with profiler.annotate("augment"):
                imgs, labels = _as_device_batch(imgs, labels, state.device)
                world = mesh.size if sharded else 1
                if isinstance(aug, torch.Generator):
                    b, n, h, w, _ = imgs.shape
                    aug = transforms.draw_augment_params(aug, world * b, n, h, w, cfg.train_h, cfg.train_w,
                                                         cfg.apply_photometric_augmentation)
                if sharded:
                    aug = _rank_rows(aug, mesh)
                x = transforms.apply_augment(imgs, aug.to(state.device), cfg.train_h, cfg.train_w)
            with profiler.annotate("forward"):
                model = state.model.train()
                for p in model.parameters():
                    p.grad = None
                with global_batch_statistics(model, mesh):
                    logits = model(split_images(x))
                ce = F.cross_entropy(logits, labels, reduction="none")
                if cfg.class_balanced_loss:
                    # Each class contributes half of the loss (train.py:118-131),
                    # the classes counted over the global batch.
                    pos = labels == 1
                    counts = torch.stack([pos.sum(), (~pos).sum()])
                    if sharded:
                        all_reduce_sum(mesh, counts)
                    n_pos, n_neg = counts.clamp_min(1).to(torch.float32)
                    loss = (ce * torch.where(pos, 0.5 / n_pos, 0.5 / n_neg)).sum()
                    if sharded:
                        loss = loss * world  # this rank's share of the global loss, as a shard mean
                else:
                    loss = ce.mean()
            with profiler.annotate("backward"):
                loss.backward()
            if sharded:
                _all_reduce_mean_grads(mesh, list(model.parameters()))
            with profiler.annotate("optimizer"):
                state.optimizer.step()
            state.step += 1
            logits, loss = logits.detach(), loss.detach()
            if sharded:
                logits, labels = all_gather_rows(mesh, logits), all_gather_rows(mesh, labels)
                loss = all_reduce_sum(mesh, loss.clone()) / world
            return state, {
                "loss": loss,
                "accuracy": (logits.argmax(dim=1) == labels).to(torch.float32).mean(),
                "probs": torch.softmax(logits, dim=1),
            }

    return train_step


def make_eval_step(cfg: TrainingConfig, mesh: Optional[Mesh] = None):
    """Returns eval_step(state, imgs, labels) -> {"loss", "probs", "y_hat"} (no grad).

    With a mesh of N > 1, imgs and labels are this rank's rows and the
    results are the global batch's (the logits all-gathered).
    """
    sharded = _sharded(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, imgs, labels):
        imgs, labels = _as_device_batch(imgs, labels, state.device)
        x = transforms.preprocess_eval(imgs, cfg.train_h, cfg.train_w)
        logits = state.model.eval()(split_images(x))
        if sharded:
            logits, labels = all_gather_rows(mesh, logits), all_gather_rows(mesh, labels)
        return {
            "loss": F.cross_entropy(logits, labels),
            "probs": torch.softmax(logits, dim=1),
            "y_hat": logits.argmax(dim=1),
        }

    return eval_step


# ---------------------------------------------------------------------------
# Checkpointing (best-val_mAcc policy; scripts/train.py:84-111).
# ---------------------------------------------------------------------------

CHECKPOINT_NAME = "train_ckpt.pt"


def _model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(save_dir: str, state: TrainState, epoch: int, val_mAcc: float, cfg: TrainingConfig) -> str:
    """Write {model state_dict, optimizer state, step} to `train_ckpt.pt`
    and the meta JSON salve_tpu writes beside its `train_ckpt.flax`.

    The write is atomic (a temporary file, then os.replace): a crash or a
    kill mid-save never leaves a truncated checkpoint for a resume to trip
    on (salve_tpu/training/train.py:209-217).
    """
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "model": _model_state(state.model),
        "opt_state": state.optimizer.state_dict(state.param_names()),
        "step": state.step,
    }
    ckpt_fpath = os.path.join(save_dir, CHECKPOINT_NAME)
    tmp_fpath = ckpt_fpath + ".tmp"
    torch.save(payload, tmp_fpath)
    os.replace(tmp_fpath, ckpt_fpath)
    meta = {
        "epoch": epoch,
        "val_mAcc": val_mAcc,
        "max_epochs": cfg.num_epochs,
        "num_layers": cfg.num_layers,
        "modalities": list(cfg.modalities),
    }
    with open(os.path.join(save_dir, "train_ckpt.meta.json"), "w") as f:
        json.dump(meta, f, indent=4)
    return ckpt_fpath


def load_model_checkpoint(ckpt_fpath: str, state: TrainState, params_only: bool = False) -> TrainState:
    """Restore a checkpoint into `state`.

    Accepts the port's `train_ckpt.pt`, salve_tpu's `train_ckpt.flax`
    (read without flax or msgpack), and a reference torch `.pth` (the
    released SALVe verifiers; weights only, fresh optimizer).

    params_only restores only the parameters and batch statistics, keeping
    the fresh optimizer and step 0: the fine-tune entry point (a finished
    run's step is past the new run's poly-LR horizon, where lr = 0).
    """
    payload = read_verifier_checkpoint(ckpt_fpath, state.model.num_layers)
    state.model.load_state_dict(payload["model"], strict=True)
    if params_only or "opt_state" not in payload:
        return state
    state.optimizer.load_state_dict(payload["opt_state"], state.param_names())
    state.step = int(payload["step"])
    return state


def save_results_json(results_dir: str, results_dict: Dict[str, Any], cfg: TrainingConfig) -> None:
    """Write the per-epoch results JSON and a config copy, as salve_tpu does
    (scripts/train.py:109-111)."""
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "results-fields.json"), "w") as f:
        json.dump(results_dict, f, indent=4)
    with open(os.path.join(results_dir, "config.json"), "w") as f:
        json.dump({k: v for k, v in asdict(cfg).items()}, f, indent=4, default=str)
