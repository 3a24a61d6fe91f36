"""Training and evaluation loops (port of salve_tpu/training/loop.py).

Keeps salve_tpu's contract (scripts/train.py, scripts/test.py through it):
per-epoch train and val metrics accumulated into a results dict,
best-`val_mAcc` checkpointing, the results JSON and config copy, and
`evaluate` writing the `batch_{i}.json` predictions Stage D reads. Runs on
one card (`device=None`), or on the mesh `cfg.mesh_shape` asks for
(parallel/mesh.py: None is the whole world of the process group, one
process outside one), with salve_tpu's global-batch semantics
(training/train.py). Each rank reads the same batches; a batch the mesh
divides is split over the ranks, and one it does not (a host-streamed
tail) runs whole on every rank, with no collective, as salve_tpu runs it
unsharded (salve_tpu/training/loop.py:123, :325). Rank 0 writes the
checkpoints, the results and the `batch_{i}.json` files. Both run under
`device.deterministic_algorithms()`: one seed and one corpus give the same
bits on every run, as salve_tpu's do on XLA:CPU.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from salve_tpu_torch.dataset.bev_pairs import BEVPairDataset
from salve_tpu_torch.device import DeviceLike, deterministic_algorithms, resolve_device
from salve_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch
from salve_tpu_torch.training import train as train_lib
from salve_tpu_torch.training.config import TrainingConfig
from salve_tpu_torch.training.meters import PrecisionRecallMeter, SegmentationAverageMeter
from salve_tpu_torch.utils import profiler
from salve_tpu_torch.utils.io import save_json_file

logger = logging.getLogger(__name__)


def _new_accumulator(num_classes: int, device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        "cm": torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device),
        "loss_sum": torch.zeros((), dtype=torch.float32, device=device),
        "n": torch.zeros((), dtype=torch.int32, device=device),
    }


def _fold(acc: Dict[str, torch.Tensor], loss, probs, labels, valid) -> None:
    """Fold one step's outputs into the device-side accumulator, in place.

    `valid` masks wrap-around padding rows (a DeviceCorpus pads its shards
    on a mesh; on one card every row is valid), so duplicated
    examples never count in the confusion matrix. The step loss is a batch
    mean, so loss_sum weights it by the valid count.
    """
    dev = acc["cm"].device
    labels = torch.as_tensor(labels).to(dev, non_blocking=True).long()
    w = torch.as_tensor(valid).to(dev, non_blocking=True).to(torch.int32)
    y_hat = probs.argmax(dim=1)
    acc["cm"].index_put_((labels, y_hat), w, accumulate=True)
    n_valid = w.sum()
    acc["loss_sum"] += loss * n_valid
    acc["n"] += n_valid


def _metrics_from_acc(acc) -> Tuple[float, float, List[float]]:
    """(avg_loss, mAcc, per-class accuracy) from the fetched accumulator
    (SegmentationAverageMeter.get_metrics' math, meters.py)."""
    cm = acc["cm"].cpu().numpy().astype(np.float64)
    inter = np.diag(cm)
    target = cm.sum(axis=1)
    accuracy_class = inter / (target + 1e-10)
    n = float(acc["n"].item())
    avg_loss = float(acc["loss_sum"].item()) / max(n, 1.0)
    return avg_loss, float(np.mean(accuracy_class)), list(map(float, accuracy_class))


def run_epoch(
    cfg: TrainingConfig,
    epoch: int,
    state: train_lib.TrainState,
    steps,
    dataset,
    split: str,
    gen: Optional[torch.Generator] = None,
    max_batches: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[train_lib.TrainState, Dict[str, float]]:
    """One pass over a split. Returns (state, metrics dict).

    `steps` is (the mesh's step, the one-device step): a batch the mesh
    divides goes through the first on this rank's rows (a DeviceCorpus
    yields them already), any other through the second whole. Steps and
    metric folds are queued on the device; the host waits only at the log
    lines (every print_every batches) and at the final fetch, and every
    `sync_every` steps fetches one scalar, so the host runs at most that
    many steps ahead of the device (each queued batch pins its images in
    device memory).

    Spans (utils/profiler.py): `epoch` (its id the epoch) with `gather`
    (the next batch from the dataset), the step's own, `fold` and `sync`
    (each fetch from the device) inside it. Counters: `train_steps` and
    `train_tuples` (a train split's steps and the rows they trained).
    """
    from salve_tpu_torch.training.device_corpus import DeviceCorpus

    sharded_step, whole_step = steps
    with profiler.annotate("epoch", id=epoch):
        acc = _new_accumulator(cfg.num_ce_classes, state.device)
        n_batches = 0
        t_start = time.time()
        sync_every = max(1, min(cfg.print_every, 32))
        rows_are_local = isinstance(dataset, DeviceCorpus)
        batches = iter(dataset.iter_batches(cfg.batch_size, shuffle=(split == "train"), seed=epoch))
        while True:
            with profiler.annotate("gather"):
                batch = next(batches, None)
            if batch is None:
                break
            imgs, labels = batch[0], batch[1]
            valid = batch[3] if len(batch) > 3 else np.ones(len(labels), bool)
            step_fn, step_imgs, step_labels = whole_step, imgs, labels
            if mesh is not None and mesh.size > 1 and len(labels) % mesh.size == 0:
                step_fn, step_labels = sharded_step, shard_batch(mesh, labels)
                step_imgs = imgs if rows_are_local else shard_batch(mesh, imgs)
            if split == "train":
                state, metrics = step_fn(state, step_imgs, step_labels, gen)
                profiler.count("train_steps")
                profiler.count("train_tuples", len(labels))
            else:
                metrics = step_fn(state, step_imgs, step_labels)
            with profiler.annotate("fold"):
                _fold(acc, metrics["loss"], metrics["probs"], labels, valid)
            n_batches += 1
            if n_batches % cfg.print_every == 0:
                with profiler.annotate("sync"):
                    avg_loss, mAcc, _ = _metrics_from_acc(acc)  # waits for this step
                    logger.info(
                        "[%s] epoch %d batch %d loss %.4f mAcc %.4f (%.2fs/batch)",
                        split, epoch, n_batches, avg_loss, mAcc, (time.time() - t_start) / n_batches,
                    )
            elif n_batches % sync_every == 0:
                with profiler.annotate("sync"):
                    int(acc["n"].item())  # backpressure only
            if max_batches is not None and n_batches >= max_batches:
                break

        with profiler.annotate("sync"):
            avg_loss, mAcc, accuracy_class = _metrics_from_acc(acc) if n_batches else (0.0, 0.0, [])
    return state, {"avg_loss": avg_loss, "mAcc": mAcc, "class_accs": accuracy_class}


def _data_sources(cfg: TrainingConfig, train_ds, val_ds, mesh: Mesh):
    """The host datasets, or device corpora where `device_corpus_gb` covers
    them (salve_tpu/training/loop.py:205-247)."""
    budget_gb = float(getattr(cfg, "device_corpus_gb", 0.0) or 0.0)
    if budget_gb <= 0 or len(train_ds) == 0:
        return train_ds, val_ds
    from salve_tpu_torch.training import device_corpus as dc

    def fits_one_step(ds) -> bool:
        # A split whose shard cannot fill one per-rank batch keeps streaming
        # from the host, which yields partial batches.
        per_rank = cfg.batch_size // mesh.size
        return -(-len(ds) // mesh.size) >= per_rank > 0

    est_train = dc.estimated_corpus_bytes(train_ds)
    est_val = dc.estimated_corpus_bytes(val_ds)
    if est_train <= budget_gb * 1e9 and cfg.batch_size % mesh.size == 0 and fits_one_step(train_ds):
        train_data, val_data = dc.DeviceCorpus(train_ds, mesh.device, mesh), val_ds
        # The val split rides along when the budget covers both (its tail
        # under one batch is then dropped).
        if 0 < est_val <= budget_gb * 1e9 - est_train and fits_one_step(val_ds):
            val_data = dc.DeviceCorpus(val_ds, mesh.device, mesh)
        elif len(val_ds) > 0:
            logger.warning(
                "device_corpus: val split streams from host (%.2f GB over remaining budget, or < one full step)",
                est_val / 1e9,
            )
        return train_data, val_data
    logger.warning(
        "device_corpus disabled: corpus %.2f GB vs budget %.2f GB, batch %d vs mesh size %d, or split smaller "
        "than one step", est_train / 1e9, budget_gb, cfg.batch_size, mesh.size,
    )
    return train_ds, val_ds


@deterministic_algorithms()
def train(
    cfg: TrainingConfig,
    seed: int = 0,
    max_batches_per_epoch: Optional[int] = None,
    resume_from: Optional[str] = None,
    finetune_from: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict[str, List[float]]:
    """Full training run (salve_tpu/training/loop.py:train).

    resume_from restores parameters, batch statistics and the optimizer
    (the port's `.pt`, salve_tpu's `.flax`, or a reference `.pth`, weights
    only) to continue the SAME run; finetune_from restores parameters and
    batch statistics only, with a fresh optimizer and LR schedule. Returns
    the results dict (train_/val_ prefixed metrics), on every rank.

    `cfg.mesh_shape` asking for more processes than the process group holds
    raises (parallel/mesh.py:make_mesh says how to start them).
    """
    if resume_from is not None and finetune_from is not None:
        raise ValueError(
            "resume_from and finetune_from are mutually exclusive: a full "
            "restore would resume past the new run's poly-LR horizon "
            "(lr=0, no learning) — pick one."
        )
    mesh = make_mesh(cfg.mesh_shape, device=resolve_device(device))
    dev = mesh.device
    np.random.seed(0)

    train_ds = BEVPairDataset("train", cfg, workers=cfg.workers)
    val_ds = BEVPairDataset("val", cfg, workers=cfg.workers)
    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
    max_iter = cfg.num_epochs * steps_per_epoch

    gen = torch.Generator().manual_seed(seed)  # init, then augmentation
    state = train_lib.create_train_state(cfg, gen, max_iter, dev)
    if resume_from is not None:
        state = train_lib.load_model_checkpoint(resume_from, state)
        logger.info("Resumed training state from %s", resume_from)
    elif finetune_from is not None:
        state = train_lib.load_model_checkpoint(finetune_from, state, params_only=True)
        logger.info("Fine-tuning from %s (fresh optimizer)", finetune_from)
    replicate(mesh, state.model)

    train_data, val_data = _data_sources(cfg, train_ds, val_ds, mesh)
    train_steps = (train_lib.make_train_step(cfg, mesh), train_lib.make_train_step(cfg))
    eval_steps = (train_lib.make_eval_step(cfg, mesh), train_lib.make_eval_step(cfg))

    results_dict: Dict[str, List[float]] = defaultdict(list)
    exp_start_time = time.strftime("%Y_%m_%d_%H_%M_%S")
    results_dir = f"{cfg.model_save_dirpath}/{exp_start_time}"

    for epoch in range(cfg.num_epochs):
        logger.info("On epoch %d", epoch)
        state, train_metrics = run_epoch(
            cfg, epoch, state, train_steps, train_data, "train", gen=gen, max_batches=max_batches_per_epoch,
            mesh=mesh,
        )
        for k, v in train_metrics.items():
            results_dict[f"train_{k}"].append(v)

        if len(val_ds) > 0:
            _, val_metrics = run_epoch(cfg, epoch, state, eval_steps, val_data, "val",
                                       max_batches=max_batches_per_epoch, mesh=mesh)
        else:
            logger.warning("val split is empty; selecting ckpt on train_mAcc")
            val_metrics = train_metrics
        for k, v in val_metrics.items():
            results_dict[f"val_{k}"].append(v)

        crit = results_dict["val_mAcc"]
        is_best = epoch == 0 or crit[-1] > max(crit[:-1])
        if mesh.is_main:
            if is_best:
                train_lib.save_checkpoint(results_dir, state, epoch, crit[-1], cfg)
            save_json_file(f"{results_dir}/results-{exp_start_time}-{cfg.cfg_stem}.json", dict(results_dict))
            train_lib.save_results_json(results_dir, dict(results_dict), cfg)
        logger.info("val_mAcc history: %s", [f"{v:.3f}" for v in crit])

    return dict(results_dict)


@deterministic_algorithms()
def evaluate(
    cfg: TrainingConfig,
    ckpt_fpath: str,
    split: str,
    serialization_save_dir: str,
    max_batches: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[float, float, float]:
    """Inference over a split, serializing per-batch predictions.

    Each batch writes batch_{i}.json with {y_hat, y_true, y_hat_probs, fp0,
    fp1} (scripts/test.py:156-254): the Stage C -> Stage D contract that
    cli/run_sfm.py parses. Returns (precision, recall, mAcc), on every
    rank of a mesh; rank 0 writes the files.
    """
    mesh = make_mesh(cfg.mesh_shape, device=resolve_device(device))
    dev = mesh.device
    ds = BEVPairDataset(split, cfg, workers=cfg.workers)
    state = train_lib.create_train_state(cfg, torch.Generator().manual_seed(0), 1, dev)
    state = train_lib.load_model_checkpoint(ckpt_fpath, state)
    sharded_step, whole_step = train_lib.make_eval_step(cfg, mesh), train_lib.make_eval_step(cfg)

    pr_meter = PrecisionRecallMeter()
    sam = SegmentationAverageMeter()
    for batch_idx, (imgs, labels, tuples) in enumerate(ds.iter_batches(cfg.batch_size, shuffle=False)):
        if mesh.size > 1 and len(labels) % mesh.size == 0:
            metrics = sharded_step(state, *shard_batch(mesh, (imgs, labels)))
        else:
            metrics = whole_step(state, imgs, labels)
        y_hat = metrics["y_hat"].cpu().numpy()
        probs = metrics["probs"].cpu().numpy()
        labels_np = np.asarray(labels)
        pr_meter.update(labels_np, y_hat)
        sam.update_metrics(y_hat, labels_np, num_classes=cfg.num_ce_classes)

        n = y_hat.shape[0]
        if mesh.is_main:
            save_json_file(
                f"{serialization_save_dir}/batch_{batch_idx}.json",
                {
                    "y_hat": y_hat.tolist(),
                    "y_true": labels_np.tolist(),
                    "y_hat_probs": probs[np.arange(n), y_hat].tolist(),
                    "fp0": [t[0] for t in tuples],
                    "fp1": [t[1] for t in tuples],
                },
            )
        if max_batches is not None and batch_idx + 1 >= max_batches:
            break

    prec, rec, mAcc = pr_meter.get_metrics()
    logger.info("%s split: prec %.3f rec %.3f mAcc %.3f", split, prec, rec, mAcc)
    return prec, rec, mAcc
