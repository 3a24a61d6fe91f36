"""Streaming metric meters (parity: salve/utils/avg_meter.py, scripts/test.py:30).

A copy of salve_tpu/training/meters.py (no JAX).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from salve_tpu_torch.utils.pr_utils import compute_precision_recall


class AverageMeter:
    """Streaming average (salve/utils/avg_meter.py:16)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1) -> None:
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count


def intersection_and_union(
    pred: np.ndarray, target: np.ndarray, num_classes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class intersection/union/target histogram counts."""
    pred = pred.reshape(-1)
    target = target.reshape(-1)
    intersection = pred[pred == target]
    area_inter = np.histogram(intersection, bins=np.arange(num_classes + 1))[0]
    area_pred = np.histogram(pred, bins=np.arange(num_classes + 1))[0]
    area_target = np.histogram(target, bins=np.arange(num_classes + 1))[0]
    area_union = area_pred + area_target - area_inter
    return area_inter, area_union, area_target


class SegmentationAverageMeter(AverageMeter):
    """Per-class accuracy/IoU meter (salve/utils/avg_meter.py:35)."""

    def __init__(self) -> None:
        self.intersection_meter = AverageMeter()
        self.union_meter = AverageMeter()
        self.target_meter = AverageMeter()
        self.accuracy = 0.0

    def update_metrics(self, pred: np.ndarray, target: np.ndarray, num_classes: int) -> None:
        inter, union, tgt = intersection_and_union(pred, target, num_classes)
        self.intersection_meter.update(inter)
        self.union_meter.update(union)
        self.target_meter.update(tgt)
        self.accuracy = sum(self.intersection_meter.val) / (sum(self.target_meter.val) + 1e-10)

    # Alias for reference-API parity.
    update_metrics_cpu = update_metrics

    def get_metrics(self):
        iou_class = self.intersection_meter.sum / (self.union_meter.sum + 1e-10)
        accuracy_class = self.intersection_meter.sum / (self.target_meter.sum + 1e-10)
        mIoU = float(np.mean(iou_class))
        mAcc = float(np.mean(accuracy_class))
        allAcc = sum(self.intersection_meter.sum) / (sum(self.target_meter.sum) + 1e-10)
        return iou_class, accuracy_class, mIoU, mAcc, allAcc


class PrecisionRecallMeter:
    """Accumulates predictions across batches for P/R (scripts/test.py:30)."""

    def __init__(self) -> None:
        self.all_y_true = np.zeros(0, dtype=np.int64)
        self.all_y_hat = np.zeros(0, dtype=np.int64)

    def update(self, y_true: np.ndarray, y_hat: np.ndarray) -> None:
        self.all_y_true = np.concatenate([self.all_y_true, y_true.reshape(-1)])
        self.all_y_hat = np.concatenate([self.all_y_hat, y_hat.reshape(-1)])

    def get_metrics(self) -> Tuple[float, float, float]:
        return compute_precision_recall(self.all_y_true, self.all_y_hat)
