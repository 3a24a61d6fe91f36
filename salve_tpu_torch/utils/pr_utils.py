"""Precision/recall computation utilities (parity: salve/utils/pr_utils.py).

A copy of salve_tpu/utils/pr_utils.py (no JAX).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EPS = 1e-7


def assign_tp_fp_fn_tn(
    y_true: np.ndarray, y_pred: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Boolean masks for TP/FP/FN/TN, with class 1 as positive."""
    is_TP = (y_true == y_pred) & (y_pred == 1)
    is_FP = (y_true != y_pred) & (y_pred == 1)
    is_FN = (y_true != y_pred) & (y_pred == 0)
    is_TN = (y_true == y_pred) & (y_pred == 0)
    return is_TP, is_FP, is_FN, is_TN


def compute_tp_fp_fn_tn_counts(
    y_true: np.ndarray, y_pred: np.ndarray
) -> Tuple[int, int, int, int]:
    """Counts of TP/FP/FN/TN."""
    is_TP, is_FP, is_FN, is_TN = assign_tp_fp_fn_tn(y_true, y_pred)
    return int(is_TP.sum()), int(is_FP.sum()), int(is_FN.sum()), int(is_TN.sum())


def compute_precision_recall(
    y_true: np.ndarray, y_pred: np.ndarray
) -> Tuple[float, float, float]:
    """Precision, recall, and mean accuracy (class 1 positive).

    mAcc is the mean of the row-normalized confusion-matrix diagonal
    (parity: salve/utils/pr_utils.py:56-105).
    """
    TP, FP, FN, TN = compute_tp_fp_fn_tn_counts(y_true, y_pred)

    C = np.zeros((2, 2))
    C[0, 0], C[0, 1] = TP, FN
    C[1, 0], C[1, 1] = FP, TN
    C[0] /= C[0].sum() + EPS
    C[1] /= C[1].sum() + EPS

    mAcc = float(np.mean(np.diag(C)))
    prec = TP / (TP + FP + EPS)
    rec = TP / (TP + FN + EPS)
    return float(prec), float(rec), mAcc


def plot_precision_recall_curve_sklearn(y_true: np.ndarray, y_prob: np.ndarray):
    """PR curve points via sklearn (kept host-side; eval-plot only)."""
    from sklearn.metrics import precision_recall_curve

    prec, rec, thresholds = precision_recall_curve(y_true, y_prob)
    return prec, rec, thresholds
