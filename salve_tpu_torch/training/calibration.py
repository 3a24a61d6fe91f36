"""Verifier confidence calibration: temperature scaling + a frozen operating point.

A copy of salve_tpu/training/calibration.py (numpy only, no JAX).

The reference deploys ONE confidence threshold (0.93) across its whole test
split (scripts/run_sfm.py:617) — its verifier's probabilities are calibrated
well enough for a single global operating point. A from-scratch verifier's
probabilities are not automatically so: round-3 sweeps found the best
reconstruction at conf 0.8 with a collapse at 0.93 (ACCURACY_r03
multi_building_heldout), which is a calibration gap, not an accuracy gap.

This module closes it the standard way (Guo et al. 2017, temperature
scaling): fit a single scalar T on the VAL split's serialized predictions
(minimizing NLL; T does not change argmax decisions), then freeze one
operating point chosen on val only. Because temperature scaling is a
monotone map of the positive-class probability, any calibrated threshold
t_cal has an exact raw-probability equivalent

    t_raw = sigmoid(T * logit(t_cal))

so the frozen point deploys through the untouched batch_{i}.json wire
format and `confidence_threshold` plumbing — no contract changes.

Wire format consumed: the Stage C->D serialized predictions
(batch_{i}.json with y_hat / y_true / y_hat_probs, scripts/test.py:72-79
parity; training/loop.py:evaluate) — y_hat_probs is p(predicted class), so
p(pos) = y_hat_probs where y_hat==1 else 1 - y_hat_probs.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, Tuple

import numpy as np

_EPS = 1e-6


def load_serialized_probs(preds_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(p_pos, y_true) from a directory of batch_{i}.json predictions."""
    p_pos, y_true = [], []
    fpaths = sorted(glob.glob(os.path.join(preds_dir, "batch_*.json")))
    if not fpaths:
        raise FileNotFoundError(f"no batch_*.json predictions in {preds_dir}")
    for fpath in fpaths:
        with open(fpath) as f:
            d = json.load(f)
        for yh, yt, p in zip(d["y_hat"], d["y_true"], d["y_hat_probs"]):
            p_pos.append(p if yh == 1 else 1.0 - p)
            y_true.append(yt)
    return np.asarray(p_pos, dtype=np.float64), np.asarray(y_true, dtype=np.int64)


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p, _EPS, 1.0 - _EPS)
    return np.log(p) - np.log1p(-p)


def _nll(z: np.ndarray, y: np.ndarray, temperature: float) -> float:
    """Mean binary NLL of sigmoid(z / T)."""
    zt = z / temperature
    # log(1 + e^-|z|) stable form: NLL = softplus(-zt) for y=1, softplus(zt) for y=0.
    s = np.where(y == 1, -zt, zt)
    return float(np.mean(np.logaddexp(0.0, s)))


def fit_temperature(p_pos: np.ndarray, y_true: np.ndarray) -> float:
    """Scalar temperature minimizing val NLL (golden-section on log T).

    T > 1 softens over-confident probabilities; T < 1 sharpens. Monotone,
    so accuracy/precision/recall at matched operating points are unchanged.
    """
    z = _logit(p_pos)
    lo, hi = math.log(0.05), math.log(20.0)
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = _nll(z, y_true, math.exp(c)), _nll(z, y_true, math.exp(d))
    for _ in range(60):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = _nll(z, y_true, math.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = _nll(z, y_true, math.exp(d))
    return float(math.exp((a + b) / 2.0))


def apply_temperature(p_pos: np.ndarray, temperature: float) -> np.ndarray:
    """Calibrated p(pos) = sigmoid(logit(p) / T)."""
    z = _logit(np.asarray(p_pos)) / temperature
    return 1.0 / (1.0 + np.exp(-z))


def raw_threshold_for_calibrated(t_cal: float, temperature: float) -> float:
    """The raw-probability threshold equivalent to calibrated threshold t_cal.

    sigmoid(logit(p)/T) >= t_cal  <=>  p >= sigmoid(T * logit(t_cal)).
    """
    z = temperature * float(_logit(np.asarray([t_cal]))[0])
    return float(1.0 / (1.0 + math.exp(-z)))


def expected_calibration_error(
    p_pos: np.ndarray, y_true: np.ndarray, num_bins: int = 10
) -> float:
    """Standard ECE over equal-width confidence bins of p(pos)."""
    p = np.asarray(p_pos, dtype=np.float64)
    y = np.asarray(y_true, dtype=np.float64)
    edges = np.linspace(0.0, 1.0, num_bins + 1)
    ece, n = 0.0, len(p)
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (p >= lo) & (p < hi) if hi < 1.0 else (p >= lo) & (p <= hi)
        if not sel.any():
            continue
        conf, acc = p[sel].mean(), y[sel].mean()
        ece += (sel.sum() / n) * abs(acc - conf)
    return float(ece)


def sweep_mAcc(
    p_cal: np.ndarray, y_true: np.ndarray, grid: np.ndarray | None = None
) -> Tuple[float, Dict[str, float]]:
    """Best calibrated threshold by balanced accuracy over a grid.

    Verifier-level fallback rule when no val reconstruction sweep is run;
    mAcc matches the checkpoint-selection metric (scripts/train.py:84).
    """
    if grid is None:
        grid = np.arange(0.5, 0.991, 0.01)
    y = np.asarray(y_true)
    npos = max(int((y == 1).sum()), 1)
    nneg = max(int((y == 0).sum()), 1)
    best_t, best_macc, table = 0.5, -1.0, {}
    for t in grid:
        pred = p_cal >= t
        tp = int((pred & (y == 1)).sum())
        tn = int((~pred & (y == 0)).sum())
        macc = 0.5 * (tp / npos + tn / nneg)
        table[f"{t:.2f}"] = round(macc, 4)
        if macc > best_macc:
            best_t, best_macc = float(t), macc
    return best_t, {"best_mAcc": round(best_macc, 4), "sweep": table}


def fit_from_preds(preds_dir: str) -> Dict:
    """Fit temperature + a val-chosen calibrated threshold from serialized preds.

    Returns a JSON-ready dict: temperature, ECE before/after, the chosen
    calibrated threshold (max val mAcc), and its frozen raw equivalent for
    the `confidence_threshold` plumbing. Callers with val buildings on disk
    should prefer choosing the threshold by a val reconstruction sweep and
    only take `temperature` / ECE from here.
    """
    p_pos, y_true = load_serialized_probs(preds_dir)
    temperature = fit_temperature(p_pos, y_true)
    p_cal = apply_temperature(p_pos, temperature)
    t_cal, macc_info = sweep_mAcc(p_cal, y_true)
    return {
        "temperature": round(temperature, 4),
        "num_val_pairs": int(len(y_true)),
        "ece_raw": round(expected_calibration_error(p_pos, y_true), 4),
        "ece_calibrated": round(expected_calibration_error(p_cal, y_true), 4),
        "threshold_calibrated": t_cal,
        "threshold_raw_equivalent": round(
            raw_threshold_for_calibrated(t_cal, temperature), 4
        ),
        "val_mAcc_at_threshold": macc_info["best_mAcc"],
    }
