"""Classification metrics: accuracy / precision / recall / F1 / ROC-AUC.

The counterpart of ``gnn_fpga_tpu/train/metrics.py``, in numpy alone (a
copy, so that the port imports nothing of the JAX package).  Optional
masks keep padded edges out of the scores; ties in the predictions are
ranked as sklearn's ``roc_auc_score`` ranks them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _flatten(pred, target, mask):
    pred = np.asarray(pred, dtype=np.float64).ravel()
    target = np.asarray(target, dtype=np.float64).ravel()
    if mask is not None:
        m = np.asarray(mask, dtype=bool).ravel()
        pred, target = pred[m], target[m]
    return pred, target


def binary_metrics(
    pred: np.ndarray,
    target: np.ndarray,
    mask: Optional[np.ndarray] = None,
    threshold: float = 0.5,
) -> Dict[str, float]:
    """accuracy / precision / recall / f1 at ``threshold`` plus ROC AUC."""
    pred, target = _flatten(pred, target, mask)
    p = pred > threshold
    t = target > 0.5
    tp = float(np.sum(p & t))
    fp = float(np.sum(p & ~t))
    fn = float(np.sum(~p & t))
    acc = float(np.mean(p == t)) if len(p) else 0.0
    prec = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    rec = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
    return {
        "accuracy": acc,
        "precision": prec,
        "recall": rec,
        "f1": f1,
        "auc": roc_auc(pred, target),
    }


def roc_auc(pred: np.ndarray, target: np.ndarray,
            mask: Optional[np.ndarray] = None) -> float:
    """ROC AUC via the rank-statistic (Mann-Whitney U) formulation, with
    proper tie handling — equivalent to sklearn.roc_auc_score."""
    pred, target = _flatten(pred, target, mask)
    t = target > 0.5
    n_pos = int(t.sum())
    n_neg = int((~t).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(pred, kind="mergesort")
    sorted_pred = pred[order]
    # Average ranks over tie groups, vectorised: each distinct value's rank
    # is the mean of its (1-based) positions start+1 .. end in sorted order.
    _, inverse, counts = np.unique(sorted_pred, return_inverse=True,
                                   return_counts=True)
    ends = np.cumsum(counts).astype(np.float64)
    starts = ends - counts
    avg_rank = 0.5 * (starts + 1 + ends)
    ranks = np.empty(len(pred), dtype=np.float64)
    ranks[order] = avg_rank[inverse]
    return float((ranks[t].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def roc_curve(pred, target, mask=None):
    """(fpr, tpr, thresholds) — for the reference's ``makeROC`` plots."""
    pred, target = _flatten(pred, target, mask)
    order = np.argsort(-pred, kind="mergesort")
    pred, target = pred[order], target[order] > 0.5
    distinct = np.where(np.diff(pred))[0]
    idx = np.r_[distinct, len(pred) - 1]
    tps = np.cumsum(target)[idx]
    fps = np.cumsum(~target)[idx]
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return np.r_[0.0, fpr], np.r_[0.0, tpr], np.r_[pred[0] + 1, pred[idx]]
