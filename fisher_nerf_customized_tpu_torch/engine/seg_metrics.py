"""Segmentation metrics for map prediction: pixel accuracy, the
confusion matrix, per-class IoU and F1 and their means over predicted
occupancy grids (the reference's metrics.py; numpy, as in the JAX
package's engine/seg_metrics.py)."""
from __future__ import annotations

import numpy as np


def pixel_accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    pred, target = np.asarray(pred), np.asarray(target)
    return float((pred == target).mean())


def confusion_matrix(pred, target, n_classes: int) -> np.ndarray:
    """(n_classes, n_classes) counts: row = target class, column =
    predicted class."""
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    idx = target * n_classes + pred
    cm = np.bincount(idx, minlength=n_classes * n_classes)
    return cm.reshape(n_classes, n_classes)


def iou_per_class(pred, target, n_classes: int) -> np.ndarray:
    """Intersection over union per class; NaN for a class absent from both."""
    cm = confusion_matrix(pred, target, n_classes).astype(np.float64)
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    return np.where(union > 0, inter / np.maximum(union, 1), np.nan)


def mean_iou(pred, target, n_classes: int) -> float:
    return float(np.nanmean(iou_per_class(pred, target, n_classes)))


def f1_per_class(pred, target, n_classes: int) -> np.ndarray:
    cm = confusion_matrix(pred, target, n_classes).astype(np.float64)
    tp = np.diag(cm)
    prec = tp / np.maximum(cm.sum(0), 1)
    rec = tp / np.maximum(cm.sum(1), 1)
    denom = prec + rec
    return np.where(denom > 0, 2 * prec * rec / np.maximum(denom, 1e-12), 0.0)


def mean_f1(pred, target, n_classes: int) -> float:
    return float(f1_per_class(pred, target, n_classes).mean())
