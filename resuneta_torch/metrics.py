"""Host-side evaluation metrics (resuneta_tpu/metrics.py:76-132).

sklearn semantics without sklearn: utils.py:52-57 compute_metrics
(accuracy, per-class F1, recall, precision, all x100) and
sklearn.metrics.confusion_matrix, over the sorted union of the labels
present (or an explicit list).
"""

import numpy as np


def confusion_matrix(true_labels, predicted_labels, labels=None):
    """cm[t, p] counts over the sorted label union (or `labels`)."""
    t = np.asarray(true_labels).ravel()
    p = np.asarray(predicted_labels).ravel()
    if labels is None:
        labels = np.unique(np.concatenate([np.unique(t), np.unique(p)]))
    labels = np.asarray(labels)
    lut = {v: i for i, v in enumerate(labels.tolist())}
    n = len(labels)
    ti = np.fromiter((lut[v] for v in t.tolist()), dtype=np.int64, count=len(t))
    pi = np.fromiter((lut[v] for v in p.tolist()), dtype=np.int64, count=len(p))
    return np.bincount(ti * n + pi, minlength=n * n).reshape(n, n)


def _prf_from_cm(cm):
    diag = np.diag(cm).astype(np.float64)
    pred_sum = cm.sum(axis=0).astype(np.float64)
    true_sum = cm.sum(axis=1).astype(np.float64)
    precision = np.divide(diag, pred_sum, out=np.zeros_like(diag),
                          where=pred_sum > 0)
    recall = np.divide(diag, true_sum, out=np.zeros_like(diag),
                       where=true_sum > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(diag),
                   where=denom > 0)
    return precision, recall, f1


def compute_metrics(true_labels, predicted_labels, labels=None):
    """(accuracy, f1_per_class, recall_per_class, precision_per_class), x100."""
    cm = confusion_matrix(true_labels, predicted_labels, labels)
    accuracy = 100.0 * np.trace(cm) / max(cm.sum(), 1)
    precision, recall, f1 = _prf_from_cm(cm)
    return accuracy, 100.0 * f1, 100.0 * recall, 100.0 * precision


def iou_per_class(cm):
    """diag / (row + col - diag); a class absent from truth and prediction
    gets 0 (sklearn jaccard_score's zero_division=0)."""
    cm = np.asarray(cm, np.float64)
    diag = np.diag(cm)
    union = cm.sum(axis=0) + cm.sum(axis=1) - diag
    return np.divide(diag, union, out=np.zeros_like(diag), where=union > 0)


def mean_iou(true_labels, predicted_labels, labels=None):
    """(mIoU, per-class IoU array)."""
    ious = iou_per_class(confusion_matrix(true_labels, predicted_labels,
                                          labels))
    return float(ious.mean()), ious
