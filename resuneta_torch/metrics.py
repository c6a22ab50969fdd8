"""Metrics (resuneta_tpu/metrics.py).

Device side, on tensors (metrics.py:18-63): Keras' compiled metrics of the
train step, categorical accuracy and TruePositives/FalsePositives/
TrueNegatives/FalseNegatives at threshold 0.5 over every class channel,
the MCC from those counts, and a confusion matrix counted on the device.

Host side (metrics.py:76-132): sklearn semantics without sklearn,
utils.py:52-57 compute_metrics (accuracy, per-class F1, recall, precision,
all x100) and sklearn.metrics.confusion_matrix, over the sorted union of the
labels present (or an explicit list); the Amazon alarm area and a masked
threshold sweep (metrics.py:135-164).
"""

import numpy as np
import torch


def categorical_accuracy(y_true, y_pred):
    """Keras 'accuracy' for softmax outputs against one-hot labels, f32.
    torch.argmax returns the first maximal index, as the reference's
    unrolled argmax does (for finite inputs)."""
    return (y_true.argmax(-1) == y_pred.argmax(-1)).float().mean()


def binary_counts(y_true, y_pred, threshold=0.5):
    """(tp, fp, tn, fn) as f32 scalars, counted over every element."""
    p = y_pred > threshold
    t = y_true > threshold
    return tuple(c.sum().float() for c in (p & t, p & ~t, ~p & ~t, ~p & t))


def compute_mcc(tp, tn, fp, fn):
    """Matthews correlation coefficient from the counts; 0 where a marginal
    count is 0 (sklearn's semantics, not the reference's NaN). The counts
    (the epoch loop's means, or scalar tensors) become Python numbers,
    combine in double precision and round to f32 before the square root
    and the division, as jnp does with Python scalars; the f32 root is
    taken in f64, so it is correctly rounded (the CPU's f32 sqrt is not
    always)."""
    tp, tn, fp, fn = (float(v) for v in (tp, tn, fp, fn))
    num = torch.tensor(tp * tn - fp * fn, dtype=torch.float32)
    denom = torch.tensor((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn),
                         dtype=torch.float32).double().sqrt().float()
    return torch.where(denom > 0, num / denom.clamp_min(1e-38),
                       torch.zeros_like(denom))


def confusion_matrix_device(true_ids, pred_ids, num_classes):
    """cm[t, p] counts of two id tensors, on their device: one bincount of
    true * C + pred."""
    idx = true_ids.long() * num_classes + pred_ids.long()
    return torch.bincount(idx.reshape(-1), minlength=num_classes ** 2) \
        .reshape(num_classes, num_classes)


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


def alarm_area(cm_2class):
    """The Amazon alarm area (amazon_py/main.py:157-158): (TP + FP) / total
    of the binary deforestation confusion matrix."""
    total = cm_2class.sum()
    return (cm_2class[1, 1] + cm_2class[0, 1]) / max(total, 1)


def threshold_sweep_curves(thresholds, prob_map, ref_reconstructed,
                           mask_considered):
    """(recall, precision, alarm area) curves in percent of a probability
    map thresholded at each of `thresholds`, over the pixels where
    mask_considered == 1. A plain diagnostic: the reference's sweep, with
    area opening and the past-deforestation mask, is
    infer/amazon.py matrics_AA_recall, which the Amazon CLI prints."""
    sel = mask_considered == 1
    ref = (np.asarray(ref_reconstructed)[sel] == 1).astype(np.int64)
    prob = np.asarray(prob_map)[sel]
    recalls, precisions, aas = [], [], []
    for th in thresholds:
        pred = (prob >= th).astype(np.int64)
        tp = int(np.sum((pred == 1) & (ref == 1)))
        fp = int(np.sum((pred == 1) & (ref == 0)))
        fn = int(np.sum((pred == 0) & (ref == 1)))
        recalls.append(100.0 * tp / max(tp + fn, 1))
        precisions.append(100.0 * tp / max(tp + fp, 1))
        aas.append(100.0 * (tp + fp) / max(ref.size, 1))
    return np.array(recalls), np.array(precisions), np.array(aas)
