'''Pixel-level metrics with Keras semantics (counterpart of
dnncancerannotator_tpu.metrics.pixel).

- a prediction counts as positive at a threshold when it is strictly
  greater (``>``); a label when it is greater than 0.5;
- ``AUC(num_thresholds=N)`` places N - 2 evenly spaced interior thresholds
  between -eps and 1 + eps; PR AUC uses Keras's careful interpolation
  (Davis & Goadrich), ROC AUC the trapezoidal rule;
- counts accumulate on the host in float64.

The counts of one batch are taken on the batch's device by sorting the
predictions of the positive and of the negative pixels and counting those
above each threshold with ``searchsorted``: exact integers, where the JAX
package's float32 matmul is exact too (below 2**24 pixels a batch).
'''

import numpy as np
import torch

from . import _memo

# per-batch confusion-count memo (see metrics/_memo.py)
_COUNT_CACHE = []


def as_tensor(x):
    '''A torch tensor as it is; anything else copied through numpy to the
    CPU.'''
    return x if torch.is_tensor(x) else torch.tensor(np.asarray(x))


def _confusion_counts(y_true, y_pred, thresholds):
    '''TP/FP/TN/FN per threshold ([T] float32 numpy) as float64 numpy.'''
    y_true = as_tensor(y_true).reshape(-1).float()
    y_pred = as_tensor(y_pred).reshape(-1).float()
    thresholds = torch.as_tensor(thresholds, device=y_pred.device)
    pos = y_true > 0.5
    counts = []
    for values in (y_pred[pos], y_pred[~pos]):
        ordered = torch.sort(values).values
        above = values.numel() - torch.searchsorted(ordered, thresholds,
                                                    right=True)
        counts.append(above.cpu().numpy().astype(np.float64))
    tp, fp = counts
    n_pos = float(pos.sum())
    n_neg = float(y_true.numel()) - n_pos
    return tp, fp, n_neg - fp, n_pos - tp


class _ConfusionMetric:
    '''Shared accumulator over thresholds.'''

    def __init__(self, thresholds=0.5, name=None):
        self._scalar = np.isscalar(thresholds)
        self.thresholds = np.reshape(np.asarray(thresholds, np.float32), [-1])
        self.name = name or type(self).__name__
        self.reset_state()

    def reset_state(self):
        n = self.thresholds.shape[0]
        self.tp = np.zeros([n], np.float64)
        self.fp = np.zeros([n], np.float64)
        self.tn = np.zeros([n], np.float64)
        self.fn = np.zeros([n], np.float64)

    def update_state(self, y_true, y_pred, sample_weight=None):
        # identical-threshold instances fed the same batch share one pass
        key = tuple(self.thresholds.tolist())
        counts = _memo.lookup(_COUNT_CACHE, key, (y_true, y_pred))
        if counts is None:
            counts = _confusion_counts(y_true, y_pred, self.thresholds)
            _memo.store(_COUNT_CACHE, key, (y_true, y_pred), counts)
        tp, fp, tn, fn = counts
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn

    def _maybe_scalar(self, x):
        x = np.asarray(x, np.float32)
        return float(x[0]) if self._scalar else x


class Precision(_ConfusionMetric):
    def result(self):
        return self._maybe_scalar(self.tp / np.maximum(self.tp + self.fp,
                                                       1e-12))


class Recall(_ConfusionMetric):
    def result(self):
        return self._maybe_scalar(self.tp / np.maximum(self.tp + self.fn,
                                                       1e-12))


class TruePositives(_ConfusionMetric):
    def result(self):
        return self._maybe_scalar(self.tp)


class FalsePositives(_ConfusionMetric):
    def result(self):
        return self._maybe_scalar(self.fp)


class TrueNegatives(_ConfusionMetric):
    def result(self):
        return self._maybe_scalar(self.tn)


class FalseNegatives(_ConfusionMetric):
    def result(self):
        return self._maybe_scalar(self.fn)


class FBetaScore:
    '''F-beta from a Precision and a Recall at the same thresholds.'''

    def __init__(self, beta, thresholds, epsilon=1e-07, name=None, **kwargs):
        if not beta > 0:
            raise ValueError(f'beta must be positive, got {beta}')
        self.beta = beta
        self.epsilon = epsilon
        self.name = name or type(self).__name__
        self.precision = Precision(thresholds)
        self.recall = Recall(thresholds)

    def update_state(self, y_true, y_pred, sample_weight=None):
        self.precision.update_state(y_true, y_pred, sample_weight)
        self.recall.update_state(y_true, y_pred, sample_weight)

    def result(self):
        p = np.asarray(self.precision.result())
        r = np.asarray(self.recall.result())
        out = (1 + self.beta ** 2) * p * r / (self.beta ** 2 * p + r +
                                              self.epsilon)
        return float(out) if out.ndim == 0 else out

    def reset_state(self):
        self.precision.reset_state()
        self.recall.reset_state()


class AUC(_ConfusionMetric):
    '''Area under the PR or ROC curve, Keras's way.'''

    def __init__(self, curve='ROC', num_thresholds=200, name=None, **kwargs):
        self.curve = curve.upper()
        self.num_thresholds = num_thresholds
        eps = 1e-7
        interior = [(i + 1) / (num_thresholds - 1)
                    for i in range(num_thresholds - 2)]
        super().__init__(thresholds=[-eps] + interior + [1.0 + eps],
                         name=name)
        self._scalar = True

    def result(self):
        tp, fp, tn, fn = self.tp, self.fp, self.tn, self.fn
        if self.curve == 'PR':
            # Keras interpolate_pr_auc (careful interpolation)
            dtp = tp[:-1] - tp[1:]
            p = tp + fp
            dp = p[:-1] - p[1:]
            prec_slope = _div_no_nan(dtp, np.maximum(dp, 0))
            intercept = tp[1:] - prec_slope * p[1:]
            safe_p_ratio = np.where(
                (p[:-1] > 0) & (p[1:] > 0),
                _div_no_nan(p[:-1], np.maximum(p[1:], 0)),
                np.ones_like(p[1:]))
            incr = _div_no_nan(
                prec_slope * (dtp + intercept * np.log(safe_p_ratio)),
                np.maximum(tp[1:] + fn[1:], 0))
            return float(np.sum(incr))
        # ROC, trapezoidal
        tpr = _div_no_nan(tp, tp + fn)
        fpr = _div_no_nan(fp, fp + tn)
        heights = (tpr[:-1] + tpr[1:]) / 2.0
        return float(np.sum((fpr[:-1] - fpr[1:]) * heights))


def _div_no_nan(a, b):
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(b != 0, a / np.where(b == 0, 1, b), 0.0)
