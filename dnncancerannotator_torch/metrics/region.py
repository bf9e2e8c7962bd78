'''Region-based (connected-component, IoU-matched) detection metrics
(counterpart of dnncancerannotator_tpu.metrics.region).

For each image of a batch, and each of T prediction thresholds:
- label and prediction are first resized (bilinear) by ``resize_factor``,
  to ``int(float16(h) * float16(resize_factor))`` as the JAX package does;
- the label is binarized at > 0.5 and labelled into 4-connected regions;
- the prediction is opened once in grayscale with a flat
  ``morph_filter_size`` window (which commutes with thresholding), then
  thresholded with ``>=`` and each thresholded mask labelled;
- a label region and a pred region match when their IoU is > IoU_threshold
  (strict). tp counts label regions matched by some pred region (the label
  side), fn the rest; tp_pred counts pred regions that match some label
  region (the pred side), fp the rest. Precision uses the pred side, the
  confusion matrix the label side, as in the reference.

The intersections are counted from the (label id, pred id) pairs of the
pixels that lie in both, with ``torch.unique``: exact integers, with no
one-hot [T, H*W, regions] tensors, so memory does not grow with the region
capacity. The capacities still decide the counts as in the JAX package:
regions with an id above ``max_label_regions`` / ``max_pred_regions`` are
never matched. A metric raises its capacities (doubling, up to
``MAX_REGION_CAP``) until the batch's true region counts fit, and keeps the
raised capacities for later batches; beyond the ceiling the extra regions
count as unmatched, with a warning.

Connected components run through ops/cca.py: the CUDA kernel on the card,
the plain fixed point on the CPU.
'''

import logging

import numpy as np
import torch

from . import _memo
from .pixel import as_tensor
from ..ops import image as image_ops
from ..ops.cca import connected_components_batch
from ..ops.morphology import morph_open

logger = logging.getLogger(__name__)

# thresholded pixels labelled at once; bounds the int64 temporaries of one
# chunk of images to a few hundred MB
PIXEL_BUDGET = 1 << 25


def _resized(y_true, y_pred, resize_factor):
    '''[B, H, W] float32 label and prediction on the prediction's device,
    resized when ``resize_factor`` is not 1.'''
    y_pred = as_tensor(y_pred).float()
    y_true = as_tensor(y_true).float().to(y_pred.device)
    if y_pred.dim() == y_true.dim() + 1:
        y_pred = y_pred.squeeze(-1)
    if resize_factor != 1.0:
        h, w = y_true.shape[1], y_true.shape[2]
        th = int(np.float16(h) * np.float16(resize_factor))
        tw = int(np.float16(w) * np.float16(resize_factor))
        stacked = image_ops.resize_bilinear(
            torch.stack([y_true, y_pred], dim=-1), th, tw)
        y_true, y_pred = stacked[..., 0], stacked[..., 1]
    return y_true, y_pred


class RegionStats:
    '''What the region counts of a batch depend on, for any capacities:
    the true region counts ``n_lab`` [B] and ``n_pred`` [B, T], and every
    (label region, pred region) pair that overlaps, as 1-D tensors: ``bt``
    (b * T + t), ids ``l`` and ``p`` (1-based), ``inter``, ``area_l`` and
    ``area_p`` in pixels.'''

    def __init__(self, y_true, y_pred, thresholds, resize_factor=1.0,
                 morph_filter_size=5):
        y_true, y_pred = _resized(y_true, y_pred, resize_factor)
        b, h, w = y_true.shape
        thresholds = torch.as_tensor(
            np.reshape(np.asarray(thresholds, np.float32), [-1]),
            device=y_pred.device)
        n_thr = thresholds.numel()
        chunk = max(1, PIXEL_BUDGET // (n_thr * h * w))
        parts = [self._chunk(y_true[i:i + chunk], y_pred[i:i + chunk],
                             thresholds, morph_filter_size, i * n_thr)
                 for i in range(0, b, chunk)]
        self.shape = (b, n_thr)
        (self.n_lab, self.n_pred, self.bt, self.l, self.p, self.inter,
         self.area_l, self.area_p) = [torch.cat(column)
                                      for column in zip(*parts)]
        self.n_pred = self.n_pred.reshape(b, n_thr)

    @staticmethod
    def _chunk(y_true, y_pred, thresholds, morph_filter_size, bt_offset):
        nb, h, w = y_true.shape
        n_thr, hw = thresholds.numel(), h * w
        lab, n_lab = connected_components_batch(y_true > 0.5)
        opened = morph_open(y_pred, morph_filter_size)
        masks = opened[:, None] >= thresholds[None, :, None, None]
        pred, n_pred = connected_components_batch(
            masks.reshape(nb * n_thr, h, w))
        lab = lab.reshape(nb, 1, hw).long()
        pred = pred.reshape(nb, n_thr, hw).long()
        l1 = int(n_lab.max()) + 1
        p1 = int(n_pred.max()) + 1
        dev = lab.device
        image = torch.arange(nb, device=dev).reshape(nb, 1, 1)
        bt = torch.arange(nb * n_thr, device=dev).reshape(nb, n_thr, 1)
        area_l = torch.bincount((image * l1 + lab).reshape(-1),
                                minlength=nb * l1)
        area_p = torch.bincount((bt * p1 + pred).reshape(-1),
                                minlength=nb * n_thr * p1)
        both = (lab > 0) & (pred > 0)
        full = (nb, n_thr, hw)
        keys = (bt.expand(full)[both] * l1 + lab.expand(full)[both]) * p1 \
            + pred[both]
        keys, inter = torch.unique(keys, return_counts=True)
        p = keys % p1
        l = keys // p1 % l1
        bt_k = keys // (p1 * l1)
        return (n_lab.long(), n_pred.long(), bt_k + bt_offset, l, p, inter,
                area_l[bt_k // n_thr * l1 + l], area_p[bt_k * p1 + p])

    def counts(self, max_label_regions, max_pred_regions, iou_threshold):
        '''(tp_label, fn, tp_pred, fp) [B, T] and (n_lab [B], n_pred
        [B, T]) as int64 numpy, matching only regions with ids within the
        capacities.'''
        b, n_thr = self.shape
        inter = self.inter.float()
        union = self.area_l.float() + self.area_p.float() - inter
        iou = torch.where(union > 0, inter / union.clamp(min=1.0), 0.0)
        hit = ((self.l <= max_label_regions) & (self.p <= max_pred_regions)
               & (iou > torch.tensor(iou_threshold, dtype=torch.float32)))
        tp = _distinct_per_bt(self.bt[hit], self.l[hit], b * n_thr)
        tp_pred = _distinct_per_bt(self.bt[hit], self.p[hit], b * n_thr)
        n_lab = self.n_lab.cpu().numpy()
        n_pred = self.n_pred.cpu().numpy()
        tp = tp.reshape(b, n_thr)
        tp_pred = tp_pred.reshape(b, n_thr)
        return tp, n_lab[:, None] - tp, tp_pred, n_pred - tp_pred, n_lab, \
            n_pred


def _distinct_per_bt(bt, ids, n):
    '''Number of distinct ids for each bt in 0..n-1, as int64 numpy.'''
    if not bt.numel():
        return np.zeros(n, np.int64)
    width = int(ids.max()) + 1
    keys = torch.unique(bt * width + ids)
    return torch.bincount(keys // width, minlength=n).cpu().numpy()


def region_confusion_batch(y_true, y_pred, thresholds, *, iou_threshold=0.30,
                           resize_factor=1.0, morph_filter_size=5,
                           max_label_regions=32, max_pred_regions=64):
    '''Per-image region counts of a batch: y_true [B, H, W], y_pred
    [B, H, W] or [B, H, W, 1], thresholds [T]. Returns (tp_label, fn,
    tp_pred, fp) [B, T] and the true region counts n_lab [B], n_pred
    [B, T], which may exceed the capacities.'''
    return RegionStats(y_true, y_pred, thresholds, resize_factor,
                       morph_filter_size).counts(
        max_label_regions, max_pred_regions, iou_threshold)


# per-batch raw-count memo (see metrics/_memo.py and _RegionBasedMetric._raw)
_RAW_CACHE = []


def _escalated(cap, need, ceiling):
    while cap < min(need, ceiling):
        cap *= 2
    return cap


class _RegionBasedMetric:
    '''Base of the region metrics (the reference's _RegionBasedMetric API).'''

    MAX_REGION_CAP = 2048  # escalation ceiling; beyond it, truncate and warn

    def __init__(self, thresholds, IoU_threshold=0.30, epsilon=1e-07,
                 resize_factor=1.0, morph_filter_size=5, name=None,
                 max_label_regions=32, max_pred_regions=64, **kwargs):
        thresholds = np.reshape(np.asarray(thresholds, np.float32), [-1])
        if not np.all(thresholds >= 0):
            raise ValueError(f'thresholds must be >= 0, got {thresholds}')
        self.thresholds = thresholds
        self.n_thresholds = thresholds.shape[0]
        self.IoU_threshold = IoU_threshold
        self.epsilon = epsilon
        self.resize_factor = resize_factor
        self.morph_filter_size = morph_filter_size
        self.max_label_regions = max_label_regions
        self.max_pred_regions = max_pred_regions
        self.name = name or type(self).__name__
        self._zeros = np.zeros([self.n_thresholds], np.int64)
        self.reset_state()

    def _param_key(self):
        '''Everything the counts depend on; the capacities are left out
        because escalation makes the counts independent of where they
        start.'''
        return (tuple(self.thresholds.tolist()), self.IoU_threshold,
                self.resize_factor, self.morph_filter_size)

    def _raw(self, y_true, y_pred):
        '''Region counts, shared by the metric instances with the same
        parameters that are fed the same batch objects.'''
        key = self._param_key()
        hit = _memo.lookup(_RAW_CACHE, key, (y_true, y_pred))
        if hit is not None:
            return hit
        out = self._raw_uncached(y_true, y_pred)
        _memo.store(_RAW_CACHE, key, (y_true, y_pred), out)
        return out

    def _raw_uncached(self, y_true, y_pred):
        '''(tp, fn, tp_pred, fp) [B, T] at capacities raised until the
        batch's regions fit, or to the ceiling.'''
        stats = RegionStats(y_true, y_pred, self.thresholds,
                            self.resize_factor, self.morph_filter_size)
        need_l = int(stats.n_lab.max()) if stats.n_lab.numel() else 0
        need_p = int(stats.n_pred.max()) if stats.n_pred.numel() else 0
        lcap, pcap = self.max_label_regions, self.max_pred_regions
        if need_l > lcap or need_p > pcap:
            lcap = _escalated(lcap, need_l, self.MAX_REGION_CAP)
            pcap = _escalated(pcap, need_p, self.MAX_REGION_CAP)
            if need_l > lcap or need_p > pcap:
                logger.warning(
                    'region counts (%d labels, %d preds) exceed the %d '
                    'escalation ceiling; overflow regions counted as '
                    'undetected', need_l, need_p, self.MAX_REGION_CAP)
            else:
                logger.info('region capacity exceeded (%d labels / %d '
                            'preds); counting at caps (%d, %d)', need_l,
                            need_p, lcap, pcap)
            self.max_label_regions, self.max_pred_regions = lcap, pcap
        return stats.counts(lcap, pcap, self.IoU_threshold)[:4]

    def get_tp_fn_fp(self, y_true, y_pred, sample_weight=None,
                     return_raw=False):
        _no_weights(sample_weight)
        tp, fn, _, fp = self._raw(y_true, y_pred)
        if return_raw:
            return tp, fn, fp
        return tp.sum(0), fn.sum(0), fp.sum(0)

    def get_tp_fn(self, y_true, y_pred, sample_weight=None):
        _no_weights(sample_weight)
        tp, fn, _, _ = self._raw(y_true, y_pred)
        return tp.sum(0), fn.sum(0)

    def get_tp_fp(self, y_true, y_pred, sample_weight=None):
        '''Pred-side counts: tp counts pred regions that match a label.'''
        _no_weights(sample_weight)
        _, _, tp_pred, fp = self._raw(y_true, y_pred)
        return tp_pred.sum(0), fp.sum(0)

    def reset_state(self):
        self.tp_count = self._zeros.copy()
        self.fn_count = self._zeros.copy()
        self.fp_count = self._zeros.copy()
        self.tp_pred_count = self._zeros.copy()

    def update_state(self, y_true, y_pred, sample_weight=None):
        _no_weights(sample_weight)
        self.update_state_raw(y_true, y_pred)

    def update_state_raw(self, y_true, y_pred):
        '''Accumulate, and return the per-image (tp, fn, fp) [B, T] counts
        (for the Visualizer's casewise rows).'''
        tp, fn, tp_pred, fp = self._raw(y_true, y_pred)
        self.tp_count = self.tp_count + tp.sum(0)
        self.fn_count = self.fn_count + fn.sum(0)
        self.fp_count = self.fp_count + fp.sum(0)
        self.tp_pred_count = self.tp_pred_count + tp_pred.sum(0)
        return tp, fn, fp

    def get_config(self):
        return dict(thresholds=self.thresholds.tolist(),
                    IoU_threshold=self.IoU_threshold, epsilon=self.epsilon,
                    resize_factor=self.resize_factor)

    @staticmethod
    def _squeeze(x):
        x = np.squeeze(np.asarray(x))
        return x if x.ndim else x.reshape(())


def _no_weights(sample_weight):
    if sample_weight is not None:
        raise NotImplementedError('region metrics take no sample_weight')


class RegionBasedRecall(_RegionBasedMetric):
    def result(self):
        r = self.tp_count.astype(np.float32) / (
            (self.tp_count + self.fn_count).astype(np.float32) + self.epsilon)
        return self._squeeze(r)


class RegionBasedPrecision(_RegionBasedMetric):
    '''Precision over the pred-side tp.'''

    def result(self):
        r = self.tp_pred_count.astype(np.float32) / (
            (self.tp_pred_count + self.fp_count).astype(np.float32)
            + self.epsilon)
        return self._squeeze(r)


class RegionBasedTruePositives(_RegionBasedMetric):
    def result(self):
        return self._squeeze(self.tp_count)


class RegionBasedFalsePositives(_RegionBasedMetric):
    def result(self):
        return self._squeeze(self.fp_count)


class RegionBasedFalseNegatives(_RegionBasedMetric):
    def result(self):
        return self._squeeze(self.fn_count)


class RegionBasedConfusionMatrix(_RegionBasedMetric):
    '''Label-side tp / fn / fp; ``result_dict`` gives the counts, recall
    and (label-side) precision per threshold.'''

    def result(self):
        return np.nan

    def result_dict(self):
        tp = self.tp_count.astype(np.float32)
        recall = tp / (tp + self.fn_count.astype(np.float32) + self.epsilon)
        precision = tp / (tp + self.fp_count.astype(np.float32) +
                          self.epsilon)
        return {
            'true_positive_counts': self._squeeze(self.tp_count),
            'false_positive_counts': self._squeeze(self.fp_count),
            'false_negative_counts': self._squeeze(self.fn_count),
            'recall': self._squeeze(recall),
            'precision': self._squeeze(precision),
        }


class RegionBasedFBetaScore:
    '''F-beta from a RegionBasedPrecision and a RegionBasedRecall.'''

    def __init__(self, beta, thresholds, IoU_threshold=0.30, epsilon=1e-07,
                 resize_factor=1.0, name=None, **kwargs):
        if not beta > 0:
            raise ValueError(f'beta must be positive, got {beta}')
        self.beta = beta
        self.epsilon = epsilon
        self.name = name or type(self).__name__
        self.precision = RegionBasedPrecision(
            thresholds=thresholds, IoU_threshold=IoU_threshold,
            epsilon=epsilon, resize_factor=resize_factor, **kwargs)
        self.recall = RegionBasedRecall(
            thresholds=thresholds, IoU_threshold=IoU_threshold,
            epsilon=epsilon, resize_factor=resize_factor, **kwargs)

    def update_state(self, y_true, y_pred, sample_weight=None):
        self.precision.update_state(y_true, y_pred, sample_weight)
        self.recall.update_state(y_true, y_pred, sample_weight)

    def result(self):
        p = self.precision.result()
        r = self.recall.result()
        return (1 + self.beta ** 2) * p * r / (
            self.beta ** 2 * p + r + self.epsilon)

    def reset_state(self):
        self.precision.reset_state()
        self.recall.reset_state()
