'''The port's metrics against the JAX package's, fed the same numpy arrays:
grayscale opening (exact), bilinear resize (<= 1e-6 absolute on values in
[0, 1]), the pixel metrics (<= 1e-6 relative: the counts are exact integers
on both sides, the rest is the same float64 host math), the region counts
(exact, at T = 1 and T = 25 and resize 1.0 and 0.5), the capacity
escalation and its persistence, the ceiling, and the per-batch memo.
'''

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from dnncancerannotator_tpu import metrics as jax_metrics
from dnncancerannotator_tpu.metrics import region as jax_region
from dnncancerannotator_tpu.ops import image as jax_image
from dnncancerannotator_tpu.ops import morphology as jax_morphology
from dnncancerannotator_torch import metrics
from dnncancerannotator_torch.metrics import region
from dnncancerannotator_torch.ops import image, morphology
from dnncancerannotator_torch.utils import config as config_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(b=6, size=64, seed=0):
    '''Labels of dilated random blobs and predictions that mostly follow
    them, with noise.'''
    rng = np.random.default_rng(seed)
    seeds = rng.random((b, size, size)) > 0.995
    y = np.stack([ndimage.binary_dilation(s, iterations=6) for s in seeds])
    y = y.astype(np.float32)
    p = np.clip(0.75 * y + 0.45 * rng.random((b, size, size)), 0, 1)
    return y, p.astype(np.float32)[..., None]


@pytest.mark.parametrize('size', [1, 3, 4, 5])
def test_morph_open_matches_jax(size):
    x = np.random.default_rng(size).random((3, 19, 26)).astype(np.float32)
    got = morphology.morph_open(torch.from_numpy(x), size)
    want = jax_morphology.morph_open(jnp.asarray(x), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('shape,target', [((2, 37, 50, 2), (18, 25)),
                                          ((1, 64, 64, 1), (32, 32)),
                                          ((2, 20, 30, 3), (41, 17))])
def test_resize_bilinear_matches_jax(shape, target):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    got = image.resize_bilinear(torch.from_numpy(x), *target)
    want = jax_image.resize_bilinear(jnp.asarray(x), *target)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_region_resize_keeps_the_float16_target_size():
    '''int(float16(90) * float16(0.7)) is 63, where int(90 * 0.7) is 62.'''
    y, p = _batch(2, 90)
    got_y, got_p = region._resized(y, p, 0.7)
    assert got_y.shape == got_p.shape == (2, 63, 63)
    want = jax_image.resize_bilinear(
        jnp.stack([jnp.asarray(y), jnp.asarray(p[..., 0])], -1), 63, 63)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want)[..., 1],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize('spec', [
    {'Precision': {'thresholds': 0.8}},
    {'Recall': {'thresholds': [0.2, 0.5, 0.8]}},
    {'FBetaScore': {'thresholds': 0.8, 'beta': 2.0}},
    {'AUC': {'curve': 'PR', 'num_thresholds': 150}},
    {'AUC': {'curve': 'ROC', 'num_thresholds': 150}},
    {'TrueNegatives': {'thresholds': [0.0, 0.5, 1.0]}},
    {'FalseNegatives': {'thresholds': 0.5}},
])
def test_pixel_metrics_match_jax(spec):
    got, want = metrics.solve_metric(spec), jax_metrics.solve_metric(spec)
    for seed in range(3):   # accumulated over batches
        y, p = _batch(seed=seed)
        got.update_state(torch.from_numpy(y), torch.from_numpy(p))
        want.update_state(y, p)
    np.testing.assert_allclose(np.asarray(got.result()),
                               np.asarray(want.result()), rtol=1e-6)


@pytest.mark.parametrize('n_thresholds', [1, 25])
@pytest.mark.parametrize('resize_factor', [1.0, 0.5])
def test_region_confusion_batch_matches_jax(n_thresholds, resize_factor):
    y, p = _batch()
    thresholds = np.linspace(0.05, 0.95, n_thresholds).astype(np.float32) \
        if n_thresholds > 1 else np.asarray([0.8], np.float32)
    got = region.region_confusion_batch(y, p, thresholds,
                                        resize_factor=resize_factor)
    want = jax_region.region_confusion_batch(
        jnp.asarray(y), jnp.asarray(p), jnp.asarray(thresholds),
        resize_factor=resize_factor)
    assert np.asarray(want[0]).sum() > 0 and np.asarray(want[3]).sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_region_counts_at_small_caps_match_jax():
    '''Capacities below the region counts: regions with larger ids are
    never matched, on both sides.'''
    y, p = _batch()
    thresholds = np.asarray([0.3, 0.6], np.float32)
    got = region.region_confusion_batch(y, p, thresholds,
                                        max_label_regions=2,
                                        max_pred_regions=3)
    want = jax_region.region_confusion_batch(
        jnp.asarray(y), jnp.asarray(p), jnp.asarray(thresholds),
        max_label_regions=2, max_pred_regions=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _grid(n_blobs=100, size=200):
    '''n isolated 6x6 pred blobs on a raster grid, the last 10 also label
    regions (tests/test_region_metrics.py).'''
    y_pred = np.zeros([size, size], np.float32)
    y_true = np.zeros([size, size], np.int64)
    blobs = [(5 + 18 * r, 5 + 18 * c) for r in range(10) for c in range(10)]
    for y0, x0 in blobs[:n_blobs]:
        y_pred[y0:y0 + 6, x0:x0 + 6] = 1.0
    for y0, x0 in blobs[n_blobs - 10:n_blobs]:
        y_true[y0:y0 + 6, x0:x0 + 6] = 1
    return y_true[None], y_pred[None, ..., None]


def test_capacity_escalation_persists_as_in_jax():
    y, p = _grid()
    got = metrics.RegionBasedConfusionMatrix(thresholds=0.5,
                                             max_pred_regions=64)
    want = jax_metrics.RegionBasedConfusionMatrix(thresholds=0.5,
                                                  max_pred_regions=64)
    counts = got.get_tp_fn_fp(y, p)
    assert [int(c[0]) for c in counts] == [10, 0, 90]
    for c, w in zip(counts, want.get_tp_fn_fp(y, p)):
        np.testing.assert_array_equal(c, np.asarray(w))
    assert (got.max_label_regions, got.max_pred_regions) == (
        want.max_label_regions, want.max_pred_regions) == (32, 128)
    # a later batch that fits starts at the raised capacity
    y2, p2 = _grid(40)
    got.get_tp_fn_fp(y2, p2)
    assert got.max_pred_regions == 128


def test_region_ceiling_truncates_with_a_warning(caplog):
    '''A 100 x 100 checkerboard has 5,000 regions a side: past the 2,048
    ceiling, ids above it count as unmatched. With only the pred side over
    the ceiling (second call) the port stops at the ceiling too, where the
    JAX package's escalation loop, which needs both sides at the ceiling
    to stop, never ends.'''
    ii, jj = np.mgrid[:100, :100]
    board = ((ii + jj) % 2 == 0).astype(np.float32)[None]
    metric = metrics.RegionBasedConfusionMatrix(thresholds=0.5,
                                                morph_filter_size=1)
    with caplog.at_level(logging.WARNING):
        counts = metric.get_tp_fn_fp(board, board[..., None])
    assert [int(c[0]) for c in counts] == [2048, 5000 - 2048, 5000 - 2048]
    assert 'ceiling' in caplog.text
    metric = metrics.RegionBasedConfusionMatrix(thresholds=0.5,
                                                morph_filter_size=1)
    counts = metric.get_tp_fn_fp(np.zeros_like(board), board[..., None])
    assert [int(c[0]) for c in counts] == [0, 0, 5000]
    assert (metric.max_label_regions, metric.max_pred_regions) == (32, 2048)


def test_metrics_yaml_suite_shares_one_region_pass(monkeypatch):
    specs = config_lib.load_config(os.path.join(
        REPO, 'configs', 'additionals', 'metrics.yaml'))[
            'deploy_options.metrics']
    passes = []
    stats = region.RegionStats

    def counting(*args, **kwargs):
        passes.append(1)
        return stats(*args, **kwargs)

    monkeypatch.setattr(region, 'RegionStats', counting)
    got = [metrics.solve_metric(s) for s in specs]
    want = [jax_metrics.solve_metric(s) for s in specs]
    assert sum(isinstance(m, (region._RegionBasedMetric,
                              metrics.RegionBasedFBetaScore))
               for m in got) == 7
    for seed in range(2):
        y, p = _batch(4, 128, seed)
        yt, pt = torch.from_numpy(y), torch.from_numpy(p)
        for m in got:
            m.update_state(yt, pt)
        for m in want:
            m.update_state(y, p)
    assert len(passes) == 2   # one a batch for the 9 region instances
    for g, w in zip(got, want):
        assert g.name == w.name
        np.testing.assert_allclose(float(g.result()), float(w.result()),
                                   rtol=1e-6, err_msg=g.name)
