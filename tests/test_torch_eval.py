'''The port's evaluation path on the CPU against the JAX package's: the eval
step (per-slice loss, probabilities, labels), the input sensitivity, the
Visualizer's image grid, the event writer, early stopping, validation
during ``train`` and the ``evaluate`` CLI on the same weights and data.

Tolerances: per-slice losses within 1e-5 relative and probabilities within
1e-5 absolute (f32 sums in another order); the sensitivity within 1e-5 of
its max; image grids and event records exactly. Metric values computed
from probabilities: exactly equal counts and ratios within 1e-6 relative,
unless a probability the metric thresholds lies within 1e-5 of one of its
thresholds, where the two frameworks' f32 probabilities may fall on
different sides. The test then says so, holds the port's metrics fed the
JAX probabilities to the JAX values exactly, and lets the port's own values
differ by at most one count per such pixel (ratios such as the AUCs by at
most 1e-3).
'''

import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dnncancerannotator_tpu import engine as jax_engine
from dnncancerannotator_tpu import metrics as jax_metrics
from dnncancerannotator_tpu.data import pipeline as jax_pipeline
from dnncancerannotator_tpu.models import build_model as jax_build_model
from dnncancerannotator_tpu.parallel import mesh as mesh_lib
from dnncancerannotator_tpu.runs.evaluate import evaluate as jax_evaluate
from dnncancerannotator_tpu.utils import tboard as jax_tboard
from dnncancerannotator_tpu.utils import viz as jax_viz
from dnncancerannotator_torch import convert, engine, metrics
from dnncancerannotator_torch.data import pipeline
from dnncancerannotator_torch.data import tfrecord as tfr
from dnncancerannotator_torch.metrics import region
from dnncancerannotator_torch.ops.morphology import morph_open
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from dnncancerannotator_torch.utils import tboard, viz
from tests import util_synth
from tests.test_torch_unet import UNET_OPTIONS, _jax_params, flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, 'configs', 'unet.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'deploy_options.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'data_options.yaml')]
METRICS_YAML = os.path.join(REPO, 'configs', 'additionals', 'metrics.yaml')
SLICE_TYPES = util_synth.SLICE_TYPES
NEAR = 1e-5


def _weights(shape, seed=0):
    '''A JAX engine built for NHWC ``shape`` with non-zero biases, and the
    same weights in a port engine on the CPU.'''
    config = config_lib.load_config(CONFIGS)
    jeng = jax_engine.Engine(config)
    jeng.build(shape)
    flat = flat_params(jeng.state['params'])
    rng = np.random.default_rng(seed)
    for key in flat:
        if key.endswith('/bias'):
            flat[key] = (rng.standard_normal(flat[key].shape) * 0.1).astype(
                np.float32)
    jeng.state['params'] = _jax_params(flat)
    eng = engine.Engine(config, device='cpu')
    eng.build(shape)
    eng.model.load_state_dict(convert.torch_state_from_flax(
        flat, expected=eng.model.state_dict()))
    return jeng, eng


@pytest.mark.parametrize('n,batch', [(12, 5), (160, 64)])
def test_eval_step_matches_jax_with_a_short_last_batch(n, batch):
    '''12 slices at batch 5 and the 160-slice dataset at batch 64: the last
    batch (2, 32 slices) is padded and masked by the JAX step, not by the
    port's.'''
    jeng, eng = _weights((batch, 32, 32, 5))
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 256, (n, 32, 32, 6), dtype=np.uint8)
    raw[..., 5] = np.where(raw[..., 5] > 200, 255, 0)
    jstep = jeng._make_eval_step(SLICE_TYPES)
    step = eng._make_eval_step(SLICE_TYPES)
    for start in range(0, n, batch):
        chunk = raw[start:start + batch]
        raw_dev, valid = mesh_lib.shard_batch(jeng.mesh, chunk, pad_to=batch)
        want_loss, want_probs, want_y = jstep(jeng.state, raw_dev,
                                              jnp.int32(valid))
        loss, probs, y = step(chunk)
        assert loss.shape == (len(chunk),) and valid == len(chunk)
        np.testing.assert_allclose(loss.numpy(),
                                   np.asarray(want_loss)[:valid], rtol=1e-5)
        np.testing.assert_allclose(probs.numpy(),
                                   np.asarray(want_probs)[:valid], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(y.numpy(), np.asarray(want_y)[:valid])


def test_input_sensitivity_matches_jax_grad():
    rng = np.random.default_rng(3)
    x = rng.random((2, 32, 32, 5), dtype=np.float32)
    model, _ = jax_build_model('UNetAnnotator', UNET_OPTIONS)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 jnp.asarray(x[:1]))['params']
    flat = flat_params(params)
    for key in flat:
        if key.endswith('/bias'):
            flat[key] = (rng.standard_normal(flat[key].shape) * 0.1).astype(
                np.float32)
    params = _jax_params(flat)
    grad = jax.jit(jax.grad(lambda v: jnp.sum(model.apply(
        {'params': params}, v, training=False))))(jnp.asarray(x))
    summed = jnp.sum(jnp.abs(grad), axis=(1, 2))
    want = np.asarray(summed / jnp.maximum(
        jnp.sum(summed, axis=1, keepdims=True), 1e-12))
    eng = engine.Engine(config_lib.load_config(CONFIGS), device='cpu')
    eng.build(x.shape)
    eng.model.load_state_dict(convert.torch_state_from_flax(
        flat, expected=eng.model.state_dict()))
    probs, sens = viz.input_sensitivity(eng.model, torch.from_numpy(x))
    assert sens.shape == (2, 5)
    np.testing.assert_allclose(sens.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jax.jit(model.apply)({'params': params},
                                                       jnp.asarray(x))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize('overlay,ratio', [
    (False, 0.5), (True, 1.0), (False, 1.0), (True, 0.5)])
def test_visualizer_image_grid_matches_jax(overlay, ratio):
    rng = np.random.default_rng(4)
    features = rng.random((32, 48, 5), dtype=np.float32)
    label = (rng.random((32, 48)) > 0.8).astype(np.float32)
    output = rng.random((32, 48, 1), dtype=np.float32)
    kwargs = dict(ratio=ratio, overlay=overlay)
    want_viz = jax_viz.Visualizer('t', None, 1, 'unused', **kwargs)
    got_viz = viz.Visualizer('t', None, 1, 'unused', **kwargs)
    want = want_viz._resize(want_viz._generate_image(features, label, output))
    got = got_viz._resize(got_viz._generate_image(features, label, output))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_summary_writer_records_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, 'time', lambda: 1.75e9)
    rng = np.random.default_rng(5)
    gray = rng.random((16, 24), dtype=np.float32)
    rgb = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    curve = [rng.random(5) for _ in range(6)]
    files = {}
    for name, module in (('jax', jax_tboard), ('torch', tboard)):
        writer = module.SummaryWriter(str(tmp_path / name))
        writer.scalar('epoch_loss', 0.25, 1)
        writer.image('path:/a/b/c,sliceID:3', gray, 2)
        writer.image('rgb', rgb, 2)
        writer.pr_curve_raw('region/PR_curve', *curve, 5, 3)
        writer.close()
        (path,) = [os.path.join(writer.logdir, f)
                   for f in os.listdir(writer.logdir)]
        files[name] = list(tfr.read_records(path, verify_crc=True))
    assert len(files['torch']) == 5
    assert files['torch'] == files['jax']
    fields = {f: v for f, _, v in tfr.iter_fields(files['torch'][0])}
    assert bytes(fields[3]) == b'brain.Event:2'


# -- train --validate, early stopping and the evaluate CLI ---------------------------
@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_eval')
    return list(util_synth.make_tfrecords(str(tmp), size=64))


def _overlay(tmp_path, steps_per_call):
    '''32 x 32 crops and eval slices, eval batch 5 (12 slices: 5, 5, 2).'''
    path = tmp_path / f'small{steps_per_call}.json'
    path.write_text(json.dumps({
        'data_options.train.output_size': [32, 32],
        'data_options.eval.output_size': [32, 32],
        'data_options.eval.batch_size': 5,
        'deploy_options.warp_bank_size': 8,
        'deploy_options.steps_per_call': steps_per_call,
    }))
    return str(path)


def test_early_stopping_stops_where_jax_does(records, tmp_path):
    '''Validation every 4 steps, patience 3, one step a chunk: the best
    step starts at the first step of the call, so the check after step 3
    stops the run before any validation, and the JAX engine, which has
    step 4 in flight by then, runs it (with its validation) first.'''
    config = config_lib.load_config([*CONFIGS, _overlay(tmp_path, 1)])
    val = jax_pipeline.eval_ds(records, **config['data_options']['eval'])
    jeng = jax_engine.Engine(config)
    want = jeng.train(jax_pipeline.train_ds(
        records, **config['data_options']['train']), val_data=val,
        save_freq=4, max_steps=12, early_stop_steps=3)
    got = main(argv=['train', '--config', *CONFIGS, _overlay(tmp_path, 1),
                     '--save_path', str(tmp_path / 'run'), '--data_path',
                     *records, '--save_freq', '4', '--max_steps', '12',
                     '--validate', '--val_data_path', *records,
                     '--early_stop_steps', '3', '--device', 'cpu'])
    assert got.epoch == want.epoch == [1, 2, 3, 4]
    assert 'val_loss' in got.history and len(got.history['val_loss']) == 1


def _probs(ds, step):
    '''[(y, probs)] numpy batches of ``step``: uint8 slices -> probs.'''
    label = SLICE_TYPES.index('label')
    return [((b['slices'][..., label] / 255.0).astype(np.float32),
             step(b['slices'])) for b in ds.batches()]


def _jax_step(jeng, batch_size):
    step = jeng._make_eval_step(SLICE_TYPES)

    def probs(slices):
        raw, n = mesh_lib.shard_batch(jeng.mesh, slices, pad_to=batch_size)
        return np.asarray(step(jeng.state, raw, jnp.int32(n))[1])[:n]
    return probs


def _near_pixels(batches, thresholds, resize_factor=None):
    '''Pixels (resized and opened first for the region metrics) within
    NEAR of one of ``thresholds``.'''
    count = 0
    for y, p in batches:
        if resize_factor is not None:
            _, p = region._resized(y, p, resize_factor)
            p = morph_open(p, 5).numpy()
        count += int((np.abs(np.asarray(p).reshape(-1, 1) -
                             np.asarray(thresholds)[None]) < NEAR).sum())
    return count


def _suite(specs, batches):
    '''The port's metric suite over numpy batches: {name: value}.'''
    suite = [metrics.solve_metric(s) for s in specs]
    for y, p in batches:
        for metric in suite:
            metric.update_state(y, p)
    return {m.name: float(m.result()) for m in suite}


def _casewise(batches):
    '''The Visualizer's casewise region counts over numpy batches, one
    [3 * 100] row a slice.'''
    cm = metrics.RegionBasedConfusionMatrix(
        viz.PR_THRESHOLDS, viz.PR_IOU_THRESHOLD, resize_factor=0.5)
    rows = [np.concatenate(cm.update_state_raw(y, p), axis=1)
            for y, p in batches]
    return np.concatenate(rows)


AUC_THRESHOLDS = jax_metrics.AUC(num_thresholds=150).thresholds
VIZ_THRESHOLDS = np.asarray(viz.PR_THRESHOLDS, np.float32)


def _near_by_column(batches, names):
    '''{column: pixels within NEAR of a threshold it uses}.'''
    pixel = _near_pixels(batches, [0.8])
    auc = _near_pixels(batches, AUC_THRESHOLDS)
    regional = _near_pixels(batches, [0.8], resize_factor=0.5)
    return {name: auc if 'AU' in name else regional if 'region' in name
            else pixel for name in names if name != 'loss'}


def _compare_values(got, want, shared, near, label):
    '''One results row: the loss within 1e-5 relative; every metric with
    no near-threshold pixel exactly (ratios within 1e-6 relative); the
    others equal on the JAX probabilities (``shared``), and the port's own
    counts within one a near pixel, its ratios within 1e-3.'''
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    for name, n_near in near.items():
        if not n_near:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                       err_msg=f'{label} {name}')
            continue
        print(f'{label} {name}: {n_near} pixels within {NEAR} of a '
              'threshold; compared on the JAX probabilities')
        np.testing.assert_allclose(shared[name], want[name], rtol=1e-6,
                                   err_msg=f'{label} {name}')
        if name.endswith(('TP', 'FP', 'FN')):
            assert abs(got[name] - want[name]) <= n_near, name
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-3, err_msg=f'{label} {name}')


def test_validation_and_evaluate_cli_match_jax(records, tmp_path):
    '''``train --validate --visualize`` with metrics.yaml for 8 steps
    (validation and checkpoints at 4 and 8), then ``evaluate`` with every
    export on both packages over the same checkpoints.'''
    overlay = _overlay(tmp_path, 2)
    save = str(tmp_path / 'torch_run')
    res = main(argv=['train', '--config', *CONFIGS, METRICS_YAML, overlay,
                     '--save_path', save, '--data_path', *records,
                     '--save_freq', '4', '--max_steps', '8', '--validate',
                     '--val_data_path', *records, '--visualize', '--device',
                     'cpu'])
    config = config_lib.load_config([*CONFIGS, METRICS_YAML, overlay])
    specs = config['deploy_options']['metrics']
    names = ['loss'] + [next(iter(s.values()))['name'] for s in specs]
    assert res.epoch == list(range(1, 9))
    assert all(len(res.history[n]) == 8 for n in names)  # train metrics
    assert len(res.history['val_loss']) == 2
    for tag in ('train', 'validation'):
        assert os.listdir(os.path.join(save, 'tfevents', tag))

    # the same checkpoints as Orbax checkpoints of the JAX package
    jax_save = str(tmp_path / 'jax_run')
    os.makedirs(jax_save)
    shutil.copy(os.path.join(save, 'options.yaml'), jax_save)
    jeng = jax_engine.Engine(config)
    jeng.build((5, 32, 32, 5))
    eng = engine.Engine(config, device='cpu')
    eng.build((5, 32, 32, 5))
    port_step = eng._make_eval_step(SLICE_TYPES)
    jax_step = _jax_step(jeng, 5)
    ds = pipeline.eval_ds(records, **config['data_options']['eval'])
    jds = jax_pipeline.eval_ds(records, **config['data_options']['eval'])
    jax_eval_step = jeng._make_eval_step(SLICE_TYPES)
    shared = {}
    for step in (4, 8):
        ckpt = os.path.join(save, 'checkpoints', f'ckpt-{step}')
        saved = engine.read_ckpt(ckpt, opt_state=False)
        jeng.state['params'] = _jax_params(
            {k: v for k, v in saved.items() if k.startswith('params/')})
        jeng.save_ckpt(os.path.join(jax_save, 'checkpoints'), step)
        eng.load(ckpt)
        got_b = _probs(ds, lambda x: port_step(x)[1].numpy())
        want_b = _probs(ds, jax_step)
        for (_, g), (_, w) in zip(got_b, want_b):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        near = _near_by_column(got_b, names)
        suite = _suite(specs, want_b)
        shared[step] = (want_b, near, _near_pixels(
            got_b, VIZ_THRESHOLDS, resize_factor=0.5))
        # validation at this step against the JAX pass on the same weights
        want = jeng._eval_dataset(jax_eval_step, jds, jeng._build_metrics())
        got = {k[4:]: res.history[k][step // 4 - 1] for k in res.history
               if k.startswith('val_')}
        assert sorted(got) == sorted(want) == sorted(names)
        _compare_values(got, want, suite, near, f'val at {step}')
    jeng.finalize_checkpoints()

    argv = ['--tag', 'val', '--export_csv', '--export_images',
            '--export_casewise_metrics']
    main(argv=['evaluate', '--save_path', save, '--data_path', *records,
               *argv, '--device', 'cpu'])
    jax_evaluate(jax_save, records, 'val', export_csv=True,
                 export_images=True, export_casewise_metrics=True)
    out, jax_out = (os.path.join(p, 'tfevents', 'val')
                    for p in (save, jax_save))
    got = pd.read_csv(os.path.join(out, 'results.csv'), index_col=0)
    want = pd.read_csv(os.path.join(jax_out, 'results.csv'), index_col=0)
    assert list(got.index) == list(want.index) == [4, 8]
    assert list(got.columns) == list(want.columns) == names
    got_cw = pd.read_csv(os.path.join(out, 'casewise_results.csv'),
                         index_col=0)
    want_cw = pd.read_csv(os.path.join(jax_out, 'casewise_results.csv'),
                          index_col=0)
    assert list(got_cw.columns) == list(want_cw.columns)
    assert list(got_cw.index) == list(want_cw.index) == list(range(24))
    assert list(got_cw['tag']) == list(want_cw['tag'])
    counts = [c for c in got_cw.columns if c != 'tag']
    for i, step in enumerate((4, 8)):
        want_b, near, n_near = shared[step]
        _compare_values(got.loc[step].to_dict(), want.loc[step].to_dict(),
                        _suite(specs, want_b), near, f'evaluate {step}')
        rows = slice(12 * i, 12 * (i + 1))
        want_rows = want_cw[counts].to_numpy()[rows]
        np.testing.assert_array_equal(_casewise(want_b), want_rows)
        diff = np.abs(got_cw[counts].to_numpy()[rows] - want_rows).sum()
        print(f'evaluate {step}: casewise counts differ by {diff} with '
              f'{n_near} pixels within {NEAR} of a threshold')
        assert diff <= n_near
    for root in (out, jax_out):
        pngs = [f for _, _, fs in os.walk(os.path.join(root, 'images'))
                for f in fs if f.endswith('.png')]
        assert len(pngs) == 24
        events = [f for f in os.listdir(root) if f.startswith('events')]
        assert len(events) == 1
    (events,) = [os.path.join(out, f) for f in os.listdir(out)
                 if f.startswith('events')]
    assert len(list(tfr.read_records(events, verify_crc=True))) == \
        1 + 2 * (12 + 2)   # version, then a slice image each and 2 curves


def test_evaluate_selects_checkpoints_and_tags_as_jax(records, tmp_path):
    '''The checkpoint and tag rules of the JAX ``eval``: ``step_range``
    (both ends included), then ``min_interval`` from the last evaluated
    step; an existing tag raises, or gets '_' appended with
    ``avoid_overwrite``.'''
    config = config_lib.load_config([*CONFIGS, _overlay(tmp_path, 1)])
    save = str(tmp_path / 'run')
    eng = engine.Engine(config, device='cpu')
    eng.build((5, 32, 32, 5))
    for step in (1, 2, 4, 7):
        eng.save_ckpt(os.path.join(save, 'checkpoints'), step)
    eng.finalize_checkpoints()
    with open(os.path.join(save, 'options.yaml'), 'w') as fh:
        json.dump({'config': config}, fh)

    def evaluate(*flags):
        return main(argv=['evaluate', '--save_path', save, '--data_path',
                          *records, '--skip_visualization', '--device',
                          'cpu', *flags])

    assert sorted(evaluate('--tag', 'a', '--step_range', '2', '7')) == \
        [2, 4, 7]
    assert sorted(evaluate('--tag', 'b', '--min_interval', '3')) == [1, 4, 7]
    assert sorted(evaluate('--tag', 'c', '--step_range', '0', '4',
                           '--min_interval', '2', '--export_csv')) == [1, 4]
    with pytest.raises(ValueError, match='already exists'):
        evaluate('--tag', 'c')
    evaluate('--tag', 'c', '--avoid_overwrite', '--step_range', '7', '7',
             '--export_csv')
    frame = pd.read_csv(os.path.join(save, 'tfevents', 'c_', 'results.csv'),
                        index_col=0)
    assert list(frame.index) == [7] and frame.index.name == 'step'
    with open(os.path.join(save, 'tfevents', 'c_',
                           'casewise_results.csv')) as fh:
        assert fh.read() == '""\n'   # pandas' empty frame
