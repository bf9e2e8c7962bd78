'''The engine's host input path on the CPU: training streamed from the host
(``device_cache: false``, a budget, a tree) through the prefetcher, the
streamed step against the resident step, the prefetched evaluation pass
against the serial one, the producer thread's end, and the ``train`` and
``generate_tfrecords`` CLI on an exam tree. The small unet.yaml stack at
32 x 32 crops (tests/test_torch_train.py's overlay). Every comparison is
exact: the same function runs on the same tensors.
'''

import itertools
import json
import os
import threading

import numpy as np
import pytest
import torch

from dnncancerannotator_tpu.data import records as jax_records
from dnncancerannotator_torch import engine
from dnncancerannotator_torch.data import pipeline
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_synth
from tests.test_torch_train import CONFIGS

SEED = 3


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('torch_stream'))
    cancer, healthy = util_synth.make_tfrecords(tmp, size=64)
    return dict(records=[cancer, healthy], tree=os.path.join(tmp, 'tree'))


def _config(**train):
    config = config_lib.load_config(CONFIGS)
    opts = config['data_options']['train']
    opts.update(output_size=[32, 32], batch_size=2, buffer_size=4, **train)
    config['data_options']['eval'].update(output_size=[32, 32], batch_size=5)
    config['deploy_options'].update(warp_bank_size=6, steps_per_call=2)
    return config


def _spy(eng):
    '''Record every raw batch the engine's train step takes.'''
    seen, step = [], eng.train_step

    def train_step(raw, *args, **kwargs):
        seen.append(raw.clone())
        return step(raw, *args, **kwargs)
    eng.train_step = train_step
    return seen


def _live_producers():
    return [t for t in threading.enumerate()
            if t.name == engine._Prefetcher.THREAD_NAME and t.is_alive()]


def test_streamed_train_consumes_raw_batches_in_order(data, tmp_path):
    config = _config(device_cache=False)
    opts = config['data_options']['train']
    ds = pipeline.train_ds(data['records'], **opts)
    assert ds.load_resident() is None
    save = str(tmp_path / 'run')
    eng = engine.Engine(config, seed=SEED, device='cpu')
    seen = _spy(eng)
    first = eng.train(ds, save_path=save, max_steps=4, save_freq=2)
    assert first.epoch == [1, 2, 3, 4]
    assert np.isfinite(first.history['loss']).all()
    stream = pipeline.train_ds(data['records'], **opts).raw_batches(SEED)
    want = list(itertools.islice(stream, 4))
    assert len(seen) == 4
    for got, ref in zip(seen, want):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert sorted(os.listdir(os.path.join(save, 'checkpoints'))) == [
        'ckpt-2', 'ckpt-4']
    assert not _live_producers()

    # a new call resumes at step 4 and starts the stream from the seed again
    eng = engine.Engine(config, seed=SEED, device='cpu')
    seen = _spy(eng)
    second = eng.train(pipeline.train_ds(data['records'], **opts),
                       save_path=save, max_steps=6, save_freq=2)
    assert second.epoch == [5, 6]
    assert np.isfinite(second.history['loss']).all()
    for got, ref in zip(seen, want[:2]):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert not _live_producers()


def test_budget_past_the_set_streams(data, monkeypatch):
    '''A set over the resident budget trains from the host stream.'''
    config = _config()
    ds = pipeline.train_ds(data['records'], **config['data_options']['train'])
    load = ds.load_resident
    monkeypatch.setattr(ds, 'load_resident',
                        lambda: load(budget_bytes=ds.element_shape[1] ** 2))
    eng = engine.Engine(config, seed=SEED, device='cpu')
    seen = _spy(eng)
    results = eng.train(ds, max_steps=2, save_freq=10)
    assert eng._resident(ds) is None and ds._device_pool is False
    assert np.isfinite(results.history['loss']).all()
    ref = next(pipeline.train_ds(data['records'], **config['data_options'][
        'train']).raw_batches(SEED))
    np.testing.assert_array_equal(seen[0].numpy(), ref)


def test_streamed_step_equals_resident_step(data):
    '''One step on a streamed batch: loss, every gradient and every updated
    parameter bit-equal to the resident path's step on the same raw batch
    (its sampler replaced) with the same augmentation draws.'''
    streamed = _config(device_cache=False)
    resident = _config()
    a = engine.Engine(streamed, seed=SEED, device='cpu')
    seen = _spy(a)
    got = a.train(pipeline.train_ds(data['records'], **streamed[
        'data_options']['train']), max_steps=1, save_freq=10)
    b = engine.Engine(resident, seed=SEED, device='cpu')
    b.sample_batch = lambda pool, size, gen: seen[0]
    ds = pipeline.train_ds(data['records'], **resident['data_options'][
        'train'])
    want = b.train(ds, max_steps=1, save_freq=10)
    assert b._resident(ds) is not None
    assert got.history['loss'] == want.history['loss']
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


def test_exhausted_stream_raises(data):
    config = _config(device_cache=False, repeat=False, normalize_exams=False)
    ds = pipeline.train_ds(data['records'], **config['data_options']['train'])
    eng = engine.Engine(config, seed=SEED, device='cpu')
    with pytest.raises(RuntimeError, match='stream ended before step 7'):
        eng.train(ds, max_steps=8, save_freq=10)    # 12 slices: 6 batches
    assert not _live_producers()


def _serial(eng, eval_step, ds, metrics):
    losses = []
    for batch in ds.batches():
        loss_vec, probs, y = eval_step(batch['slices'])
        losses.append(loss_vec.numpy())
        for metric in metrics:
            metric.update_state(y, probs)
    return {'loss': float(np.concatenate(losses).mean()),
            **{m.name: float(m.result()) for m in metrics}}


def test_prefetched_eval_equals_serial(data):
    config = _config()
    config['deploy_options']['metrics'] = [
        {'Precision': {'thresholds': 0.5, 'name': 'p'}},
        {'AUC': {'curve': 'PR', 'num_thresholds': 50, 'name': 'auc'}}]
    eng = engine.Engine(config, seed=SEED, device='cpu')
    ds = pipeline.eval_ds(data['records'], **config['data_options']['eval'])
    assert [len(b['meta']) for b in ds.batches()] == [5, 5, 2]
    eng.build(ds.feature_shape)
    step = eng._make_eval_step(ds.slice_types)
    got = eng._eval_dataset(step, ds, eng._build_metrics())
    want = _serial(eng, step, ds, eng._build_metrics())
    assert got == want
    assert not _live_producers()


def test_failing_metric_leaves_no_producer(data):
    class Failing:
        name = 'failing'
        calls = 0

        def update_state(self, y, probs):
            self.calls += 1
            if self.calls == 2:
                raise ArithmeticError('metric failed')

    config = _config()
    eng = engine.Engine(config, seed=SEED, device='cpu')
    ds = pipeline.eval_ds(data['records'], batch_size=1,
                          output_size=(32, 32))
    eng.build(ds.feature_shape)
    with pytest.raises(ArithmeticError, match='metric failed'):
        eng._eval_dataset(eng._make_eval_step(ds.slice_types), ds,
                          [Failing()])
    assert not _live_producers()


def test_prefetcher_raises_the_producers_error():
    def stream():
        yield np.zeros((2, 3), np.uint8)
        raise OSError('decode failed')

    batches = engine._Prefetcher(stream(), 'cpu')
    try:
        item, tensor = next(batches)
        assert tensor.dtype == torch.uint8 and tensor.shape == (2, 3)
        with pytest.raises(OSError, match='decode failed'):
            next(batches)
    finally:
        batches.close()
    assert not _live_producers()


@pytest.mark.parametrize('device_cache', [True, False])
def test_train_cli_from_an_exam_tree(data, tmp_path, device_cache):
    overlay = tmp_path / 'small.json'
    overlay.write_text(json.dumps({
        'data_options.train.output_size': [32, 32],
        'data_options.train.batch_size': 2,
        'data_options.train.device_cache': device_cache,
        'deploy_options.warp_bank_size': 6,
    }))
    save = str(tmp_path / 'run')
    res = main(argv=['train', '--config', *CONFIGS, str(overlay),
                     '--save_path', save, '--data_path', data['tree'],
                     '--max_steps', '3', '--save_freq', '3', '--device',
                     'cpu'])
    assert res.epoch == [1, 2, 3]
    assert np.isfinite(res.history['loss']).all()
    assert os.listdir(os.path.join(save, 'checkpoints')) == ['ckpt-3']


def test_generate_tfrecords_cli(data, tmp_path):
    out = str(tmp_path / 'out' / 'cancer.tfrecords')
    n = main(argv=['generate_tfrecords', '--path', data['tree'], '--output',
                   out, '--category', 'cancer', '--output_size', '48', '48'])
    assert n == 2
    ref = str(tmp_path / 'ref.tfrecords')
    jax_records.generate_tfrecords(data['tree'], ref, category='cancer',
                                   output_size=(48, 48))
    with open(out, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
    exams = list(pipeline._sources([out], util_synth.SLICE_TYPES)[0]
                 .iter_exams())
    assert [e['slices'].shape for e in exams] == [(3, 48, 48, 6)] * 2
