'''The port's writer of the JAX package's Orbax checkpoints
(dnncancerannotator_torch/ckpt/ and the engine's background save) against
the libraries it stands in for and the JAX package itself, on the CPU:

- ``zstd.compress`` decoded by ``zstandard`` (an oracle only) and by the
  port's decoder to the same bytes, with RLE blocks where a block is one
  byte repeated;
- ``ocdbt.write_store`` listed and read by tensorstore's ``ocdbt`` kvstore
  and by the port's reader; a flipped byte fails both CRC32C checks;
- ``zarr.write_array`` read back through tensorstore's zarr support, its
  ``.zarray`` the bytes of the JAX engine's own;
- each of the ten optimizers (and the sgd / rmsprop variants whose chains
  differ): the port's chain against the JAX state's, its checkpoint
  restored by Orbax's StandardCheckpointer with the JAX engine's template
  bit for bit, and read back by the port;
- end to end: the port's ``train`` CLI writes runs that the JAX engine's
  ``load`` restores bit for bit and the JAX ``evaluate`` scores as the
  port's own ``evaluate`` does (loss to 1e-5 relative, region counts
  equal), for unet.yaml and a BatchNorm UNet;
- the background save: a save in flight while training goes on holds the
  state of its step; a writer that raises surfaces at
  ``finalize_checkpoints`` and leaves no checkpoint; pruning keeps the
  newest committed checkpoints.

The module runs torch on one thread (as tests/test_torch_region_metrics.py
does): the port's steps here are small ops, slowed many times over by
torch's thread pool while the test run's other workers hold the cores.
'''

import json
import logging
import os
import struct
import sys
import threading

import jax
import numpy as np
import pandas as pd
import pytest
import tensorstore as ts
import torch
import zstandard

from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.ckpt import ocdbt, orbax, zarr, zstd
from dnncancerannotator_torch.data import pipeline
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.train import optimizers
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_orbax, util_synth
from tests.test_torch_orbax import assert_same_bits

REPO = util_orbax.REPO
ADDITIONALS = os.path.join(REPO, 'configs', 'additionals')
METRICS = os.path.join(ADDITIONALS, 'metrics.yaml')
# unet.yaml, and unet_big.yaml at 4 first filters and 2 levels in f32
# (deploy_options.yaml replaces its deploy_options): a BatchNorm model with
# batch_stats
RUNS = {'unet': util_orbax.UNET_CONFIGS,
        'bn': [os.path.join(REPO, 'configs', 'unet_big.yaml'),
               os.path.join(ADDITIONALS, 'data_options.yaml'),
               os.path.join(ADDITIONALS, 'deploy_options.yaml')]}
SMALL = {'data_options.train.output_size': [32, 32],
         'data_options.eval.output_size': [32, 32],
         'data_options.eval.batch_size': 5,
         'deploy_options.warp_bank_size': 8,
         'deploy_options.steps_per_call': 2}
REGION_COUNTS = ('region/TP', 'region/FP', 'region/FN')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- zstd ---------------------------------------------------------------------

def _blocks(frame):
    '''(type, size) of each block of a single-segment frame.'''
    descriptor = frame[4]
    assert descriptor & 0x20   # single segment
    pos = 5 + {0: 1, 1: 2, 2: 4, 3: 8}[descriptor >> 6]
    out = []
    while True:
        header = int.from_bytes(frame[pos:pos + 3], 'little')
        kind, size = header >> 1 & 3, header >> 3
        out.append((kind, size))
        pos += 3 + (1 if kind == 1 else size)
        if header & 1:
            assert pos == len(frame)
            return out


@pytest.mark.parametrize('size', [0, 1, 131071, 131072, 131073, 1 << 20,
                                  'zeros'])
def test_compress_decodes_with_zstandard(size):
    rng = np.random.default_rng(7)
    data = bytes(300_000) if size == 'zeros' else rng.bytes(size)
    frame = zstd.compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompressobj().decompress(
        frame) == data
    assert zstd.decompress(frame) == zstd.decompress(frame, len(data)) == data
    blocks = _blocks(frame)
    assert sum(n for _, n in blocks) == len(data)
    assert all(n <= zstd.BLOCK for _, n in blocks)
    # RLE exactly where a block is one byte repeated
    assert [k for k, _ in blocks] == [int(size == 'zeros')] * len(blocks)


def test_compress_past_a_single_segment(monkeypatch):
    '''A frame past the single-segment limit takes a 128 KiB window and an
    8-byte content size; a block of one repeated byte amid others is RLE.'''
    monkeypatch.setattr(zstd, 'SINGLE_SEGMENT_MAX', 1000)
    data = np.random.default_rng(1).bytes(200_000) + b'\x07' * zstd.BLOCK
    frame = zstd.compress(data)
    assert frame[4] == 0xC0 and frame[5] == 7 << 3
    assert struct.unpack('<Q', frame[6:14])[0] == len(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data


# -- OCDBT and zarr -----------------------------------------------------------

def _items(n):
    rng = np.random.default_rng(n)
    return {f'p{i % 7}/layer_{i:04d}/{"kernel" if i % 2 else "b"}':
            rng.bytes(int(rng.integers(0, 3000))) for i in range(n)}


@pytest.mark.parametrize('n', [1, 7, 400])
def test_ocdbt_store_reads_in_tensorstore(tmp_path, n):
    items = _items(n)
    path = str(tmp_path / 'store')
    ocdbt.write_store(path, items)
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{path}/'}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(items)
    store = ocdbt.OcdbtStore(path)
    assert store.keys() == sorted(items)
    for key, value in items.items():
        assert kv.read(key).result().value == value
        assert store.read(key) == value
    with pytest.raises(ValueError, match='exists'):
        ocdbt.write_store(path, items)


@pytest.mark.parametrize('where', ['manifest', 'node'])
def test_ocdbt_flipped_byte_fails_both_crcs(tmp_path, where):
    path = str(tmp_path / 'store')
    ocdbt.write_store(path, _items(7))
    if where == 'manifest':
        target, offset = os.path.join(path, ocdbt.MANIFEST), 30
    else:   # inside the B-tree leaf, which ends the data file
        (name,) = os.listdir(os.path.join(path, ocdbt.DATA_DIR))
        target = os.path.join(path, ocdbt.DATA_DIR, name)
        offset = os.path.getsize(target) - 20
    with open(target, 'r+b') as fh:
        fh.seek(offset)
        byte = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(ValueError, match='CRC32C'):
        ocdbt.OcdbtStore(path)
    with pytest.raises(ValueError, match='(?i)checksum|crc'):
        kv = ts.KvStore.open({'driver': 'ocdbt',
                              'base': f'file://{path}/'}).result()
        kv.list().result()


@pytest.mark.parametrize('value', [
    np.random.default_rng(0).standard_normal((3, 3, 2, 4)).astype(
        np.float32),
    np.arange(-3, 4, dtype=np.int32),
    np.asarray(865, np.int32)], ids=['f4', 'i4', 'scalar'])
def test_zarr_array_reads_in_tensorstore(tmp_path, value):
    items = {}
    zarr.write_array(items, 'a.b', value)
    path = str(tmp_path / 'store')
    ocdbt.write_store(path, items)
    got = ts.open({'driver': 'zarr', 'path': 'a.b', 'kvstore': {
        'driver': 'ocdbt', 'base': f'file://{path}/'}}).result().read(
    ).result()
    assert got.dtype == value.dtype and got.shape == value.shape
    assert got.tobytes() == value.tobytes()
    back = zarr.read_array(ocdbt.OcdbtStore(path), 'a.b')
    assert back.dtype == value.dtype and back.tobytes() == value.tobytes()
    # the .zarray the JAX engine writes for its int32 step, with this
    # array's dtype and shape
    fixture = ocdbt.OcdbtStore(os.path.join(
        util_orbax.FIXTURES, 'unet', 'checkpoints', 'ckpt-865'))
    step_meta = fixture.read('step/.zarray')
    meta = dict(json.loads(step_meta), shape=list(value.shape),
                chunks=list(value.shape),
                dtype={'float32': '<f4', 'int32': '<i4'}[value.dtype.name])
    assert items['a.b/.zarray'] == json.dumps(
        meta, sort_keys=True, separators=(',', ':')).encode()
    if value.ndim == 0:
        assert items['a.b/.zarray'] == step_meta
    with pytest.raises(ValueError, match='dtype'):
        zarr.write_array({}, 'x', value.astype(np.float16))


# -- every optimizer's chain --------------------------------------------------

OPTIMIZERS = ['adam', 'adamw', 'adamax', 'nadam', 'sgd', 'rmsprop',
              'adagrad', 'adadelta', 'lamb', 'lion',
              {'class_name': 'sgd', 'config': {'momentum': 0.9}},
              {'class_name': 'rmsprop', 'config': {'centered': True}}]


def _spec_id(spec):
    return spec if isinstance(spec, str) else '-'.join(
        [spec['class_name'], *spec['config']])


@pytest.mark.parametrize('spec', OPTIMIZERS, ids=_spec_id)
def test_every_optimizer_restores_in_orbax(tmp_path, spec):
    view, expected = util_orbax.optimizer_view(spec, seed=5)
    port_opt, _ = optimizers.solve_optimizer(
        spec, [torch.nn.Parameter(torch.zeros(2))])
    chain = optimizers.chain(port_opt)
    assert chain == tuple(tuple(getattr(s, '_fields', ()))
                          for s in view['opt_state'])
    path = str(tmp_path / 'ckpt-1')
    orbax.write_checkpoint(path, expected, chain)
    restored = util_orbax.restore(path, view)
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(view)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(view)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert_same_bits(orbax.read_checkpoint(path), expected)
    assert sorted(os.listdir(tmp_path)) == ['ckpt-1']


def test_writer_refuses_what_it_cannot_place(tmp_path):
    _, flat = util_orbax.optimizer_view('adam', seed=1)
    chain = ((('count', 'mu', 'nu'), ('count',)))
    with pytest.raises(ValueError, match='no place'):
        orbax.write_checkpoint(str(tmp_path / 'a'), flat, (('count',),))
    partial = {k: v for k, v in flat.items() if k != 'nu/params/conv/bias'}
    with pytest.raises(ValueError, match="moment 'nu'"):
        orbax.write_checkpoint(str(tmp_path / 'b'), partial, chain)
    assert os.listdir(tmp_path) == []


# -- end to end: the port's runs in the JAX package ---------------------------

@pytest.fixture(scope='module')
def port_runs(tmp_path_factory):
    '''Records and, for each of RUNS, a save_path the port's ``train`` CLI
    wrote (4 steps, checkpoints at 2 and 4, metrics.yaml) with the port's
    own ``evaluate`` of it under the tag ``port``.'''
    root = tmp_path_factory.mktemp('orbax_write')
    records = list(util_synth.make_tfrecords(str(root / 'records'), size=64))
    out = {}
    for name, configs in RUNS.items():
        overlay = root / f'{name}.json'
        overlay.write_text(json.dumps(dict(SMALL, **(
            {'model_options.n_filters_first': 4,
             'model_options.n_downsample': 2} if name == 'bn' else {}))))
        save = str(root / name)
        main(argv=['train', '--config', *configs, METRICS, str(overlay),
                   '--save_path', save, '--data_path', *records,
                   '--save_freq', '2', '--max_steps', '4', '--device',
                   'cpu'])
        main(argv=['evaluate', '--save_path', save, '--data_path', *records,
                   '--tag', 'port', '--export_csv', '--skip_visualization',
                   '--device', 'cpu'])
        out[name] = save
    return records, out


def _jax_engine(save):
    from dnncancerannotator_tpu import engine as jax_engine
    from dnncancerannotator_tpu.utils import config as jax_config
    config = jax_config.load_config(os.path.join(save, 'options.yaml'))
    eng = jax_engine.Engine(config.get('config', config))
    eng.build((1, 32, 32, 5))
    return eng


@pytest.mark.parametrize('name', sorted(RUNS))
def test_jax_engine_loads_the_port_run(port_runs, name, caplog):
    _, saves = port_runs
    save = saves[name]
    ckpts = os.path.join(save, 'checkpoints')
    assert sorted(os.listdir(ckpts)) == ['ckpt-2', 'ckpt-4']
    ckpt = os.path.join(ckpts, 'ckpt-4')
    assert {'_METADATA', '_CHECKPOINT_METADATA', 'manifest.ocdbt', 'd'} == \
        set(os.listdir(ckpt))
    saved = engine.read_ckpt(ckpt)
    assert int(saved['step']) == int(saved['count']) == 4
    assert any(k.startswith('batch_stats/') for k in saved) == (name == 'bn')
    eng = _jax_engine(save)
    with caplog.at_level(logging.WARNING):
        eng.load(ckpt)
    assert 'flat-layout' not in caplog.text   # the param-tree restore took it
    assert eng.current_step == 4
    assert_same_bits(saved, util_orbax.expected_flat(
        jax.tree.map(np.asarray, eng._ckpt_view())))


@pytest.mark.parametrize('name', sorted(RUNS))
def test_jax_evaluate_scores_the_port_run(port_runs, name):
    from dnncancerannotator_tpu.runs.evaluate import evaluate as jax_evaluate
    records, saves = port_runs
    save = saves[name]
    jax_evaluate(save, records, 'jax', export_csv=True,
                 skip_visualization=True)

    def csv(tag):
        return pd.read_csv(os.path.join(save, 'tfevents', tag,
                                        'results.csv'), index_col=0)

    got, want = csv('port'), csv('jax')
    assert list(got.index) == list(want.index) == [2, 4]
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    for column in REGION_COUNTS:
        np.testing.assert_array_equal(got[column], want[column], column)


def test_untrained_engine_saves_its_initial_state(tmp_path):
    '''``Engine.save`` before any step writes the optimizer's initial state
    (adagrad: sums of squares at 0.1, count 0), synchronously, as the JAX
    engine's ``save`` of a built state.'''
    config = config_lib.load_config(util_orbax.UNET_CONFIGS)
    config['deploy_options']['optimizer'] = 'adagrad'
    eng = engine.Engine(config, device='cpu')
    eng.build((1, 32, 32, 5))
    path = str(tmp_path / 'ckpt-0')
    eng.save(path)
    saved = engine.read_ckpt(path)
    assert int(saved['step']) == int(saved['count']) == 0
    sums = [v for k, v in saved.items() if k.startswith('sum_of_squares/')]
    assert len(sums) == sum(k.startswith('params/') for k in saved) > 0
    assert all((v == np.float32(0.1)).all() for v in sums)
    model = convert.flax_from_torch_state(eng.model.state_dict())
    assert_same_bits({k: saved[k] for k in model}, model)


# -- the background save ------------------------------------------------------

@pytest.fixture(scope='module')
def records(port_runs):
    return port_runs[0]


def _train_engine(records, **deploy):
    config = config_lib.load_config(util_orbax.UNET_CONFIGS)
    config['data_options']['train']['output_size'] = [32, 32]
    config['deploy_options'].update(warp_bank_size=8, **deploy)
    eng = engine.Engine(config, device='cpu')
    return eng, pipeline.train_ds(records, **config['data_options']['train'])


def _live_flat(eng, step):
    flat = convert.flax_from_torch_state(eng.model.state_dict())
    flat.update(eng._opt_state_flat(step))
    return flat


def test_save_in_flight_holds_its_step(records, tmp_path, monkeypatch):
    '''The writer of ckpt-2 is held until training has taken step 3: the
    checkpoint commits with the state of step 2 all the same.'''
    unbroken, ds = _train_engine(records)
    unbroken.train(ds, max_steps=2, save_freq=1000)
    want = _live_flat(unbroken, 2)

    stepped = threading.Event()
    train_step = engine.Engine.train_step

    def counting_step(self, raw, step, gen, outputs=False):
        if step >= 2:
            stepped.set()
        return train_step(self, raw, step, gen, outputs)

    write = orbax.write_checkpoint

    def held_write(path, flat, chain):
        if path.endswith('ckpt-2'):
            assert stepped.wait(60), 'training did not go on'
        return write(path, flat, chain)

    monkeypatch.setattr(engine.Engine, 'train_step', counting_step)
    monkeypatch.setattr(orbax, 'write_checkpoint', held_write)
    eng, ds = _train_engine(records)
    save = str(tmp_path / 'run')
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # the writer and the loop interleave often
    try:
        eng.train(ds, save_path=save, max_steps=4, save_freq=2)
    finally:
        sys.setswitchinterval(interval)
    assert stepped.is_set()
    ckpts = os.path.join(save, 'checkpoints')
    assert sorted(os.listdir(ckpts)) == ['ckpt-2', 'ckpt-4']
    assert_same_bits(engine.read_ckpt(os.path.join(ckpts, 'ckpt-2')), want)
    assert_same_bits(engine.read_ckpt(os.path.join(ckpts, 'ckpt-4')),
                     _live_flat(eng, 4))


def test_failed_save_raises_at_finalize(records, tmp_path, monkeypatch):
    eng, ds = _train_engine(records)
    eng._setup_training(ds)
    store = ocdbt.write_store

    def failing_store(path, items):
        store(path, items)
        raise OSError('no space left on device')

    monkeypatch.setattr(ocdbt, 'write_store', failing_store)
    ckpts = str(tmp_path / 'checkpoints')
    eng.save_ckpt(ckpts, 1)
    with pytest.raises(OSError, match='no space'):
        eng.finalize_checkpoints()
    assert os.listdir(ckpts) == [] and not eng.get_ckpts(ckpts)
    eng.finalize_checkpoints()   # raised once, then nothing in flight
    with pytest.raises(OSError, match='no space'):
        eng.train(ds, save_path=str(tmp_path), max_steps=1, save_freq=1)
    assert os.listdir(ckpts) == []


def test_pruning_keeps_the_newest(records, tmp_path):
    eng, ds = _train_engine(records, max_checkpoints_to_keep=2)
    save = str(tmp_path / 'run')
    eng.train(ds, save_path=save, max_steps=3, save_freq=1)
    ckpts = os.path.join(save, 'checkpoints')
    assert sorted(os.listdir(ckpts)) == ['ckpt-2', 'ckpt-3']
    assert_same_bits(engine.read_ckpt(os.path.join(ckpts, 'ckpt-3')),
                     _live_flat(eng, 3))
    # an npz checkpoint of the port's earlier form is pruned and read alike
    old = os.path.join(ckpts, 'ckpt-1')
    os.makedirs(old)
    model = convert.flax_from_torch_state(eng.model.state_dict())
    np.savez(os.path.join(old, engine.PARAMS_FILE), **model)
    assert_same_bits(engine.read_ckpt(old), model)
    eng.train(ds, save_path=save, max_steps=4, save_freq=1)
    assert sorted(os.listdir(ckpts)) == ['ckpt-3', 'ckpt-4']
