'''The port's reader of the JAX package's Orbax checkpoints
(dnncancerannotator_torch/ckpt/) against the libraries it replaces and the
JAX engine's own state, on the CPU:

- the zstd decoder (csrc/host/zstd_decode.cc) against ``zstandard`` (a
  test-side oracle; the port never imports it), byte for byte, on every
  chunk of checkpoints the JAX engine writes and on seeded payloads;
  malformed frames raise;
- the OCDBT store against tensorstore's ``KvStore``: the same keys and
  values; a flipped byte fails the CRC32C;
- the zarr arrays against tensorstore's own zarr reads;
- the Orbax reader against the JAX engine's ``_ckpt_view()``: every leaf
  bit-equal, for unet.yaml, full-width unet_big, the flat interim layout
  and the ten optimizers' chains, and the committed fixtures against their
  ``expected.npz``;
- the engine: evaluate and a resumed train on a JAX save_path give the
  bits of the same run converted to the port's npz form (predict and
  export_model: tests/test_torch_predict.py, test_torch_export.py).
'''

import json
import os
import shutil
import struct

import numpy as np
import pytest
import tensorstore as ts
import zstandard

from dnncancerannotator_torch.ckpt import ocdbt, orbax, zarr, zstd
from tests import util_orbax

OPTIMIZERS = ['adam', 'adamw', 'adamax', 'nadam', 'sgd', 'rmsprop',
              'adagrad', 'adadelta', 'lamb', 'lion']


def assert_same_bits(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key


@pytest.fixture(scope='module')
def jax_ckpts(tmp_path_factory):
    '''name -> (checkpoint dir, expected flat dict), written by the JAX
    engine: unet.yaml and full-width unet_big through ``save_ckpt``, and
    unet.yaml's runtime state in the flat interim layout.'''
    root = tmp_path_factory.mktemp('orbax')
    unet = util_orbax.load_config(util_orbax.UNET_CONFIGS)
    out = {
        'unet': util_orbax.write_run(str(root / 'unet'), unet, seed=1),
        'big': util_orbax.write_run(
            str(root / 'big'),
            util_orbax.load_config(util_orbax.BIG_CONFIGS), seed=2),
    }
    flat = str(root / 'flat' / 'ckpt-1')
    out['flat'] = (flat, util_orbax.write_flat_layout(flat, unet, seed=3))
    return out


@pytest.fixture(scope='module')
def deep_store(tmp_path_factory):
    '''A tensorstore OCDBT store with small nodes: interior nodes over
    several heights, keys that share prefixes, inline and referenced
    values, and versions past the manifest's two inline ones (older ones
    in version-tree nodes).'''
    path = str(tmp_path_factory.mktemp('deep'))
    kv = ts.KvStore.open({
        'driver': 'ocdbt', 'base': f'file://{path}/',
        'config': {'max_decoded_node_bytes': 400,
                   'max_inline_value_bytes': 24,
                   'version_tree_arity_log2': 1}}).result()
    rng = np.random.default_rng(0)
    for part in range(3):
        with ts.Transaction() as txn:
            for i in range(part * 150, (part + 1) * 150):
                key = f'p{i % 7}/layer_{i:04d}/{"kernel" if i % 2 else "b"}'
                kv.with_transaction(txn)[key] = rng.bytes(
                    int(rng.integers(0, 60)))
    return path


# -- zstd ---------------------------------------------------------------------

def _oracle(frame):
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)


def _envelope_frames(ckpt):
    '''The zstd frames of the checkpoint's OCDBT files that hold one
    envelope each (the manifests, the root B-tree node).'''
    for dirpath, _, names in os.walk(ckpt):
        for name in names:
            with open(os.path.join(dirpath, name), 'rb') as fh:
                raw = fh.read()
            if len(raw) < 18 or raw[:2] != b'\x0c\xdb' or \
                    struct.unpack('<Q', raw[4:12])[0] != len(raw):
                continue
            assert raw[12:14] == b'\x00\x01'  # version 0, zstd
            yield raw[14:-4]


@pytest.mark.parametrize('name', ['unet', 'big'])
def test_decoder_matches_zstandard_on_checkpoints(jax_ckpts, name):
    ckpt = jax_ckpts[name][0]
    store = ocdbt.OcdbtStore(ckpt)
    frames = [store.read(k) for k in store.keys()
              if not k.endswith('/.zarray')]
    envelopes = list(_envelope_frames(ckpt))
    assert len(frames) > 90 and len(envelopes) >= 3
    for frame in frames + envelopes:
        want = _oracle(frame)
        assert zstd.decompress(frame) == want
        assert zstd.decompress(frame, len(want)) == want


def _payloads():
    rng = np.random.default_rng(0)
    words = [b'kernel', b'bias', b'mu', b'nu', b'\x00\x00\x80\x3f']
    return {
        'empty': b'',
        'byte': b'a',
        'floats': rng.standard_normal(50_000).astype(np.float32).tobytes(),
        'moments': (rng.integers(-511, 512, 60_000) * 2.0 ** -12).astype(
            np.float32).tobytes(),
        'counts': rng.geometric(0.05, 140_000).astype(np.uint8).tobytes(),
        'words': b''.join(words[i] for i in rng.integers(0, 5, 40_000)),
        'zeros': bytes(150_000),
        'random': rng.bytes(20_000),
        # short runs of 7 values: Huffman weights stored directly
        'runs': b''.join(bytes([i % 7]) * int(rng.integers(1, 9))
                         for i in range(30_000)),
    }


@pytest.mark.parametrize('checksum', [False, True])
@pytest.mark.parametrize('content_size', [False, True])
@pytest.mark.parametrize('level', [-5, 1, 3, 19])
def test_decoder_matches_zstandard(level, content_size, checksum):
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)
    for name, data in _payloads().items():
        frame = cctx.compress(data)
        assert zstd.decompress(frame) == data, name
        assert zstd.decompress(frame, len(data)) == data, name


@pytest.mark.parametrize('level', [1, 19])
def test_decoder_reads_frame_sequences(level):
    '''Two frames back to back, skippable frames before and between, and a
    streamed frame flushed every 5000 bytes (many blocks: repeated FSE
    tables and treeless literals).'''
    payloads = _payloads()
    a, b = payloads['floats'], payloads['words']
    one = zstandard.ZstdCompressor(level=level).compress(a)
    two = zstandard.ZstdCompressor(level=level, write_checksum=True,
                                   write_content_size=False).compress(b)
    skip = struct.pack('<II', 0x184D2A5E, 3) + b'xyz'
    assert zstd.decompress(one + two) == a + b
    assert zstd.decompress(skip + one + skip + two, len(a) + len(b)) == a + b
    data = payloads['moments'] + payloads['words']
    co = zstandard.ZstdCompressor(level=level).compressobj()
    parts = []
    for i in range(0, len(data), 5000):
        parts.append(co.compress(data[i:i + 5000]))
        parts.append(co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK))
    parts.append(co.flush())
    assert zstd.decompress(b''.join(parts)) == data


def test_decoder_reads_hand_built_blocks():
    '''Blocks zstandard's encoder seldom writes: RLE literals with no
    sequences, an RLE block, a raw block, in a single-segment frame.'''
    rle_literals = bytes([20 << 3 | 1, ord('z'), 0])  # 20 x 'z', 0 sequences
    blocks = [(2, rle_literals, 20), (1, b'y', 10), (0, b'raw!', 4)]
    body = b''
    for i, (kind, content, size) in enumerate(blocks):
        last = i == len(blocks) - 1
        header = (size if kind == 1 else len(content)) << 3 | kind << 1 | last
        body += header.to_bytes(3, 'little') + content
    frame = struct.pack('<I', 0xFD2FB528) + bytes([0x20, 34]) + body
    want = b'z' * 20 + b'y' * 10 + b'raw!'
    assert _oracle(frame) == want
    assert zstd.decompress(frame) == zstd.decompress(frame, 34) == want


def test_decoder_rejects_malformed_frames():
    data = _payloads()['words']
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        data)
    for cut in (1, 4, 6, 12, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError, match='zstd'):
            zstd.decompress(frame[:cut], len(data))
    bad = bytearray(frame)
    bad[-1] ^= 0x01
    with pytest.raises(ValueError, match='checksum'):
        zstd.decompress(bytes(bad), len(data))
    for i in range(4, len(frame) - 4, max(1, len(frame) // 40)):
        bad = bytearray(frame)
        bad[i] ^= 0x24
        with pytest.raises(ValueError, match='zstd'):
            zstd.decompress(bytes(bad), len(data))
    with pytest.raises(ValueError, match='expected'):
        zstd.decompress(frame, len(data) - 1)
    with pytest.raises(ValueError, match='not a frame|magic'):
        zstd.decompress(frame + b'\x01\x02\x03\x04\x05')
    samples = [data[i:i + 500] for i in range(0, 100_000, 500)]
    dictionary = zstandard.train_dictionary(1024, samples)
    with pytest.raises(ValueError, match='dictionary'):
        zstd.decompress(zstandard.ZstdCompressor(
            dict_data=dictionary).compress(data[:2000]))


# -- OCDBT and zarr -----------------------------------------------------------

@pytest.mark.parametrize('name', ['unet', 'big', 'deep'])
def test_ocdbt_matches_tensorstore(jax_ckpts, deep_store, name):
    path = deep_store if name == 'deep' else jax_ckpts[name][0]
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{path}/'}).result()
    want = [k.decode() for k in kv.list().result()]
    store = ocdbt.OcdbtStore(path)
    assert store.keys() == sorted(want) and len(want) > 90
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    with pytest.raises(KeyError):
        store.read('absent')


def test_ocdbt_flipped_byte_fails_the_crc(jax_ckpts, tmp_path):
    ckpt = str(tmp_path / 'ckpt')
    shutil.copytree(jax_ckpts['unet'][0], ckpt)
    ocdbt.OcdbtStore(ckpt)
    (node,) = os.listdir(os.path.join(ckpt, 'd'))
    with open(os.path.join(ckpt, 'd', node), 'r+b') as fh:
        fh.seek(40)
        byte = fh.read(1)
        fh.seek(40)
        fh.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(ValueError, match='CRC32C'):
        ocdbt.OcdbtStore(ckpt)


@pytest.mark.parametrize('dtype,separator', [
    ('<f4', '.'), ('<f8', '/'), ('<i4', '.'), ('<i8', '/'), ('|u1', '.'),
    ('|b1', '/'), ('bfloat16', '.')])
def test_zarr_matches_tensorstore(tmp_path, dtype, separator):
    '''Several chunks with padded edges, one chunk missing (the fill), the
    two separators and every dtype the reader takes.'''
    path = str(tmp_path)
    spec = {'driver': 'zarr',
            'kvstore': {'driver': 'ocdbt', 'base': f'file://{path}/'},
            'path': 'a.b', 'create': True,
            'metadata': {'shape': [5, 7, 3], 'chunks': [2, 3, 3],
                         'dtype': dtype, 'fill_value': 1 if dtype in (
                             '<i4', '<i8', '|u1') else None,
                         'compressor': {'id': 'zstd', 'level': 1},
                         'dimension_separator': separator}}
    arr = ts.open(spec).result()
    rng = np.random.default_rng(len(dtype))
    values = (rng.standard_normal((5, 7, 3)) * 100).astype(
        arr.dtype.numpy_dtype)
    arr[:, :6].write(values[:, :6]).result()   # column chunk 2 only partly
    arr[:4, 6:].write(values[:4, 6:]).result()  # chunk (2, 2, 0) never
    want = arr.read().result()
    got = zarr.read_array(ocdbt.OcdbtStore(path), 'a.b')
    if dtype == 'bfloat16':
        want = want.astype(np.float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('field,value,match', [
    ('filters', [{'id': 'delta'}], 'filters'),
    ('compressor', {'id': 'blosc'}, 'compressor'),
    ('dtype', '<f2', 'dtype'),
    ('order', 'F', 'order'),
    ('dimension_separator', '-', 'dimension_separator'),
    ('attributes', {}, 'attributes'),
])
def test_zarr_refuses_unknown_fields(field, value, match):
    meta = {'zarr_format': 2, 'shape': [2], 'chunks': [2], 'dtype': '<f4',
            'compressor': None, 'fill_value': None, 'order': 'C',
            'filters': None, 'dimension_separator': '.'}
    meta[field] = value
    store = {'x/.zarray': json.dumps(meta).encode(), 'x/0': bytes(8)}
    store = type('Store', (dict,), {'read': dict.__getitem__})(store)
    with pytest.raises(ValueError, match=match):
        zarr.read_array(store, 'x')


# -- the Orbax reader ---------------------------------------------------------

@pytest.mark.parametrize('name', ['unet', 'big', 'flat'])
def test_reader_matches_jax_state(jax_ckpts, name):
    ckpt, expected = jax_ckpts[name]
    assert_same_bits(orbax.read_checkpoint(ckpt), expected)
    model_only = orbax.read_checkpoint(ckpt, opt_state=False)
    assert_same_bits(model_only, {k: v for k, v in expected.items()
                                  if k.split('/')[0] in ('params',
                                                         'batch_stats',
                                                         'step')})
    assert any(k.startswith('batch_stats/') for k in expected) == \
        (name == 'big')


@pytest.mark.parametrize('optimizer', OPTIMIZERS)
def test_reader_takes_every_optimizer(tmp_path, optimizer):
    ckpt = str(tmp_path / 'ckpt')
    expected = util_orbax.write_optimizer_state(ckpt, optimizer, seed=5)
    got = orbax.read_checkpoint(ckpt)
    assert_same_bits(got, expected)
    moments = {k.split('/')[0] for k in got if '/params/' in k}
    assert moments == {
        'adam': {'mu', 'nu'}, 'adamw': {'mu', 'nu'},
        'adamax': {'mu', 'nu'}, 'nadam': {'mu', 'nu'}, 'sgd': set(),
        'rmsprop': {'nu', 'trace'}, 'adagrad': {'sum_of_squares'},
        'adadelta': {'e_g', 'e_x'}, 'lamb': {'mu', 'nu'},
        'lion': {'mu'}}[optimizer]


@pytest.mark.parametrize('name', sorted(util_orbax.FIXTURE_SPECS))
def test_committed_fixture_reads_back(name):
    ckpts = os.path.join(util_orbax.FIXTURES, name, 'checkpoints')
    (ckpt,) = os.listdir(ckpts)
    with np.load(os.path.join(util_orbax.FIXTURES,
                              f'{name}.expected.npz')) as npz:
        expected = {k: npz[k] for k in npz.files}
    got = orbax.read_checkpoint(os.path.join(ckpts, ckpt))
    assert_same_bits(got, expected)
    assert ckpt == f'ckpt-{int(got["step"])}' and got['count'] == got['step']


def _edit_metadata(ckpt, edit):
    path = os.path.join(ckpt, orbax.METADATA)
    with open(path) as fh:
        meta = json.load(fh)
    edit(meta['tree_metadata'])
    with open(path, 'w') as fh:
        json.dump(meta, fh)


def test_reader_refusals(jax_ckpts, tmp_path, monkeypatch):
    from dnncancerannotator_torch import engine

    def copy(name):
        dst = str(tmp_path / name)
        shutil.copytree(jax_ckpts['unet'][0], dst)
        return dst

    ckpt = copy('uncommitted')
    os.remove(os.path.join(ckpt, orbax.COMMIT_METADATA))
    with pytest.raises(ValueError, match='never committed'):
        orbax.read_checkpoint(ckpt)

    def rename(tree, old, new):
        def edit(entries):
            entry = entries.pop(old)
            entry['key_metadata'] = [dict(k, key=n) for k, n in
                                     zip(entry['key_metadata'], new)]
            entries[str(tuple(new))] = entry
        return edit

    leaf = "('opt_state', '0', 'mu', 'last_conv', 'bias')"
    ckpt = copy('twice')
    _edit_metadata(ckpt, rename(None, leaf, ['opt_state', '1', 'mu',
                                             'last_conv', 'bias']))
    with pytest.raises(ValueError, match="'mu' appears twice"):
        orbax.read_checkpoint(ckpt)
    ckpt = copy('unplaced')
    _edit_metadata(ckpt, rename(None, leaf, ['opt_state', '0', 'velocity',
                                             'last_conv', 'bias']))
    with pytest.raises(ValueError, match='cannot be placed'):
        orbax.read_checkpoint(ckpt)
    ckpt = copy('malformed')
    _edit_metadata(ckpt, lambda entries: entries[leaf].pop('key_metadata'))
    with pytest.raises(ValueError, match='malformed'):
        orbax.read_checkpoint(ckpt)
    ckpt = copy('zarr3')
    with open(os.path.join(ckpt, orbax.METADATA)) as fh:
        meta = json.load(fh)
    meta['use_zarr3'] = True
    with open(os.path.join(ckpt, orbax.METADATA), 'w') as fh:
        json.dump(meta, fh)
    with pytest.raises(ValueError, match='use_zarr3'):
        orbax.read_checkpoint(ckpt)
    read_array = zarr.read_array
    monkeypatch.setattr(zarr, 'read_array', lambda store, name: (
        read_array(store, name) + 1 if name == 'opt_state.1.count'
        else read_array(store, name)))
    with pytest.raises(ValueError, match='counts disagree'):
        orbax.read_checkpoint(jax_ckpts['unet'][0])
    monkeypatch.undo()
    neither = tmp_path / 'neither'
    neither.mkdir()
    (neither / 'weights.bin').write_bytes(b'\x00' * 8)
    with pytest.raises(ValueError, match='neither checkpoint format'):
        engine.read_ckpt(str(neither))


# -- the engine on a JAX save_path --------------------------------------------

@pytest.fixture(scope='module')
def e2e(tmp_path_factory):
    '''Records, a JAX save_path of unet.yaml + metrics.yaml at 32² (its
    moments seeded) and its twin in the port's npz form.'''
    from tests import util_synth
    root = tmp_path_factory.mktemp('orbax_e2e')
    records = list(util_synth.make_tfrecords(str(root / 'records'), size=64))
    config = util_orbax.load_config(util_orbax.UNET_CONFIGS + [os.path.join(
        util_orbax.REPO, 'configs', 'additionals', 'metrics.yaml')])
    data = config['data_options']
    data['train']['output_size'] = data['eval']['output_size'] = [32, 32]
    data['eval']['batch_size'] = 5
    config['deploy_options'].update(warp_bank_size=8, steps_per_call=2)
    jax_run = str(root / 'jax_run')
    ckpt, expected = util_orbax.write_run(jax_run, config, seed=6)
    twin = str(root / 'twin')
    twin_ckpt = os.path.join(twin, 'checkpoints', os.path.basename(ckpt))
    os.makedirs(twin_ckpt)
    shutil.copy(os.path.join(jax_run, 'options.yaml'), twin)
    model = {k: v for k, v in expected.items()
             if k.split('/')[0] in ('params', 'batch_stats')}
    np.savez(os.path.join(twin_ckpt, 'params.npz'), **model)
    np.savez(os.path.join(twin_ckpt, 'opt_state.npz'),
             **{k: v for k, v in expected.items()
                if k not in model and k != 'count'})
    return records, jax_run, twin, int(expected['step'])


def test_evaluate_reads_a_jax_run(e2e):
    '''``evaluate`` on the JAX save_path writes the CSVs of its npz twin,
    to the bit, and the loss of the JAX package's own evaluate (1e-5
    relative, as tests/test_torch_eval.py holds it).'''
    import pandas as pd
    from dnncancerannotator_tpu.runs.evaluate import evaluate as jax_evaluate
    from dnncancerannotator_torch.runs.__main__ import main

    records, jax_run, twin, step = e2e
    for run, tag in ((jax_run, 'port'), (twin, 'port')):
        main(argv=['evaluate', '--save_path', run, '--data_path', *records,
                   '--tag', tag, '--export_csv', '--skip_visualization',
                   '--device', 'cpu'])
    jax_evaluate(jax_run, records, 'jax', export_csv=True,
                 skip_visualization=True)

    def csv(run, tag, name):
        return pd.read_csv(os.path.join(run, 'tfevents', tag, name),
                           index_col=0)

    for name in ('results.csv', 'casewise_results.csv'):
        got, want = csv(jax_run, 'port', name), csv(twin, 'port', name)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    got, want = csv(jax_run, 'port', 'results.csv'), csv(
        jax_run, 'jax', 'results.csv')
    assert list(got.index) == list(want.index) == [step]
    assert list(got.columns) == list(want.columns) and len(got.columns) > 5
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)


def test_train_resumes_a_jax_run(e2e, tmp_path):
    '''A resumed ``train`` from the JAX save_path takes the steps of a
    resume from its npz twin, bit for bit, from the checkpoint's step.'''
    import torch
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.utils import config as config_lib

    records, jax_run, twin, step = e2e
    runs = {}
    for name, src in (('jax', jax_run), ('twin', twin)):
        save = str(tmp_path / name)
        shutil.copytree(src, save)
        config = config_lib.load_config(
            os.path.join(save, 'options.yaml'))['config']
        eng = engine.Engine(config, seed=3, device='cpu')
        res = eng.train(pipeline.train_ds(
            records, **config['data_options']['train']), save_path=save,
            max_steps=step + 3, save_freq=1000)
        moments = {k: v.clone() for p, st in eng.optimizer.state.items()
                   for k, v in st.items() if k != 'step'}
        runs[name] = (res.epoch, res.history['loss'],
                      eng.model.state_dict(), eng.optimizer.state)
        assert moments
    (epoch, loss, params, opt), (epoch_b, loss_b, params_b, opt_b) = \
        runs['jax'], runs['twin']
    assert epoch == epoch_b == [step + 1, step + 2, step + 3]
    assert loss == loss_b and all(np.isfinite(loss))
    for name in params:
        assert torch.equal(params[name], params_b[name]), name
    for (p, st), (p_b, st_b) in zip(opt.items(), opt_b.items()):
        assert sorted(st) == sorted(st_b)
        for key in st:
            assert torch.equal(st[key], st_b[key]), key
