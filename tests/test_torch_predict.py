'''The port's predict CLI against the JAX package's predict, on the same
checkpoint weights and .tfrecords, and the port's eval pipeline against
the JAX one.'''

import os
import shutil

import numpy as np
import pytest

from tests import util_synth
from tests.test_torch_unet import flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, 'configs', 'unet.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'deploy_options.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'data_options.yaml')]


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmpdir = tmp_path_factory.mktemp('torch_predict')
    return list(util_synth.make_tfrecords(str(tmpdir), size=64))


def _maps(root, output_format):
    maps = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            if output_format == 'npy':
                maps[os.path.relpath(path, root)] = np.load(path)
            else:
                from PIL import Image
                with Image.open(path) as img:
                    maps[os.path.relpath(path, root)] = \
                        np.asarray(img).astype(np.float64)
    return maps


@pytest.fixture(scope='module')
def save_paths(records, tmp_path_factory):
    '''A JAX save_path (options.yaml + Orbax checkpoint) and the port's
    save_path with the same options and the same params as params.npz.'''
    from dnncancerannotator_tpu import engine as jax_engine
    from dnncancerannotator_tpu.utils import config as jax_config
    from dnncancerannotator_tpu.utils import dump

    tmp = tmp_path_factory.mktemp('save_paths')
    config = jax_config.load_config(CONFIGS)
    config['data_options']['eval']['output_size'] = [64, 64]
    jax_save = str(tmp / 'jax_run')
    dump.dump_options(os.path.join(jax_save, 'options.yaml'), config=config,
                      save_path=jax_save, data_path=records)
    engine = jax_engine.Engine(config)
    engine.build((5, 64, 64, 5))
    engine.save_ckpt(os.path.join(jax_save, 'checkpoints'), 7)
    engine.finalize_checkpoints()

    torch_save = str(tmp / 'torch_run')
    ckpt = os.path.join(torch_save, 'checkpoints', 'ckpt-7')
    os.makedirs(ckpt)
    shutil.copy(os.path.join(jax_save, 'options.yaml'), torch_save)
    np.savez(os.path.join(ckpt, 'params.npz'),
             **flat_params(engine.state['params']))
    return jax_save, torch_save


@pytest.mark.parametrize('output_format', ['npy', 'png', 'png16'])
def test_predict_cli_matches_jax(records, save_paths, tmp_path,
                                 output_format):
    from dnncancerannotator_tpu.runs.predict import predict as jax_predict
    from dnncancerannotator_torch.runs.__main__ import main as torch_main

    jax_save, torch_save = save_paths
    # 12 slices at batch 5: the last batch is short
    jax_out, torch_out = str(tmp_path / 'jax_out'), str(tmp_path / 'torch_out')
    n_jax = jax_predict(jax_save, records, jax_out, batch_size=5,
                        output_format=output_format)
    n_torch = torch_main(argv=[
        'predict', '--save_path', torch_save, '--data_path', *records,
        '--output_path', torch_out, '--batch_size', '5',
        '--output_format', output_format, '--device', 'cpu'])
    assert n_jax == n_torch == 12
    want, got = _maps(jax_out, output_format), _maps(torch_out, output_format)
    assert sorted(got) == sorted(want)
    # probabilities within 1e-5; a PNG level may round the other way
    atol = {'npy': 1e-5, 'png': 1.0, 'png16': 1.0}[output_format]
    for name in want:
        assert got[name].shape == want[name].shape == (64, 64)
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_predict_reads_the_jax_run(records, save_paths, tmp_path):
    '''predict on the JAX save_path itself (its Orbax checkpoint, read by
    the port's ckpt/) writes the maps of its npz twin, to the bit, and the
    JAX package's within 1e-5.'''
    from dnncancerannotator_tpu.runs.predict import predict as jax_predict
    from dnncancerannotator_torch.runs.__main__ import main as torch_main

    jax_save, torch_save = save_paths
    maps = {}
    for name, save in (('jax_run', jax_save), ('twin', torch_save)):
        out = str(tmp_path / name)
        torch_main(argv=[
            'predict', '--save_path', save, '--data_path', *records,
            '--output_path', out, '--batch_size', '5', '--output_format',
            'npy', '--device', 'cpu'])
        maps[name] = _maps(out, 'npy')
    jax_out = str(tmp_path / 'jax_out')
    jax_predict(jax_save, records, jax_out, batch_size=5,
                output_format='npy')
    want = _maps(jax_out, 'npy')
    assert sorted(maps['jax_run']) == sorted(maps['twin']) == sorted(want)
    for name in want:
        got = maps['jax_run'][name]
        assert got.tobytes() == maps['twin'][name].tobytes(), name
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_eval_dataset_matches_jax(records):
    from dnncancerannotator_tpu.data import pipeline as jax_pipeline
    from dnncancerannotator_torch.data import pipeline as torch_pipeline

    # pads one axis and crops the other
    kwargs = dict(batch_size=5, output_size=(80, 48),
                  slice_types=('ADC', 'TRA', 'label', 'DWI'))
    want = list(jax_pipeline.predict_ds(records, **kwargs).batches())
    got = list(torch_pipeline.predict_ds(records, **kwargs).batches())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g['slices'].dtype == np.uint8
        np.testing.assert_array_equal(g['slices'], w['slices'])
        assert g['meta'] == w['meta']


def test_tfrecord_codec_matches_jax(records, tmp_path):
    '''Same bytes out of both writers, including the chunked CRC32C.'''
    from dnncancerannotator_tpu.data import tfrecord as jax_tfr
    from dnncancerannotator_torch.data import tfrecord as torch_tfr

    payloads = list(jax_tfr.read_records(records[0]))
    assert payloads
    payloads.append(bytes(range(256)) * 300)   # crosses the chunked CRC path
    for name, mod in (('jax', jax_tfr), ('torch', torch_tfr)):
        with open(tmp_path / f'{name}.tfrecords', 'wb') as f:
            for p in payloads:
                mod.write_record(f, p)
    assert (tmp_path / 'jax.tfrecords').read_bytes() == \
        (tmp_path / 'torch.tfrecords').read_bytes()
    assert list(torch_tfr.read_records(str(tmp_path / 'torch.tfrecords'),
                                       verify_crc=True)) == payloads
