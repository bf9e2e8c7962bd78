'''The model geometries past unet.yaml's against the JAX package: upsampling
rates 3 and 4, strided convs and VALID padding, in UNetAnnotator and
MulmoUNetAnnotator (3 first filters, 2 levels, f32 unless stated).

Weights come from the port's seeded init and cross to the JAX model
through ``convert.flax_from_torch_state`` (HWIO kernels, the transposed
convs flipped), so one set of weights runs on both sides. Tolerances: a
forward within 1e-5 absolute of the JAX logits; a parameter gradient of
sum(logits * G) within GRAD_TOL of its max|ref| (f32 sums in other
orders); bf16 by tests/test_torch_bf16.py's rule. Where the JAX model or
its loss raises, the port raises too (a ValueError naming the shapes);
where the JAX loss broadcasts a 1 x 1 output against the labels, the port
takes the same loss.
'''

import os
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dnncancerannotator_tpu import engine as jax_engine
from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_tpu.data import augment as jax_augment
from dnncancerannotator_tpu.models import blocks as jax_blocks
from dnncancerannotator_tpu.models import fastconv as jax_fastconv
from dnncancerannotator_tpu.train import losses as jax_losses
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.data import augment, pipeline
from dnncancerannotator_torch.models import blocks, fastconv
from dnncancerannotator_torch.ops import gates
from dnncancerannotator_torch.train import losses
from tests import test_torch_bf16 as tb
from tests import test_torch_mulmo as tm
from tests import util_bf16_ref, util_synth
from tests.test_torch_augment import _jax_draws
from tests.test_torch_train import CONFIGS, SLICE_TYPES, _small_config
from tests.test_torch_unet import _jax_params, flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(n_filters_first=3, n_downsample=2, rate=2, kernel_size=3,
            conv_stride=1, bn=False, padding='same')
FWD_TOL = 1e-5
GRAD_TOL = 1e-5
# (model, options, input size, input channels): every geometry at the
# sizes the JAX model runs; the last is a strided rate-3 MulmoUNet whose
# pools leave empty planes: its wide transposed conv (45 -> 9 channels)
# gives lax.conv_transpose's 2 x 2 of bias, and the output is 1 x 1
GEOMETRIES = {
    'unet_rate3': ('UNetAnnotator', dict(rate=3), 81, 5),
    'mulmo_rate3': ('MulmoUNetAnnotator', dict(rate=3), 81, 5),
    'unet_rate4': ('UNetAnnotator', dict(rate=4), 64, 5),
    'mulmo_rate4': ('MulmoUNetAnnotator', dict(rate=4), 64, 2),
    'unet_stride2': ('UNetAnnotator', dict(conv_stride=2), 64, 5),
    'mulmo_stride2': ('MulmoUNetAnnotator', dict(conv_stride=2), 64, 5),
    'unet_valid_rate3': ('UNetAnnotator', dict(rate=3, padding='valid'),
                         100, 5),
    'mulmo_valid_rate3': ('MulmoUNetAnnotator',
                          dict(rate=3, padding='valid'), 100, 2),
    'mulmo_valid': ('MulmoUNetAnnotator', dict(padding='valid'), 140, 2),
    'mulmo_stride2_rate3': ('MulmoUNetAnnotator',
                            dict(rate=3, conv_stride=2), 81, 5),
}
# the JAX output shape of each (what the port must give)
SHAPES = {'unet_rate3': 81, 'mulmo_rate3': 81, 'unet_rate4': 64,
          'mulmo_rate4': 64, 'unet_stride2': 1, 'mulmo_stride2': 1,
          'unet_valid_rate3': 65, 'mulmo_valid_rate3': 65,
          'mulmo_valid': 116, 'mulmo_stride2_rate3': 1}
BF16_CASE = 'unet_rate3'    # tests/util_bf16_ref.py's GEOMETRY_CASES


@pytest.fixture(scope='module')
def bf16_refs(tmp_path_factory):
    '''The JAX bf16 values of BF16_CASE, from tests/util_bf16_ref.py in a
    process of its own (as test_torch_bf16.py's), started when the module
    starts so that it runs beside the other tests.'''
    out = tmp_path_factory.mktemp('geometry_bf16')
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    env.pop('DNNCA_PALLAS_INTERPRET', None)
    env['XLA_FLAGS'] = (env.get('XLA_FLAGS', '')
                        + ' --xla_allow_excess_precision=false').strip()
    proc = subprocess.Popen(
        [sys.executable, '-m', 'tests.util_bf16_ref', str(out), BF16_CASE],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _case(name, overrides, size, channels, seed=0):
    '''(port model, JAX model, flat weights, x [1, size, size, C]): the
    port's seeded weights with random biases.'''
    options = dict(BASE, **overrides)
    port, _ = torch_models.build_model(
        name, options, in_channels=channels,
        generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():   # non-zero biases, so a misplaced bias shows
        for key, param in port.named_parameters():
            if key.endswith('.bias'):
                param.copy_(torch.from_numpy(
                    rng.standard_normal(param.shape).astype(np.float32)
                    * 0.1))
    model, _ = jax_models.build_model(name, options)
    x = rng.random((1, size, size, channels), dtype=np.float32)
    return port, model, convert.flax_from_torch_state(port.state_dict()), x


def _jax_logits(model, flat, x):
    return np.asarray(jax.jit(lambda p, v: model.apply(
        {'params': p}, v, return_logits=True))(_jax_params(flat),
                                               jnp.asarray(x)))


@pytest.mark.parametrize('case', list(GEOMETRIES))
def test_forward_matches_jax(case, bf16_refs):
    port, model, flat, x = _case(*GEOMETRIES[case])
    want = _jax_logits(model, flat, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_logits=True).numpy()
    side = SHAPES[case]
    assert got.shape == want.shape == (1, side, side, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_build_model_takes_every_geometry():
    '''Every rate, conv_stride and padding the JAX models build, for both
    annotators, builds in the port with the JAX parameter tree (the
    stride and the padding change no parameter: the JAX tree is traced
    once a rate).'''
    for name in ('UNetAnnotator', 'MulmoUNetAnnotator'):
        for rate in (2, 3, 4):
            model, _ = jax_models.build_model(name, dict(BASE, rate=rate))
            shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 2)))['params']
            want = {'/'.join(['params'] + [str(k.key) for k in path]):
                    tuple(leaf.shape) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(shapes)[0]}
            for stride in (1, 2):
                for padding in ('same', 'valid'):
                    options = dict(BASE, rate=rate, conv_stride=stride,
                                   padding=padding)
                    jax_models.build_model(name, options)
                    port, _ = torch_models.build_model(name, options,
                                                       in_channels=2)
                    got = {k: v.shape for k, v in
                           convert.flax_from_torch_state(
                               port.state_dict()).items()}
                    assert got == want, (name, options)


def test_where_jax_raises_the_port_raises():
    '''A strided rate-3 UNetAnnotator at 81 x 81: its second pool leaves a
    0 x 0 plane, and the decoder's small strided conv of it refuses a
    negative slice limit in the JAX package (TypeError) and in the port
    (ValueError).'''
    port, model, flat, x = _case('UNetAnnotator',
                                 dict(rate=3, conv_stride=2), 81, 5)
    with pytest.raises(TypeError, match='nonnegative'):
        _jax_logits(model, flat, x)
    with pytest.raises(ValueError, match='0x0 plane'):
        port(torch.from_numpy(x))


@pytest.mark.parametrize('case', ['unet_rate3', 'unet_valid_rate3'])
def test_gradients_match_jax(case):
    '''Every parameter gradient of sum(logits * G) against jax.grad.'''
    port, model, flat, x = _case(*GEOMETRIES[case], seed=1)
    side = SHAPES[case]
    gmap = np.random.default_rng(2).standard_normal(
        (1, side, side, 1)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.vdot(model.apply(
        {'params': p}, jnp.asarray(x), return_logits=True),
        jnp.asarray(gmap))))(_jax_params(flat))
    want = convert.torch_state_from_flax(flat_params(grads))
    (port(torch.from_numpy(x), return_logits=True)
     * torch.from_numpy(gmap)).sum().backward()
    for key, param in port.named_parameters():
        ref = want[key].numpy()
        np.testing.assert_allclose(param.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=key)


@pytest.mark.parametrize('size,target', [(9, 5), (10, 5), (9, 9), (2, 3),
                                         (1, 2), (2, 6), (0, 2), (21, 3)])
def test_center_crop_matches_jax(size, target):
    '''The skip crop's slicing, a target larger than the skip included (the
    strided geometries), in both layouts.'''
    x = np.arange(2 * 3 * size * size, dtype=np.float32).reshape(
        2, 3, size, size)
    for fmt, arr in (('NCHW', x), ('NHWC', x.transpose(0, 2, 3, 1))):
        want = np.asarray(jax_blocks.center_crop_to(
            jnp.asarray(arr), target, target, fmt))
        got = blocks.center_crop_to(torch.from_numpy(arr.copy()), target,
                                    target, fmt).numpy()
        np.testing.assert_array_equal(got, want)


def test_conv_geometry_matches_jax():
    for h in (0, 1, 2, 5, 64, 81):
        for k in (1, 3, 5):
            for s in (1, 2, 3):
                for padding in ('SAME', 'VALID', 'same', 'valid'):
                    assert fastconv.conv_geometry(
                        h, h + 1, k, k, (s, s), padding) == \
                        jax_fastconv._conv_geometry(
                            h, h + 1, k, k, (s, s), padding), (h, k, s,
                                                               padding)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rate,ci,co', [(3, 4, 5), (4, 3, 2), (3, 40, 6)])
def test_tconv_matches_jax(rate, ci, co, dtype):
    '''ConvTranspose2DFast at kernel == stride == 3 and 4 against the JAX
    module on converted weights (convert.py's flip of a tconv kernel), NCHW
    and NHWC, small (the JAX einsum form) and wide (lax.conv_transpose);
    f32 within FWD_TOL of the scale, bf16 within a bf16 ulp of it (the
    output is rounded once on each side, after an f32 sum of ci terms).'''
    rng = np.random.default_rng(rate * ci)
    kernel = rng.standard_normal((rate, rate, ci, co)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    x = rng.standard_normal((2, 5, 6, ci)).astype(np.float32)
    flat = {'params/up/tconv/kernel': kernel, 'params/up/tconv/bias': bias}
    state = convert.torch_state_from_flax(flat)
    back = convert.flax_from_torch_state(state)
    np.testing.assert_array_equal(back['params/up/tconv/kernel'], kernel)
    for fmt in ('NCHW', 'NHWC'):
        arr = x.transpose(0, 3, 1, 2) if fmt == 'NCHW' else x
        module = jax_fastconv.ConvTranspose2DFast(
            features=co, kernel_size=(rate, rate), strides=(rate, rate),
            dtype=jnp.bfloat16 if dtype == 'bfloat16' else None,
            data_format=fmt)
        want = np.asarray(module.apply(
            {'params': {'kernel': kernel, 'bias': bias}},
            jnp.asarray(arr)).astype(jnp.float32))
        port = fastconv.ConvTranspose2DFast(ci, co, (rate, rate),
                                            (rate, rate), data_format=fmt,
                                            dtype=dtype)
        port.load_state_dict({'weight': state['up.tconv.weight'],
                              'bias': state['up.tconv.bias']})
        with torch.no_grad():
            got = port(torch.from_numpy(arr.copy())).float().numpy()
        assert got.shape == want.shape
        ulp = 2.0 ** -8 if dtype == 'bfloat16' else FWD_TOL
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ulp * np.abs(want).max(),
                                   err_msg=fmt)


def test_bf16_forward_rate3_matches_jax(bf16_refs):
    '''unet.yaml's model at rate 3 in bf16 (2 levels, [2, 27, 27, 5]): the
    eval-mode logits within tests/test_torch_bf16.py's BF16_TOL of their
    scale outright, the train-mode logits and every gradient by its rule
    (BF16_TOL, else F64_RATIO of the JAX bf16 value's RMS distance from
    the f64 one), and bf16 really on.'''
    proc, out = bf16_refs
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    name, options, shape, _, sens = util_bf16_ref.GEOMETRY_CASES[BF16_CASE]
    part = tb._load(out, BF16_CASE)
    x, gmap = tb._t(part['in']['x']), tb._t(part['in']['gmap'])
    want = {k: tb._t(v) for k, v in part['bf16'].items()}
    want64 = {k: tb._t(v) for k, v in part['f64'].items()}
    port = tb._port(name, options, shape, part['param'], 'bfloat16')
    got = tm._run_port(port, x, gmap, gates.KernelGates(), sens)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        err = float((got[key].double() - value.double()).abs().max())
        if key == 'eval' or err <= tb.BF16_TOL * tb._scale(want, key):
            assert err <= tb.BF16_TOL * tb._scale(want, key), key
            continue
        ours, theirs = tb._rms(got[key], want64[key]), tb._rms(
            value, want64[key])
        assert ours <= tb.F64_RATIO * theirs, (key, err, ours, theirs)
    port32 = tb._port(name, options, shape, part['param'], None)
    with torch.no_grad():
        logits32 = port32(x, return_logits=True)
    gap_jax = float((want['train'] - tb._t(part['f32']['train'])).abs().max())
    gap_port = float((got['train'] - logits32).abs().max())
    assert gap_jax > 0 and gap_port >= tb.GUARD_SHARE * gap_jax


def test_train_steps_rate3_match_jax():
    '''Three train steps of unet.yaml's model at rate 3 (2 levels, 36 x 36
    crops, B=2) against the JAX train step on the same raw batches, draws
    and warp bank, as tests/test_torch_train.py's
    test_three_train_steps_match_jax: the losses within 1e-5 relative,
    every parameter within 1e-6 absolute.'''
    config = _small_config()
    config['model_options'].update(rate=3, n_downsample=2)
    config['data_options']['train']['output_size'] = [36, 36]
    opts = config['data_options']['train']
    methods = jax_augment.parse_augment_options(
        opts['augment_options'], SLICE_TYPES, (36, 36))
    dataset = types.SimpleNamespace(augment_methods=methods,
                                    slice_types=SLICE_TYPES, batch_size=2,
                                    feature_shape=(2, 36, 36, 5))
    jeng = jax_engine.Engine(config)
    jeng.build((2, 36, 36, 5))
    flat0 = flat_params(jeng.state['params'])
    jstep = jax.jit(jeng._make_train_step(dataset, multi_step='one_step'))
    bank = jeng._warp_bank(dataset)
    port_bank = dict(bank, flows=torch.from_numpy(np.array(bank['flows'])))

    eng = engine.Engine(config, device='cpu')
    eng._setup_training(pipeline.TrainDataset(
        'unused.tfrecords', **dict(opts, output_size=(36, 36))))
    eng.model.load_state_dict(convert.torch_state_from_flax(
        flat0, expected=eng.model.state_dict()))
    assert eng.model.unet.decoder.up_0.tconv.weight.shape[2:] == (3, 3)

    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(7)
    state = jeng.state
    for step in range(3):
        raw = rng.integers(0, 256, (2, 48, 48, 6), dtype=np.uint8)
        raw[..., 5] = np.where(raw[..., 5] > 200, 255, 0)
        draws = _jax_draws(methods, 2, jax.random.fold_in(key, step), 6)
        eng._augment = lambda images, gen, d=draws: augment.apply_chain(
            methods, images, d, port_bank)
        state, want_loss, _, _ = jstep(state, jnp.asarray(raw), key)
        got_loss = eng.train_step(torch.from_numpy(raw), step, gen=None)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
    want = convert.torch_state_from_flax(flat_params(state['params']))
    for name, p in eng.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_loss_shapes_as_jax():
    '''A VALID model's smaller output: the JAX loss raises, and so does the
    port's, naming both shapes, in the train step too (the eval step, and
    so evaluate and predict, call the same loss); a strided model's 1 x 1
    output broadcasts in both, to the same loss.'''
    rng = np.random.default_rng(3)
    labels = (rng.random((2, 32, 32)) > 0.8).astype(np.float32)
    small = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    with pytest.raises(TypeError, match='broadcast'):
        jax_losses.WeightedCrossentropy().per_sample(jnp.asarray(labels),
                                                     jnp.asarray(small))
    with pytest.raises(ValueError, match=r'\(2, 8, 8\).*\(2, 32, 32\)'):
        losses.WeightedCrossentropy().per_sample(torch.from_numpy(labels),
                                                 torch.from_numpy(small))
    one = rng.standard_normal((2, 1, 1, 1)).astype(np.float32)
    want = jax_losses.WeightedCrossentropy().per_sample(
        jnp.asarray(labels), jnp.asarray(one))
    got = losses.WeightedCrossentropy().per_sample(torch.from_numpy(labels),
                                                   torch.from_numpy(one))
    # means of 1024 f32 terms summed in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    config = _small_config()
    config['model_options'].update(padding='valid', n_downsample=2)
    opts = config['data_options']['train']
    eng = engine.Engine(config, device='cpu')
    eng._setup_training(pipeline.TrainDataset(
        'unused.tfrecords', **dict(opts, output_size=(32, 32))))
    raw = torch.from_numpy(rng.integers(0, 256, (2, 44, 44, 6),
                                        dtype=np.uint8))
    with pytest.raises(ValueError, match=r'logits \(2, 8, 8\).*\(2, 32, 32\)'):
        eng.train_step(raw, 0, gen=torch.Generator().manual_seed(0))


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    return list(util_synth.make_tfrecords(
        str(tmp_path_factory.mktemp('geometry_records')), size=64))


def _jax_runs(root, records, variants):
    '''{name: a JAX save_path} (options.yaml and an Orbax checkpoint, which
    the port reads as it is) of unet.yaml at 2 levels and 64 x 64 with
    each variant's model options; one checkpoint serves them all (neither
    the stride nor the padding changes a parameter).'''
    from dnncancerannotator_tpu.utils import config as jax_config
    from dnncancerannotator_tpu.utils import dump
    saves = {}
    for name, model_options in variants.items():
        config = jax_config.load_config(CONFIGS)
        config['model_options'].update(n_downsample=2, **model_options)
        config['data_options']['eval']['output_size'] = [64, 64]
        save = saves[name] = str(root / name)
        dump.dump_options(os.path.join(save, 'options.yaml'), config=config,
                          save_path=save, data_path=records)
        ckpts = os.path.join(save, 'checkpoints')
        if len(saves) == 1:
            eng = jax_engine.Engine(config)
            eng.build((5, 64, 64, 5))
            eng.save_ckpt(ckpts, 3)
            eng.finalize_checkpoints()
            first = ckpts
        else:
            shutil.copytree(first, ckpts)
    return saves


def test_cli_paths_as_jax(records, tmp_path):
    '''The CLI where the JAX engine completes and where it raises: a
    strided model predicts 1 x 1 maps (its loss broadcasts) equal to the
    JAX package's; a VALID model's predict raises in both (the loss), and
    its export completes in both, with the same sidecar (the input's
    shape as the output's, as the JAX package writes it) and an artifact
    whose 40 x 40 output equals the JAX artifact's.'''
    from dnncancerannotator_tpu.runs import export as jax_export
    from dnncancerannotator_tpu.runs.predict import predict as jax_predict
    from dnncancerannotator_torch.runs import export as torch_export
    from dnncancerannotator_torch.runs.__main__ import main as torch_main

    runs = _jax_runs(tmp_path, records, {'strided': dict(conv_stride=2),
                                         'valid': dict(padding='valid')})
    strided, valid = runs['strided'], runs['valid']
    maps = {}
    for name in ('jax', 'torch'):
        out = str(tmp_path / f'{name}_maps')
        if name == 'jax':
            jax_predict(strided, records, out, batch_size=5,
                        output_format='npy')
        else:
            torch_main(argv=['predict', '--save_path', strided,
                             '--data_path', *records, '--output_path', out,
                             '--batch_size', '5', '--output_format', 'npy',
                             '--device', 'cpu'])
        maps[name] = {os.path.relpath(os.path.join(d, f), out):
                      np.load(os.path.join(d, f))
                      for d, _, files in os.walk(out) for f in files}
    assert sorted(maps['torch']) == sorted(maps['jax'])
    assert len(maps['jax']) == 12
    for key, want in maps['jax'].items():
        assert want.shape == maps['torch'][key].shape == (1, 1)
        np.testing.assert_allclose(maps['torch'][key], want, rtol=0,
                                   atol=FWD_TOL)

    with pytest.raises(TypeError, match='broadcast'):
        jax_predict(valid, records, str(tmp_path / 'jax_valid'),
                    batch_size=5)
    with pytest.raises(ValueError, match=r'\(5, 40, 40\).*\(5, 64, 64\)'):
        torch_main(argv=['predict', '--save_path', valid, '--data_path',
                         *records, '--output_path',
                         str(tmp_path / 'torch_valid'), '--batch_size', '5',
                         '--device', 'cpu'])
    jax_art = jax_export.export_model(valid, str(tmp_path / 'jax_art'),
                                      platforms=('cpu',))
    torch_art = torch_export.export_model(valid, str(tmp_path / 'torch_art'))
    sidecars = []
    for path in (jax_art, torch_art):
        with open(os.path.splitext(path)[0] + '.yaml') as fh:
            sidecars.append(yaml.safe_load(fh))
    assert sidecars[0]['output'] == sidecars[1]['output']
    assert sidecars[1]['output']['shape'] == [-1, 64, 64, 1]
    x = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 5), np.uint8)
    want = np.asarray(jax_export.load_exported(jax_art)(x))
    got = torch_export.load_exported(torch_art, device='cpu')(x)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape == (2, 40, 40, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
