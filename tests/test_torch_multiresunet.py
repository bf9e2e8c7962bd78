'''The port's MultiResUnet on the CPU against the JAX package: BatchNorm
without a scale, flax ``nn.ConvTranspose``'s tap convention against the
port's transposed conv and the JAX package's ConvTranspose2DFast, the
model at base_filters 4 on 32 x 32 (logits, batch_stats, every parameter
gradient; tolerances and the float64 rule of
tests/test_torch_mulmo.py), the converter, and the ``train`` / ``evaluate``
/ ``predict`` CLI with resume.
'''

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dnncancerannotator_tpu.models import fastbn as jax_fastbn
from dnncancerannotator_tpu.models import fastconv as jax_fastconv
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.models import fastbn, multiresunet
from dnncancerannotator_torch.runs.__main__ import main
from tests import util_synth
from tests.test_torch_mulmo import (GATES_OFF, check_model_against_jax,
                                    model_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(height=None, width=None, n_channels=5, base_filters=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_no_scale_batchnorm_matches_flax():
    '''BatchNormFast(use_scale=False): no scale parameter on either side;
    train-mode output, statistics and the x and bias gradients, then the
    eval-mode output, within 1e-5 of max|ref|.'''
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 6, 5, 3)) * 2 + 1).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jbn = jax_fastbn.BatchNormFast(use_running_average=None, use_scale=False)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         use_running_average=False)
    assert sorted(variables['params']) == ['bias']
    bn = fastbn.BatchNormFast(3, use_scale=False)
    assert [n for n, _ in bn.named_parameters()] == ['bias']
    bias = rng.standard_normal(3).astype(np.float32)
    params = {'bias': jnp.asarray(bias)}
    with torch.no_grad():
        bn.bias.copy_(_t(bias))

    def train_out(p, x_):
        return jbn.apply({'params': p, 'batch_stats': variables['batch_stats']},
                         x_, use_running_average=False,
                         mutable=['batch_stats'])

    y, new_stats = train_out(params, jnp.asarray(x))
    dp, dx = jax.grad(lambda p, x_: jnp.vdot(train_out(p, x_)[0],
                                             jnp.asarray(g)),
                      argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    bn.train()
    yt = bn(xt)
    (yt * _t(g)).sum().backward()
    for got, want in ((yt.detach(), y), (bn.mean, new_stats['batch_stats']
                                          ['mean']),
                      (bn.var, new_stats['batch_stats']['var']),
                      (xt.grad, dx), (bn.bias.grad, dp['bias'])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    bn.eval()
    stats = {k: np.asarray(v) for k, v in new_stats['batch_stats'].items()}
    want = jbn.apply({'params': params, 'batch_stats': stats},
                     jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        got = bn(_t(x)).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()


def test_flax_conv_transpose_taps_match_the_port():
    '''flax nn.ConvTranspose (transpose_kernel=False, MultiResUnet's raw
    decoder upsample) applies its HWIO kernel as the JAX package's
    ConvTranspose2DFast does, so convert.py's one flip of every ``tconv``
    kernel serves both: the port's UpTconv on the converted weights equals
    both JAX modules' apply.'''
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    flax_tconv = nn.ConvTranspose(features=4, kernel_size=(2, 2),
                                  strides=(2, 2), padding='SAME')
    variables = flax_tconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = rng.standard_normal((2, 2, 7, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    params = {'kernel': jnp.asarray(kernel), 'bias': jnp.asarray(bias)}
    assert variables['params']['kernel'].shape == kernel.shape
    want = np.asarray(flax_tconv.apply({'params': params}, jnp.asarray(x)))
    fast = jax_fastconv.ConvTranspose2DFast(features=4, kernel_size=(2, 2),
                                            strides=(2, 2))
    np.testing.assert_allclose(
        np.asarray(fast.apply({'params': params}, jnp.asarray(x))), want,
        rtol=1e-5, atol=1e-5)
    up = multiresunet.UpTconv(7, 4)
    up.load_state_dict(convert.torch_state_from_flax(
        {'params/tconv/kernel': kernel, 'params/tconv/bias': bias}))
    with torch.no_grad():
        got = up(_t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_filter_splits():
    '''The JAX model's Python float arithmetic: 51, 105, 212, 426 and 853
    channels at 32 base filters.'''
    assert [sum(multiresunet.multires_filters(32 * s))
            for s in (1, 2, 4, 8, 16)] == [51, 105, 212, 426, 853]
    assert multiresunet.multires_filters(4) == (1, 2, 3)


def test_multiresunet_matches_jax():
    '''base_filters 4 on 5 channels at 32 x 32, in train and eval mode (the
    input sensitivity is left out: its third compile of the JAX model takes
    half a minute here; MultiResUnet runs no kernel of the port).'''
    case = model_case('MultiResUnet', SMALL, (2, 32, 32, 5), 7)
    held = check_model_against_jax('MultiResUnet', SMALL, case, GATES_OFF,
                                   sens=False)
    # 24 here, BatchNorm and conv gradients of the blocks with 1-3
    # channels a branch: the logits and statistics meet their tolerances
    assert all(key.startswith('params/') for key in held), held


def test_multiresunet_converter_round_trip():
    '''Every leaf of the flax tree, the no-scale BatchNorms (bias only) and
    the raw decoder tconvs included, survives flax -> port -> flax, and
    the port's state_dict has the flax tree's keys.'''
    _, _, _, flat, stats = model_case('MultiResUnet', SMALL, (1, 16, 16, 5),
                                      8)
    both = {**flat, **stats}
    assert 'params/mres1/shortcut/bn/bias' in both
    assert 'params/mres1/shortcut/bn/scale' not in both
    assert 'params/head_bn/scale' not in both
    assert 'params/up6/tconv/kernel' in both
    port, _ = torch_models.build_model('MultiResUnet', SMALL, in_channels=5)
    assert sorted(convert.flax_from_torch_state(port.state_dict())) == \
        sorted(both)
    back = convert.flax_from_torch_state(convert.torch_state_from_flax(
        both, expected=port.state_dict()))
    assert sorted(back) == sorted(both)
    for key in both:
        np.testing.assert_array_equal(back[key], both[key])


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_multiresunet')
    return list(util_synth.make_tfrecords(str(tmp), size=64, n_slices=2))


def test_multiresunet_train_evaluate_predict_cli(records, tmp_path):
    '''multiresunet.yaml (base_filters 4) through the train CLI with
    --validate: 2 + 2 steps with a resume equal 4 in one call, batch_stats
    move; evaluate writes one results row a checkpoint; predict writes
    finite maps in [0, 1].'''
    overlay = tmp_path / 'narrow.json'
    overlay.write_text(json.dumps({
        'model_options.base_filters': 4,
        'data_options.train.output_size': [32, 32],
        'data_options.train.batch_size': 2,
        'data_options.eval.output_size': [32, 32],
        'data_options.eval.batch_size': 4,
        'deploy_options.warp_bank_size': 8,
        'deploy_options.steps_per_call': 2,
    }))
    configs = [os.path.join(REPO, 'configs', c) for c in (
        'multiresunet.yaml', 'additionals/data_options.yaml',
        'additionals/deploy_options.yaml')]

    def run(save, max_steps, validate=False):
        argv = ['train', '--config', *configs, str(overlay), '--save_path',
                save, '--data_path', *records, '--save_freq', '2', '--seed',
                '1', '--device', 'cpu', '--max_steps', str(max_steps)]
        if validate:
            argv += ['--validate', '--val_data_path', *records]
        return main(argv=argv)

    def ckpt(save, step):
        return engine.read_ckpt(os.path.join(
            save, 'checkpoints', f'ckpt-{step}'), opt_state=False)

    a, b = str(tmp_path / 'a'), str(tmp_path / 'b')
    res = run(a, 4, validate=True)
    assert res.epoch == [1, 2, 3, 4] and np.isfinite(res.history['loss']).all()
    assert len(res.history['val_loss']) == 2
    run(b, 2)
    assert run(b, 4).epoch == [3, 4]
    unbroken, resumed, first = ckpt(a, 4), ckpt(b, 4), ckpt(b, 2)
    assert sorted(unbroken) == sorted(resumed)
    for key in unbroken:
        np.testing.assert_array_equal(unbroken[key], resumed[key], key)
    stats = [k for k in first if k.startswith('batch_stats/')]
    assert stats and all(
        not np.allclose(first[k], 1.0 if k.endswith('/var') else 0.0)
        for k in stats)
    rows = main(argv=['evaluate', '--save_path', a, '--data_path', *records,
                      '--tag', 'val', '--export_csv', '--device', 'cpu'])
    assert sorted(rows) == [2, 4]
    assert all(np.isfinite(r['loss']) for r in rows.values())
    out = str(tmp_path / 'maps')
    count = main(argv=['predict', '--save_path', a, '--data_path', *records,
                       '--output_path', out, '--output_format', 'npy',
                       '--device', 'cpu'])
    assert count > 0
    for root, _, files in os.walk(out):
        for f in files:
            m = np.load(os.path.join(root, f))
            assert np.isfinite(m).all() and m.min() >= 0 and m.max() <= 1
