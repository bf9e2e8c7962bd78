'''The port's training path on the CPU against the JAX package: the loss,
the learning-rate schedule, the optimizers, three full train steps on the
same batches and draws, the resident sampler, and a small ``train`` CLI run
that checkpoints, resumes and predicts.

Tolerances: the loss within 1e-6 relative; schedules and optimizer updates
within 1e-6 relative (f32 on one side, float64 learning rates on the
other); after three train steps the losses within 1e-5 relative and every
parameter within 1e-6 absolute (each step moves a parameter by about
lr = 1e-3; the gradients agree to ~2e-6 relative, test_torch_grads.py;
1.5e-7 measured).
'''

import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnncancerannotator_tpu import engine as jax_engine
from dnncancerannotator_tpu.data import augment as jax_augment
from dnncancerannotator_tpu.train import losses as jax_losses
from dnncancerannotator_tpu.train import optimizers as jax_optimizers
from dnncancerannotator_tpu.train import schedules as jax_schedules
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.data import augment, pipeline
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.train import losses, optimizers, schedules
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_synth
from tests.test_torch_augment import _jax_draws
from tests.test_torch_unet import flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, 'configs', 'unet.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'deploy_options.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'data_options.yaml')]
SLICE_TYPES = util_synth.SLICE_TYPES


def _t(a):
    return torch.from_numpy(np.array(a))


# -- loss, schedule, optimizers ------------------------------------------------------
@pytest.mark.parametrize('labels', ['binary', 'none', 'warped'])
@pytest.mark.parametrize('spec', [dict(weight_mul=3.0),
                                  dict(weight=2.5, weight_add=0.5)])
def test_weighted_crossentropy_matches_jax(labels, spec):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 16, 16, 1)) * 4).astype(np.float32)
    y = {'binary': (rng.random((3, 16, 16)) > 0.9),
         'none': np.zeros((3, 16, 16)),
         'warped': rng.random((3, 16, 16)) * (rng.random((3, 16, 16)) > 0.8),
         }[labels].astype(np.float32)
    want = jax_losses.WeightedCrossentropy(**spec).per_sample(
        jnp.asarray(y), jnp.asarray(logits))
    got = losses.WeightedCrossentropy(**spec).per_sample(_t(y), _t(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_label_smoothing_raises():
    with pytest.raises(NotImplementedError, match='label_smoothing'):
        losses.solve_loss({'class_name': 'WeightedCrossentropy',
                           'config': {'label_smoothing': True}})


@pytest.mark.parametrize('spec', [
    'lambda epoch, current_lr: 0.001 * 0.96 ** (epoch // 1000)',
    'lambda e, lr: 0.01 * 0.9 ** e', 'lambda e, lr: 0.005',
    {'kind': 'exponential_step_decay', 'initial': 1e-3, 'rate': 0.5,
     'interval': 3},
])
def test_schedule_matches_jax(spec):
    got, want = schedules.solve_schedule(spec), jax_schedules.solve_schedule(
        spec)
    for step in (0, 1, 5, 999, 1000, 2500, 10000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    with pytest.raises(ValueError, match='parsed'):
        schedules.solve_schedule('lambda e, lr: __import__("os")')


@pytest.mark.parametrize('spec', [
    'adam',
    {'class_name': 'Adam', 'config': {'beta_1': 0.8, 'epsilon': 1e-5}},
    {'class_name': 'AdamW', 'config': {'weight_decay': 0.01}},
    {'class_name': 'SGD', 'config': {'momentum': 0.9, 'nesterov': True}},
])
def test_optimizer_matches_optax(spec):
    rng = np.random.default_rng(1)
    p0 = [rng.standard_normal((4, 3)).astype(np.float32),
          rng.standard_normal(5).astype(np.float32)]
    grads = [[(rng.standard_normal(p.shape) * 10.0 ** -k).astype(np.float32)
              for p in p0] for k in range(5)]   # down to 1e-4: eps matters
    sched = jax_schedules.solve_schedule('lambda e, lr: 0.01 * 0.5 ** e')
    tx, _ = jax_optimizers.solve_optimizer(spec, sched)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tparams = [torch.nn.Parameter(_t(p)) for p in p0]
    opt, schedule = optimizers.solve_optimizer(
        spec, tparams, schedules.solve_schedule('lambda e, lr: 0.01 * 0.5 ** e'))
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        for group in opt.param_groups:
            group['lr'] = schedule(step)
        for p, x in zip(tparams, g):
            p.grad = _t(x)
        opt.step()
    for got, want in zip(tparams, params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_adam_eps_and_unported_optimizers():
    opt, _ = optimizers.solve_optimizer('adam', [torch.nn.Parameter(
        torch.zeros(1))])
    assert opt.defaults['eps'] == 1e-7
    with pytest.raises(NotImplementedError, match='rmsprop'):
        optimizers.solve_optimizer('rmsprop', [torch.nn.Parameter(
            torch.zeros(1))])


# -- three train steps against the JAX engine -------------------------------------------
def _small_config(**deploy):
    config = config_lib.load_config(CONFIGS)
    config['data_options']['train']['output_size'] = [32, 32]
    config['data_options']['train']['batch_size'] = 2
    config['deploy_options'].update(warp_bank_size=6, **deploy)
    return config


def test_three_train_steps_match_jax():
    '''The JAX train step and the port's on the same raw batches, with the
    augmentation draws and the warp bank of the JAX step fed to the port.'''
    config = _small_config()
    opts = config['data_options']['train']
    methods = jax_augment.parse_augment_options(
        opts['augment_options'], SLICE_TYPES, (32, 32))
    dataset = types.SimpleNamespace(augment_methods=methods,
                                    slice_types=SLICE_TYPES, batch_size=2,
                                    feature_shape=(2, 32, 32, 5))
    jeng = jax_engine.Engine(config)
    jeng.build((2, 32, 32, 5))
    flat0 = flat_params(jeng.state['params'])
    jstep = jax.jit(jeng._make_train_step(dataset, multi_step='one_step'))
    bank = jeng._warp_bank(dataset)
    port_bank = dict(bank, flows=_t(bank['flows']))

    eng = engine.Engine(config, device='cpu')
    eng._setup_training(pipeline.TrainDataset(
        'unused.tfrecords', **dict(opts, output_size=(32, 32))))
    eng.model.load_state_dict(convert.torch_state_from_flax(
        flat0, expected=eng.model.state_dict()))

    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(7)
    state = jeng.state
    for step in range(3):
        raw = rng.integers(0, 256, (2, 44, 44, 6), dtype=np.uint8)
        raw[..., 5] = np.where(raw[..., 5] > 200, 255, 0)
        draws = _jax_draws(methods, 2, jax.random.fold_in(key, step), 6)
        eng._augment = lambda images, gen, d=draws: augment.apply_chain(
            methods, images, d, port_bank)
        state, want_loss, _, _ = jstep(state, jnp.asarray(raw), key)
        got_loss = eng.train_step(_t(raw), step, gen=None)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
    want = convert.torch_state_from_flax(flat_params(state['params']))
    for name, p in eng.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_loss_gradient_at_zero_logits_matches_jax():
    '''Logits of exactly 0 (dead head inputs with a zero bias, common at
    initialisation) take the JAX package's gradient.'''
    y = np.array([[[0.0, 1.0, 0.3, 0.0]]], np.float32)
    z = np.array([[[0.0, 0.0, 0.0, 1e-3]]], np.float32)
    loss = jax_losses.WeightedCrossentropy(weight_mul=3.0)
    want = jax.grad(lambda v: jnp.mean(loss.per_sample(jnp.asarray(y), v)))(
        jnp.asarray(z))
    zt = _t(z).requires_grad_()
    losses.WeightedCrossentropy(weight_mul=3.0)(_t(y), zt).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), rtol=1e-6)


# -- the training set and the resident sampler -----------------------------------------
@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_train')
    return list(util_synth.make_tfrecords(str(tmp), size=64))


def test_train_dataset_matches_jax(records, tmp_path):
    from dnncancerannotator_tpu.data import pipeline as jax_pipeline
    opts = config_lib.load_config(CONFIGS)['data_options']['train']
    empty = str(tmp_path / 'empty.tfrecords')
    open(empty, 'wb').close()
    paths = [records[0], empty, records[1]]
    got = pipeline.train_ds(paths, **opts)
    want = jax_pipeline.train_ds(paths, **opts)
    assert got.augment_methods == want.augment_methods
    assert got.host_crop == want.host_crop == (268, 268)
    assert got.element_shape == want.element_shape
    assert got.feature_shape == want.feature_shape == (8, 256, 256, 5)
    small = dict(opts, output_size=[32, 32])
    res = pipeline.train_ds(paths, **small).load_resident()
    ref = jax_pipeline.train_ds(paths, **small).load_resident()
    np.testing.assert_array_equal(res['data'], ref['data'])
    np.testing.assert_array_equal(res['starts'], ref['starts'])
    np.testing.assert_array_equal(res['counts'], ref['counts'])
    assert res['balanced'] and len(res['starts']) == 2   # empty one dropped
    with pytest.raises(NotImplementedError, match='budget'):
        pipeline.train_ds(paths, **small).load_resident(budget_bytes=1000)


def test_balanced_sampler_draws_sources_equally():
    eng = engine.Engine(_small_config(), device='cpu')
    pool = torch.arange(12, dtype=torch.uint8).reshape(12, 1, 1, 1)
    resident = (pool, torch.tensor([0, 3]), torch.tensor([3, 9]), True)
    gen = torch.Generator().manual_seed(0)
    idx = torch.cat([eng.sample_batch(resident, 8, gen).reshape(-1).long()
                     for _ in range(1000)])
    assert abs((idx < 3).double().mean() - 0.5) < 0.03
    counts = torch.bincount(idx, minlength=12).double()
    assert (counts[:3] / counts[:3].sum() - 1 / 3).abs().max() < 0.04
    assert (counts[3:] / counts[3:].sum() - 1 / 9).abs().max() < 0.03
    resident = (pool, torch.tensor([0, 3]), torch.tensor([3, 9]), False)
    idx = torch.cat([eng.sample_batch(resident, 8, gen).reshape(-1).long()
                     for _ in range(1000)])
    assert abs((idx < 3).double().mean() - 0.25) < 0.03


# -- the train CLI ---------------------------------------------------------------------
def _overlay(tmp_path):
    path = tmp_path / 'small.json'
    path.write_text(json.dumps({
        'data_options.train.output_size': [32, 32],
        'data_options.eval.output_size': [32, 32],
        'deploy_options.warp_bank_size': 8,
        'deploy_options.steps_per_call': 2,
        'deploy_options.max_checkpoints_to_keep': 2,
    }))
    return str(path)


def test_train_cli_checkpoints_resumes_and_predicts(records, tmp_path):
    save = str(tmp_path / 'run')
    ckpt_dir = os.path.join(save, 'checkpoints')
    argv = ['train', '--config', *CONFIGS, _overlay(tmp_path), '--save_path',
            save, '--data_path', *records, '--save_freq', '2', '--device',
            'cpu', '--max_steps']
    first = main(argv=argv + ['4'])
    assert first.epoch == [1, 2, 3, 4]
    assert all(np.isfinite(first.history['loss']))
    assert first.history['lr'] == [1e-3] * 4
    assert sorted(os.listdir(ckpt_dir)) == ['ckpt-2', 'ckpt-4']
    with np.load(os.path.join(ckpt_dir, 'ckpt-4', 'opt_state.npz')) as npz:
        keys = set(npz.files)
        assert int(npz['step']) == 4
    with np.load(os.path.join(ckpt_dir, 'ckpt-4', 'params.npz')) as npz:
        params = set(npz.files)
    assert keys == {'step'} | {f'{m}/{k}' for m in ('mu', 'nu')
                               for k in params}

    second = main(argv=argv + ['6'])   # resumes at step 4
    assert second.epoch == [5, 6]
    assert sorted(os.listdir(ckpt_dir)) == ['ckpt-4', 'ckpt-6']   # keep 2
    assert {'options.yaml', 'options_.yaml', 'results.pkl'} <= set(
        os.listdir(save))
    with open(os.path.join(save, 'results.pkl'), 'rb') as fh:
        assert pickle.load(fh)['epoch'] == [5, 6]

    out = str(tmp_path / 'maps')
    count = main(argv=['predict', '--save_path', save, '--data_path',
                       *records, '--output_path', out, '--output_format',
                       'npy', '--batch_size', '4', '--device', 'cpu'])
    eng = engine.Engine(config_lib.load_config(
        os.path.join(save, 'options.yaml'))['config'], device='cpu')
    ds = pipeline.predict_ds(records, output_size=(32, 32), batch_size=4)
    eng.build(ds.feature_shape)
    eng.load(os.path.join(ckpt_dir, 'ckpt-6'))
    want = eng.predict(ds)
    assert count == len(want) > 0
    batch = next(ds.batches())
    meta = batch['meta'][0]
    got = np.load(os.path.join(out, *meta['path'].split('/')[-3:],
                               f"{meta['sliceID']:02d}.npy"))
    np.testing.assert_array_equal(got, want[0, :, :, 0])


def test_resumed_training_equals_unbroken_training(records, tmp_path):
    '''The draws depend on (seed, step) and the optimizer state is saved,
    so 2 + 2 steps with a resume give what 4 steps in one call give.'''
    config = config_lib.load_config([*CONFIGS, _overlay(tmp_path)])
    opts = config['data_options']['train']

    def run(save, max_steps, save_freq):
        eng = engine.Engine(config, seed=3, device='cpu')
        results = eng.train(pipeline.train_ds(records, **opts),
                            save_path=save, max_steps=max_steps,
                            save_freq=save_freq)
        return results.history['loss'], eng.model.state_dict()

    unbroken, params = run(str(tmp_path / 'a'), 4, 4)
    run(str(tmp_path / 'b'), 2, 2)
    resumed, params_b = run(str(tmp_path / 'b'), 4, 2)
    assert resumed == unbroken[2:]
    for name in params:
        assert torch.equal(params[name], params_b[name]), name
