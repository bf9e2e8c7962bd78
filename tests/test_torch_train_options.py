'''The port's training options on the CPU against the JAX package: the
Gaussian label filter and the smoothed loss, the ten registry optimizers
against ``optax.flatten`` of the JAX transforms, their state through a
checkpoint, the kernel regularizer for all four model families, the
``debug_asserts`` checks, SIGTERM draining, the profiler window, and two
train steps of the whole options stack against the JAX train step.

Tolerances: the filter within 1e-6 absolute (values in [0, 1], f32 sums
in another order); the smoothed loss within 1e-6 relative; optimizer
parameters after six steps within 1e-6 relative plus 1e-5 of the leaf's
largest move from its start (optax computes Adam's bias correction
``1 - 0.999 ** t`` in f32, 1.3e-5 off at step 1, which torch's Adam and
AdamW compute in f64; the port's own optimizers copy optax's f32); the
regularizer within 1e-6 relative (one f32 sum in another order); the two
train steps as tests/test_torch_train.py's three: losses within 1e-5
relative, parameters within 1e-6 absolute. A resumed run is held exactly
equal to an unbroken one.
'''

import json
import os
import signal
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import checkify

from dnncancerannotator_tpu import engine as jax_engine
from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_tpu.data import augment as jax_augment
from dnncancerannotator_tpu.ops import filters as jax_filters
from dnncancerannotator_tpu.train import losses as jax_losses
from dnncancerannotator_tpu.train import optimizers as jax_optimizers
from dnncancerannotator_tpu.train import schedules as jax_schedules
from dnncancerannotator_tpu.utils import checks as jax_checks
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.data import augment, pipeline
from dnncancerannotator_torch.ops import filters
from dnncancerannotator_torch.runs import train as train_run
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.train import losses, optimizers, schedules
from dnncancerannotator_torch.utils import checks
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_synth
from tests.test_torch_augment import _jax_draws
from tests.test_torch_unet import flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADDITIONALS = os.path.join(REPO, 'configs', 'additionals')
CONFIGS = [os.path.join(REPO, 'configs', 'unet.yaml'),
           os.path.join(ADDITIONALS, 'deploy_options.yaml'),
           os.path.join(ADDITIONALS, 'data_options.yaml')]
OPTIONS = [os.path.join(ADDITIONALS, 'enable_label_smoothing.yaml'),
           os.path.join(ADDITIONALS, 'kernel_regularizer.yaml')]
SLICE_TYPES = util_synth.SLICE_TYPES
L2 = {'class_name': 'L2', 'config': {'l2': 0.01}}
SCHEDULE = 'lambda e, lr: 0.01 * 0.5 ** e'


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the label filter and the smoothed loss ---------------------------------------
@pytest.mark.parametrize('filter_shape,sigma,c', [
    (3, 1.0, 1), (6, 3, 1), ((5, 4), (1.5, 2.5), 3), (4, (2.0, 1.0), 2),
    (6, 3, 2)])
def test_gaussian_filter_matches_jax(filter_shape, sigma, c):
    image = np.random.default_rng(0).random((2, 13, 11, c), np.float32)
    want = jax_filters.gaussian_filter2d(jnp.asarray(image), filter_shape,
                                         sigma)
    got = filters.gaussian_filter2d(_t(image), filter_shape, sigma)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('spec', [dict(weight_mul=3.0),
                                  dict(weight=2.5, label_smoothing_sigma=1.5,
                                       label_smoothing_filter_size=5)])
def test_smoothed_loss_matches_jax(spec):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 16, 16, 1)) * 4).astype(np.float32)
    y = (rng.random((3, 16, 16)) > 0.8).astype(np.float32)
    want = jax_losses.WeightedCrossentropy(
        label_smoothing=True, **spec).per_sample(jnp.asarray(y),
                                                 jnp.asarray(logits))
    loss = losses.solve_loss({'class_name': 'WeightedCrossentropy',
                              'config': dict(label_smoothing=True, **spec)})
    got = loss.per_sample(_t(y), _t(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    plain = losses.WeightedCrossentropy(**spec).per_sample(_t(y), _t(logits))
    assert not torch.allclose(got, plain)   # the blur took effect


# -- the optimizers ---------------------------------------------------------------
OPTIMIZER_SPECS = [
    'adam',
    {'class_name': 'AdamW', 'config': {'weight_decay': 0.01}},
    {'class_name': 'SGD', 'config': {'momentum': 0.9, 'nesterov': True}},
    'adamax',
    {'class_name': 'Nadam', 'config': {'beta_1': 0.8}},
    'rmsprop',
    {'class_name': 'RMSprop', 'config': {'momentum': 0.5, 'centered': True}},
    'adagrad',
    'adadelta',
    {'class_name': 'Lamb', 'config': {'weight_decay': 0.01}},
    {'class_name': 'Lion', 'config': {'weight_decay': 0.1}},
]
SHAPES = {'a': (4, 3), 'b': (5,), 'c': (2, 2, 3)}


def _name(spec):
    return spec if isinstance(spec, str) else spec['class_name'].lower()


def _grads(spec, steps=6, seed=2):
    '''Seeded gradients down to 1e-4 (eps matters); lion's keep one sign
    an element and a magnitude in [0.5, 1.5], so that no sign of its
    update rests on rounding.'''
    rng = np.random.default_rng(seed)
    if _name(spec) == 'lion':
        signs = {k: rng.choice([-1.0, 1.0], s) for k, s in SHAPES.items()}
        return [{k: (signs[k] * (0.5 + rng.random(s))).astype(np.float32)
                 for k, s in SHAPES.items()} for _ in range(steps)]
    return [{k: (rng.standard_normal(s) * 10.0 ** -(i % 5)).astype(
        np.float32) for k, s in SHAPES.items()} for i in range(steps)]


@pytest.mark.parametrize('spec', OPTIMIZER_SPECS, ids=[
    _name(s) + ('_' + '_'.join(s['config']) if isinstance(s, dict) else '')
    for s in OPTIMIZER_SPECS])
def test_optimizer_matches_flattened_optax(spec):
    '''Six steps under a decaying schedule against the JAX engine's
    ``optax.flatten(solve_optimizer(...))``; for lamb also that the
    per-leaf trust ratio (optax without the flatten) lands elsewhere.'''
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = _grads(spec)
    tx, _ = jax_optimizers.solve_optimizer(
        spec, jax_schedules.solve_schedule(SCHEDULE))

    def run_optax(tx):
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()}, state, params)
            params = optax.apply_updates(params, updates)
        return params

    want = run_optax(optax.flatten(tx))
    tparams = [torch.nn.Parameter(_t(p0[k])) for k in sorted(SHAPES)]
    opt, schedule = optimizers.solve_optimizer(
        spec, tparams, schedules.solve_schedule(SCHEDULE))
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group['lr'] = schedule(step)
        for p, k in zip(tparams, sorted(SHAPES)):
            p.grad = _t(g[k])
        opt.step()
    for p, k in zip(tparams, sorted(SHAPES)):
        moved = float(np.abs(np.asarray(want[k]) - p0[k]).max())
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-5 * moved, err_msg=k)
    if _name(spec) == 'lamb':
        per_leaf = run_optax(tx)
        assert max(float(np.abs(np.asarray(per_leaf[k]) - np.asarray(
            want[k])).max()) for k in SHAPES) > 1e-4


TINY = {'n_filters_first': 2, 'n_downsample': 1, 'rate': 2,
        'kernel_size': 3, 'conv_stride': 1, 'bn': False, 'padding': 'same'}
OPTAX_STATE = {'adam': {'mu', 'nu'}, 'adamw': {'mu', 'nu'},
               'sgd': {'trace'}, 'adamax': {'mu', 'nu'},
               'nadam': {'mu', 'nu'}, 'rmsprop': {'nu', 'trace'},
               'adagrad': {'sum_of_squares'}, 'adadelta': {'e_g', 'e_x'},
               'lamb': {'mu', 'nu'}, 'lion': {'mu'}}


@pytest.mark.parametrize('spec', OPTIMIZER_SPECS, ids=[
    _name(s) + ('_' + '_'.join(s['config']) if isinstance(s, dict) else '')
    for s in OPTIMIZER_SPECS])
def test_optimizer_state_resumes_exactly(spec, tmp_path):
    '''Three steps, a checkpoint, and two more steps in a new Engine that
    loads it give what five steps in one Engine give, bit for bit; the
    state is stored under optax's names.'''
    config = {'model': 'UNetAnnotator', 'model_options': TINY,
              'deploy_options': {'optimizer': spec}}
    rng = np.random.default_rng(3)

    def new_engine():
        eng = engine.Engine(config, device='cpu')
        eng.build((1, 8, 8, 5))
        eng.optimizer, eng.schedule = optimizers.solve_optimizer(
            spec, eng.model.parameters(), schedules.solve_schedule(SCHEDULE))
        return eng

    grads = [{n: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32)) for n, p in new_engine().model.named_parameters()}
        for _ in range(5)]

    def steps(eng, first, last):
        for step in range(first, last):
            for group in eng.optimizer.param_groups:
                group['lr'] = eng.schedule(step)
            for name, p in eng.model.named_parameters():
                p.grad = grads[step][name].clone()
            eng.optimizer.step()

    unbroken = new_engine()
    steps(unbroken, 0, 5)
    first = new_engine()
    steps(first, 0, 3)
    path = first.save_ckpt(str(tmp_path), 3)
    first.finalize_checkpoints()
    saved = engine.read_ckpt(path)
    names = {k.split('/', 1)[0] for k in saved if '/params/' in k}
    assert int(saved['step']) == int(saved['count']) == 3
    centered = isinstance(spec, dict) and spec['config'].get('centered')
    assert names == OPTAX_STATE[_name(spec)] | ({'mu'} if centered else set())
    resumed = new_engine().load(path)
    steps(resumed, 3, 5)
    for (name, p), q in zip(unbroken.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(p, q), name


# -- the kernel regularizer -----------------------------------------------------------
MULMO = config_lib.load_config(
    [os.path.join(REPO, 'configs', 'mulmo_unet.yaml')])['model_options']
FAMILIES = {
    'unet': ('UNetAnnotator', dict(TINY, n_downsample=2), 5),
    'unet_bn': ('UNetAnnotator', dict(TINY, n_downsample=2, bn=True), 5),
    'mulmo': ('MulmoUNetAnnotator', dict(MULMO, n_filters_first=4,
                                         n_downsample=2), 5),
    'multiresunet': ('MultiResUnet', dict(height=None, width=None,
                                          n_channels=5, base_filters=4), 5),
}


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_regularizer_matches_jax(family):
    '''``l2 * sum(w**2)`` over exactly the JAX tree's ``kernel`` leaves, on
    seeded values of every parameter, for each model family (the
    regularizer accepted by both registries).'''
    name, options, c = FAMILIES[family]
    options = dict(options, kernel_regularizer=L2)
    model, spec = jax_models.build_model(name, options)
    assert spec == L2
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, c)))['params']
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(
        s.shape).astype(np.float32)), shapes)
    scale = types.SimpleNamespace(
        l2_scale=jax_engine.Engine._solve_regularizer(spec))
    want = jax.jit(lambda p: jax_engine.Engine._reg_loss(scale, p))(params)
    kernels = {'/'.join(['params'] + [str(k.key) for k in path])
               for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
               if any(getattr(k, 'key', None) == 'kernel' for k in path)}

    eng = engine.Engine({'model': name, 'model_options': options,
                         'deploy_options': {}}, device='cpu')
    eng.build((1, 16, 16, c))
    state = eng.model.state_dict()
    state.update(convert.torch_state_from_flax(flat_params(params)))
    eng.model.load_state_dict(state)
    got = eng.regularization()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert {convert.flax_key(n) for n, _ in eng.model.named_parameters()
            if convert.flax_key(n).endswith('/kernel')} == kernels
    got.backward()   # d/dw = 2 * l2 * w on the kernels, 0 elsewhere
    for n, p in eng.model.named_parameters():
        want_grad = 0.02 * p.detach() if convert.flax_key(n) in kernels \
            else torch.zeros_like(p)
        torch.testing.assert_close(
            torch.zeros_like(p) if p.grad is None else p.grad, want_grad,
            rtol=1e-6, atol=0)


@pytest.mark.parametrize('spec,scale', [
    (None, 0.0), ({'class_name': 'l2'}, 0.01), (L2, 0.01),
    ({'class_name': 'L2', 'config': {'l2': 0.5}}, 0.5),
    ({'class_name': 'L1', 'config': {'l1': 0.01}}, ValueError),
    ('l2', ValueError)])
def test_regularizer_spec_matches_jax(spec, scale):
    if scale is ValueError:
        for solve in (engine.solve_regularizer,
                      jax_engine.Engine._solve_regularizer):
            with pytest.raises(ValueError, match='kernel_regularizer'):
                solve(spec)
    else:
        assert engine.solve_regularizer(spec) == scale == \
            jax_engine.Engine._solve_regularizer(spec)


# -- debug_asserts --------------------------------------------------------------------
@pytest.mark.parametrize('case,check', [
    ('negative_weight_add', 'loss weight'), ('labels_above_1', 'labels'),
    ('labels_below_0', 'labels'), ('labels_nan', 'labels')])
def test_debug_asserts_raise_in_both_packages(case, check):
    '''The loss's checks fail on a negative weight, on labels outside
    [0, 1] and on a NaN label in both packages, naming the check; off,
    nothing is checked.'''
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    y = (rng.random((2, 8, 8)) > 0.5).astype(np.float32)
    spec = {'weight_mul': 3.0}
    if case == 'negative_weight_add':
        spec['weight_add'] = -10.0
    else:
        y[1, 2, 3] = {'labels_above_1': 2.0, 'labels_below_0': -0.5,
                      'labels_nan': np.nan}[case]
    jax_checks.enable(True)
    try:
        fn = jax_checks.checked(jax.jit(
            jax_losses.WeightedCrossentropy(**spec).per_sample))
        with pytest.raises(checkify.JaxRuntimeError,
                           match=check):
            fn(jnp.asarray(y), jnp.asarray(logits))
    finally:
        jax_checks.enable(False)
    loss = losses.WeightedCrossentropy(**spec)
    with checks.collect() as found:
        loss.per_sample(_t(y), _t(logits))
    values = torch.cat([v for _, v in found]).tolist()
    with pytest.raises(checks.CheckError, match=f'{check}.* at step 7'):
        checks.raise_failed([(7, [m for m, _ in found])], values)
    with checks.collect(False) as off:
        loss.per_sample(_t(y), _t(logits))
    assert off == []
    y_ok = np.clip(np.nan_to_num(y), 0, 1)
    with checks.collect() as found:
        losses.WeightedCrossentropy(weight_mul=3.0).per_sample(
            _t(y_ok), _t(logits))
    assert [m.split(' ')[0] for m, _ in found] == [
        'labels', 'positive_rate', 'loss']
    checks.raise_failed([(1, [m for m, _ in found])],
                        torch.cat([v for _, v in found]).tolist())


# -- the train loop: debug_asserts, SIGTERM, the profiler window ---------------------
@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_train_options')
    return list(util_synth.make_tfrecords(str(tmp), size=64))


def _overlay(tmp_path, **extra):
    path = tmp_path / 'small.json'
    path.write_text(json.dumps({
        'data_options.train.output_size': [32, 32],
        'data_options.train.batch_size': 2,
        'deploy_options.warp_bank_size': 4,
        'deploy_options.steps_per_call': 2,
        **extra}))
    return str(path)


def test_debug_asserts_in_train(records, tmp_path):
    '''debug_asserts: true trains as without it, and stops at the step
    whose loss weight is negative, naming the check.'''
    def run(**extra):
        config = config_lib.load_config(
            [*CONFIGS, *OPTIONS, _overlay(tmp_path, **extra)])
        eng = engine.Engine(config, device='cpu')
        ds = pipeline.train_ds(records, **config['data_options']['train'])
        return eng.train(ds, max_steps=3, save_freq=100).history['loss']

    assert run(**{'deploy_options.debug_asserts': True}) == run()
    with pytest.raises(checks.CheckError, match='loss weight is negative.* '
                       'at step 1'):
        run(**{'deploy_options.debug_asserts': True,
               'deploy_options.loss.config.weight_add': -100.0})


def test_sigterm_checkpoints_and_resumes(records, tmp_path):
    '''tests/test_preemption.py for the port: SIGTERM while the handler is
    installed finishes the chunk, checkpoints the stop step and returns;
    the next call resumes from it and matches an unbroken run.'''
    overlay = _overlay(tmp_path)
    save_path = str(tmp_path / 'run')
    args = dict(config=[*CONFIGS, *OPTIONS, overlay], save_path=save_path,
                data_path=records, device='cpu')
    # SIGTERM only while the engine's handler is live: the default
    # disposition would end the test process
    initial_handler = signal.getsignal(signal.SIGTERM)

    def kill_when_handler_live(grace=1.0, timeout=300.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if signal.getsignal(signal.SIGTERM) is not initial_handler:
                time.sleep(grace)   # let a few steps run first
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.05)

    killer = threading.Thread(target=kill_when_handler_live, daemon=True)
    killer.start()
    results = train_run.train(max_steps=100000, save_freq=50000, **args)
    killer.join(timeout=30)
    assert not killer.is_alive()
    assert signal.getsignal(signal.SIGTERM) is initial_handler
    stopped_at = results.epoch[-1]
    assert 0 < stopped_at < 100000
    assert stopped_at % 2 == 0   # the chunk in flight finished
    ckpts = sorted(os.listdir(os.path.join(save_path, 'checkpoints')))
    assert ckpts == [f'ckpt-{stopped_at}']

    resumed = train_run.train(max_steps=stopped_at + 2, save_freq=10, **args)
    assert resumed.epoch == [stopped_at + 1, stopped_at + 2]
    config = config_lib.load_config(args['config'])
    eng = engine.Engine(config, device='cpu')
    unbroken = eng.train(
        pipeline.train_ds(records, **config['data_options']['train']),
        max_steps=stopped_at + 2, save_freq=1 << 30)
    assert resumed.history['loss'] == unbroken.history['loss'][-2:]
    saved = engine.read_ckpt(os.path.join(save_path, 'checkpoints',
                                          f'ckpt-{stopped_at + 2}'))
    for key, value in convert.flax_from_torch_state(
            eng.model.state_dict()).items():
        np.testing.assert_array_equal(saved[key], value, err_msg=key)


def test_profile_window_writes_a_trace(records, tmp_path, monkeypatch):
    '''--profile traces the (shortened) window [start + 2, start + 4) of a
    call under save_path/tfevents/profile; a call that ends before the
    window writes nothing.'''
    monkeypatch.setattr(engine, 'PROFILE_START', 2)
    monkeypatch.setattr(engine, 'PROFILE_STEPS', 2)
    save = str(tmp_path / 'run')
    argv = ['train', '--config', *CONFIGS, _overlay(tmp_path), '--save_path',
            save, '--data_path', *records, '--save_freq', '100', '--device',
            'cpu', '--profile', '--max_steps']
    profile_dir = os.path.join(save, 'tfevents', 'profile')
    main(argv=argv + ['2'])
    assert not os.path.exists(profile_dir)
    main(argv=argv + ['8'])   # resumes at 2: the window is steps 5-6
    assert os.listdir(profile_dir) == ['steps-5-6.pt.trace.json']
    with open(os.path.join(profile_dir, 'steps-5-6.pt.trace.json')) as fh:
        events = json.load(fh)['traceEvents']
    assert any('conv2d' in e.get('name', '') for e in events)


# -- the whole stack against the JAX train step ------------------------------------------
def test_options_stack_steps_match_jax():
    '''enable_label_smoothing.yaml + kernel_regularizer.yaml + lamb: two
    train steps of the JAX engine (optax.flatten) and of the port on the
    same raw batches, with the JAX step's augmentation draws and warp bank
    fed to the port (as tests/test_torch_train.py's three steps).'''
    config = config_lib.load_config(CONFIGS + OPTIONS)
    config['data_options']['train'].update(output_size=[32, 32],
                                           batch_size=2)
    config['deploy_options'].update(warp_bank_size=6, optimizer={
        'class_name': 'Lamb', 'config': {'weight_decay': 0.01}})
    assert config['deploy_options']['loss']['config']['label_smoothing']
    opts = config['data_options']['train']
    methods = jax_augment.parse_augment_options(
        opts['augment_options'], SLICE_TYPES, (32, 32))
    dataset = types.SimpleNamespace(augment_methods=methods,
                                    slice_types=SLICE_TYPES, batch_size=2,
                                    feature_shape=(2, 32, 32, 5))
    jeng = jax_engine.Engine(config)
    assert jeng.l2_scale == 0.01
    jeng.build((2, 32, 32, 5))
    flat0 = flat_params(jeng.state['params'])
    jstep = jax.jit(jeng._make_train_step(dataset, multi_step='one_step'))
    bank = jeng._warp_bank(dataset)
    port_bank = dict(bank, flows=_t(bank['flows']))

    config['deploy_options']['debug_asserts'] = True   # read, never fails
    eng = engine.Engine(config, device='cpu')
    eng._setup_training(pipeline.TrainDataset(
        'unused.tfrecords', **dict(opts, output_size=(32, 32))))
    assert isinstance(eng.optimizer, optimizers.Lamb)
    eng.model.load_state_dict(convert.torch_state_from_flax(
        flat0, expected=eng.model.state_dict()))

    key = jax.random.PRNGKey(8)
    rng = np.random.default_rng(8)
    state = jeng.state
    for step in range(2):
        raw = rng.integers(0, 256, (2, 44, 44, 6), dtype=np.uint8)
        raw[..., 5] = np.where(raw[..., 5] > 200, 255, 0)
        draws = _jax_draws(methods, 2, jax.random.fold_in(key, step), 6)
        eng._augment = lambda images, gen, d=draws: augment.apply_chain(
            methods, images, d, port_bank)
        state, want_loss, _, _ = jstep(state, jnp.asarray(raw), key)
        got_loss = eng.train_step(_t(raw), step, gen=None)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
    assert [at for at, _, _ in eng._check_log] == [1, 2]
    want = convert.torch_state_from_flax(flat_params(state['params']))
    for name, p in eng.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
