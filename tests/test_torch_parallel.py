'''The port's data parallelism on the CPU: ranks are processes in a gloo
group (tests/util_torch_dp.py), held against the JAX package's Engine on a
2-device mesh and against one rank of the port.

- (i) 2 ranks of the port against the JAX Engine on a 2-device mesh
  (tests/conftest.py:scrubbed_cpu_env(2)), fed the JAX run's draws, on
  the small UNet and a small BN UNet, 3 steps: the losses to 1e-5 relative
  and every parameter to 1e-6 absolute, test_three_train_steps_match_jax's
  limits; the batch's second half (rank 1's rows) holds no positive pixel
  and other intensities, so the ranks' BatchNorm statistics differ;
- (ii) controls: the same runs with each rank's own BatchNorm statistics,
  or its own positive rate, miss those limits;
- (iii) 3 ranks at B = 8 (rows 2, 3, 3) against one rank, resident and
  streamed; (iv) every rank's parameters the same bits;
- (v) 2 ranks to step 2, resumed by one rank to step 4, against an
  unbroken 2-rank run; (vi) a 2-rank ``evaluate`` against one rank's
  results.csv, rank 1 writing nothing; (vii) SIGTERM to one rank stops
  every rank at one step with one checkpoint;
- (viii) two NCCL ranks on one card refused, and ``launch``'s choice of
  one process or one a card; (ix) one rank in a group (gloo, in this
  process) gives the bits of no group.

The ranks and the JAX run start together in one module fixture and take
~30-40 s on this host.
'''

import contextlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.data import pipeline
from dnncancerannotator_torch.parallel import mesh, multihost
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_synth
from tests.conftest import scrubbed_cpu_env
from tests.util_torch_dp import TIMEOUT, ranks, wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, 'configs', 'unet.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'deploy_options.yaml'),
           os.path.join(REPO, 'configs', 'additionals', 'data_options.yaml')]
METRICS = os.path.join(REPO, 'configs', 'additionals', 'metrics.yaml')
STEPS = 3
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6


def _config(bn=False, batch=4, **deploy):
    config = config_lib.load_config(CONFIGS)
    config['data_options']['train'].update(output_size=[32, 32],
                                           batch_size=batch)
    config['deploy_options'].update(warp_bank_size=6, enable_multigpu=True,
                                    **deploy)
    if bn:
        config['model_options'].update(bn=True, n_downsample=2)
    return config


JAX_RUN = r'''
import json, sys, types
import jax, jax.numpy as jnp, numpy as np
jax.config.update('jax_default_matmul_precision', 'highest')
from dnncancerannotator_tpu import engine as jax_engine
from dnncancerannotator_tpu.data import augment as jax_augment

out, configs = sys.argv[1], json.loads(sys.argv[2])
assert jax.device_count() == 2
SLICE_TYPES = ('TRA', 'ADC', 'DWI', 'DCEE', 'DCEL', 'label')

def flat(tree, prefix):
    return {'/'.join([prefix] + [str(k.key) for k in path]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

def draws(methods, b, key, n_bank):
    # the draws of build_augment_fn for crop, flip, contrast, banked warp
    # (tests/test_torch_augment.py:_jax_draws)
    kc, kf, kk, kw = jax.random.split(key, len(methods))
    noise = jax.random.normal(kc, [b, 2]) * methods[0][1].get('stddev', 4)
    k_idx, k_ud, k_lr = jax.random.split(kw, 3)
    return dict(
        crop=jnp.clip(noise.astype(jnp.int32), -6, 6),
        flip=jax.vmap(jax.random.bernoulli)(jax.random.split(kf, b)),
        contrast=jax.vmap(lambda k: jax.random.uniform(
            k, (), minval=0.8, maxval=1.2))(jax.random.split(kk, b)),
        bank_idx=jax.random.randint(k_idx, [b], 0, n_bank),
        bank_ud=jax.random.bernoulli(k_ud, shape=(b,)),
        bank_lr=jax.random.bernoulli(k_lr, shape=(b,)))

for name, config in configs.items():
    opts = config['data_options']['train']
    b = opts['batch_size']
    methods = jax_augment.parse_augment_options(
        opts['augment_options'], SLICE_TYPES, (32, 32))
    dataset = types.SimpleNamespace(
        augment_methods=methods, slice_types=SLICE_TYPES, batch_size=b,
        feature_shape=(b, 32, 32, 5))
    eng = jax_engine.Engine(config)
    assert eng.mesh.shape['data'] == 2
    eng.build((b, 32, 32, 5))
    dump = flat(eng.state['params'], 'init/params')
    if eng.state.get('batch_stats'):
        dump.update(flat(eng.state['batch_stats'], 'init/batch_stats'))
    step = jax.jit(eng._make_train_step(dataset, multi_step='one_step'),
                   in_shardings=(eng._rep, eng._data_sh, eng._rep),
                   out_shardings=(eng._rep, eng._rep, eng._data_sh,
                                  eng._data_sh))
    bank = eng._warp_bank(dataset)
    n_bank = bank['flows'].shape[0]
    key, rng = jax.random.PRNGKey(7), np.random.default_rng(7)
    state, raws, drawn, losses = eng.state, [], [], []
    for s in range(3):
        raw = rng.integers(0, 256, (b, 44, 44, 6), dtype=np.uint8)
        raw[..., 5] = np.where(raw[..., 5] > 200, 255, 0)
        raw[b // 2:, ..., 5] = 0      # the second shard: no positive pixel
        raw[b // 2:, ..., :5] //= 4   # and other BatchNorm statistics
        raws.append(raw)
        drawn.append(draws(methods, b, jax.random.fold_in(key, s), n_bank))
        state, loss, _, _ = step(state, jnp.asarray(raw), key)
        losses.append(float(loss))
    dump.update(flat(state['params'], 'final/params'))
    if state.get('batch_stats'):
        dump.update(flat(state['batch_stats'], 'final/batch_stats'))
    dump.update({k: np.stack([np.asarray(d[k]) for d in drawn])
                 for k in drawn[0]})
    np.savez(f'{out}/{name}.npz', raw=np.stack(raws), losses=losses,
             bank_flows=np.asarray(bank['flows']),
             bank_stride=bank['stride'],
             bank_max_displacement=bank['max_displacement'],
             bank_out_size=np.asarray(bank['out_size']), **dump)
'''


def _overlay(work):
    path = os.path.join(work, 'small.json')
    if os.path.exists(path):   # ranks may be reading it
        return path
    with open(path, 'w') as fh:
        json.dump({'data_options.train.output_size': [32, 32],
                   'data_options.train.batch_size': 4,
                   'data_options.eval.output_size': [32, 32],
                   'data_options.eval.batch_size': 5,
                   'deploy_options.warp_bank_size': 4,
                   'deploy_options.steps_per_call': 2,
                   'deploy_options.enable_multigpu': True}, fh)
    return path


def _argv(work, records, save, steps):
    return ['train', '--config', *CONFIGS, METRICS, _overlay(work),
            '--save_path', save, '--data_path', *records, '--save_freq', '2',
            '--device', 'cpu', '--max_steps', str(steps)]


class Runs:
    '''The module's rank launches and the JAX run, started together.'''

    def __init__(self, work, records):
        self.work, self.records = work, records
        self.procs = {}
        jax_configs = {'unet': _config(),
                       'bn': _config(bn=True, optimizer='sgd')}
        with open(os.path.join(work, 'jax.log'), 'w') as log:
            jax_run = subprocess.Popen(
                [sys.executable, '-c', JAX_RUN, work,
                 json.dumps(jax_configs)], cwd=REPO, env=scrubbed_cpu_env(2),
                stdout=log, stderr=subprocess.STDOUT)
        w = lambda *p: os.path.join(work, *p)   # noqa: E731
        self.procs['resume'] = ranks(2, [
            dict(kind='cli', argv=_argv(work, records, w('broken'), 2),
                 guard=w('broken'), out=w('broken')),
            dict(kind='cli', argv=_argv(work, records, w('unbroken'), 4),
                 guard=w('unbroken'), out=w('unbroken')),
            dict(kind='cli', guard=w('unbroken'), out=w('evaluate'), argv=[
                'evaluate', '--save_path', w('unbroken'), '--data_path',
                *records, '--tag', 'dp', '--export_csv', '--device', 'cpu'])],
            work, 'resume')
        self.procs['uneven'] = ranks(3, [
            dict(kind='train', config=_config(batch=8), records=records,
                 max_steps=STEPS, out=w('uneven_unet')),
            dict(kind='train', config=_stream_config(), records=records,
                 max_steps=STEPS, out=w('uneven_stream')),
            dict(kind='train', config=_config(bn=True, batch=8),
                 records=records, max_steps=1, out=w('uneven_bn'))],
            work, 'uneven')
        self.procs['sigterm'] = ranks(2, [dict(
            kind='sigterm', victim=1, out=w('sigterm'), argv=[
                'train', '--config', *CONFIGS, _overlay(work), '--save_path',
                w('sigterm_run'), '--data_path', *records, '--save_freq',
                '50000', '--device', 'cpu', '--max_steps', '100000'])],
            work, 'sigterm')
        self.procs['jax'] = [jax_run]
        self.wait('jax', log='jax.log')
        self.procs['steps'] = ranks(2, [
            dict(kind='steps', config=jax_configs[name], ref=w(f'{name}.npz'),
                 control=control, out=w(f'steps_{name}_{control}'))
            for name, control in (('unet', None), ('bn', None),
                                  ('bn', 'local_bn'),
                                  ('unet', 'local_rate'))], work, 'steps')

    def wait(self, name, log=None):
        procs = self.procs.pop(name, None)
        if procs is None:
            return
        if log is None:
            return wait(procs, self.work, name)
        procs[0].wait(timeout=TIMEOUT)
        if procs[0].returncode != 0:
            with open(os.path.join(self.work, log)) as fh:
                raise AssertionError(fh.read()[-3000:])

    def close(self):
        for procs in self.procs.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


@contextlib.contextmanager
def one_thread():
    '''The references run in this process single-threaded, as the ranks do
    (OMP_NUM_THREADS=1): the warp bank's spline solve may round otherwise
    with more threads.'''
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _stream_config():
    config = _config(batch=8)
    config['data_options']['train']['device_cache'] = False
    return config


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp('torch_parallel'))
    records = [str(r) for r in util_synth.make_tfrecords(work, size=64)]
    started = Runs(work, records)
    try:
        yield started
    finally:
        started.close()


def _rank_npz(work, out, rank):
    with np.load(os.path.join(work, f'{out}.rank{rank}.npz')) as npz:
        return {k: npz[k] for k in npz.files}


def _rank_json(work, out, rank):
    with open(os.path.join(work, f'{out}.rank{rank}.json')) as fh:
        return json.load(fh)


def _jax_ref(work, name):
    with np.load(os.path.join(work, f'{name}.npz')) as npz:
        return {k: npz[k] for k in npz.files}


def _distance(got, ref):
    '''(the largest relative loss error, the largest parameter error)
    of a rank's run against the JAX run.'''
    loss = np.max(np.abs(got['losses'] - ref['losses']) /
                  np.abs(ref['losses']))
    param = max(float(np.abs(got[k[len('final/'):]] - v).max())
                for k, v in ref.items() if k.startswith('final/params/'))
    return loss, param


# -- (i), (ii), (iv): 2 ranks against the JAX package's 2-device mesh ----------------
@pytest.mark.parametrize('name', ['unet', 'bn'])
def test_two_ranks_match_the_jax_mesh(runs, name):
    runs.wait('steps')
    ref = _jax_ref(runs.work, name)
    for rank in (0, 1):
        got = _rank_npz(runs.work, f'steps_{name}_None', rank)
        np.testing.assert_allclose(got['losses'], ref['losses'],
                                   rtol=LOSS_RTOL)
        for key, want in ref.items():
            if key.startswith('final/params/'):
                np.testing.assert_allclose(
                    got[key[len('final/'):]], want, rtol=0, atol=PARAM_ATOL,
                    err_msg=key)
            elif key.startswith('final/batch_stats/'):
                np.testing.assert_allclose(
                    got[key[len('final/'):]], want, rtol=0,
                    atol=PARAM_ATOL, err_msg=key)
    if name == 'bn':
        assert any(k.startswith('final/batch_stats/') for k in ref)


@pytest.mark.parametrize('name, control', [('bn', 'local_bn'),
                                           ('unet', 'local_rate')])
def test_controls_miss_the_limits(runs, name, control):
    '''Per-rank BatchNorm statistics, or a per-shard positive rate, move
    the run past the limits that the global ones hold.'''
    runs.wait('steps')
    loss, param = _distance(
        _rank_npz(runs.work, f'steps_{name}_{control}', 0),
        _jax_ref(runs.work, name))
    assert loss > LOSS_RTOL or param > PARAM_ATOL, (loss, param)
    sound = _distance(_rank_npz(runs.work, f'steps_{name}_None', 0),
                      _jax_ref(runs.work, name))
    assert sound[0] <= LOSS_RTOL and sound[1] <= PARAM_ATOL, sound


@pytest.mark.parametrize('out, world', [('steps_unet_None', 2),
                                        ('steps_bn_None', 2),
                                        ('uneven_unet', 3),
                                        ('uneven_stream', 3),
                                        ('uneven_bn', 3)])
def test_ranks_hold_the_same_bits(runs, out, world):
    runs.wait('steps' if out.startswith('steps') else 'uneven')
    first = _rank_npz(runs.work, out, 0)
    for rank in range(1, world):
        got = _rank_npz(runs.work, out, rank)
        assert sorted(got) == sorted(first)
        for key, value in first.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


# -- (iii): uneven shards against one rank -------------------------------------------
@pytest.mark.parametrize('out', ['uneven_unet', 'uneven_stream'])
def test_three_uneven_ranks_match_one(runs, out):
    '''B = 8 over 3 ranks (rows 2, 3, 3): the resident and the streamed
    UNet, three Adam steps, against one rank on the same data and draws.'''
    config = _config(batch=8) if out == 'uneven_unet' else _stream_config()
    eng = engine.Engine(config, device='cpu')
    assert eng.group is None
    with one_thread():
        res = eng.train(pipeline.train_ds(runs.records,
                                          **config['data_options']['train']),
                        max_steps=STEPS, save_freq=1 << 30)
    runs.wait('uneven')
    got = _rank_npz(runs.work, out, 0)
    np.testing.assert_allclose(got['losses'], res.history['loss'],
                               rtol=LOSS_RTOL)
    for key, value in convert.flax_from_torch_state(
            eng.model.state_dict()).items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


STEP_TOL, F64_RATIO = 1e-4, 4.0   # chip_smoke.py phase 5's rule


def test_three_uneven_bn_ranks_match_one(runs):
    '''The BN UNet's first step at B = 8 over 3 ranks against one rank:
    the loss to 1e-5 relative, every updated BatchNorm statistic to 1e-6,
    and every gradient by chip_smoke.py phase 5's rule: within 1e-4 of its
    scale of the one-rank step's, else no further from an f64 step than 4
    times the one-rank step (a bias that feeds a BatchNorm, whose exact
    gradient is 0, on the scale of its layer's weight gradient, as
    tests/test_torch_unet_big.py holds it). Here the one-rank f32 step is
    the one far from f64 (~5e-3 of scale: E[x^2] - mean^2 over one batch of
    8192 pixels cancels), the ranks' sums of partial moments ~1e-6.'''
    from dnncancerannotator_torch.data import augment
    config = _config(bn=True, batch=8)
    eng = engine.Engine(config, device='cpu')
    ds = pipeline.train_ds(runs.records, **config['data_options']['train'])
    with one_thread():
        eng._setup_training(ds)
    # the first step's batch and draws, as Engine.train takes them
    gen = torch.Generator()
    gen.manual_seed(engine._stream_seed(eng.seed, engine._SAMPLE, 0))
    raw = eng.sample_batch(eng._resident(ds), 8, gen)
    gen.manual_seed(engine._stream_seed(eng.seed, engine._AUGMENT, 0))
    x, y = augment.to_feature_label(eng._augment(raw.float() / 255.0, gen),
                                    ds.slice_types)

    def step(dtype):
        model = eng.model.to(dtype).train()
        model.zero_grad(set_to_none=True)
        loss = eng.loss(y.to(dtype), model(x.to(dtype), return_logits=True))
        loss.backward()
        grads = {n: p.grad.double() for n, p in model.named_parameters()}
        stats = {n: b.double().clone() for n, b in model.named_buffers()}
        model.float()
        return float(loss.detach()), grads, stats

    loss, grads, stats = step(torch.float32)
    _, exact, _ = step(torch.float64)
    runs.wait('uneven')
    got = _rank_npz(runs.work, 'uneven_bn', 0)
    np.testing.assert_allclose(got['losses'], [loss], rtol=LOSS_RTOL)
    got_state = convert.torch_state_from_flax(
        {k: v for k, v in got.items() if k.startswith('batch_stats/')})
    for name, want in stats.items():
        np.testing.assert_allclose(got_state[name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    got_grads = convert.torch_state_from_flax(
        {k[len('grad/'):]: v for k, v in got.items()
         if k.startswith('grad/')})
    for name, want in grads.items():
        layer = name.rsplit('.', 1)[0]
        scale = max(float(want.abs().max()), float(grads.get(
            layer + '.weight', want).abs().max()))
        err = float((got_grads[name].double() - want).abs().max())
        if err <= STEP_TOL * scale:
            continue
        err64 = float((got_grads[name].double() - exact[name]).abs().max())
        plain64 = float((want - exact[name]).abs().max())
        assert err64 <= F64_RATIO * plain64, (name, err, scale, err64,
                                              plain64)


# -- (v), (vi): topology change and evaluate -------------------------------------------
def test_two_ranks_resumed_by_one_match_an_unbroken_run(runs):
    runs.wait('resume')
    work = runs.work
    broken = _rank_json(work, 'broken', 0)
    unbroken = _rank_json(work, 'unbroken', 0)
    assert broken['epoch'] == [1, 2] and unbroken['epoch'] == [1, 2, 3, 4]
    for out in ('broken', 'unbroken'):
        assert _rank_json(work, out, 1)['writes'] == []
    save = os.path.join(work, 'broken')
    assert sorted(os.listdir(os.path.join(save, 'checkpoints'))) == [
        'ckpt-2']
    with one_thread():
        resumed = main(argv=_argv(work, runs.records, save, 4))
    assert resumed.epoch == [3, 4]
    np.testing.assert_allclose(resumed.history['loss'],
                               unbroken['losses'][2:], rtol=LOSS_RTOL)
    np.testing.assert_allclose(broken['losses'], unbroken['losses'][:2],
                               rtol=0)
    got = engine.read_ckpt(os.path.join(save, 'checkpoints', 'ckpt-4'),
                           opt_state=False)
    want = engine.read_ckpt(os.path.join(work, 'unbroken', 'checkpoints',
                                         'ckpt-4'), opt_state=False)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    # rank 0 alone wrote: one event file a directory, one results pickle
    events = os.path.join(work, 'unbroken', 'tfevents', 'train')
    assert len([f for f in os.listdir(events)
                if f.startswith('events.out')]) == 1
    with open(os.path.join(work, 'unbroken', 'results.pkl'), 'rb') as fh:
        assert pickle.load(fh)['epoch'] == [1, 2, 3, 4]
    assert sorted(os.listdir(os.path.join(work, 'unbroken'))) == [
        'checkpoints', 'options.yaml', 'results.pkl', 'tfevents']


def _csv(path):
    with open(path) as fh:
        return [line.rstrip('\n').split(',') for line in fh]


def test_two_rank_evaluate_matches_one(runs):
    '''results.csv of a 2-rank evaluate (batches of 5 padded to 6) equals
    one rank's: region counts exactly, the other columns to 1e-6 relative;
    rank 1 wrote nothing.'''
    runs.wait('resume')
    save = os.path.join(runs.work, 'unbroken')
    main(argv=['evaluate', '--save_path', save, '--data_path', *runs.records,
               '--tag', 'one', '--export_csv', '--device', 'cpu'])
    assert _rank_json(runs.work, 'evaluate', 1)['writes'] == []
    got = _csv(os.path.join(save, 'tfevents', 'dp', 'results.csv'))
    want = _csv(os.path.join(save, 'tfevents', 'one', 'results.csv'))
    assert got[0] == want[0] and len(got) == len(want) == 3
    assert any(name.startswith('region/') for name in got[0])
    for row_got, row_want in zip(got[1:], want[1:]):
        for name, a, b in zip(got[0], row_got, row_want):
            if name.startswith('region/') and 'count' in name or \
                    name == 'step':
                assert a == b, name
            else:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                           err_msg=name)
    casewise = [_csv(os.path.join(save, 'tfevents', tag,
                                  'casewise_results.csv'))
                for tag in ('dp', 'one')]
    assert casewise[0] == casewise[1]


# -- (vii): SIGTERM to one rank ----------------------------------------------------------
def test_sigterm_to_one_rank_stops_every_rank(runs):
    runs.wait('sigterm')
    stops = [_rank_json(runs.work, 'sigterm', rank)['epoch'][-1]
             for rank in (0, 1)]
    assert stops[0] == stops[1] and 0 < stops[0] < 100000
    assert stops[0] % 2 == 0   # the chunk in flight finished
    assert sorted(os.listdir(os.path.join(
        runs.work, 'sigterm_run', 'checkpoints'))) == [f'ckpt-{stops[0]}']


# -- (viii): NCCL on one card, and launch's choice --------------------------------------
def test_two_nccl_ranks_on_one_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(dist, 'init_process_group', lambda *a, **k: (
        pytest.fail('joined a group')))
    with pytest.raises(RuntimeError, match='two NCCL ranks on one card'):
        multihost.init('nccl', 'localhost', 1, 2, 1, 1, 2, device='cuda')
    env = dict(DNNCA_MULTIHOST='1', MASTER_ADDR='localhost',
               MASTER_PORT='1', WORLD_SIZE='2', RANK='0', LOCAL_RANK='0',
               LOCAL_WORLD_SIZE='2')
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match='two NCCL ranks on one card'):
        multihost.maybe_initialize('cuda')
    # gloo may put both ranks on the one card
    monkeypatch.setattr(torch.cuda, 'set_device', lambda index: None)
    joined = []
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **k: joined.append(backend))
    multihost.init('gloo', 'localhost', 1, 2, 1, 1, 2, device='cuda')
    assert joined == ['gloo']


@pytest.mark.parametrize('enable, device, cards, spawned', [
    (True, 'cuda', 4, 4), (True, 'cuda', 1, 0), (False, 'cuda', 4, 0),
    (True, 'cuda:1', 4, 0), (True, 'cpu', 4, 0)])
def test_launch_spawns_one_process_a_card(monkeypatch, enable, device, cards,
                                          spawned):
    import torch.multiprocessing as mp
    monkeypatch.delenv('DNNCA_MULTIHOST', raising=False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    calls = []

    def start_processes(fn, args, nprocs, start_method):
        calls.append((fn, nprocs, start_method))
        with open(args[-1], 'wb') as fh:
            pickle.dump('rank 0', fh)
    monkeypatch.setattr(mp, 'start_processes', start_processes)
    got = multihost.launch(lambda x: x, ('here',), enable, device)
    if spawned:
        assert got == 'rank 0'
        assert calls == [(multihost._spawned, spawned, 'spawn')]
    else:
        assert got == 'here' and calls == []


# -- the shard and padding rules ----------------------------------------------------------
def _group(world, rank):
    group = object.__new__(mesh.Group)
    group.world, group.rank = world, rank
    return group


@pytest.mark.parametrize('world', [1, 2, 3])
def test_shard_rows_and_padding(world):
    for b in range(world, 10):
        rows = [_group(world, r).shard_rows(b) for r in range(world)]
        assert rows[0][0] == 0 and rows[-1][1] == b
        assert all(a[1] == c[0] for a, c in zip(rows, rows[1:]))
        assert max(h - lo for lo, h in rows) - min(
            h - lo for lo, h in rows) <= 1
    for n in range(1, 8):
        for pad_to in (None, 6):
            batch = np.arange(n)
            target = max(pad_to or n, n)
            target += -target % world
            # JAX parallel/mesh.py:shard_batch's padding
            want = np.concatenate([batch, np.repeat(batch[-1:], target - n)])
            parts = [_group(world, r).shard_batch(batch, pad_to)
                     for r in range(world)]
            assert np.array_equal(np.concatenate([p for p, _ in parts]), want)
            assert sum(v for _, v in parts) == n
            for rows, valid in parts:
                assert np.array_equal(rows[:valid], batch[
                    np.isin(batch, rows[:valid])])
            tparts = [_group(world, r).shard_batch(torch.from_numpy(batch),
                                                   pad_to)
                      for r in range(world)]
            assert [v for _, v in tparts] == [v for _, v in parts]
            assert np.array_equal(torch.cat([p for p, _ in tparts]).numpy(),
                                  want)
    if world > 1:
        with pytest.raises(ValueError, match='without rows'):
            _group(world, 0).shard_rows(world - 1)


# -- (ix): one rank in a group gives the bits of no group ------------------------------------
def test_one_rank_group_is_bit_equal_to_no_group(runs):
    '''The BN UNet with the train metrics and debug_asserts: three steps
    and an evaluate pass in a world-1 gloo group (every collective run)
    against no group, the same bits.'''
    config = _config(bn=True, debug_asserts=True)
    config['deploy_options']['metrics'] = config_lib.load_config(
        [*CONFIGS, METRICS])['deploy_options']['metrics'][:2]
    ds = pipeline.train_ds(runs.records, **config['data_options']['train'])
    eval_ds = pipeline.eval_ds(runs.records, batch_size=5,
                               output_size=(32, 32))

    def run():
        eng = engine.Engine(config, device='cpu')
        res = eng.train(ds, max_steps=STEPS, save_freq=1 << 30)
        val = eng._eval_dataset(eng._make_eval_step(eval_ds.slice_types),
                                eval_ds, eng._build_metrics())
        return eng, res, val

    plain, plain_res, plain_val = run()
    assert plain.group is None
    dist.init_process_group('gloo', init_method='tcp://localhost:'
                            f'{multihost.free_port()}', world_size=1, rank=0)
    try:
        grouped, res, val = run()
        assert grouped.group is not None and grouped.group.world == 1
    finally:
        dist.destroy_process_group()
    assert res.history == plain_res.history
    assert val == plain_val
    want = plain.model.state_dict()
    for key, value in grouped.model.state_dict().items():
        assert torch.equal(value, want[key]), key
