'''The port's spatial partitioning (``deploy_options.spatial_partition``) on
the CPU: the image rows of every batch split over the ranks of a model
group (gloo processes, tests/util_torch_dp.py), the halos exchanged
explicitly, held against one rank of the port and against the JAX
package's ``(data, model)`` mesh.

- (a) the slab rule in one process: for every split of an 8-row image
  over 2 and 3 ranks, at r = 1 and the chain's 2r, the chain, the NCHW
  and NHWC stencil convs and the library conv on each rank's slab (built
  through the exchange's own pack / unpack, the buffers summed here),
  cut back, equal the whole image's forward bit for bit; the exchange's
  transpose gives the whole image's dx, dw and db within 1e-6 of scale;
- (b) three Adam steps of a narrow UNet at (data 1, model 2) and (data 2,
  model 2) against one rank on the same data and draws, at
  tests/test_torch_parallel.py's LOSS_RTOL and PARAM_ATOL; the first step
  of a narrow BN UNet at both layouts and of a narrow MulmoUNet and
  MultiResUnet at (data 1, model 2) by that file's f64 rule; every rank
  the same parameter bits;
- (c) the UNet at (data 1, model 2) against the JAX Engine's
  ``spatial_partition: 2`` on two CPU devices, fed its draws;
- (d) ``evaluate`` and ``predict`` at N = 2 against one rank: results.csv
  (region counts exactly) and the maps; ``train --validate --visualize``
  ran at N = 2;
- (e) the exchange giving zero rows misses (b)'s limits;
- (f) a run written at N = 2 resumes at N = 1, and one written at N = 1
  at N = 2, against unbroken runs; SIGTERM to one rank stops both at one
  step;
- (g) a world that N does not divide, too few blocks, a misaligned
  height, N > 1 with ``enable_multigpu: false`` or with no group raise.

The ranks and the JAX run start together in one module fixture.
'''

import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.data import pipeline
from dnncancerannotator_torch.models import fastconv
from dnncancerannotator_torch.ops import functions, pooling
from dnncancerannotator_torch.parallel import mesh, multihost
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_synth, util_torch_dp
from tests.conftest import scrubbed_cpu_env
from tests.test_torch_parallel import (CONFIGS, JAX_RUN, LOSS_RTOL, METRICS,
                                       PARAM_ATOL, _config,
                                       _csv, _rank_json, _rank_npz,
                                       one_thread)
from tests.util_torch_dp import TIMEOUT, ranks, wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# a BatchNorm model's f64 step on the ranks against one rank's: the
# statistics and the loss (relative), and the gradients relative to the
# model's largest
F64_TOL = 1e-9

# the JAX run of tests/test_torch_parallel.py on a (data 1, model 2) mesh
_DATA_MESH = "assert eng.mesh.shape['data'] == 2"
assert _DATA_MESH in JAX_RUN
JAX_SPATIAL = JAX_RUN.replace(_DATA_MESH,
                              "assert eng.mesh.shape['model'] == 2")


def _model_config(name, spatial=2):
    '''A narrow config of each family at 32 x 32, batch 4.'''
    if name == 'unet':
        config = _config()
    elif name == 'bn':
        config = _config(bn=True)
    else:
        yaml = {'mulmo': 'mulmo_unet.yaml', 'mru': 'multiresunet.yaml'}[name]
        config = config_lib.load_config(
            [os.path.join(REPO, 'configs', yaml)] + CONFIGS[1:])
        config['data_options']['train'].update(output_size=[32, 32],
                                               batch_size=4)
        config['deploy_options'].update(warp_bank_size=6,
                                        enable_multigpu=True)
        config['model_options'].update(
            dict(n_filters_first=4, n_downsample=2) if name == 'mulmo'
            else dict(base_filters=4))
    if spatial > 1:
        config['deploy_options']['spatial_partition'] = spatial
    return config


def _overlay(work, spatial):
    path = os.path.join(work, f'spatial{spatial}.json')
    if not os.path.exists(path):   # ranks may be reading it
        with open(path, 'w') as fh:
            json.dump({'data_options.train.output_size': [32, 32],
                       'data_options.train.batch_size': 4,
                       'data_options.eval.output_size': [32, 32],
                       'data_options.eval.batch_size': 5,
                       'deploy_options.warp_bank_size': 4,
                       'deploy_options.steps_per_call': 2,
                       'deploy_options.enable_multigpu': True,
                       'deploy_options.spatial_partition': spatial}, fh)
    return path


def _train_argv(work, records, save, steps, spatial, *extra):
    return ['train', '--config', *CONFIGS, METRICS, _overlay(work, spatial),
            '--save_path', save, '--data_path', *records, '--save_freq', '2',
            '--device', 'cpu', '--max_steps', str(steps), *extra]


def _eval_argv(work, records, save, tag, spatial):
    return ['evaluate', '--save_path', save, '--data_path', *records,
            '--tag', tag, '--export_csv', '--visualize_sensitivity',
            '--config', _overlay(work, spatial), '--device', 'cpu']


def _predict_argv(work, records, save, out, spatial):
    return ['predict', '--save_path', save, '--data_path', *records,
            '--output_path', out, '--output_format', 'npy', '--batch_size',
            '3', '--config', _overlay(work, spatial), '--device', 'cpu']


class Runs:
    '''The module's rank launches and the JAX run, started together.'''

    def __init__(self, work, records):
        self.work, self.records = work, records
        self.procs = {}
        w = lambda *p: os.path.join(work, *p)   # noqa: E731
        with open(w('jax.log'), 'w') as log:
            jax_run = subprocess.Popen(
                [sys.executable, '-c', JAX_SPATIAL, work,
                 json.dumps({'unet': _model_config('unet')})], cwd=REPO,
                env=scrubbed_cpu_env(2), stdout=log,
                stderr=subprocess.STDOUT)
        self.procs['jax'] = [jax_run]
        # (f): one rank to step 2, which the 2-rank launch resumes
        with one_thread():
            main(argv=_train_argv(work, records, w('up'), 2, 1))
        train = lambda name, out, steps=STEPS, **kw: dict(   # noqa: E731
            kind='train', config=_model_config(name), records=records,
            max_steps=steps, out=w(out), **kw)
        self.procs['two'] = ranks(2, [
            train('unet', 'two_unet'),
            *(train(name, f'two_{name}{f64}', 1, f64=bool(f64))
              for name in ('bn', 'mulmo', 'mru') for f64 in ('', '64')),
            train('unet', 'two_zero', control='zero_halo')], work, 'two')
        # the CLI runs on two more ranks at the same time
        self.procs['cli'] = ranks(2, [
            dict(kind='cli', out=w('broken'), argv=_train_argv(
                work, records, w('broken'), 2, 2, '--validate',
                '--val_data_path', *records, '--visualize')),
            dict(kind='cli', out=w('unbroken'), argv=_train_argv(
                work, records, w('unbroken'), 4, 2)),
            dict(kind='cli', out=w('up'), argv=_train_argv(
                work, records, w('up'), 4, 2)),
            dict(kind='cli', out=w('evaluate'), argv=_eval_argv(
                work, records, w('unbroken'), 'two', 2)),
            dict(kind='cli', out=w('predict'), argv=_predict_argv(
                work, records, w('unbroken'), w('maps_two'), 2)),
            dict(kind='sigterm', victim=1, out=w('sigterm'), argv=[
                'train', '--config', *CONFIGS, _overlay(work, 2),
                '--save_path', w('sigterm_run'), '--data_path', *records,
                '--save_freq', '50000', '--device', 'cpu', '--max_steps',
                '100000'])],
            work, 'cli')
        self.procs['four'] = ranks(4, [train('unet', 'four_unet'),
                                       train('bn', 'four_bn', 1),
                                       train('bn', 'four_bn64', 1, f64=True)],
                                   work, 'four')
        self.wait('jax', log='jax.log')
        self.procs['steps'] = ranks(2, [dict(
            kind='steps', config=_model_config('unet'), ref=w('unet.npz'),
            control=None, out=w('steps_unet'))], work, 'steps')

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


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp('torch_spatial'))
    records = [str(r) for r in util_synth.make_tfrecords(work, size=64)]
    started = Runs(work, records)
    try:
        yield started
    finally:
        started.close()


# -- (a): the slab rule in one process ---------------------------------------------
H = 8


def _splits():
    '''Every split of H rows over 2 and 3 ranks, as boundaries.'''
    for n in (2, 3):
        for cut in itertools.combinations(range(1, H), n - 1):
            yield (0, *cut, H)


def _fns():
    '''{name: (fn(x, w, b), radius, rows axis, chain)} of the functions
    that run on slabs.'''
    pads = ((1, 1), (1, 1))
    return {
        'chain': (lambda x, w, b: functions.conv_chain(
            x, w[0], b[0], w[1], b[1]), 1, 2, True),
        'stencil': (lambda x, w, b: functions.stencil_conv(
            x, w, b, pads, True), 1, 2, False),
        'stencil_nhwc': (lambda x, w, b: functions.stencil_conv_nhwc(
            x, w, b, pads, True), 1, 1, False),
        'library': (lambda x, w, b: F.conv2d(x, w, b, padding=1), 1, 2,
                    False)}


def _inputs(name, axis, chain):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 3, H, 6, generator=gen)
    if axis == 1:
        x = x.permute(0, 2, 3, 1).contiguous()
    if chain:
        w = (torch.randn(4, 3, 3, 3, generator=gen) / 4,
             torch.randn(4, 4, 3, 3, generator=gen) / 4)
        b = (torch.randn(4, generator=gen), torch.randn(4, generator=gen))
    else:
        w, b = torch.randn(4, 3, 3, 3, generator=gen) / 4, torch.randn(
            4, generator=gen)
    return x, w, b


def _leaves(w, b):
    '''Leaf copies of the weights and biases (tuples for the chain) that
    record their gradients: (the leaves, w, b).'''
    chain = isinstance(w, tuple)
    params = [t.detach().clone().requires_grad_()
              for t in ((*w, *b) if chain else (w, b))]
    if chain:
        return params, tuple(params[:2]), tuple(params[2:])
    return params, params[0], params[1]


def _emulated(fn, x, w, b, bounds, up, axis, g=None):
    '''Every rank of ``bounds``'s forward on its slab, the exchange's
    buffers summed here (its collective), cut back; with the cotangent
    ``g`` also the whole dx (each rank's through the transpose) and the
    parameters' gradients summed over the ranks.'''
    n = len(bounds) - 1
    rows = [x.narrow(axis, bounds[m], bounds[m + 1] - bounds[m]).movedim(
        axis, 0) for m in range(n)]
    total = sum(mesh.pack(rows[m], bounds, m, up, up) for m in range(n))
    outs, slab_grads, dparams = [], [], []
    for m in range(n):
        above, below = mesh.unpack(total, rows[m], bounds, m, up, up)
        slab = mesh.slab(*(t.movedim(0, axis) for t in (rows[m], above,
                                                         below)), axis)
        params, pw, pb = _leaves(w, b)
        slab.requires_grad_(g is not None)
        (a, lo), _ = mesh.halo(bounds, m, up, up)
        out = fn(slab, pw, pb).narrow(axis, lo - a, bounds[m + 1] - lo)
        outs.append(out.detach())
        if g is not None:
            out.backward(g.narrow(axis, lo, bounds[m + 1] - lo))
            slab_grads.append(slab.grad.movedim(axis, 0))
            dparams.append([p.grad for p in params])
    if g is None:
        return torch.cat(outs, axis)
    total = sum(mesh.pack_t(slab_grads[m], bounds, m, up, up)
                for m in range(n))
    dx = torch.cat([mesh.unpack_t(total, slab_grads[m], bounds, m, up, up)
                    for m in range(n)], 0).movedim(0, axis)
    return dx, [sum(p) for p in zip(*dparams)]


@pytest.mark.parametrize('name', ['chain', 'stencil', 'stencil_nhwc',
                                  'library'])
def test_slab_forward_is_bit_equal(name):
    fn, r, axis, chain = _fns()[name]
    x, w, b = _inputs(name, axis, chain)
    want = fn(x, w, b)
    count = 0
    for bounds in _splits():
        for up in (r, 2 * r):
            if chain and up < 2 * r:
                continue   # the chain needs both convs' halo
            got = _emulated(fn, x, w, b, bounds, up, axis)
            assert torch.equal(got, want), (name, bounds, up)
            count += 1
    assert count == (7 + 21) * (1 if chain else 2)


@pytest.mark.parametrize('name', ['chain', 'stencil', 'stencil_nhwc',
                                  'library'])
def test_halo_transpose_gives_whole_gradients(name):
    fn, r, axis, chain = _fns()[name]
    x, w, b = _inputs(name, axis, chain)
    x.requires_grad_()
    params, pw, pb = _leaves(w, b)
    out = fn(x, pw, pb)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    out.backward(g)
    want = [x.grad] + [p.grad for p in params]
    for bounds in _splits():
        dx, dparams = _emulated(fn, x.detach(), w, b, bounds, 2 * r, axis, g)
        for got, ref in zip([dx] + dparams, want):
            err = float((got - ref).abs().max())
            assert err <= 1e-6 * float(ref.abs().max()), (name, bounds, err)


# -- (b), (e): against one rank -------------------------------------------------------
def _one_rank(records, name, steps):
    '''One rank's ``Engine.train`` of ``name`` on the same data and
    draws.'''
    config = _model_config(name, spatial=1)
    eng = engine.Engine(config, device='cpu')
    assert eng.group is None
    with one_thread():
        res = eng.train(pipeline.train_ds(records,
                                          **config['data_options']['train']),
                        max_steps=steps, save_freq=1 << 30)
    return res.history['loss'], convert.flax_from_torch_state(
        eng.model.state_dict())


def _distance(got, losses, state):
    loss = max(abs(a - b) / abs(b) for a, b in zip(got['losses'], losses))
    param = max(float(np.abs(got[k] - v).max()) for k, v in state.items()
                if k.startswith('params/'))
    return loss, param


def _same_bits(work, out, world):
    first = _rank_npz(work, out, 0)
    for rank in range(1, world):
        got = _rank_npz(work, out, rank)
        assert sorted(got) == sorted(first)
        for key, value in first.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    return first


@pytest.mark.parametrize('out, world', [('two_unet', 2), ('four_unet', 4)])
def test_unet_steps_match_one_rank(runs, out, world):
    '''Three Adam steps at (data 1, model 2) and (data 2, model 2).'''
    losses, state = _one_rank(runs.records, 'unet', STEPS)
    runs.wait('two' if world == 2 else 'four')
    got = _same_bits(runs.work, out, world)
    np.testing.assert_allclose(got['losses'], losses, rtol=LOSS_RTOL)
    for key, value in state.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


def test_zero_halo_misses_the_limits(runs):
    '''(e): the exchange giving zero rows moves (b) past its limits.'''
    losses, state = _one_rank(runs.records, 'unet', STEPS)
    runs.wait('two')
    loss, param = _distance(_rank_npz(runs.work, 'two_zero', 0), losses,
                            state)
    assert loss > LOSS_RTOL or param > PARAM_ATOL, (loss, param)
    sound = _distance(_rank_npz(runs.work, 'two_unet', 0), losses, state)
    assert sound[0] <= LOSS_RTOL and sound[1] <= PARAM_ATOL, sound


@pytest.mark.parametrize('out, world', [('two_bn', 2), ('four_bn', 4),
                                        ('two_mulmo', 2), ('two_mru', 2)])
def test_bn_first_step_matches_one_rank(runs, out, world):
    '''The first step of a BatchNorm model against one rank's
    ``Engine.train`` on the same data and draws: in f32 the loss to
    LOSS_RTOL and every updated statistic to PARAM_ATOL; with the model in
    f64 (util_torch_dp.py's ``f64`` job, here and on the ranks) every
    statistic to F64_TOL, the loss to F64_TOL relative and every gradient
    to F64_TOL of the model's largest. The f32 gradients are not held to
    one another: E[x^2] - mean^2 summed in another order moves a
    pre-activation near 0 across it (MultiResUnet's respath3.conv_1:
    -2.1e-6 on one rank, +7.9e-7 on two), and the relu there sends one
    pixel's gradient another way.'''
    name = out.split('_')[1]
    one = {}
    with one_thread():
        for f64 in ('', '64'):
            util_torch_dp.train(dict(
                kind='train', config=_model_config(name, spatial=1),
                records=runs.records, max_steps=1, f64=bool(f64),
                out=os.path.join(runs.work, f'one_{out}{f64}')), 0)
            one[f64] = _rank_npz(runs.work, f'one_{out}{f64}', 0)
    runs.wait('two' if world == 2 else 'four')
    got = _same_bits(runs.work, out, world)
    np.testing.assert_allclose(got['losses'], one['']['losses'],
                               rtol=LOSS_RTOL)
    _close(_part(got, 'batch_stats'), _part(one[''], 'batch_stats'),
           PARAM_ATOL)
    got64, one64 = _same_bits(runs.work, out + '64', world), one['64']
    _close(_part(got64, 'stat'), _part(one64, 'stat'), F64_TOL)
    _close(_part(got64, 'grad'), _part(one64, 'grad'), F64_TOL * max(
        float(np.abs(g).max()) for g in _part(one64, 'grad').values()))
    np.testing.assert_allclose(got64['losses'], one64['losses'],
                               rtol=F64_TOL)


def _part(saved, kind):
    '''The entries of a rank's npz under ``kind/``, by the rest of the
    key.'''
    return {k.split('/', 1)[1]: v for k, v in saved.items()
            if k.startswith(kind + '/')}


def _close(got, want, tol):
    '''Every array of ``want`` within ``tol`` of ``got``'s.'''
    assert sorted(got) == sorted(want)
    worst = max((float(np.abs(got[k].astype(np.float64) - v).max()), k)
                for k, v in want.items())
    assert worst[0] <= tol, (worst, tol)


# -- (c): against the JAX package's (data 1, model 2) mesh ---------------------------
def test_two_ranks_match_the_jax_spatial_mesh(runs):
    runs.wait('steps')
    with np.load(os.path.join(runs.work, 'unet.npz')) as npz:
        ref = {k: npz[k] for k in npz.files}
    for rank in (0, 1):
        got = _rank_npz(runs.work, 'steps_unet', rank)
        np.testing.assert_allclose(got['losses'], ref['losses'],
                                   rtol=LOSS_RTOL)
        for key, want in ref.items():
            if key.startswith('final/params/'):
                np.testing.assert_allclose(
                    got[key[len('final/'):]], want, rtol=0, atol=PARAM_ATOL,
                    err_msg=key)


# -- (d), (f): the CLI at N = 2 ---------------------------------------------------------
def test_evaluate_and_predict_match_one_rank(runs):
    '''results.csv of a 2-rank evaluate (batches of 5, each rank 16 of the
    32 rows; its Visualizer with the input sensitivity) equals one rank's:
    region counts exactly, the other columns to 1e-6 relative; the 2-rank
    maps equal one rank's to 1e-6; the 2-rank ``train --validate
    --visualize`` logged its validation.'''
    runs.wait('cli')
    w = lambda *p: os.path.join(runs.work, *p)   # noqa: E731
    save = w('unbroken')
    with one_thread():
        main(argv=_eval_argv(runs.work, runs.records, save, 'one', 1))
        main(argv=_predict_argv(runs.work, runs.records, save, w('maps_one'),
                                1))
    got = _csv(os.path.join(save, 'tfevents', 'two', 'results.csv'))
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
                for tag in ('two', 'one')]
    assert casewise[0] == casewise[1]
    sens = [sorted(os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(save, 'tfevents', tag, 'csv')) for f in fs
        if f.endswith('_sensitivity.csv')) for tag in ('two', 'one')]
    assert len(sens[0]) == len(sens[1]) > 0
    for a, b in zip(*sens):
        np.testing.assert_allclose(
            [float(r[1]) for r in _csv(a)[1:]],
            [float(r[1]) for r in _csv(b)[1:]], rtol=1e-5, atol=1e-7)
    maps = [sorted(os.path.join(d, f) for d, _, fs in os.walk(w(m))
                   for f in fs) for m in ('maps_two', 'maps_one')]
    assert len(maps[0]) == len(maps[1]) > 0
    for a, b in zip(*maps):
        np.testing.assert_allclose(np.load(a), np.load(b), rtol=0, atol=1e-6)
    broken = _rank_json(runs.work, 'broken', 0)
    assert broken['epoch'] == [1, 2]
    assert os.path.isdir(w('broken', 'tfevents', 'train'))


@pytest.mark.parametrize('direction', ['2 to 1', '1 to 2'])
def test_resume_across_spatial(runs, direction):
    '''(f): a run written at one N resumed at the other, against an
    unbroken 2-rank run (both to step 4).'''
    runs.wait('cli')
    w = lambda *p: os.path.join(runs.work, *p)   # noqa: E731
    unbroken = _rank_json(runs.work, 'unbroken', 0)
    assert unbroken['epoch'] == [1, 2, 3, 4]
    if direction == '2 to 1':
        broken = _rank_json(runs.work, 'broken', 0)
        np.testing.assert_allclose(broken['losses'], unbroken['losses'][:2],
                                   rtol=LOSS_RTOL)
        with one_thread():
            resumed = main(argv=_train_argv(runs.work, runs.records,
                                            w('broken'), 4, 1))
        epoch, losses, save = resumed.epoch, resumed.history['loss'], \
            w('broken')
    else:
        resumed = _rank_json(runs.work, 'up', 0)
        epoch, losses, save = resumed['epoch'], resumed['losses'], w('up')
    assert epoch == [3, 4]
    np.testing.assert_allclose(losses, unbroken['losses'][2:],
                               rtol=LOSS_RTOL)
    got = engine.read_ckpt(os.path.join(save, 'checkpoints', 'ckpt-4'),
                           opt_state=False)
    want = engine.read_ckpt(w('unbroken', 'checkpoints', 'ckpt-4'),
                            opt_state=False)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


def test_sigterm_to_one_rank_stops_every_rank(runs):
    '''SIGTERM to rank 1 of a model group stops both ranks after the same
    chunk, with one checkpoint at that step (steps_per_call 2).'''
    runs.wait('cli')
    stops = [_rank_json(runs.work, 'sigterm', rank)['epoch'][-1]
             for rank in (0, 1)]
    assert stops[0] == stops[1] and 0 < stops[0] < 100000
    assert stops[0] % 2 == 0
    assert sorted(os.listdir(os.path.join(
        runs.work, 'sigterm_run', 'checkpoints'))) == [f'ckpt-{stops[0]}']


# -- (g): layouts that cannot be split ------------------------------------------------------
def test_split_rows():
    '''``split_rows`` spreads blocks as ``shard_rows`` spreads rows, and
    raises with the numbers.'''
    assert mesh.split_rows(256, 8, 3) == (0, 80, 168, 256)
    assert mesh.split_rows(32, 8, 2) == (0, 16, 32)
    with pytest.raises(ValueError, match='36 image rows .* 8-row block'):
        mesh.split_rows(36, 8, 2)
    with pytest.raises(ValueError, match='2 block.* fewer than the 3'):
        mesh.split_rows(16, 8, 3)


@pytest.mark.parametrize('case', ['world', 'no_group', 'multigpu_off',
                                  'launch', 'blocks', 'aligned', 'valid',
                                  'pool'])
def test_layouts_that_cannot_split_raise(case):
    config = _model_config('unet')
    if case in ('valid', 'pool'):
        # rank 1 of a model group of 2 holding rows [6, 12) of 12
        group = object.__new__(mesh.Group)
        group.world, group.rank, group.spatial = 2, 1, 2
        x = torch.zeros(1, 2, 6, 4)
        with mesh.active(mesh.Shard(group, 1, 1, (0, 6, 12))):
            if case == 'valid':   # its output would lose the halo rows
                conv = fastconv.Conv2DFast(2, 2, (3, 3), padding='VALID')
                with pytest.raises(ValueError, match='VALID 3x3 conv needs '
                                   'whole planes'):
                    conv(x)
            else:   # a pool of 4 over its 6 rows would cross ranks
                with pytest.raises(ValueError, match='pool of 4 rows'):
                    pooling.max_pool2d(x, 4)
        return
    if case == 'multigpu_off':
        config['deploy_options']['enable_multigpu'] = False
        with pytest.raises(ValueError, match='enable_multigpu .here False'):
            engine.Engine(config, device='cpu')
        return
    if case == 'no_group':
        with pytest.raises(ValueError, match='spatial_partition 2 needs'):
            engine.Engine(config, device='cpu')
        return
    if case == 'launch':
        with pytest.raises(ValueError, match='spatial_partition 2 needs'):
            multihost.launch(lambda: pytest.fail('ran'), (), True, 'cpu', 2)
        return
    dist.init_process_group('gloo', init_method='tcp://localhost:'
                            f'{multihost.free_port()}', world_size=1, rank=0)
    try:
        if case == 'world':
            with pytest.raises(ValueError, match='2 does not divide the '
                               'world of 1'):
                engine.Engine(config, device='cpu')
            with pytest.raises(ValueError, match='2 does not divide the '
                               'world of 1'):
                multihost.launch(lambda: pytest.fail('ran'), (), True, 'cpu',
                                 2)
            return
        config['deploy_options']['spatial_partition'] = 1
        eng = engine.Engine(config, device='cpu')
        eng.build((4, 32, 32, 5))
        # as if the world held a model group of 3
        eng.group.spatial = eng.spatial = 3
        if case == 'blocks':
            # 16 rows in the UNet's 8-row blocks: 2 blocks for 3 ranks
            with pytest.raises(ValueError, match='fewer than the 3 ranks'):
                eng._split(16)
            return
        shard = mesh.Shard(eng.group, 4, 4, (0, 12, 20, 32))
        with mesh.active(shard), pytest.raises(ValueError,
                                               match='8-row block'):
            eng.model(torch.zeros(4, 12, 32, 5))
    finally:
        dist.destroy_process_group()
