'''One rank of a data-parallel test run of the port on the CPU (gloo):
``python tests/util_torch_dp.py SPEC.json`` in each rank's process, with
``DNNCA_MULTIHOST=1`` and torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) in its
environment, as ``tests/test_torch_parallel.py:ranks`` starts them.

SPEC holds ``jobs``, run in order, each writing this rank's results to
``<out>.rank<r>.npz`` (or .json):
- ``steps``: train steps of the port on the JAX run's raw batches, draws
  and initial weights (an .npz of tests/test_torch_parallel.py's JAX
  script), each rank on its rows; with ``control`` 'local_bn' or
  'local_rate' BatchNorm's statistics or the loss's positive rate are the
  rank's own (a broken step, which the test must catch);
- ``train``: ``Engine.train`` on records for ``max_steps`` steps (the
  losses, the state and the last step's gradients); with ``control``
  'zero_halo' the spatial_partition exchange gives zero rows (a broken
  step, which tests/test_torch_spatial.py must catch); with ``f64`` the
  model, its inputs and its loss in float64 (the augmentation in f32, then
  cast, as tests/test_torch_spatial.py's f64 reference takes it; the
  gradients and statistics saved in f64 by torch name);
- ``cli``: the port's CLI with ``argv``; with ``guard`` a rank other than
  0 records every file it opens for writing, makes, moves or removes under
  that directory;
- ``sigterm``: the ``train`` CLI, SIGTERM sent to rank ``victim`` once its
  handler is live.
A job's ``device`` (default 'cpu') may be 'cuda': then every rank runs on
the one card, the group still gloo. The module imports no JAX.
'''

import builtins
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch.data import augment, pipeline
from dnncancerannotator_torch.models import fastbn
from dnncancerannotator_torch.ops import kernels
from dnncancerannotator_torch.parallel import mesh, multihost
from dnncancerannotator_torch.runs.__main__ import main as cli
from dnncancerannotator_torch.train import losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def ranks(world, jobs, work, name):
    '''Start ``world`` rank processes of this module on ``jobs`` in a gloo
    group on a free localhost port (its files under ``work``, named
    ``name``); returns the processes.'''
    spec = os.path.join(work, f'{name}.spec.json')
    with open(spec, 'w') as fh:
        json.dump({'jobs': jobs}, fh)
    port = multihost.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + os.environ.get('PYTHONPATH', '').split(os.pathsep)),
                   DNNCA_MULTIHOST='1', MASTER_ADDR='localhost',
                   MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS='1')
        log = open(os.path.join(work, f'{name}.rank{rank}.log'), 'w')
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait(procs, work, name, timeout=TIMEOUT):
    deadline = time.time() + timeout
    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(work, f'{name}.rank{rank}.log')) as fh:
                raise AssertionError(f'{name} rank {rank} exited '
                                     f'{proc.returncode}:\n{fh.read()[-3000:]}')


def _state(eng):
    return convert.flax_from_torch_state(eng.model.state_dict())


def _save(job, rank, **arrays):
    np.savez(f"{job['out']}.rank{rank}.npz", **arrays)


class _Local:
    '''A stand-in for parallel.mesh in one module: no data-parallel step
    is ever current there.'''

    @staticmethod
    def current():
        return None


def steps(job, rank):
    '''The JAX run's steps on this rank's rows (tests/test_torch_train.py's
    three-step test, data-parallel).'''
    patched = {'local_bn': fastbn, 'local_rate': losses}.get(
        job.get('control'))
    if patched is None:
        return _steps(job, rank)
    real, patched.mesh_lib = patched.mesh_lib, _Local
    try:
        return _steps(job, rank)
    finally:
        patched.mesh_lib = real


def _steps(job, rank):
    ref = dict(np.load(job['ref']))
    config = job['config']
    opts = config['data_options']['train']
    eng = engine.Engine(config, device='cpu')
    ds = pipeline.TrainDataset('unused.tfrecords', **opts)
    eng._setup_training(ds)
    eng.model.load_state_dict(convert.torch_state_from_flax(
        {k[len('init/'):]: v for k, v in ref.items()
         if k.startswith('init/')}, expected=eng.model.state_dict()))
    bank = dict(flows=torch.from_numpy(ref['bank_flows']),
                stride=int(ref['bank_stride']),
                max_displacement=int(ref['bank_max_displacement']),
                out_size=tuple(int(v) for v in ref['bank_out_size']))
    lo, hi, _ = eng._rows or (0, None, None)
    got = []
    for s in range(ref['raw'].shape[0]):
        draws = [torch.from_numpy(ref['crop'][s]).long(),
                 torch.from_numpy(ref['flip'][s]),
                 torch.from_numpy(ref['contrast'][s]),
                 tuple(torch.from_numpy(ref[k][s]) for k in (
                     'bank_idx', 'bank_ud', 'bank_lr'))]
        mine = augment.take_rows(draws, lo, hi)
        eng._augment = lambda images, gen, d=mine: augment.apply_chain(
            ds.augment_methods, images, d, bank)
        raw = torch.from_numpy(ref['raw'][s][lo:hi])
        got.append(float(eng.train_step(raw, s, gen=None)))
    _save(job, rank, losses=np.asarray(got), **_state(eng))


def _zero_halo(buf, xt, *args):
    '''``mesh.unpack`` with the neighbours' rows replaced by zeros.'''
    return tuple(torch.zeros_like(t) for t in _unpack(buf, xt, *args))


_unpack = mesh.unpack


class _F64Augment:
    '''``data.augment`` for the engine, its features and labels in
    float64.'''

    def __getattr__(self, name):
        return getattr(augment, name)

    @staticmethod
    def to_feature_label(images, slice_types):
        return tuple(t.double() for t in augment.to_feature_label(
            images, slice_types))


_F64_AUGMENT = _F64Augment()


def train(job, rank):
    '''``Engine.train`` for ``max_steps`` steps on ``records``.'''
    config = job['config']
    eng = engine.Engine(config, seed=job.get('seed', 0),
                        device=job.get('device', 'cpu'))
    ds = pipeline.train_ds(job['records'], **config['data_options']['train'])
    kernels.reset_launches()
    if job.get('f64'):
        eng.build(ds.feature_shape)
        eng.model.double()
        engine.augment_mod = _F64_AUGMENT
    if job.get('control') == 'zero_halo':
        mesh.unpack = _zero_halo
    try:
        res = eng.train(ds, max_steps=job['max_steps'], save_freq=1 << 30)
    finally:
        mesh.unpack = _unpack
        engine.augment_mod = augment
    launches = {f'launches/{k}': v for k, v in kernels.launch_counts().items()}
    if job.get('f64'):   # by torch name, unrounded
        _save(job, rank, losses=np.asarray(res.history['loss']), **{
            f'{kind}/{name}': t.detach().double().numpy()
            for kind, items in (('grad', ((n, p.grad) for n, p in
                                          eng.model.named_parameters())),
                                ('stat', eng.model.named_buffers()))
            for name, t in items})
        return
    _save(job, rank, losses=np.asarray(res.history['loss']), **_state(eng),
          **_grads(eng), **launches)


def _grads(eng):
    '''The last step's gradients (summed over the ranks), 'grad/' + the
    flax path.'''
    return {f'grad/{k}': v for k, v in convert.flax_from_torch_state(
        {n: p.grad for n, p in eng.model.named_parameters()}).items()}


class _Guard:
    '''Records the writes of this process under ``root``.'''

    def __init__(self, root):
        self.root = os.path.realpath(root)
        self.writes = []

    def _under(self, path):
        try:
            path = os.path.realpath(os.fspath(path))
        except TypeError:   # a file descriptor
            return False
        return path == self.root or path.startswith(self.root + os.sep)

    def wrap(self, module, name, writes):
        real = getattr(module, name)

        def guarded(*args, **kwargs):
            if args and writes(*args, **kwargs) and self._under(args[0]):
                self.writes.append(f'{name} {args[0]}')
            return real(*args, **kwargs)
        setattr(module, name, guarded)

    def install(self):
        def opened_to_write(path, mode='r', *args, **kwargs):
            return any(c in kwargs.get('mode', mode) for c in 'wax+')
        self.wrap(builtins, 'open', opened_to_write)
        io.open = builtins.open
        for name in ('makedirs', 'mkdir', 'replace', 'rename', 'remove',
                     'unlink'):
            self.wrap(os, name, lambda *a, **k: True)
        self.wrap(shutil, 'rmtree', lambda *a, **k: True)


def cli_job(job, rank):
    guard = None
    if job.get('guard') and rank != 0:
        guard = _Guard(job['guard'])
        guard.install()
    res = cli(argv=job['argv'])
    out = {}
    if job['argv'][0] == 'train':
        out = dict(epoch=list(res.epoch), losses=res.history['loss'])
    if guard is not None:
        out['writes'] = guard.writes
    with open(f"{job['out']}.rank{rank}.json", 'w') as fh:
        json.dump(out, fh)


def sigterm(job, rank):
    '''tests/test_torch_train_options.py's SIGTERM test across ranks: the
    victim sends itself SIGTERM once the engine's handler is live.'''
    initial = signal.getsignal(signal.SIGTERM)

    def kill_when_handler_live(grace=1.0, timeout=120.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if signal.getsignal(signal.SIGTERM) is not initial:
                time.sleep(grace)   # let a few steps run first
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.05)

    killer = None
    if rank == job['victim']:
        killer = threading.Thread(target=kill_when_handler_live, daemon=True)
        killer.start()
    res = cli(argv=job['argv'])
    if killer is not None:
        killer.join(timeout=30)
        assert not killer.is_alive()
    with open(f"{job['out']}.rank{rank}.json", 'w') as fh:
        json.dump(dict(epoch=list(res.epoch)), fh)


JOBS = dict(steps=steps, train=train, cli=cli_job, sigterm=sigterm)


def main(spec_path):
    torch.set_num_threads(1)
    rank = int(os.environ['RANK'])
    with open(spec_path) as fh:
        spec = json.load(fh)
    multihost.maybe_initialize(spec['jobs'][0].get('device', 'cpu'),
                               backend='gloo')
    for job in spec['jobs']:
        JOBS[job['kind']](job, rank)


if __name__ == '__main__':
    main(sys.argv[1])
