'''Process groups: one process a card, on one host or several (counterpart
of dnncancerannotator_tpu.parallel.multihost).

- ``maybe_initialize``: with ``DNNCA_MULTIHOST=1`` in every worker's
  environment, join the group that a launcher describes there (torchrun:
  ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``), on one host or many;
- ``launch``: the ``train``, ``evaluate`` and ``predict`` runs go through
  it, and with ``deploy_options.enable_multigpu`` (default True) and more
  than one visible card it spawns one process a card in an NCCL group on a
  free localhost port, as the JAX package's single command uses every local
  device;
- ``is_primary``: the process that writes files (rank 0).

With ``deploy_options.spatial_partition`` N > 1, ``launch`` checks that the
world it runs in (the launcher's, the group's, or one process a card)
is a multiple of N (parallel/mesh.py: ``check_layout``) before any rank
starts work; one process with no group raises, as N ranks are needed.

The backend is an argument: NCCL for the card (the default), gloo for the
CPU. Nothing switches it by itself: NCCL refuses two ranks on one card, and
that raises here, while a caller that asks for gloo may put several ranks
on one card (a rank takes card ``LOCAL_RANK`` modulo the count).
'''

import logging
import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist

from . import mesh

logger = logging.getLogger(__name__)

ENV = 'DNNCA_MULTIHOST'


def init(backend, address, port, world_size, rank, local_rank,
         local_world_size=None, device='cuda'):
    '''Join the process group as ``rank`` of ``world_size`` at
    tcp://address:port with ``backend``; on a CUDA ``device`` make card
    ``local_rank`` (modulo the count under gloo) this process's current
    device first. NCCL with more local ranks than visible cards raises.'''
    if torch.device(device).type == 'cuda':
        count = torch.cuda.device_count()
        if backend == 'nccl' and max(local_rank + 1,
                                     local_world_size or 0) > count:
            raise RuntimeError(
                f'NCCL needs one card a rank: {local_world_size or "?"} '
                f'local ranks (this one {local_rank}) and {count} visible '
                'card(s); two NCCL ranks on one card are refused (the gloo '
                'backend may run several ranks on one card)')
        if count == 0:
            raise RuntimeError(f'device {device!r} requested but no CUDA '
                               'device is available')
        torch.cuda.set_device(local_rank % count)
    kwargs = {}
    if backend == 'nccl':
        kwargs['device_id'] = torch.device('cuda', local_rank)
    dist.init_process_group(backend, init_method=f'tcp://{address}:{port}',
                            world_size=world_size, rank=rank, **kwargs)
    logger.info('Joined the %s group: rank %d of %d (local rank %d)',
                backend, rank, world_size, local_rank)


def maybe_initialize(device='cuda', backend=None):
    '''With ``DNNCA_MULTIHOST=1``, join the group of the launcher's
    environment (once) with ``backend`` (default NCCL for a CUDA
    ``device``, gloo for the CPU); returns whether a group was joined
    now.'''
    if os.environ.get(ENV) != '1' or dist.is_initialized():
        return False
    env = os.environ
    backend = backend or ('nccl' if torch.device(device).type == 'cuda'
                          else 'gloo')
    init(backend, env['MASTER_ADDR'], env['MASTER_PORT'],
         int(env['WORLD_SIZE']), int(env['RANK']), int(env['LOCAL_RANK']),
         int(env['LOCAL_WORLD_SIZE']) if 'LOCAL_WORLD_SIZE' in env else None,
         device)
    return True


def is_primary():
    '''True on the process that writes checkpoints, logs and exports: rank
    0, or the only process.'''
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port():
    '''A TCP port on localhost that was free a moment ago.'''
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _spawned(rank, world_size, port, fn, args, out):
    logging.basicConfig(level=logging.INFO)
    init('nccl', 'localhost', port, world_size, rank, rank, world_size)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out, 'wb') as fh:
                pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def launch(fn, args, enable_multigpu=True, device='cuda', spatial=1):
    '''``fn(*args)`` on the cards that the configuration and the machine
    give, returning rank 0's result:
    - under ``DNNCA_MULTIHOST=1``: in this process, joined to the
      launcher's group, whatever the count of cards;
    - in a process that is in a group already: in this process;
    - with ``enable_multigpu``, ``device`` 'cuda' (no index) and more than
      one visible card: in one spawned process a card, an NCCL group of
      them; a worker's failure raises here (nothing falls back to one card
      or to the CPU);
    - else in this process, on one device, with no group.
    ``spatial`` (``spatial_partition``) must divide the world so chosen:
    else ValueError, naming both.'''
    spatial = int(spatial)
    maybe_initialize(device)
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == 'cuda' else 0
    if (dist.is_initialized() or not enable_multigpu or dev.index is not None
            or count < 2):
        mesh.check_spatial(enable_multigpu, spatial)
        return fn(*args)
    mesh.check_layout(count, spatial)
    import torch.multiprocessing as mp
    logger.info('Data parallel over %d cards: one process a card (NCCL)',
                count)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'result.pkl')
        mp.start_processes(_spawned, args=(count, free_port(), fn, args, out),
                           nprocs=count, start_method='spawn')
        with open(out, 'rb') as fh:
            return pickle.load(fh)
