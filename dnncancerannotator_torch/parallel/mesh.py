'''Data parallelism over processes, one a card (counterpart of
dnncancerannotator_tpu.parallel.mesh).

The JAX package shards every batch over the ``data`` axis of a device mesh
and GSPMD inserts the reductions over the batch. Here each process (a rank)
holds a replica of the model on its own card and takes its rows of every
global batch; the reductions over the batch are explicit collectives of
``torch.distributed``, so a run gives the numbers of one device running the
whole batch, up to the order of a sum:
- the gradient: a rank's loss is its rows' share of the global mean, and
  the gradients are summed over the ranks (``Engine.train_step``);
- the auto positive rate of the loss (train/losses.py) and BatchNorm's
  statistics and backward sums (models/fastbn.py) sum over the ranks;
- evaluation pads a batch to a multiple of the ranks (``shard_batch``) and
  gathers each rank's outputs (``Group.gather``).

``Group`` is an Engine's data-parallel group over the default process group
(``group``). The Engine announces a ``Shard`` of it, the rows this rank
holds, for the span of its train and eval steps (``active``), and the model
and the loss read it (``current``), as the JAX engine announces its mesh to
the kernels (``pallas_spmd``). Without a process group there is no Group
and no Shard, every helper below is the identity, and the callers keep
their one-device arithmetic. Every collective here is a broadcast or an
``all_reduce``, which NCCL and gloo (also on CUDA tensors) both carry.
'''

import contextlib
import threading

import torch
import torch.distributed as dist

_TLS = threading.local()


class Group:
    '''The data-parallel group of this process: ``world`` ranks, this one
    ``rank``, over the default process group.'''

    def __init__(self):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()

    def shard_rows(self, b):
        '''This rank's rows [lo, hi) of a global batch of ``b`` rows:
        [floor(rank b / world), floor((rank + 1) b / world)); they differ by
        at most one row between ranks when ``b % world != 0``.'''
        if b < self.world:
            raise ValueError(f'a batch of {b} rows over {self.world} ranks '
                             'leaves a rank without rows')
        return self.rank * b // self.world, (self.rank + 1) * b // self.world

    def shard_batch(self, batch, pad_to=None):
        '''This rank's rows of ``batch`` (a tensor or an array, rows first)
        and how many of them are real: the batch padded to ``pad_to`` rows
        (at least its own) and then to a multiple of the ranks, both by
        repeating its last row (JAX parallel/mesh.py:shard_batch), then
        split into equal parts. Returns (rows, n_valid); the real rows come
        first.'''
        n = batch.shape[0]
        target = max(pad_to or n, n)
        target += (-target) % self.world
        per = target // self.world
        lo = self.rank * per
        if lo + per > n:
            take = torch.arange(lo, lo + per).clamp(max=n - 1)
            if torch.is_tensor(batch):
                rows = batch[take.to(batch.device)]
            else:
                rows = batch[take.numpy()]
        else:
            rows = batch[lo:lo + per]
        return rows, max(min(n - lo, per), 0)

    def all_reduce_sum(self, t):
        '''Sum ``t`` over the ranks, in place; returns ``t``.'''
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def all_reduce_max(self, t):
        '''Elementwise maximum of ``t`` over the ranks, in place.'''
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def gather(self, rows, start, total):
        '''The [total, ...] tensor that holds every rank's ``rows`` at its
        ``start``, on every rank: each rank writes its rows into a zeroed
        buffer and the buffers are summed (an all_reduce, which gloo also
        carries on CUDA tensors where it has no all_gather).'''
        out = rows.new_zeros((total,) + tuple(rows.shape[1:]))
        out[start:start + rows.shape[0]] = rows
        return self.all_reduce_sum(out)

    def broadcast_(self, tensors):
        '''Overwrite each tensor with rank 0's, in place.'''
        for t in tensors:
            dist.broadcast(t, src=0)

    def barrier(self, device):
        '''Return once every rank has reached this call (an all_reduce of
        one element on ``device``, read back).'''
        self.all_reduce_sum(torch.zeros(1, device=device)).item()


def group(enable=True):
    '''The data-parallel Group over the default process group when
    ``enable`` and torch.distributed is initialized (at any world size,
    1 included), else None.'''
    if enable and dist.is_available() and dist.is_initialized():
        return Group()
    return None


class Shard:
    '''The rows of one global batch that this rank holds in a step: the
    first ``valid`` of its rows are real (the rest repeat the batch's last
    row), of ``total`` real rows over all ranks.'''

    def __init__(self, group, valid, total):
        self.group = group
        self.valid = valid
        self.total = total


@contextlib.contextmanager
def active(shard):
    '''Within the block (on this thread) ``current()`` is ``shard``
    (None: no data parallelism).'''
    prev = getattr(_TLS, 'shard', None)
    _TLS.shard = shard
    try:
        yield
    finally:
        _TLS.shard = prev


def current():
    '''The Shard of the step running on this thread, or None.'''
    return getattr(_TLS, 'shard', None)
