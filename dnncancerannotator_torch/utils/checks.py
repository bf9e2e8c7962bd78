'''Runtime checks of the training data (counterpart of
dnncancerannotator_tpu.utils.checks), on with
``deploy_options.debug_asserts``.

The loss calls ``check_range`` and ``check_non_negative`` (labels within
[0, 1], the batch's positive rate within [0, 1], the loss weight
non-negative, the reference's ``tf.debugging`` asserts). They cost nothing
unless a ``collect()`` block is active: then each check records a device
vector ``[failed, min, max]`` and reads nothing back, so the engine can
read every step's checks with the chunk's one host read and ``raise_failed``
names the first check that failed and its step. In a data-parallel run
(parallel/mesh.py) ``span_ranks`` makes each vector the global batch's
before that read, a MAX over every rank (under ``spatial_partition`` each
rank checks its image rows).
'''

import contextlib

import torch

_ACTIVE = []


class CheckError(RuntimeError):
    '''A check of ``debug_asserts`` failed.'''


@contextlib.contextmanager
def collect(on=True):
    '''Within the block (when ``on``), the checks record into the list the
    block yields: (message, device vector [failed, min, max]) each.'''
    found = []
    if not on:
        yield found
        return
    _ACTIVE.append(found)
    try:
        yield found
    finally:
        _ACTIVE.pop()


def _record(x, lo, hi, message):
    # one pass over x: aminmax returns NaN for both ends when x holds a
    # NaN, and every comparison with NaN is false, so a NaN fails
    mn, mx = torch.aminmax(x.detach().reshape(-1).float())
    ok = mn >= lo if hi is None else (mn >= lo) & (mx <= hi)
    _ACTIVE[-1].append((message, torch.stack([(~ok).float(), mn, mx])))


def check_range(x, lo, hi, name):
    '''lo <= x <= hi elementwise (a NaN fails).'''
    if _ACTIVE:
        _record(x, lo, hi, f'{name} outside [{lo}, {hi}] (min={{}}, '
                'max={})')


def check_non_negative(x, name, device=None):
    '''x >= 0 elementwise (a NaN fails); a number x is put on ``device``
    by a fill, not a copy from the host.'''
    if _ACTIVE:
        if not torch.is_tensor(x):
            x = torch.full((), float(x), device=device)
        _record(x, 0, None, f'{name} is negative (min={{}}, max={{}})')


def span_ranks(group, values, flags=()):
    '''Every rank's check vectors ``values`` ([failed, min, max] each,
    concatenated, on the device) as the global batch's: failed where any
    rank's failed, the least min, the largest max; after them, each number
    of ``flags`` as its largest over the ranks. One all_reduce MAX; returns
    one device vector, the checks first, for the caller's one host read.'''
    signs = torch.tensor([1.0, -1.0, 1.0], device=values.device)
    packed = torch.cat([(values.view(-1, 3) * signs).view(-1),
                        torch.tensor([float(f) for f in flags],
                                     device=values.device)])
    packed = group.all_reduce_max(packed)
    n = values.numel()
    return torch.cat([(packed[:n].view(-1, 3) * signs).view(-1), packed[n:]])


def raise_failed(steps, values):
    '''Raise CheckError for the first failed check of the first step that
    has one. ``steps``: [(step, [message, ...])]; ``values``: the host
    floats of those steps' vectors, concatenated in the same order.'''
    at = 0
    for step, messages in steps:
        for message in messages:
            failed, lo, hi = values[at:at + 3]
            at += 3
            if failed:
                raise CheckError(f'debug_asserts: {message.format(lo, hi)} '
                                 f'at step {step}')
