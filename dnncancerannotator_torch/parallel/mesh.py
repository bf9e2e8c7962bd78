'''Data parallelism and spatial partitioning over processes, one a card
(counterpart of dnncancerannotator_tpu.parallel.mesh).

The JAX package shards every batch over the ``data`` axis of a ``(data,
model)`` device mesh, and with ``deploy_options.spatial_partition: N`` the
image rows (H) of every batch over its ``model`` axis of N devices; GSPMD
inserts the reductions over the batch and the convs' halo exchanges. Here
each process (a rank) holds a replica of the model on its own card, and
the reductions and the exchanges are explicit collectives of
``torch.distributed``, so a run gives the numbers of one device running the
whole batch, up to the order of a sum.

Layout (JAX parallel/mesh.py:96-106): a world of W ranks at
``spatial_partition`` N has W / N data groups; rank r is in data group
r // N with model index r % N. A data group takes its rows of every global
batch (``Group.shard_rows``, ``shard_batch``), and its N ranks split the
image rows of those: the H rows in blocks of 2^levels rows (the model's
``row_block``: every pool and transposed conv stays on its rank), spread as
evenly as ``shard_rows`` spreads batch rows (``split_rows``). Each model
group has its own process group (``dist.new_group``) for its halos.

- the gradient: a rank's loss is its pixels' share of the global mean, and
  the gradients are summed over every rank (``Engine.train_step``);
- the auto positive rate of the loss (train/losses.py) and BatchNorm's
  statistics and backward sums (models/fastbn.py) sum over every rank,
  each rank's count its batch rows x its image rows x the width;
- a SAME conv of radius r runs on its rank's slab, the rows [lo, hi) plus
  up to r rows of each neighbour (``on_slab``: never past the plane's
  edge, where the kernel's own padding is the right one), and keeps
  [lo, hi); the exchange is an autograd Function whose backward is its
  transpose (each halo row's gradient added on its owner), over a pure
  function of this rank's rows and the neighbours' (``slab``);
- evaluation pads a batch to a multiple of the data groups
  (``shard_batch``) and gathers each rank's outputs (``Group.gather``),
  image rows included, to whole planes.

``Group`` is an Engine's group over the default process group (``group``).
The Engine announces a ``Shard`` of it, the batch rows and image rows this
rank holds, for the span of its train and eval steps (``active``), and the
model and the loss read it (``current``), as the JAX engine announces its
mesh to the kernels (``pallas_spmd``). Without a process group there is no
Group and no Shard, every helper below is the identity, and the callers
keep their one-device arithmetic. Every collective here is a broadcast or
an ``all_reduce``, which NCCL and gloo (also on CUDA tensors) both carry:
an exchange or a gather writes each rank's rows into a zeroed buffer and
sums the buffers. Nothing is reduced over the data axis alone (every
reduction spans the world), so no data-axis group is built.
'''

import contextlib
import threading

import torch
import torch.distributed as dist

_TLS = threading.local()


def check_layout(world, spatial):
    '''Raise ValueError unless ``spatial`` (>= 1) divides a world of
    ``world`` ranks (JAX parallel/mesh.py:104).'''
    if spatial < 1 or world % spatial:
        raise ValueError(f'spatial_partition {spatial} does not divide the '
                         f'world of {world} rank(s)')


def split_rows(h, block, n):
    '''The boundaries (b_0 = 0, ..., b_n = h) of ``h`` image rows over
    ``n`` ranks in blocks of ``block`` rows: rank m holds [b_m, b_m+1),
    floor(m k / n) blocks from the top of k = h / block (256 rows in blocks
    of 8 over 3 ranks: 10, 11 and 11 blocks). Raises ValueError when h is
    not a multiple of the block or there are fewer blocks than ranks.'''
    if h % block:
        raise ValueError(f'spatial_partition: {h} image rows are not a '
                         f'multiple of the model\'s {block}-row block')
    blocks = h // block
    if blocks < n:
        raise ValueError(f'spatial_partition: {h} image rows make {blocks} '
                         f'block(s) of {block} rows, fewer than the {n} '
                         'ranks of a model group')
    return tuple(m * blocks // n * block for m in range(n + 1))


class Group:
    '''The group of this process: ``world`` ranks, this one ``rank``, over
    the default process group, in data groups of ``spatial`` ranks that
    split their image rows (``spatial`` 1: data parallelism alone).'''

    spatial = 1
    model_group = None   # the process group of this rank's model group

    def __init__(self, spatial=1):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        check_layout(self.world, spatial)
        self.spatial = spatial
        if spatial > 1:
            # every rank takes part in building every group
            for g in range(self.world // spatial):
                handle = dist.new_group(list(range(g * spatial,
                                                   (g + 1) * spatial)))
                if g == self.part:
                    self.model_group = handle

    @property
    def parts(self):
        '''The number of data groups.'''
        return self.world // self.spatial

    @property
    def part(self):
        '''This rank's data group.'''
        return self.rank // self.spatial

    @property
    def model_rank(self):
        '''This rank's index in its model group.'''
        return self.rank % self.spatial

    def shard_rows(self, b):
        '''This data group's rows [lo, hi) of a global batch of ``b`` rows:
        [floor(part b / parts), floor((part + 1) b / parts)); they differ by
        at most one row between groups when ``b % parts != 0``.'''
        if b < self.parts:
            raise ValueError(f'a batch of {b} rows over {self.parts} data '
                             'groups leaves a rank without rows')
        return self.part * b // self.parts, (self.part + 1) * b // self.parts

    def shard_batch(self, batch, pad_to=None):
        '''This data group's rows of ``batch`` (a tensor or an array, rows
        first) and how many of them are real: the batch padded to
        ``pad_to`` rows (at least its own) and then to a multiple of the
        data groups, both by repeating its last row (JAX
        parallel/mesh.py:shard_batch), then split into equal parts. Returns
        (rows, n_valid); the real rows come first.'''
        n = batch.shape[0]
        target = max(pad_to or n, n)
        target += (-target) % self.parts
        per = target // self.parts
        lo = self.part * per
        if lo + per > n:
            take = torch.arange(lo, lo + per).clamp(max=n - 1)
            if torch.is_tensor(batch):
                rows = batch[take.to(batch.device)]
            else:
                rows = batch[take.numpy()]
        else:
            rows = batch[lo:lo + per]
        return rows, max(min(n - lo, per), 0)

    def all_reduce_sum(self, t, group=None):
        '''Sum ``t`` over the ranks (of ``group``, default every rank), in
        place; returns ``t``.'''
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_reduce_max(self, t):
        '''Elementwise maximum of ``t`` over the ranks, in place.'''
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def gather(self, rows, start, total, image=None, group=None):
        '''The [total, ...] tensor that holds every rank's ``rows`` at its
        ``start``, on every rank: each rank writes its rows into a zeroed
        buffer and the buffers are summed (an all_reduce, which gloo also
        carries on CUDA tensors where it has no all_gather), over every
        rank or over ``group``. With ``image`` (lo, hi, h) the rows hold
        image rows [lo, hi) of planes of h rows (axis 1), and the planes
        come back whole. Ranks that write the same place are summed.'''
        shape = [total] + list(rows.shape[1:])
        if image is not None:
            lo, hi, shape[1] = image
        out = rows.new_zeros(shape)
        if image is None:
            out[start:start + rows.shape[0]] = rows
        else:
            out[start:start + rows.shape[0], lo:hi] = rows
        return self.all_reduce_sum(out, group)

    def broadcast_(self, tensors):
        '''Overwrite each tensor with rank 0's, in place.'''
        for t in tensors:
            dist.broadcast(t, src=0)

    def barrier(self, device):
        '''Return once every rank has reached this call (an all_reduce of
        one element on ``device``, read back).'''
        self.all_reduce_sum(torch.zeros(1, device=device)).item()


def _grouped(enable):
    return bool(enable) and dist.is_available() and dist.is_initialized()


def check_spatial(enable, spatial):
    '''Raise ValueError unless ``spatial`` ranks can split the image rows:
    ``spatial`` 1, or ``enable`` (``deploy_options.enable_multigpu``) and a
    process group whose world it divides. Nothing falls back to one
    rank.'''
    if spatial == 1:
        return
    if not _grouped(enable):
        raise ValueError(
            f'spatial_partition {spatial} needs deploy_options.'
            f'enable_multigpu (here {bool(enable)}) and a process group of '
            f'a multiple of {spatial} ranks (here none: one process)')
    check_layout(dist.get_world_size(), spatial)


def group(enable=True, spatial=1):
    '''The Group over the default process group when ``enable`` and
    torch.distributed is initialized (at any world size, 1 included), else
    None; ``spatial`` as ``check_spatial`` allows it.'''
    check_spatial(enable, spatial)
    return Group(spatial) if _grouped(enable) else None


class Shard:
    '''The rows of one global batch that this rank holds in a step: the
    first ``valid`` of its batch rows are real (the rest repeat the batch's
    last row), of ``total`` real rows over all data groups; with
    ``bounds`` (``split_rows`` of the whole plane) it holds image rows
    [bounds[m], bounds[m + 1]) of them, m its model index.'''

    def __init__(self, group, valid, total, bounds=None):
        self.group = group
        self.valid = valid
        self.total = total
        self.bounds = bounds if bounds and len(bounds) > 2 else None

    @property
    def spatial(self):
        '''Whether the image rows are split (over more than one rank).'''
        return self.bounds is not None

    @property
    def rows(self):
        '''This rank's image rows (lo, hi, h) at full resolution.'''
        m = self.group.model_rank
        return self.bounds[m], self.bounds[m + 1], self.bounds[-1]

    def level(self, h):
        '''(bounds, m) at the resolution where this rank holds ``h``
        rows: every boundary divided by the scale, m the model index.'''
        lo, hi, _ = self.rows
        scale = (hi - lo) // h
        if scale * h != hi - lo or any(b % scale for b in self.bounds):
            raise ValueError(f'spatial_partition: {h} rows at a level of '
                             f'rows [{lo}, {hi}) do not follow the split '
                             f'{self.bounds}')
        return tuple(b // scale for b in self.bounds), self.group.model_rank

    def plane(self, h):
        '''The whole plane's rows at the level where this rank holds
        ``h`` rows (``h`` without a split).'''
        return self.level(h)[0][-1] if self.spatial else h

    def share(self):
        '''This rank's share of the global batch's pixels: its real batch
        rows over ``total``, times its image rows over the plane's (1.0 at
        one rank).'''
        share = self.valid / self.total
        if self.spatial:
            lo, hi, h = self.rows
            share = share * (hi - lo) / h
        return share

    def take(self, t):
        '''This rank's image rows (axis 1) of a tensor of whole planes.'''
        if not self.spatial:
            return t
        lo, hi, _ = self.rows
        return t[:, lo:hi]


def halo(bounds, m, up, down):
    '''The rows [a, lo) above and [hi, b) below rank m's rows [lo, hi)
    that its slab of ``up`` rows above and ``down`` below takes, clipped to
    the plane [0, bounds[-1]).'''
    lo, hi = bounds[m], bounds[m + 1]
    return (max(lo - up, 0), lo), (hi, min(hi + down, bounds[-1]))


def slab(rows, above, below, axis):
    '''A rank's slab: its ``rows`` with the neighbours' rows ``above``
    and ``below`` it, along ``axis``.'''
    return torch.cat([above, rows, below], axis)


def _slots(bounds, up, down):
    '''The exchange buffer's slots: for each boundary k (between ranks
    k - 1 and k), the rows that ``halo`` gives rank k above it, at slot
    rows [up - len, up), and those it gives rank k - 1 below it, at slot
    rows [up, up + len); as (slot k - 1, its first slot row, global rows
    [a, b)).'''
    out = []
    for k in range(1, len(bounds) - 1):
        (a, lo), _ = halo(bounds, k, up, down)
        out.append((k - 1, up - (lo - a), a, lo))
        _, (hi, b) = halo(bounds, k - 1, up, down)
        out.append((k - 1, up, hi, b))
    return out


def _zeros(t, bounds, up, down):
    # in f32 at least: gloo's sums take no bf16, and a sum of one value
    # and zeros is exact
    return t.new_zeros((len(bounds) - 2, up + down) + tuple(t.shape[1:]),
                       dtype=torch.promote_types(t.dtype, torch.float32))


def pack(xt, bounds, m, up, down):
    '''Rank m's part of the exchange buffer [n - 1, up + down, ...]: the
    rows it owns (``xt``, rows first) of every slot, zeros elsewhere. The
    sum of every rank's part is what ``unpack`` reads.'''
    lo, hi = bounds[m], bounds[m + 1]
    buf = _zeros(xt, bounds, up, down)
    for slot, at, a, b in _slots(bounds, up, down):
        s, e = max(a, lo), min(b, hi)
        if s < e:
            buf[slot, at + s - a:at + e - a] = xt[s - lo:e - lo]
    return buf


def unpack(buf, xt, bounds, m, up, down):
    '''The rows above and below rank m's rows in its slab (rows first,
    in xt's dtype), from the summed buffer.'''
    lo, hi = bounds[m], bounds[m + 1]
    (a, _), (_, b) = halo(bounds, m, up, down)
    above = buf[m - 1, up - (lo - a):up] if lo > a else xt[:0]
    below = buf[m, up:up + b - hi] if b > hi else xt[:0]
    return above.to(xt.dtype), below.to(xt.dtype)


def pack_t(gt, bounds, m, up, down):
    '''The transpose of ``unpack``: rank m's slab gradient's halo rows
    (``gt``, rows first) into the slots they were read from.'''
    lo, hi = bounds[m], bounds[m + 1]
    (a, _), (_, b) = halo(bounds, m, up, down)
    buf = _zeros(gt, bounds, up, down)
    if lo > a:
        buf[m - 1, up - (lo - a):up] = gt[:lo - a]
    if b > hi:
        buf[m, up:up + b - hi] = gt[gt.shape[0] - (b - hi):]
    return buf


def unpack_t(buf, gt, bounds, m, up, down):
    '''The transpose of ``pack``: the gradient of rank m's rows, its
    slab's middle plus, from the summed buffer, every halo row's gradient
    that the other ranks sent back to it.'''
    lo, hi = bounds[m], bounds[m + 1]
    (a, _), _ = halo(bounds, m, up, down)
    g = gt[lo - a:lo - a + hi - lo].clone()
    for slot, at, sa, sb in _slots(bounds, up, down):
        s, e = max(sa, lo), min(sb, hi)
        if s < e:
            g[s - lo:e - lo] += buf[slot, at + s - sa:at + e - sa].to(g.dtype)
    return g


class _Halo(torch.autograd.Function):
    '''x (this rank's rows along ``axis``) -> its slab; the backward adds
    the slab's halo rows' gradients to their owners' rows. The buffers are
    summed over the model group.'''

    @staticmethod
    def forward(ctx, x, shard, axis, up, down):
        bounds, m = shard.level(x.shape[axis])
        # the backward may run on another thread: it keeps the step's shard
        ctx.args = bounds, m, up, down
        ctx.group, ctx.axis = shard.group, axis
        xt = x.movedim(axis, 0)
        buf = ctx.group.all_reduce_sum(pack(xt, *ctx.args),
                                       ctx.group.model_group)
        above, below = unpack(buf, xt, *ctx.args)
        return slab(x, above.movedim(0, axis), below.movedim(0, axis), axis)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.axis, 0)
        buf = ctx.group.all_reduce_sum(pack_t(gt, *ctx.args),
                                       ctx.group.model_group)
        return (unpack_t(buf, gt, *ctx.args).movedim(0, ctx.axis), None,
                None, None, None)


def on_slab(fn, xs, up, down, axis):
    '''``fn(*slabs)`` of the tensors ``xs`` (the same rows along
    ``axis``), cut back to this rank's rows: inside a spatial step each
    tensor takes ``up`` rows of the ranks above it and ``down`` of those
    below (never past the plane's edge), so a SAME conv (or chain) whose
    output keeps its input's rows gives this rank's rows of the whole
    plane's output (a contiguous tensor); else ``fn(*xs)``.'''
    shard = current()
    if shard is None or not shard.spatial or not up + down:
        return fn(*xs)
    h = xs[0].shape[axis]
    bounds, m = shard.level(h)
    (a, lo), _ = halo(bounds, m, up, down)
    out = fn(*(_Halo.apply(x, shard, axis, up, down) for x in xs))
    # contiguous, as the kernels that read it next take their inputs
    return out.narrow(axis, lo - a, h).contiguous()


def check_whole(what):
    '''Inside a spatial step, raise ValueError: ``what`` needs whole
    planes.'''
    shard = current()
    if shard is not None and shard.spatial:
        raise ValueError(f'spatial_partition: {what} needs whole planes '
                         f'(split {shard.bounds})')


def check_even(h, rate):
    '''Inside a spatial step, raise ValueError unless a pool of ``rate``
    rows keeps to this rank's ``h`` rows.'''
    shard = current()
    if shard is not None and shard.spatial and h % rate:
        raise ValueError(f'spatial_partition: a pool of {rate} rows over a '
                         f'rank\'s {h} rows (split {shard.bounds})')


def check_aligned(h, block):
    '''Inside a spatial step, raise ValueError unless the model's input of
    ``h`` rows is this rank's rows and every boundary of the split lies on
    the model's ``block``.'''
    shard = current()
    if shard is None or not shard.spatial:
        return
    lo, hi, _ = shard.rows
    if h != hi - lo or any(b % block for b in shard.bounds):
        raise ValueError(f'spatial_partition: the model takes {h} rows of '
                         f'the split {shard.bounds}, whose boundaries must '
                         f'lie on its {block}-row block')


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
