'''Backward of the stride-1 stencil conv (ops/kernels/stencil_conv.py),
NCHW, in f32 or bf16.

The CUDA kernels (csrc/stencil_conv_bwd.cu) replace
conv_kernel.stencil_conv2d_bwd_pallas of the JAX package: from the
forward's input x, the cotangent g of its output and the weight they
return (dx or None, dw, db). When the forward fused a relu, the caller
masks g by the forward's output first (ops/functions.py), as
fastconv.py:200-201 does. ``route`` picks the kernels from the shape:

- ``pointwise`` (1 x 1, zero pads: the logits head): one launch a call.
  Blocks stage tiles of x and g, compute dx and per-block f64 partial sums
  of dw and db, and the last block to arrive (a ticket) adds the partials
  in block order. ``plan`` sizes the launch in pure Python from the shape
  alone (tile, tiles a block, blocks, slices, shared memory), so dw and db
  are the same bits on every card and call; the partials' scratch is kept
  per device and size, not allocated a call.
- ``stencil`` (any other shape), in one of two forms (``route``, a
  function of the shape): ``tile``, one launch a call on the pointwise
  route's pattern (blocks walk tiles of whole rows of one image, stage g
  with dx's halo and x with dw's, compute dx and per-block f64 partials of
  dw and db, a cluster of blocks adds its blocks' partials in shared
  memory, and the last cluster adds the clusters' partials in order;
  ``tile_plan`` sizes it from the shape alone, its scratch kept per device
  and size), wherever the tile and the partial fit a block's shared
  memory; else ``split``, the dgrad kernel, then the shared wgrad kernel
  (csrc/wgrad.cu) and its fixed-order partial sum: three launches.

``stencil_conv_bwd`` launches the kernels for CUDA tensors and runs
``plain`` (the data and weight gradients of ``F.conv2d`` on the padded
input) for CPU tensors; it raises on any other input.

bf16 form: x, g and w bf16 take the kernels' bf16 entries, which compute
from the exact upcast values in the f32 form's order and round dx, dw and
db to bf16, as fastconv.py:213 casts the Pallas backward's; ``plain`` does
the same on the CPU.
'''

import collections
import functools

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from . import _build, _wgrad
from . import stencil_conv as fwd
from .tconv2x2_bwd import cdiv, pad4, ticket

launches = 0  # kernel launches in this process
launches_bf16 = 0  # those of the bf16 form

# the pointwise kernel (csrc/stencil_conv_bwd.cu: pointwise_bwd_kernel)
THREADS = 256          # kPwThreads
CHUNK = 16             # block partials a finish unit adds (kChunk)
# pixels a tile: at the head (B=8) 2048 was the fastest of 256 to 4096
# (tools/profile_torch_sites.py --sweep-head on an H100: 0.0091 ms on the
# device, 0.0098 at 1024, 0.0094 at 4096)
MAX_TILE = 2048
STAGE_BYTES = 32768    # x and g planes of one tile in shared memory
# at most this many blocks (and partials for the last one to add); past
# it a block takes several tiles
MAX_BLOCKS = 1024

Plan = collections.namedtuple('Plan', 'tile chunks tiles per_block blocks '
                                      'slices smem')

# the stencil route's tile kernel (csrc/stencil_conv_bwd.cu:
# stencil_tile_bwd_kernel)
TILE_THREADS = 512     # kTileThreads
DX_THREADS = 128       # kDxThreads: dx, two pixels each; the rest, dw
KX = 3                 # taps of a kernel row a dw work unit sums (kKx)
# rows a tile: enough for two dx pixels a dx thread, fewer where the tile
# would pass this many bytes of shared memory
TILE_BYTES = 160 * 1024
# at most this many blocks; past it a block takes several tiles
MAX_TILE_BLOCKS = 128
# blocks a thread-block cluster: a cluster adds its blocks' partials in
# shared memory, so the last one adds one a cluster. At down_2's first
# conv (128 blocks of ~92 KB) clusters of 4 or 8 did not all fit the card
# at once and ran ~40% slower than clusters of 2 (tools/
# profile_torch_sites.py --sweep-stencil on an H100 80GB HBM3 at 700 W)
CLUSTER = 2

TilePlan = collections.namedtuple(
    'TilePlan', 'rows tiles_y tiles per_block blocks cluster units per_pass '
                'slices n2 smem')


def plain(x, g, w, pads, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw, db), in x's dtype
    (computed in f32 from bf16 inputs, then rounded).'''
    if x.dtype == torch.bfloat16:
        return tuple(None if t is None else t.to(x.dtype) for t in plain(
            *_build.upcast(x, g, w), pads, need_dx))
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x, (pl, pr, pt, pb))
    dw = nn_grad.conv2d_weight(xp, w.shape, g)
    dx = None
    if need_dx:
        h, wd = x.shape[2], x.shape[3]
        dx = nn_grad.conv2d_input(xp.shape, w, g)[:, :, pt:pt + h,
                                                  pl:pl + wd]
    return dx, dw, g.sum((0, 2, 3))


def _dgrad_smem_bytes(ci, co, kh, kw):
    return 4 * co * kh * kw * _wgrad.bucket(ci)


@functools.lru_cache(maxsize=None)
def supported(ci, co, kh, kw):
    return (fwd.supported(ci, co, kh, kw)
            and _dgrad_smem_bytes(ci, co, kh, kw) <= _build.MAX_SMEM_BYTES
            and _wgrad.fits(co, ci, kh, kw))


@functools.lru_cache(maxsize=None)
def plan(b, ci, co, h, w):
    '''The pointwise kernel's launch over B planes of H * W pixels, from
    the shape alone: tiles of whole float4 groups of one plane (as many
    pixels as STAGE_BYTES holds of the Ci + Co planes, at most MAX_TILE,
    at most the plane rounded up to 4), the tiles in order over the batch,
    consecutive runs of them a block so that at most MAX_BLOCKS partials
    remain, and the slices an item of a tile (the largest power of two
    that keeps the items x slices within a block's threads and a group a
    slice). The shared memory holds the staged planes, the weight, the
    warps' slice sums and the block's partial, and at least one row of the
    last block's chunk sums.'''
    p = h * w
    n = ci * co + co
    tile = min(MAX_TILE, STAGE_BYTES // (4 * (ci + co)) // 4 * 4, pad4(p))
    chunks = cdiv(p, tile)
    tiles = b * chunks
    per_block = cdiv(tiles, MAX_BLOCKS)
    blocks = cdiv(tiles, per_block)
    slices = 1
    while n * slices * 2 <= THREADS and slices * 2 <= tile // 4:
        slices *= 2
    smem = 4 * ((ci + co) * tile + pad4(ci * co)) + 8 * (THREADS // 32 + n)
    smem = max(smem, 8 * cdiv(blocks, CHUNK))
    return Plan(tile, chunks, tiles, per_block, blocks, slices, smem)


def units(ci, kh, kw):
    '''dw's work units: (input channel, kernel row, chunk of KX taps), then
    the bias.'''
    return ci * kh * cdiv(kw, KX) + 1


def _tile_layout(ci, co, h, w, kh, kw, pads, rows):
    '''(bytes of the tile's shared-memory layout, items n): the kernel's
    TileLayout. Weights [KH][KW][CO][CI], g with dx's halo
    as [pixel][CO], x with dw's halo as [Ci][rows][columns], the work
    units' f32 sums [KX][CO][slices][per_pass] (f32, to a whole 16 bytes),
    then the block's f64 partial of the n items.'''
    (pt, pb), (pl, pr) = pads
    oh, ow = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    cib, cob = _wgrad.bucket(ci), _wgrad.bucket(co)
    n = co * ci * kh * kw + co
    per_pass = min(units(ci, kh, kw), TILE_THREADS - DX_THREADS)
    slices = (TILE_THREADS - DX_THREADS) // per_pass
    g_lo, gc_lo = min(0, pt - kh + 1), min(0, pl - kw + 1)
    gr = rows + pt - g_lo
    gw = max(ow - 1, w - 1 + pl) - gc_lo + 1
    floats = (kh * kw * cob * cib + gr * gw * cob
              + ci * (rows + kh - 1) * (ow + kw - 1)
              + slices * per_pass * KX * cob)
    return 4 * pad4(floats) + 8 * n, n


@functools.lru_cache(maxsize=None)
def tile_plan(b, ci, co, h, w, kh, kw, pads, rows=None):
    '''The stencil route's one-launch kernel over B images, from the shape
    alone: tiles of ``rows`` whole rows of one image (input rows for dx,
    output rows for dw; as many as give each dx thread two pixels, fewer
    where the tile passes TILE_BYTES; or ``rows`` where given:
    tools/profile_torch_sites.py --sweep-stencil), the tiles in order over
    the batch, consecutive runs of them a block so that at most
    MAX_TILE_BLOCKS blocks remain, the blocks in clusters of at most
    CLUSTER (the grid padded to whole clusters with blocks of no tile), the
    work units of dw and db (``units``, ``per_pass`` of them a pass in
    ``slices`` slices of the tile's pixels),
    each cluster's partial of n2 doubles (the n items to a whole pair), and
    the shared memory: the tile's layout, and at least one item pair's
    chunk sums in the last cluster's finish.'''
    (pt, pb), (pl, pr) = pads
    oh = h + pt + pb - kh + 1
    span = max(h, oh)
    if rows is None:
        rows = min(span, cdiv(2 * DX_THREADS, w))
        while rows > 1 and _tile_layout(ci, co, h, w, kh, kw, pads,
                                        rows)[0] > TILE_BYTES:
            rows -= 1
    smem, n = _tile_layout(ci, co, h, w, kh, kw, pads, rows)
    tiles_y = cdiv(span, rows)
    tiles = b * tiles_y
    per_block = cdiv(tiles, MAX_TILE_BLOCKS)
    blocks = cdiv(tiles, per_block)
    cluster = min(CLUSTER, blocks)
    blocks = cdiv(blocks, cluster) * cluster
    n_units = units(ci, kh, kw)
    per_pass = min(n_units, TILE_THREADS - DX_THREADS)
    smem = max(smem, 16 * cdiv(blocks // cluster, CHUNK))
    return TilePlan(rows, tiles_y, tiles, per_block, blocks, cluster,
                    n_units, per_pass, (TILE_THREADS - DX_THREADS) // per_pass,
                    n + n % 2, smem)


@functools.lru_cache(maxsize=None)
def route(b, ci, co, h, w, kh, kw, pads):
    '''The backward's kernels for a shape: ``pointwise`` where the
    forward's route is (one launch), else ``tile`` where the tile plan's
    shared memory fits a block (one launch), else ``split`` (three).'''
    if fwd.route(ci, co, kh, kw, pads, h, w) == 'pointwise':
        return 'pointwise'
    if tile_plan(b, ci, co, h, w, kh, kw, pads).smem <= _build.MAX_SMEM_BYTES:
        return 'tile'
    return 'split'


_scratch = {}  # (device index, doubles) -> the partials' scratch


def scratch(device, doubles):
    '''The one-launch kernels' f64 partials (the pointwise route's
    [blocks][Ci Co + Co], the tile form's [clusters][n2]): one buffer a
    device and size, kept across calls (calls on one device run in stream
    order, so they never hold it at once).'''
    key = (device.index, doubles)
    if key not in _scratch:
        _scratch[key] = torch.empty(doubles, dtype=torch.float64,
                                    device=device)
    return _scratch[key]


def stencil_conv_bwd(x, g, w, pads, need_dx=True):
    '''Returns (dx or None, dw, db).'''
    global launches, launches_bf16
    pads = fwd._pads(pads)
    co, ci, kh, kw = w.shape
    oh, ow = fwd.out_hw(tuple(x.shape), tuple(w.shape), (co,), pads)
    if tuple(g.shape) != (x.shape[0], co, oh, ow):
        raise ValueError(f'g must be [B, Co, OH, OW] = '
                         f'{(x.shape[0], co, oh, ow)}, got {tuple(g.shape)}')
    if not supported(ci, co, kh, kw):
        raise ValueError(f'stencil_conv_bwd takes at most '
                         f'{fwd.MAX_CHANNELS} channels that fit shared '
                         f'memory; got Ci={ci} Co={co} kernel {kh}x{kw}')
    if x.device.type == 'cpu':
        return plain(x, g, w, pads, need_dx)
    entry, dtype = _build.form('dnnca_stencil_conv_bwd', x.dtype)
    device = _build.check_cuda(dtype, x=x, g=g, w=w)
    b, _, h, wd = x.shape
    f32 = dict(device=device, dtype=torch.float32)
    out = dict(device=device, dtype=dtype)
    dx = torch.empty_like(x) if need_dx else None
    dx_ptr = dx.data_ptr() if dx is not None else None
    stream = _build.stream_of(device)
    kind = route(b, ci, co, h, wd, kh, kw, pads)
    if kind == 'pointwise':
        pl = plan(b, ci, co, h, wd)
        align = 4 * x.element_size()  # four values a load
        vec = ((h * wd) % 4 == 0 and x.data_ptr() % align == 0
               and g.data_ptr() % align == 0)
        dw, db = torch.empty(w.shape, **out), torch.empty(co, **out)
        _build.launch(_build.form('dnnca_pointwise_conv_bwd', dtype)[0],
                      x.data_ptr(),
                      g.data_ptr(), w.data_ptr(), dx_ptr, dw.data_ptr(),
                      db.data_ptr(),
                      scratch(device, pl.blocks * (ci * co + co)).data_ptr(),
                      ticket(device).data_ptr(), b, ci, co, h * wd, pl.tile,
                      pl.per_block, pl.blocks, pl.slices, int(vec), pl.smem,
                      device.index, stream)
        if dtype == torch.bfloat16:
            launches_bf16 += 1
        else:
            launches += 1
        return dx, dw, db
    n_w = co * ci * kh * kw
    dwb = torch.empty(n_w + co, **out)
    if kind == 'tile':
        pl = tile_plan(b, ci, co, h, wd, kh, kw, pads)
        align = 4 * x.element_size()  # four values a load
        vec = (ow % 4 == 0 and wd % 4 == 0 and x.data_ptr() % align == 0
               and g.data_ptr() % align == 0)
        _build.launch(_build.form('dnnca_stencil_conv_bwd_tile', dtype)[0],
                      x.data_ptr(), g.data_ptr(), w.data_ptr(), dx_ptr,
                      dwb.data_ptr(),
                      scratch(device,
                              pl.blocks // pl.cluster * pl.n2).data_ptr(),
                      ticket(device).data_ptr(), b, ci, co, h, wd, kh, kw,
                      pads[0][0], pads[1][0], oh, ow, pl.rows, pl.per_block,
                      pl.blocks, pl.cluster, int(vec), pl.smem, device.index,
                      stream)
    else:
        blocks = _wgrad.blocks(b, oh, ow)
        partial = torch.empty((n_w + co) * blocks, **f32)
        _build.launch(entry, x.data_ptr(), g.data_ptr(),
                      w.data_ptr(), dx_ptr, dwb.data_ptr(),
                      partial.data_ptr(), b, ci, co, h, wd, kh, kw,
                      pads[0][0], pads[1][0], oh, ow, blocks, device.index,
                      stream)
    if dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return dx, dwb[:n_w].view(co, ci, kh, kw), dwb[n_w:]
