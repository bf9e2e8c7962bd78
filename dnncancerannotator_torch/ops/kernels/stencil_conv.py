'''Stride-1 conv with explicit pads, bias and an optional fused relu, NCHW
f32, small channels.

The CUDA kernels (csrc/stencil_conv.cu) replace
conv_kernel.stencil_conv2d_pallas of the JAX package. The weight is in
PyTorch OIHW layout [Co, Ci, KH, KW]; ``pads`` is ((top, bottom),
(left, right)) as in the JAX package. ``route`` picks one of three
kernels from the shape alone:

- ``pointwise`` for a 1 x 1 conv with zero pads (the logits head: a
  float4 stream of Ci reads and Co writes a pixel);
- ``tile`` for any other shape whose tile fits a block's shared memory:
  every conv that runs alone on the model's paths. Under unet.yaml +
  leakyReLU.yaml no chain fuses (a chain fuses relu only), so the nine
  convs of kh * kw * Ci * Co <= 1024 come here each forward (3 x 3, 3-12
  channels, at 256, 128 and 64 pixels a side); under bf16.yaml the split
  down_2 chain's first conv. ``plan`` sizes the tile in pure Python: the
  channel group, pixels a work item, rows a tile, threads, the staged
  rows' layout and its shared memory (reckoned in f32 for both forms, so
  the f32 and bf16 forms take the same route and the same plan);
- ``stencil`` (direct: one thread an output pixel) only where the tile
  cannot fit, a staged row with its halo or the weights too large for a
  block.

``stencil_conv`` launches the kernel for CUDA tensors and runs ``plain``
(``F.conv2d`` on the padded input) for CPU tensors; it raises on any other
input.

bf16 form: x, w and b bf16 (the JAX stencil conv takes bf16, upcasts and
computes in f32; its caller rounds, fastconv.py:182) take the kernels' bf16
entries, which compute from the exact upcast values in the f32 form's
order and round the output to bf16; ``plain`` does the same on the CPU.
'''

import collections
import functools

import torch
import torch.nn.functional as F

from . import _build
# a row stride of at least n floats, 4 mod 8: the float4 window reads of
# the lanes on a pair of rows hit distinct banks
from .conv_chain import cdiv, pad4, stride

MAX_CHANNELS = 32
# conv_kernel.supported: kh * kw * Ci * Co terms unrolled a program
MAX_TERMS = 1024
# the pointwise kernel's offsets inside one batch item are 32-bit
MAX_PLANE_FLOATS = 2**31 - 1
# past this many bytes a call (the H100's 50 MB of L2) the pointwise
# kernel streams its loads (evict-first)
L2_BYTES = 50 * 2**20

# the tile kernel (csrc/stencil_conv.cu: stencil_tile_kernel)
THREADS = 256                   # kTileThreads
SMS = 132                       # streaming multiprocessors of an H100
# a tile's rows: as many as give each of THREADS threads one work item, up
# to MAX_ROWS and TILE_BYTES of shared memory (three tiles an SM). On an
# H100 80GB HBM3 at 700 W (tools/profile_torch_sites.py --sweep-stencil)
# blocks of 256 threads ran fastest at every site: at down_2.conv_0, B=8,
# four rows a block (128 blocks) took 0.0055 ms where one row (512 blocks,
# two or more an SM) took 0.0072
TILE_BYTES = 72 * 1024
MAX_ROWS = 16
# the work item: the most sums a thread (at most 24, the forms that keep
# to 64 registers) that leaves this many warps an SM over the call
MIN_WARPS = 6
MAX_SUMS = 24
# two lanes an item (the input channels split in halves) where the items
# leave fewer warps an SM than this
SPLIT_WARPS = 12
# (output channels, pixels) of a work item the kernel is built for
TILES = ((3, 4), (3, 8), (4, 4), (4, 8), (6, 4), (6, 8), (8, 4), (12, 4))
EXACT_CPT = (3, 6, 12)

Plan = collections.namedtuple(
    'Plan', 'cpt px ri ks rows tiles_y blocks threads cols xs_w smem')

launches = 0  # kernel launches in this process
launches_bf16 = 0  # those of the bf16 form
launches_tile = 0  # of ``launches``, those of the tile route
launches_tile_bf16 = 0  # of ``launches_bf16``, those of the tile route


def plain(x, w, b, pads, relu=False):
    '''Plain PyTorch version, in x's dtype (computed in f32 from bf16
    inputs, then rounded).'''
    dtype = x.dtype
    x, w, b = _build.upcast(x, w, b)
    (pt, pb), (pl, pr) = pads
    out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b)
    return (F.relu(out) if relu else out).to(dtype)


def _smem_bytes(ci, co, kh, kw):
    '''Weights and bias, padded to the kernel's Co bucket
    (csrc/stencil_conv.cu).'''
    width = next(b for b in (1, 4, 8, 16, 32) if co <= b)
    return 4 * (ci * kh * kw + 1) * width


@functools.lru_cache(maxsize=None)
def supported(ci, co, kh, kw):
    return (max(ci, co) <= MAX_CHANNELS
            and _smem_bytes(ci, co, kh, kw) <= _build.MAX_SMEM_BYTES)


def eligible(ci, co, kh, kw):
    '''Whether a stride-1 NCHW conv of Ci -> Co channels with a kh x kw
    kernel routes to this kernel: the JAX package's ``small`` conv that
    reaches ``stencil_conv2d_pallas`` (conv_kernel.supported's unroll
    bound, kh * kw * Ci * Co <= MAX_TERMS; its VMEM bound is a TPU limit
    and is not kept), where the kernel and its backward take it.'''
    from . import stencil_conv_bwd
    return (kh * kw * ci * co <= MAX_TERMS
            and stencil_conv_bwd.supported(ci, co, kh, kw))


def tile_groups(co):
    '''The channel groups the tile takes for Co outputs: the exact ones
    that divide Co (3, 6 or 12; every site of the model), else 4 and 8
    with the last group padded.'''
    exact = tuple(c for c in EXACT_CPT if co % c == 0)
    return exact or (4, 8)


def _items(b, co, oh, ow, item):
    '''Warps of one work item a lane over a call, an SM.'''
    cpt, px = item
    return b * oh * cdiv(ow, px) * cdiv(co, cpt) / (32 * SMS)


def _widest(choices, warps, tie):
    '''Of ``choices``, the most sums a thread (the fewest shared-memory
    reads a FMA) that leaves MIN_WARPS warps an SM (``warps`` of an item),
    ties to ``tie``; where none does, the most warps.'''
    full = [t for t in choices if warps(t) >= MIN_WARPS]
    if full:
        return max(full, key=lambda t: (t[0] * t[1], tie(t)))
    return max(choices, key=lambda t: (warps(t), tie(t)))


def tile_item(b, co, oh, ow):
    '''(CPT, PX) of a work item, one lane an item: of the kernel's TILES
    of at most MAX_SUMS sums at a group Co takes, ``_widest``; ties go to
    the wider channel group (6 x 4 ran 2-15% faster than 3 x 8 at
    unet.yaml's 128 x 128 sites at B=64 on an H100).'''
    choices = [t for t in TILES
               if t[0] in tile_groups(co) and t[0] * t[1] <= MAX_SUMS]
    return _widest(choices, lambda t: _items(b, co, oh, ow, t),
                   lambda t: t[0])


def tile_rule(b, ci, co, oh, ow):
    '''(CPT, PX, KS): ``tile_item`` with one lane an item, unless its
    items leave fewer than SPLIT_WARPS warps an SM and each half of the
    input channels has two or more: then two lanes an item and the widest
    item their warps allow, ties to runs of 8 (3 x 8 with two lanes ran
    4-8% faster than 6 x 4 at unet.yaml's 128 x 128 and 64 x 64 sites at
    B=8, on an H100: tools/profile_torch_sites.py --sweep-stencil).'''
    base = tile_item(b, co, oh, ow)
    if ci < 4 or _items(b, co, oh, ow, base) >= SPLIT_WARPS:
        return (*base, 1)
    choices = [t for t in TILES
               if t[0] in tile_groups(co) and t[0] * t[1] <= MAX_SUMS]
    item = _widest(choices, lambda t: 2 * _items(b, co, oh, ow, t),
                   lambda t: t[1])
    return (*item, 2)


def tile_cols(ow, px, kw):
    '''Staged columns a row: every tap of the runs, and the last run's
    window read as whole float4s where the kernel holds a 3-wide row's
    window in registers.'''
    runs = cdiv(ow, px)
    cols = runs * px + kw - 1
    if kw == 3:
        cols = max(cols, (runs - 1) * px + 4 * cdiv(px + kw - 1, 4))
    return cols


def _tile_smem(ci, co, kh, kw, cpt, rows, xs_w):
    '''Bytes of the tile's shared memory, f32 in both forms: the weights
    and bias in group slots, the staged input rows.'''
    w_row = cdiv(co, cpt) * pad4(cpt)
    return 4 * (ci * kh * kw * w_row + w_row + ci * (rows + kh - 1) * xs_w)


@functools.lru_cache(maxsize=None)
def plan(b, ci, co, h, w, kh, kw, pads, rows=None, px=None, cpt=None,
         ks=None):
    '''The tile kernel's launch for x [B, Ci, H, W] and a kh x kw kernel,
    from the shape alone (not its dtype): the channel group and pixels of
    a work item and the lanes an item (``tile_rule``), the lanes' row
    pairs (ri = 2 for runs of 8 on an even number of rows), the staged
    columns and their stride; rows a tile the most up to MAX_ROWS that
    keep one work item a thread (two lanes where ks = 2) and the tile
    within TILE_BYTES (runs of 8 on an even number of rows); one block a
    tile, with as many threads as the items' lanes (whole warps, at most
    THREADS). ``rows``, ``ks`` and (together) ``cpt`` and ``px`` override
    the rule (tools/profile_torch_sites.py --sweep-stencil).'''
    (pt, pb), (pl, pr) = pads
    oh, ow = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    rule = tile_rule(b, ci, co, oh, ow)
    if cpt is None or px is None:
        cpt, px = rule[:2]
    ks = ks or rule[2]
    groups = cdiv(co, cpt)
    per_row = groups * cdiv(ow, px)
    cols = tile_cols(ow, px, kw)
    xs_w = stride(cols)

    def smem(r):
        return _tile_smem(ci, co, kh, kw, cpt, r, xs_w)

    def lanes(r):
        return 32 * cdiv(r * per_row, 16) if ks == 2 else r * per_row
    if rows is None:
        rows = 1
        for r in range(min(oh, MAX_ROWS), 1, -1):
            if ((px == 8 and r % 2) or lanes(r) > THREADS
                    or smem(r) > TILE_BYTES):
                continue
            rows = r
            break
    tiles_y = cdiv(oh, rows)
    ri = 2 if px == 8 and rows % 2 == 0 else 1
    threads = min(THREADS, 32 * cdiv(lanes(rows), 32))
    return Plan(cpt, px, ri, ks, rows, tiles_y, b * tiles_y, threads, cols,
                xs_w, smem(rows))


@functools.lru_cache(maxsize=None)
def route(ci, co, kh, kw, pads, h, w):
    '''``'pointwise'`` for a 1 x 1 conv with zero pads whose planes the
    pointwise kernel's 32-bit offsets reach; else ``'tile'`` where a tile
    of one row fits a block's shared memory; else ``'stencil'``, the
    direct kernel.'''
    if ((kh, kw) == (1, 1) and pads == ((0, 0), (0, 0))
            and max(ci, co) <= MAX_CHANNELS
            and max(ci, co) * h * w <= MAX_PLANE_FLOATS):
        return 'pointwise'
    if plan(1, ci, co, h, w, kh, kw, pads, rows=1).smem <= \
            _build.MAX_SMEM_BYTES:
        return 'tile'
    return 'stencil'


@functools.lru_cache(maxsize=None)
def out_hw(x_shape, w_shape, b_shape, pads):
    '''(OH, OW) of the conv; raises on shapes the kernels do not take.'''
    if len(x_shape) != 4 or 0 in x_shape:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {x_shape}')
    co, ci, kh, kw = w_shape
    if ci != x_shape[1] or b_shape != (co,):
        raise ValueError(f'stencil_conv needs w [Co, Ci, KH, KW] and b [Co]; '
                         f'got x {x_shape}, w {w_shape}, b {b_shape}')
    (pt, pb), (pl, pr) = pads
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f'pads must be non-negative, got {pads}')
    oh = x_shape[2] + pt + pb - kh + 1
    ow = x_shape[3] + pl + pr - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f'empty output for x {x_shape}, '
                         f'kernel {kh}x{kw}, pads {pads}')
    if not supported(ci, co, kh, kw):
        raise ValueError(f'stencil_conv takes at most {MAX_CHANNELS} '
                         f'channels; got Ci={ci} Co={co}')
    return oh, ow


def _pads(pads):
    (pt, pb), (pl, pr) = pads
    return (pt, pb), (pl, pr)


def check(x, w, b, pads):
    return out_hw(tuple(x.shape), tuple(w.shape), tuple(b.shape),
                  _pads(pads))


def stencil_conv(x, w, b, pads, relu=False):
    global launches, launches_bf16, launches_tile, launches_tile_bf16
    pads = _pads(pads)
    oh, ow = check(x, w, b, pads)
    if x.device.type == 'cpu':
        return plain(x, w, b, pads, relu)
    entry, dtype = _build.form('dnnca_stencil_conv', x.dtype)
    device = _build.check_cuda(dtype, x=x, w=w, b=b)
    bsz, ci, h, wd = x.shape
    co, _, kh, kw = w.shape
    out = torch.empty((bsz, co, oh, ow), device=device, dtype=dtype)
    stream = _build.stream_of(device)
    kind = route(ci, co, kh, kw, pads, h, wd)
    if kind == 'pointwise':
        size = x.element_size()
        vec = (h * wd) % 4 == 0 and x.data_ptr() % (4 * size) == 0
        streaming = size * (x.numel() + out.numel()) > L2_BYTES
        _build.launch(_build.form('dnnca_pointwise_conv', dtype)[0],
                      x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), out.data_ptr(), bsz, ci, co, h * wd,
                      int(bool(relu)), int(streaming), int(vec),
                      device.index, stream)
    elif kind == 'tile':
        pl = plan(bsz, ci, co, h, wd, kh, kw, pads)
        if x.data_ptr() % 16:
            x = x.clone()   # the staging's 8-byte copies need aligned rows
        _build.launch(_build.form('dnnca_stencil_conv_tile', dtype)[0],
                      x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      out.data_ptr(), bsz, ci, co, h, wd, kh, kw, pads[0][0],
                      pads[1][0], oh, ow, int(bool(relu)), pl.cpt, pl.px,
                      pl.ri, pl.rows, pl.cols, pl.xs_w, pl.ks, pl.threads,
                      pl.smem, device.index, stream)
    else:
        _build.launch(entry, x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), out.data_ptr(), bsz, ci, co, h, wd, kh,
                      kw, pads[0][0], pads[1][0], oh, ow, int(bool(relu)),
                      device.index, stream)
    if dtype == torch.bfloat16:
        launches_bf16 += 1
        launches_tile_bf16 += kind == 'tile'
    else:
        launches += 1
        launches_tile += kind == 'tile'
    return out
