'''Stride-1 conv with explicit pads, bias and an optional fused relu, NHWC,
small channels, in f32 or bf16: the NHWC form of stencil_conv
(ops/kernels/stencil_conv.py).

The CUDA kernels (csrc/stencil_conv_nhwc.cu, entry
``dnnca_stencil_conv_nhwc``) replace conv_kernel.stencil_conv2d_pallas of
the JAX package with ``nchw=False``. x is [B, H, W, Ci]; its channels must
be contiguous, but its pixels may lie further apart than Ci values: a
channel slice ``x[..., i:i + 1]`` of a batch (MulmoUNet's per-channel
encoders) is read in place. The weight is PyTorch OIHW [Co, Ci, KH, KW];
``pads`` is ((top, bottom), (left, right)) as in the JAX package. The
output is a contiguous [B, OH, OW, Co].

``eligible`` is the routing: the JAX package's ``small`` conv
(fastconv.py:365-372) and the unroll bound of ``conv_kernel.supported``
(kh * kw * Ci * Co <= 1024). ``supported``'s per-program VMEM bound is not
kept: it is the TPU kernel's whole padded image a program in VMEM.

``route`` picks one of two kernels from the shape alone: ``tile`` (a block
owns whole output rows of one image, stages their input rows in shared
memory and writes its output as one contiguous run), wherever ``plan``'s
tile fits a block's shared memory; else ``direct`` (one thread an output
pixel, read from device memory), for shapes whose one output row does not
fit. ``plan`` sizes the tile in pure Python: rows a tile, pixels a thread,
the shared-memory layout.

``stencil_conv_nhwc`` launches the kernel for CUDA tensors and runs
``plain`` (``F.conv2d`` on the padded NCHW view) for CPU tensors; it raises
on any other input. Its backward is the plain version's gradient, the
library's conv backward (ops/functions.py): at these shapes the JAX package
computes that backward in XLA too (the Pallas backward's per-program bound
is over its VMEM limit there).

bf16 form: x, w and b bf16 take the kernel's bf16 entry (computed in f32
from the exact upcast values in the f32 form's order, the output rounded to
bf16), and ``plain`` does the same on the CPU; ``grads`` then runs the
library's conv backward in bf16, as XLA's in the JAX package (f32
accumulation, bf16 results).
'''

import collections
import functools

import torch
import torch.nn.functional as F

from . import _build
from . import stencil_conv as nchw
from .tconv2x2_bwd import cdiv, pad4

MAX_CHANNELS = nchw.MAX_CHANNELS
MAX_TERMS = nchw.MAX_TERMS

launches = 0  # kernel launches in this process
launches_bf16 = 0  # those of the bf16 form

# the tile kernel (csrc/stencil_conv_nhwc.cu: stencil_nhwc_tile_kernel)
THREADS = 256   # kThreads
# a tile's rows hold this many output pixels (four a thread at the head, two
# groups of two at an encoder), fewer where the tile would pass TILE_BYTES
# of shared memory: with them MulmoUNet's sites ran fastest of 1-8 rows
# (tools/profile_torch_sites.py --sweep-stencil on an H100 80GB HBM3 at
# 700 W; four blocks of 64 registers a thread fit an SM)
TILE_PX = 1024
TILE_BYTES = 48 * 1024

Plan = collections.namedtuple('Plan', 'rows px gpr sw in_row vec_out tiles '
                                      'smem')


def bucket(co):
    '''The kernels' register width for Co output channels.'''
    return next(b for b in (1, 4, 8, 16, 32) if co <= b)


def form(ci, kh, kw, pads):
    '''The tile kernel's form (its KX): 3 for a one-channel 3-wide stencil
    (a window of staged values reused across the taps), 1 for a 1 x 1 conv
    with zero pads (no halo: a thread reads its pixel's channels straight
    into registers and nothing is staged), 0 for any other shape.'''
    if ci == 1 and kw == 3:
        return 3
    if (kh, kw) == (1, 1) and pads == ((0, 0), (0, 0)):
        return 1
    return 0


def pixels(ci, co, kh, kw, pads):
    '''Pixels a thread computes along a row (the kernel's tile_px): the
    3-wide form keeps a window of P + 2 values and P * CO <= 32 sums, at
    most 4 pixels; any other shape one pixel.'''
    if form(ci, kh, kw, pads) == 3:
        width = bucket(co)
        return 1 if width >= 32 else 2 if width >= 16 else 4
    return 1


def _smem(rows, ci, co, kh, kw, ow, px, gpr, in_row, vec_out, esize,
          staged=True):
    '''The tile's shared memory (the kernel's TileLayout): weights and bias
    (f32, to a whole 16 bytes), the staged input rows (f32; none for the
    1 x 1 form), and the output staging (in x's dtype): 16-byte chunks of
    each thread's P * Co outputs with a chunk of padding after an even
    count, or the run value by value with up to one chunk of slack before
    it.'''
    width = bucket(co)
    floats = pad4(kh * kw * ci * width + width) + (
        (rows + kh - 1) * in_row if staged else 0)
    if vec_out:
        gc = px * width * esize // 16
        out = 16 * rows * gpr * (gc + (1 if gc % 2 == 0 else 0))
    else:
        out = cdiv((rows * ow * co + 16 // esize) * esize, 16) * 16
    return 4 * floats + out


@functools.lru_cache(maxsize=None)
def plan(b, h, w, ci, co, kh, kw, pads, esize, rows=None):
    '''The tile kernel's launch for x [B, H, W, Ci] of ``esize``-byte values
    and a kh x kw kernel, from the shape alone: its ``form``, P pixels a
    thread
    (``pixels``), ceil(OW / P) groups a row, the staged rows' width (the
    groups' pixels and the kernel's halo), the output as 16-byte chunks
    where Co fills its bucket, P * Co values are whole chunks and P divides
    OW; rows a tile for TILE_PX pixels, fewer where the tile passes
    TILE_BYTES (or ``rows`` where given: tools/profile_torch_sites.py
    --sweep-stencil); one block a tile.'''
    (pt, pb), (pl, pr) = pads
    oh, ow = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    px = pixels(ci, co, kh, kw, pads)
    staged = form(ci, kh, kw, pads) != 1
    gpr = cdiv(ow, px)
    sw = gpr * px + kw - 1
    in_row = pad4(sw * ci)
    vec_out = (co == bucket(co) and (px * co * esize) % 16 == 0
               and ow % px == 0)

    def smem(r):
        return _smem(r, ci, co, kh, kw, ow, px, gpr, in_row, vec_out, esize,
                     staged)
    if rows is None:
        rows = min(oh, cdiv(TILE_PX, ow))
        while rows > 1 and smem(rows) > TILE_BYTES:
            rows -= 1
    return Plan(rows, px, gpr, sw, in_row, vec_out, b * cdiv(oh, rows),
                smem(rows))


@functools.lru_cache(maxsize=None)
def route(b, h, w, ci, co, kh, kw, pads, esize):
    '''``tile`` where the plan's tile fits a block's shared memory and its
    grid the launch, else ``direct``.'''
    pl = plan(b, h, w, ci, co, kh, kw, pads, esize)
    if pl.smem <= _build.MAX_SMEM_BYTES and pl.tiles < 2**31:
        return 'tile'
    return 'direct'


def plain(x, w, b, pads, relu=False):
    '''Plain PyTorch version: NHWC in, an NHWC view out.'''
    out = nchw.plain(x.permute(0, 3, 1, 2), w, b, pads, relu)
    return out.permute(0, 2, 3, 1)


def eligible(ci, co, kh, kw, padding):
    '''Whether an NHWC stride-1 conv of Ci -> Co channels with a kh x kw
    kernel and ``padding`` routes to this kernel.'''
    return (ci <= MAX_CHANNELS and co <= MAX_CHANNELS
            and isinstance(padding, str)
            and kh * kw * ci * co <= MAX_TERMS)


def pixel_stride(x):
    '''Floats between neighbouring pixels of x [B, H, W, C] whose channels
    are contiguous and whose pixels are evenly spaced (a contiguous tensor,
    or a channel slice of one); raises otherwise. A dimension of size 1
    has any stride (the NHWC view of a [B, C, 1, 1] output has W's = 1), so
    the spacing is read from the innermost pixel dimension that has more
    than one element.'''
    b, h, w, c = x.shape
    xs = next((x.stride(d) // step for d, n, step in (
        (2, w, 1), (1, h, w), (0, b, h * w)) if n > 1), c)
    if ((c > 1 and x.stride(3) != 1) or xs < c
            or (h > 1 and x.stride(1) != w * xs)
            or (b > 1 and x.stride(0) != h * w * xs)):
        raise ValueError(f'stencil_conv_nhwc needs x with contiguous channels '
                         f'and evenly spaced pixels; got shape '
                         f'{tuple(x.shape)}, strides {tuple(x.stride())}')
    return xs


def check(x, w, b, pads):
    '''(OH, OW, pixel stride of x); raises on what the kernel does not
    take.'''
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, H, W, C] tensor, '
                         f'got {tuple(x.shape)}')
    nchw_shape = (x.shape[0], x.shape[3], x.shape[1], x.shape[2])
    oh, ow = nchw.out_hw(nchw_shape, tuple(w.shape), tuple(b.shape),
                         nchw._pads(pads))
    return oh, ow, pixel_stride(x)


def stencil_conv_nhwc(x, w, b, pads, relu=False):
    global launches, launches_bf16
    pads = nchw._pads(pads)
    oh, ow, xs = check(x, w, b, pads)
    if x.device.type == 'cpu':
        return plain(x, w, b, pads, relu)
    entry, dtype = _build.form('dnnca_stencil_conv_nhwc', x.dtype)
    device = _build.check_cuda(dtype, w=w, b=b)
    if not x.is_cuda or x.device != device:
        raise ValueError(f'x must be a CUDA tensor on {device}, got '
                         f'{x.dtype} on {x.device}')
    bsz, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    esize = x.element_size()
    out = torch.empty((bsz, oh, ow, co), device=device, dtype=dtype)
    if out.data_ptr() % 16:
        raise ValueError('stencil_conv_nhwc needs a 16-byte aligned output')
    vec_in = (ci % 4 == 0 and xs % 4 == 0
              and x.data_ptr() % (4 * esize) == 0)
    tile = route(bsz, h, wd, ci, co, kh, kw, pads, esize) == 'tile'
    pl = plan(bsz, h, wd, ci, co, kh, kw, pads, esize)
    _build.launch(entry, x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), out.data_ptr(), bsz, ci, co, h, wd, xs, kh,
                  kw, pads[0][0], pads[1][0], oh, ow, int(bool(relu)),
                  int(vec_in), int(tile), pl.rows, int(pl.vec_out),
                  device.index, _build.stream_of(device))
    if dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def grads(x, g, w, pads, need_dx=True):
    '''(dx or None, dw, db) of the conv at x [B, H, W, Ci] for the
    cotangent g [B, OH, OW, Co] of its output (after any relu mask): the
    library's conv backward on the NCHW views, the padded input where the
    pads are not symmetric.'''
    (pt, pb), (pl, pr) = nchw._pads(pads)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    sym = (pt, pl) == (pb, pr)
    if not sym:
        xn = F.pad(xn, (pl, pr, pt, pb))
    dx, dw, db = torch.ops.aten.convolution_backward(
        gn, xn, w, [w.shape[0]], [1, 1], [pt, pl] if sym else [0, 0],
        [1, 1], False, [0, 0], 1, [need_dx, True, True])
    if dx is not None:
        if not sym:
            dx = dx[:, :, pt:dx.shape[2] - pb, pl:dx.shape[3] - pr]
        dx = dx.permute(0, 2, 3, 1)
    return dx, dw, db
