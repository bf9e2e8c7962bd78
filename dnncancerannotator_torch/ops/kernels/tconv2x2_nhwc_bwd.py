'''Backward of the NHWC transposed conv (ops/kernels/tconv2x2_nhwc.py).

The CUDA kernels (csrc/tconv2x2_nhwc_bwd.cu) replace the backward of
tconv_kernel.conv_transpose2x2_nhwc of the JAX package (``_bwd_kernel``):
from the forward's input x, the cotangent g of its output and the weight in
PyTorch's unflipped [Ci, Co, 2, 2] layout they return (dx or None, dw, db).
The two products run on the tensor cores in 3xTF32 (csrc/tconv_gemm.cuh);
``plan`` splits the dgrad over its phases and the wgrad over the input
pixels so that the blocks fill the card, and the partial sums are added in
a fixed order, so dx, dw and db are the same from run to run.

``tconv2x2_nhwc_bwd`` launches the kernels for CUDA tensors and runs
``plain`` (the dx, dw and db einsums) for CPU tensors; it raises on any
other input.
'''

import functools

import torch

from . import _build
from . import tconv2x2_nhwc as fwd

launches = 0  # kernel launches in this process

SMS = 132   # SMs of an H100 SXM; on a card the wrapper asks the device
BK = 32     # depth of a K slice of the GEMM (csrc/tconv_gemm.cuh kBK)


def plain(x, g, w, need_dx=True, wpt=None):
    '''Plain PyTorch version: returns (dx or None, dw, db) (``wpt``, the
    kernel's packed weight, is not read).'''
    b, h, wd, _ = x.shape
    gr = g.reshape(b, h, 2, wd, 2, w.shape[1])
    dx = torch.einsum('bhpwqo,iopq->bhwi', gr, w) if need_dx else None
    dw = torch.einsum('bhwi,bhpwqo->iopq', x, gr)
    return dx, dw, g.sum((0, 1, 2))


def plan(b, h, w, ci, co, sms=SMS):
    '''(dgrad splits, wgrad chunk, wgrad splits) of the backward at x
    [b, h, w, ci] and Co = ``co`` on ``sms`` SMs (one 128 x 128 tile a
    block, one block an SM).

    The dgrad's K = 4 * Co is split by phase into 1, 2 or 4 parts, the
    fewest that give every SM a block. The wgrad's reduction over the
    b * h * w input pixels is split into chunks of whole K slices, as many
    as one wave of blocks holds (at least one), so its partial sums stay
    sms * 128 * 128 floats or fewer.'''
    pixels = b * h * w
    tile = fwd.ALIGN
    dgrad_tiles = (ci // tile) * -(-pixels // tile)
    dgrad_splits = next(s for s in (1, 2, 4)
                        if s == 4 or dgrad_tiles * s >= sms)
    wgrad_tiles = (ci // tile) * (4 * co // tile)
    target = min(max(1, sms // wgrad_tiles), -(-pixels // BK))
    chunk = -(-(-(-pixels // target)) // BK) * BK
    return dgrad_splits, chunk, -(-pixels // chunk)


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def tconv2x2_nhwc_bwd(x, g, w, need_dx=True, wpt=None):
    '''Returns (dx or None, dw, db). ``wpt`` is ``fwd.pack(w)`` where the
    caller has it (the autograd Function packs it in the forward); it is
    packed here otherwise, and only when dx is asked for.'''
    global launches
    fwd.check(x, w, torch.empty(w.shape[1], device='meta'))
    b, h, wd, ci = x.shape
    co = w.shape[1]
    if tuple(g.shape) != (b, 2 * h, 2 * wd, co):
        raise ValueError(f'g must be [B, 2H, 2W, Co] = '
                         f'{(b, 2 * h, 2 * wd, co)}, got {tuple(g.shape)}')
    if x.device.type == 'cpu':
        return plain(x, g, w, need_dx)
    read = dict(x=x, g=g)
    if need_dx:
        if wpt is None:
            wpt = fwd.pack(w)
        fwd.check_packed(wpt, w)
        read['wpt'] = wpt
    device = _build.check_cuda_f32(w=w, **read)
    if any(t.data_ptr() % 16 for t in read.values()):
        raise ValueError('tconv2x2_nhwc_bwd reads x, g and wpt 16 bytes at a '
                         'time: they must be 16-byte aligned')
    f32 = dict(device=device, dtype=torch.float32)
    pixels = b * h * wd
    dgrad_splits, chunk, wgrad_splits = plan(b, h, wd, ci, co,
                                             _sms(device.index))
    n_w = wgrad_splits * ci * 4 * co
    n_db = wgrad_splits * 4 * co
    n_dx = dgrad_splits * pixels * ci if need_dx and dgrad_splits > 1 else 0
    # one workspace for the partials; every part starts 16-byte aligned
    work = torch.empty(n_w + n_db + n_dx, **f32)
    base = work.data_ptr()
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty(w.shape, **f32)
    db = torch.empty(co, **f32)
    _build.launch('dnnca_tconv2x2_nhwc_bwd', x.data_ptr(), g.data_ptr(),
                  wpt.data_ptr() if need_dx else None,
                  dx.data_ptr() if need_dx else None, dw.data_ptr(),
                  db.data_ptr(), base, base + 4 * n_w,
                  base + 4 * (n_w + n_db) if n_dx else None, b, h, wd, ci,
                  co, dgrad_splits, chunk, wgrad_splits, device.index,
                  _build.stream_of(device))
    launches += 1
    return dx, dw, db
