'''Backward of the NHWC transposed conv (ops/kernels/tconv2x2_nhwc.py).

The CUDA kernels (csrc/tconv2x2_nhwc_bwd.cu) replace the backward of
tconv_kernel.conv_transpose2x2_nhwc of the JAX package (``_bwd_kernel``):
from the forward's input x, the cotangent g of its output and the weight in
PyTorch's unflipped [Ci, Co, 2, 2] layout they return (dx or None, dw, db).
The weight gradient's reduction over the input pixels is split into chunks
whose partial sums are added in a fixed order, so dw and db are the same
from run to run.

``tconv2x2_nhwc_bwd`` launches the kernels for CUDA tensors and runs
``plain`` (the dx, dw and db einsums) for CPU tensors; it raises on any
other input.
'''

import torch

from . import _build
from . import tconv2x2_nhwc as fwd

launches = 0  # kernel launches in this process

# the reduction is split until about this many blocks share the dw GEMM (4
# per SM of an H100), in chunks of whole 8-deep K slices
TARGET_BLOCKS = 528
DB_COLS = 128   # channels per block of the db sums (csrc)


def plain(x, g, w, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw, db).'''
    b, h, wd, _ = x.shape
    gr = g.reshape(b, h, 2, wd, 2, w.shape[1])
    dx = torch.einsum('bhpwqo,iopq->bhwi', gr, w) if need_dx else None
    dw = torch.einsum('bhwi,bhpwqo->iopq', x, gr)
    return dx, dw, g.sum((0, 1, 2))


def _chunks(rows, target, multiple=1):
    '''(rows per chunk, chunks) splitting ``rows`` into about ``target``
    chunks of a multiple of ``multiple`` rows.'''
    chunk = -(-rows // max(target, 1))
    chunk = -(-chunk // multiple) * multiple
    return chunk, -(-rows // chunk)


def tconv2x2_nhwc_bwd(x, g, w, need_dx=True):
    '''Returns (dx or None, dw, db).'''
    global launches
    fwd.check(x, w, torch.empty(w.shape[1], device='meta'))
    b, h, wd, ci = x.shape
    co = w.shape[1]
    if tuple(g.shape) != (b, 2 * h, 2 * wd, co):
        raise ValueError(f'g must be [B, 2H, 2W, Co] = '
                         f'{(b, 2 * h, 2 * wd, co)}, got {tuple(g.shape)}')
    if x.device.type == 'cpu':
        return plain(x, g, w, need_dx)
    device = _build.check_cuda_f32(x=x, g=g, w=w)
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError('tconv2x2_nhwc_bwd reads x and g as float4: they '
                         'must be 16-byte aligned')
    f32 = dict(device=device, dtype=torch.float32)
    pixels = b * h * wd
    tiles = (ci // fwd.ALIGN) * (4 * co // fwd.ALIGN)
    w_chunk, w_splits = _chunks(pixels, -(-TARGET_BLOCKS // tiles), 8)
    db_chunk, db_chunks = _chunks(4 * pixels, TARGET_BLOCKS // 2 // (
        co // DB_COLS))
    wpt = w.permute(2, 3, 1, 0).reshape(4 * co, ci).contiguous()
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty(w.shape, **f32)
    db = torch.empty(co, **f32)
    partial = torch.empty(w_splits * ci * 4 * co, **f32)
    db_partial = torch.empty(db_chunks * co, **f32)
    _build.launch('dnnca_tconv2x2_nhwc_bwd', x.data_ptr(), g.data_ptr(),
                  wpt.data_ptr(), dx.data_ptr() if dx is not None else None,
                  dw.data_ptr(), db.data_ptr(), partial.data_ptr(),
                  db_partial.data_ptr(), b, h, wd, ci, co, w_chunk, w_splits,
                  db_chunk, db_chunks, device.index, _build.stream_of(device))
    launches += 1
    return dx, dw, db
