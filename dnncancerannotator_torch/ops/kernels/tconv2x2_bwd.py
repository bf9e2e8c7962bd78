'''Backward of ConvTranspose(kernel=2, stride=2) plus bias
(ops/kernels/tconv2x2.py), NCHW f32.

The CUDA kernel (csrc/tconv2x2_bwd.cu) replaces flattconv's backward kernel
(``_bwd_call``) of the JAX package and also serves the upsamples that
package leaves to XLA. From the forward's input x, the cotangent g of its
output and the weight in PyTorch's unflipped [Ci, Co, 2, 2] layout it
returns (dx or None, dw, db); dw is the gradient with respect to that
layout.

``tconv2x2_bwd`` launches the kernel for CUDA tensors and runs ``plain``
(``F.conv2d`` of g with stride 2 for dx, an einsum over the four phases for
dw) for CPU tensors; it raises on any other input.
'''

import torch
import torch.nn.functional as F

from . import _build, _wgrad
from . import tconv2x2 as fwd

launches = 0  # kernel launches in this process

# input pixels of one weight-gradient tile (csrc/tconv2x2_bwd.cu); its
# shared memory fits at every width the forward takes
_TILE_H, _TILE_W = 4, 32


def plain(x, g, w, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw, db).'''
    b, ci, h, wd = x.shape
    co = w.shape[1]
    dx = F.conv2d(g, w, stride=2) if need_dx else None
    dw = torch.einsum('bihw,bohpwq->iopq', x, g.reshape(b, co, h, 2, wd, 2))
    return dx, dw, g.sum((0, 2, 3))


def tconv2x2_bwd(x, g, w, need_dx=True):
    '''Returns (dx or None, dw, db).'''
    global launches
    fwd.check(x, w, torch.empty(w.shape[1], device='meta'))
    b, ci, h, wd = x.shape
    co = w.shape[1]
    if tuple(g.shape) != (b, co, 2 * h, 2 * wd):
        raise ValueError(f'g must be [B, Co, 2H, 2W] = '
                         f'{(b, co, 2 * h, 2 * wd)}, got {tuple(g.shape)}')
    if x.device.type == 'cpu':
        return plain(x, g, w, need_dx)
    device = _build.check_cuda_f32(x=x, g=g, w=w)
    if w.data_ptr() % 16:
        raise ValueError('tconv2x2_bwd reads w as float4: it must be 16-byte '
                         'aligned')
    n_w = ci * co * 4
    f32 = dict(device=device, dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    dwb = torch.empty(n_w + co, **f32)
    blocks = _wgrad.blocks(b, h, wd, _TILE_H, _TILE_W)
    partial = torch.empty((n_w + co) * blocks, **f32)
    _build.launch('dnnca_tconv2x2_bwd', x.data_ptr(), g.data_ptr(),
                  w.data_ptr(), dx.data_ptr() if dx is not None else None,
                  dwb.data_ptr(), partial.data_ptr(), b, ci, co, h, wd,
                  blocks, device.index, _build.stream_of(device))
    launches += 1
    return dx, dwb[:n_w].view(ci, co, 2, 2), dwb[n_w:]
