'''Backward of the stride-1 stencil conv (ops/kernels/stencil_conv.py),
NCHW f32.

The CUDA kernel (csrc/stencil_conv_bwd.cu with csrc/wgrad.cu) replaces
conv_kernel.stencil_conv2d_bwd_pallas of the JAX package: from the
forward's input x, the cotangent g of its output and the weight it returns
(dx or None, dw, db). When the forward fused a relu, the caller masks g by
the forward's output first (ops/functions.py), as fastconv.py:200-201 does.

``stencil_conv_bwd`` launches the kernel for CUDA tensors and runs ``plain``
(the data and weight gradients of ``F.conv2d`` on the padded input) for CPU
tensors; it raises on any other input.
'''

import functools

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from . import _build, _wgrad
from . import stencil_conv as fwd

launches = 0  # kernel launches in this process


def plain(x, g, w, pads, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw, db).'''
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


def stencil_conv_bwd(x, g, w, pads, need_dx=True):
    '''Returns (dx or None, dw, db).'''
    global launches
    co, ci, kh, kw = w.shape
    oh, ow = fwd.check(x, w, torch.empty(co, device='meta'), pads)
    if tuple(g.shape) != (x.shape[0], co, oh, ow):
        raise ValueError(f'g must be [B, Co, OH, OW] = '
                         f'{(x.shape[0], co, oh, ow)}, got {tuple(g.shape)}')
    if not supported(ci, co, kh, kw):
        raise ValueError(f'stencil_conv_bwd takes at most '
                         f'{fwd.MAX_CHANNELS} channels that fit shared '
                         f'memory; got Ci={ci} Co={co} kernel {kh}x{kw}')
    if x.device.type == 'cpu':
        return plain(x, g, w, pads, need_dx)
    device = _build.check_cuda_f32(x=x, g=g, w=w)
    b, _, h, wd = x.shape
    n_w = co * ci * kh * kw
    f32 = dict(device=device, dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    dwb = torch.empty(n_w + co, **f32)
    blocks = _wgrad.blocks(b, oh, ow)
    partial = torch.empty((n_w + co) * blocks, **f32)
    _build.launch('dnnca_stencil_conv_bwd', x.data_ptr(), g.data_ptr(),
                  w.data_ptr(), dx.data_ptr() if dx is not None else None,
                  dwb.data_ptr(), partial.data_ptr(), b, ci, co, h, wd, kh,
                  kw, pads[0][0], pads[1][0], oh, ow, blocks, device.index,
                  _build.stream_of(device))
    launches += 1
    return dx, dwb[:n_w].view(co, ci, kh, kw), dwb[n_w:]
