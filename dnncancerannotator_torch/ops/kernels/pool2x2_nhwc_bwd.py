'''Backward of the 2x2 / stride-2 NHWC max pool (ops/kernels/pool2x2_nhwc.py).

The CUDA kernel (csrc/pool2x2_nhwc_bwd.cu) replaces the backward of
pool_kernel.max_pool2x2_nhwc of the JAX package (``_bwd_kernel``): the
cotangent follows the two-level max tree, split 0.5 / 0.5 at an exact tie
on each level (``_balanced``, the gradient of jnp.maximum and of
torch.maximum), so a window tied on both levels gives each input 1/4. The
kernel equals ``plain`` bit for bit.

``pool2x2_nhwc_bwd`` launches the kernel for CUDA tensors and runs
``plain`` for CPU tensors; it raises on any other input.
'''

import torch

from . import _build
from . import pool2x2_nhwc as fwd

launches = 0  # kernel launches in this process


def _balanced(a, ans, b, g):
    '''The share of g that input a of ans = max(a, b) receives.'''
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    return torch.where(a == ans, torch.where(b == ans, g * 0.5, g), zero)


def plain(x, g):
    '''Plain PyTorch version: dx of the pool at x for the cotangent g,
    written out as the JAX kernel's _bwd_kernel computes it.'''
    za, zb = x[:, 0::2], x[:, 1::2]                 # rows 2y, 2y + 1
    m = torch.maximum(za, zb)
    m0, m1 = m[:, :, 0::2], m[:, :, 1::2]           # columns 2x, 2x + 1
    out = torch.maximum(m0, m1)
    dm = torch.empty_like(m)
    dm[:, :, 0::2] = _balanced(m0, out, m1, g)
    dm[:, :, 1::2] = _balanced(m1, out, m0, g)
    dx = torch.empty_like(x)
    dx[:, 0::2] = _balanced(za, m, zb, dm)
    dx[:, 1::2] = _balanced(zb, m, za, dm)
    return dx


def pool2x2_nhwc_bwd(x, g):
    global launches
    fwd.check(x)
    b, h2, w2, c = x.shape
    if tuple(g.shape) != (b, h2 // 2, w2 // 2, c):
        raise ValueError(f'g must be [B, H/2, W/2, C] = '
                         f'{(b, h2 // 2, w2 // 2, c)}, got {tuple(g.shape)}')
    if x.device.type == 'cpu':
        return plain(x, g)
    device = _build.check_cuda_f32(x=x, g=g)
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError('pool2x2_nhwc_bwd reads x and g as float4: they '
                         'must be 16-byte aligned')
    dx = torch.empty_like(x)
    _build.launch('dnnca_pool2x2_nhwc_bwd', x.data_ptr(), g.data_ptr(),
                  dx.data_ptr(), b, h2 // 2, w2 // 2, c, device.index,
                  _build.stream_of(device))
    launches += 1
    return dx
