'''Backward of the fused conv chain (ops/kernels/conv_chain.py), NCHW f32.

The CUDA kernel (csrc/conv_chain_bwd.cu with csrc/wgrad.cu) replaces the
backward kernels of both JAX chain formulations:
conv_kernel.conv_chain_bwd_pallas and flatchain's _bwd_call_im2col /
_bwd_call. Given the forward's input x, its saved post-relu outputs c1 and
c2, the cotangent g of c2 and the weights, it returns
(dx, dw1, db1, dw2, db2); dx is None when ``need_dx`` is false, which is
need_dx=False in the JAX package (the model's first chain, whose input needs
no gradient). The relu masks are c1 > 0 and c2 > 0.

``conv_chain_bwd`` launches the kernel for CUDA tensors and runs ``plain``
(the data and weight gradients of the two ``F.conv2d``, masked by the saved
outputs) for CPU tensors; it raises on any other input.
'''

import functools

import torch
from torch.nn import grad as nn_grad

from . import _build, _wgrad
from . import conv_chain as fwd

launches = 0  # kernel launches in this process


def plain(x, c1, c2, g, w1, w2, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw1, db1, dw2, db2).'''
    pad = w1.shape[-1] // 2
    g2 = g * (c2 > 0)
    dw2 = nn_grad.conv2d_weight(c1, w2.shape, g2, padding=pad)
    dc1 = nn_grad.conv2d_input(c1.shape, w2, g2, padding=pad) * (c1 > 0)
    dw1 = nn_grad.conv2d_weight(x, w1.shape, dc1, padding=pad)
    dx = (nn_grad.conv2d_input(x.shape, w1, dc1, padding=pad)
          if need_dx else None)
    return dx, dw1, dc1.sum((0, 2, 3)), dw2, g2.sum((0, 2, 3))


def _dgrad_smem_bytes(ci, cm, co, k, tile_h, need_dx):
    '''Shared memory of one dgrad block: the flipped weights padded to the
    channel bucket, g2 over the tile with a 2p halo and dc1 over the tile
    with a p halo (csrc/conv_chain_bwd.cu).'''
    p = k // 2
    width = fwd.bucket(max(cm, ci if need_dx else 0))
    floats = ((co + (cm if need_dx else 0)) * k * k * width
              + co * (tile_h + 4 * p) * (fwd.TILE_W + 4 * p)
              + cm * (tile_h + 2 * p) * (fwd.TILE_W + 2 * p))
    return 4 * floats


@functools.lru_cache(maxsize=None)
def _tile_height(ci, cm, co, k, need_dx):
    for limit in (fwd.TWO_BLOCKS_SMEM, _build.MAX_SMEM_BYTES):
        for tile_h in fwd.TILE_HEIGHTS:
            if _dgrad_smem_bytes(ci, cm, co, k, tile_h, need_dx) <= limit:
                return tile_h
    return None


@functools.lru_cache(maxsize=None)
def supported(ci, cm, co, k):
    '''Whether the kernel takes these channel counts and kernel size (with
    dx, the larger case).'''
    return (max(ci, cm, co) <= fwd.MAX_CHANNELS and k % 2 == 1
            and _tile_height(ci, cm, co, k, True) is not None
            and _wgrad.fits(co, cm, k, k) and _wgrad.fits(cm, ci, k, k))


def _check(x, c1, c2, g, w1, w2):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {tuple(x.shape)}')
    b, ci, h, w = x.shape
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    if (tuple(w1.shape) != (cm, ci, k, k) or tuple(w2.shape) != (co, cm, k, k)
            or tuple(c1.shape) != (b, cm, h, w)
            or tuple(c2.shape) != (b, co, h, w) or g.shape != c2.shape):
        raise ValueError(
            f'conv_chain_bwd shapes do not chain: x {tuple(x.shape)}, '
            f'c1 {tuple(c1.shape)}, c2 {tuple(c2.shape)}, g {tuple(g.shape)}, '
            f'w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}')
    if not supported(ci, cm, co, k):
        raise ValueError(
            f'conv_chain_bwd takes odd K and at most {fwd.MAX_CHANNELS} '
            f'channels that fit shared memory; got Ci={ci} Cm={cm} Co={co} '
            f'K={k}')


def conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx=True):
    '''Returns (dx or None, dw1, db1, dw2, db2).'''
    global launches
    _check(x, c1, c2, g, w1, w2)
    if x.device.type == 'cpu':
        return plain(x, c1, c2, g, w1, w2, need_dx)
    device = _build.check_cuda_f32(x=x, c1=c1, c2=c2, g=g, w1=w1, w2=w2)
    b, ci, h, w = x.shape
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    n1, n2 = cm * ci * k * k, co * cm * k * k
    f32 = dict(device=device, dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    dc1 = torch.empty_like(c1)
    dw1b = torch.empty(n1 + cm, **f32)
    dw2b = torch.empty(n2 + co, **f32)
    blocks = _wgrad.blocks(b, h, w)
    partial = torch.empty(max(n1 + cm, n2 + co) * blocks, **f32)
    tile_h = _tile_height(ci, cm, co, k, need_dx)
    _build.launch(
        'dnnca_conv_chain_bwd', x.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        g.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        dx.data_ptr() if dx is not None else None, dc1.data_ptr(),
        dw1b.data_ptr(), dw2b.data_ptr(), partial.data_ptr(),
        b, ci, cm, co, h, w, k, tile_h,
        _dgrad_smem_bytes(ci, cm, co, k, tile_h, need_dx), blocks,
        device.index, _build.stream_of(device))
    launches += 1
    return (dx, dw1b[:n1].view(cm, ci, k, k), dw1b[n1:],
            dw2b[:n2].view(co, cm, k, k), dw2b[n2:])
