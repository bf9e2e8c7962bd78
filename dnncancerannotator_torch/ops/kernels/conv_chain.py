'''Fused conv chain relu(conv(relu(conv(x, w1) + b1), w2) + b2), NCHW f32.

One CUDA kernel (csrc/conv_chain.cu) replaces both Pallas chain kernels of
the JAX package: conv_kernel.conv_chain_pallas and
flatchain.conv_chain_flat_nchw. Stride 1, odd K, "same" pads K // 2;
weights in PyTorch OIHW layout ([Cm, Ci, K, K] and [Co, Cm, K, K]).

``conv_chain`` launches the kernel for CUDA tensors and runs ``plain`` (two
``F.conv2d`` + relu) for CPU tensors; it raises on any other input.
'''

import functools

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 32
TILE_W = 32
TILE_HEIGHTS = (16, 8, 4)
# tiles up to this much shared memory leave room for two blocks per SM
TWO_BLOCKS_SMEM = 113 * 1024

launches = 0  # kernel launches in this process


def plain(x, w1, b1, w2, b2):
    '''Plain PyTorch version: returns (c1, c2), both post-relu.'''
    pad = w1.shape[-1] // 2
    c1 = F.relu(F.conv2d(x, w1, b1, padding=pad))
    c2 = F.relu(F.conv2d(c1, w2, b2, padding=pad))
    return c1, c2


def bucket(c):
    '''The kernel's register width for c output channels.'''
    return next(b for b in (4, 8, 16, 32) if c <= b)


def _smem_bytes(ci, cm, co, k, tile_h):
    '''Shared memory of one block: both weight sets and biases padded to
    the channel bucket, the input tile with a 2p halo and c1 over the tile
    with a p halo (csrc/conv_chain.cu).'''
    p = k // 2
    width = bucket(max(cm, co))
    floats = ((ci + cm) * k * k * width + 2 * width
              + ci * (tile_h + 4 * p) * (TILE_W + 4 * p)
              + cm * (tile_h + 2 * p) * (TILE_W + 2 * p))
    return 4 * floats


@functools.lru_cache(maxsize=None)
def _tile_height(ci, cm, co, k):
    '''The tallest tile that leaves room for two blocks per SM, else the
    tallest that fits one; None if none fits.'''
    for limit in (TWO_BLOCKS_SMEM, _build.MAX_SMEM_BYTES):
        for tile_h in TILE_HEIGHTS:
            if _smem_bytes(ci, cm, co, k, tile_h) <= limit:
                return tile_h
    return None


@functools.lru_cache(maxsize=None)
def supported(ci, cm, co, k):
    '''Whether the kernel takes these channel counts and kernel size.'''
    return (max(ci, cm, co) <= MAX_CHANNELS and k % 2 == 1
            and _tile_height(ci, cm, co, k) is not None)


def _check(x, w1, b1, w2, b2):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {tuple(x.shape)}')
    ci = x.shape[1]
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    if (tuple(w1.shape) != (cm, ci, k, k) or tuple(w2.shape) != (co, cm, k, k)
            or tuple(b1.shape) != (cm,) or tuple(b2.shape) != (co,)):
        raise ValueError(
            f'conv_chain shapes do not chain: x {tuple(x.shape)}, '
            f'w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, '
            f'w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}')
    if not supported(ci, cm, co, k):
        raise ValueError(
            f'conv_chain takes odd K and at most {MAX_CHANNELS} channels '
            f'that fit shared memory; got Ci={ci} Cm={cm} Co={co} K={k}')


def conv_chain(x, w1, b1, w2, b2, need_c1=False):
    '''Returns (c1, c2); c1 is None unless ``need_c1``.'''
    global launches
    _check(x, w1, b1, w2, b2)
    if x.device.type == 'cpu':
        c1, c2 = plain(x, w1, b1, w2, b2)
        return (c1 if need_c1 else None), c2
    device = _build.check_cuda_f32(x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    b, ci, h, w = x.shape
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    c2 = torch.empty((b, co, h, w), device=device, dtype=torch.float32)
    c1 = (torch.empty((b, cm, h, w), device=device, dtype=torch.float32)
          if need_c1 else None)
    tile_h = _tile_height(ci, cm, co, k)
    _build.launch(
        'dnnca_conv_chain', x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(),
        c1.data_ptr() if c1 is not None else None, c2.data_ptr(),
        b, ci, cm, co, h, w, k, tile_h,
        _smem_bytes(ci, cm, co, k, tile_h), device.index,
        _build.stream_of(device))
    launches += 1
    return c1, c2
