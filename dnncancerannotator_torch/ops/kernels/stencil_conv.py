'''Stride-1 conv with explicit pads, bias and an optional fused relu, NCHW
f32, small channels.

The CUDA kernel (csrc/stencil_conv.cu) replaces
conv_kernel.stencil_conv2d_pallas of the JAX package. The weight is in
PyTorch OIHW layout [Co, Ci, KH, KW]; ``pads`` is ((top, bottom),
(left, right)) as in the JAX package.

``stencil_conv`` launches the kernel for CUDA tensors and runs ``plain``
(``F.conv2d`` on the padded input) for CPU tensors; it raises on any other
input.
'''

import functools

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 32

launches = 0  # kernel launches in this process


def plain(x, w, b, pads, relu=False):
    '''Plain PyTorch version.'''
    (pt, pb), (pl, pr) = pads
    out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b)
    return F.relu(out) if relu else out


def _smem_bytes(ci, co, kh, kw):
    '''Weights and bias, padded to the kernel's Co bucket
    (csrc/stencil_conv.cu).'''
    width = next(b for b in (1, 4, 8, 16, 32) if co <= b)
    return 4 * (ci * kh * kw + 1) * width


@functools.lru_cache(maxsize=None)
def supported(ci, co, kh, kw):
    return (max(ci, co) <= MAX_CHANNELS
            and _smem_bytes(ci, co, kh, kw) <= _build.MAX_SMEM_BYTES)


def check(x, w, b, pads):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {tuple(x.shape)}')
    co, ci, kh, kw = w.shape
    if ci != x.shape[1] or tuple(b.shape) != (co,):
        raise ValueError(f'stencil_conv needs w [Co, Ci, KH, KW] and b [Co]; '
                         f'got x {tuple(x.shape)}, w {tuple(w.shape)}, '
                         f'b {tuple(b.shape)}')
    (pt, pb), (pl, pr) = pads
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f'pads must be non-negative, got {pads}')
    oh = x.shape[2] + pt + pb - kh + 1
    ow = x.shape[3] + pl + pr - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f'empty output for x {tuple(x.shape)}, '
                         f'kernel {kh}x{kw}, pads {pads}')
    if not supported(ci, co, kh, kw):
        raise ValueError(f'stencil_conv takes at most {MAX_CHANNELS} '
                         f'channels; got Ci={ci} Co={co}')
    return oh, ow


def stencil_conv(x, w, b, pads, relu=False):
    global launches
    oh, ow = check(x, w, b, pads)
    if x.device.type == 'cpu':
        return plain(x, w, b, pads, relu)
    device = _build.check_cuda_f32(x=x, w=w, b=b)
    bsz, ci, h, wd = x.shape
    co, _, kh, kw = w.shape
    out = torch.empty((bsz, co, oh, ow), device=device, dtype=torch.float32)
    _build.launch('dnnca_stencil_conv', x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), out.data_ptr(), bsz, ci, co, h, wd, kh, kw,
                  pads[0][0], pads[1][0], oh, ow, int(bool(relu)),
                  device.index, _build.stream_of(device))
    launches += 1
    return out
