'''Stride-1 conv with explicit pads, bias and an optional fused relu, NCHW
f32, small channels.

The CUDA kernel (csrc/stencil_conv.cu) replaces
conv_kernel.stencil_conv2d_pallas of the JAX package. The weight is in
PyTorch OIHW layout [Co, Ci, KH, KW]; ``pads`` is ((top, bottom),
(left, right)) as in the JAX package. ``route`` picks one of its two
kernels: ``pointwise`` for a 1 x 1 conv with zero pads (the logits head: a
float4 stream of Ci reads and Co writes a pixel), ``stencil`` for any
other shape.

``stencil_conv`` launches the kernel for CUDA tensors and runs ``plain``
(``F.conv2d`` on the padded input) for CPU tensors; it raises on any other
input.
'''

import functools

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 32
# the pointwise kernel's offsets inside one batch item are 32-bit
MAX_PLANE_FLOATS = 2**31 - 1
# past this many bytes a call (the H100's 50 MB of L2) the pointwise
# kernel streams its loads (evict-first)
L2_BYTES = 50 * 2**20

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


@functools.lru_cache(maxsize=None)
def route(ci, co, kh, kw, pads, h, w):
    '''``'pointwise'`` for a 1 x 1 conv with zero pads whose planes the
    pointwise kernel's 32-bit offsets reach, else ``'stencil'``.'''
    if ((kh, kw) == (1, 1) and pads == ((0, 0), (0, 0))
            and max(ci, co) <= MAX_CHANNELS
            and max(ci, co) * h * w <= MAX_PLANE_FLOATS):
        return 'pointwise'
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
    global launches
    pads = _pads(pads)
    oh, ow = check(x, w, b, pads)
    if x.device.type == 'cpu':
        return plain(x, w, b, pads, relu)
    device = _build.check_cuda_f32(x=x, w=w, b=b)
    bsz, ci, h, wd = x.shape
    co, _, kh, kw = w.shape
    out = torch.empty((bsz, co, oh, ow), device=device, dtype=torch.float32)
    stream = _build.stream_of(device)
    if route(ci, co, kh, kw, pads, h, wd) == 'pointwise':
        vec = (h * wd) % 4 == 0 and x.data_ptr() % 16 == 0
        streaming = 4 * (x.numel() + out.numel()) > L2_BYTES
        _build.launch('dnnca_pointwise_conv', x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), out.data_ptr(), bsz, ci, co, h * wd,
                      int(bool(relu)), int(streaming), int(vec),
                      device.index, stream)
    else:
        _build.launch('dnnca_stencil_conv', x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), out.data_ptr(), bsz, ci, co, h, wd, kh,
                      kw, pads[0][0], pads[1][0], oh, ow, int(bool(relu)),
                      device.index, stream)
    launches += 1
    return out
