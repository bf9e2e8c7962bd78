'''ConvTranspose(kernel=2, stride=2) plus bias, NHWC f32, Ci and Co
multiples of 128.

The CUDA kernel (csrc/tconv2x2_nhwc.cu) replaces
tconv_kernel.conv_transpose2x2_nhwc of the JAX package (forward). The
weight is PyTorch's ConvTranspose2d [Ci, Co, 2, 2], applied unflipped:

    out[b, 2y+dy, 2x+dx, co] = bias[co] + sum_ci x[b, y, x, ci] w[ci, co, dy, dx]

(convert.py flips the flax HWIO kernel into this layout once; it is not
flipped again here). The kernel's one GEMM runs on the tensor cores in
3xTF32 (csrc/tconv_gemm.cuh) and reads the weight packed by ``pack`` as
[4 * Co, Ci], the layout the backward's dgrad reads too: the autograd
Function (ops/functions.py) packs it once a step and hands it to both.

``tconv2x2_nhwc`` launches the kernel for CUDA tensors and runs ``plain``
(an einsum over the phase grid) for CPU tensors; it raises on any other
input. ``eligible`` is the routing: the JAX package's ``tconv_pallas_ok``
without its TPU-only conditions.
'''

import torch

from .. import gates
from . import _build

ALIGN = 128   # Ci and Co must be multiples of this (csrc/tconv_gemm.cuh)

launches = 0  # kernel launches in this process


def plain(x, w, b, wpt=None):
    '''Plain PyTorch version (``wpt``, the kernel's packed weight, is not
    read).'''
    bsz, h, wd, _ = x.shape
    co = w.shape[1]
    out = torch.einsum('bhwi,iopq->bhpwqo', x, w)
    return out.reshape(bsz, 2 * h, 2 * wd, co) + b


def pack(w):
    '''The weight [Ci, Co, 2, 2] as wpt[(2*dy + dx)*Co + co, ci]: the
    forward's B with K = ci contiguous and the dgrad's B with N = ci
    contiguous.'''
    ci, co = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(4 * co, ci).contiguous()


def check_packed(wpt, w):
    if tuple(wpt.shape) != (4 * w.shape[1], w.shape[0]):
        raise ValueError(f'wpt must be pack(w), [4 * Co, Ci] = '
                         f'{(4 * w.shape[1], w.shape[0])}; got '
                         f'{tuple(wpt.shape)}')


def eligible(xshape, kernel_size, strides, features, data_format, dtype):
    '''Whether a ConvTranspose routes to this kernel: the ``pallas_tconv``
    gate, NHWC f32, the 2x2 / stride-2 geometry and Ci, Co multiples of
    128.'''
    if not gates.enabled('pallas_tconv'):
        return False
    if data_format != 'NHWC' or tuple(kernel_size) != (2, 2) \
            or tuple(strides) != (2, 2) or dtype != torch.float32:
        return False
    _, h, wd, ci = xshape
    return h >= 1 and wd >= 1 and ci % ALIGN == 0 and features % ALIGN == 0


def check(x, w, b):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, H, W, C] tensor, '
                         f'got {tuple(x.shape)}')
    ci, co = x.shape[3], w.shape[1]
    if tuple(w.shape) != (ci, co, 2, 2) or tuple(b.shape) != (co,):
        raise ValueError(f'tconv2x2_nhwc needs w [Ci, Co, 2, 2] and b [Co]; '
                         f'got x {tuple(x.shape)}, w {tuple(w.shape)}, '
                         f'b {tuple(b.shape)}')
    if ci % ALIGN or co % ALIGN:
        raise ValueError(f'tconv2x2_nhwc takes Ci and Co multiples of {ALIGN}; '
                         f'got Ci={ci} Co={co}')


def tconv2x2_nhwc(x, w, b, wpt=None):
    '''out [B, 2H, 2W, Co]; ``wpt`` is ``pack(w)`` where the caller has it
    (packed here otherwise).'''
    global launches
    check(x, w, b)
    if x.device.type == 'cpu':
        return plain(x, w, b)
    if wpt is None:
        wpt = pack(w)
    check_packed(wpt, w)
    device = _build.check_cuda_f32(x=x, w=w, b=b, wpt=wpt)
    if any(t.data_ptr() % 16 for t in (x, b, wpt)):
        raise ValueError('tconv2x2_nhwc reads x, b and wpt 16 bytes at a '
                         'time: they must be 16-byte aligned')
    bsz, h, wd, ci = x.shape
    co = w.shape[1]
    out = torch.empty((bsz, 2 * h, 2 * wd, co), device=device,
                      dtype=torch.float32)
    _build.launch('dnnca_tconv2x2_nhwc', x.data_ptr(), wpt.data_ptr(),
                  b.data_ptr(), out.data_ptr(), bsz, h, wd, ci, co,
                  device.index, _build.stream_of(device))
    launches += 1
    return out
