'''2x2 / stride-2 max pool of NHWC f32 [B, 2H, 2W, C] -> [B, H, W, C].

The CUDA kernel (csrc/pool2x2_nhwc.cu) replaces
pool_kernel.max_pool2x2_nhwc of the JAX package (forward). Its values equal
the plain pairwise tree bit for bit: the row pair first, then the column
pair, with torch.maximum's NaN rule.

``pool2x2_nhwc`` launches the kernel for CUDA tensors and runs ``plain``
for CPU tensors; it raises on any other input. ``eligible`` is the
routing: the JAX package's ``pool_pallas_ok`` without its TPU-only
conditions.
'''

import torch

from .. import gates
from . import _build

launches = 0  # kernel launches in this process


def plain(x):
    '''Plain PyTorch version: the JAX package's pairwise tree, NHWC.'''
    m = torch.maximum(x[:, 0::2], x[:, 1::2])           # row pairs
    return torch.maximum(m[:, :, 0::2], m[:, :, 1::2])  # column pairs


def eligible(shape, rate, data_format, dtype):
    '''Whether a max pool routes to this kernel: the ``pallas_pool`` gate,
    NHWC f32, rate 2, H and W even and C % 128 == 0.'''
    if not gates.enabled('pallas_pool'):
        return False
    if data_format != 'NHWC' or rate != 2 or dtype != torch.float32:
        return False
    _, h, w, c = shape
    return h % 2 == 0 and w % 2 == 0 and c % 128 == 0 and w >= 2


def check(x):
    if x.dim() != 4 or x.numel() == 0 or x.shape[1] % 2 or x.shape[2] % 2 \
            or x.shape[3] % 4:
        raise ValueError(f'pool2x2_nhwc needs a non-empty [B, H, W, C] tensor '
                         f'with H and W even and C % 4 == 0, got '
                         f'{tuple(x.shape)}')


def pool2x2_nhwc(x):
    global launches
    check(x)
    if x.device.type == 'cpu':
        return plain(x)
    device = _build.check_cuda_f32(x=x)
    if x.data_ptr() % 16:
        raise ValueError('pool2x2_nhwc reads x as float4: it must be 16-byte '
                         'aligned')
    b, h2, w2, c = x.shape
    out = torch.empty((b, h2 // 2, w2 // 2, c), device=device,
                      dtype=torch.float32)
    _build.launch('dnnca_pool2x2_nhwc', x.data_ptr(), out.data_ptr(), b,
                  h2 // 2, w2 // 2, c, device.index, _build.stream_of(device))
    launches += 1
    return out
