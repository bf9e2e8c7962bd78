'''ConvTranspose(kernel=2, stride=2) plus bias, NCHW f32.

The CUDA kernel (csrc/tconv2x2.cu) replaces
flattconv.conv_transpose2x2_flat_nchw of the JAX package and also serves
the upsamples that package computes as a plain einsum. The weight is in
PyTorch's ConvTranspose2d layout [Ci, Co, 2, 2], applied unflipped:

    out[b, co, 2y+dy, 2x+dx] = bias[co] + sum_ci x[b, ci, y, x] w[ci, co, dy, dx]

(convert.py flips the flax HWIO kernel into this layout once).

``tconv2x2`` launches the kernel for CUDA tensors and runs ``plain``
(``F.conv_transpose2d``) for CPU tensors; it raises on any other input.
'''

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 64

launches = 0  # kernel launches in this process


def plain(x, w, b):
    '''Plain PyTorch version.'''
    return F.conv_transpose2d(x, w, b, stride=2)


def supported(ci, co):
    return max(ci, co) <= MAX_CHANNELS


def _check(x, w, b):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {tuple(x.shape)}')
    ci, co = x.shape[1], w.shape[1]
    if tuple(w.shape) != (ci, co, 2, 2) or tuple(b.shape) != (co,):
        raise ValueError(f'tconv2x2 needs w [Ci, Co, 2, 2] and b [Co]; got '
                         f'x {tuple(x.shape)}, w {tuple(w.shape)}, '
                         f'b {tuple(b.shape)}')
    if not supported(ci, co):
        raise ValueError(f'tconv2x2 takes at most {MAX_CHANNELS} channels; '
                         f'got Ci={ci} Co={co}')


def tconv2x2(x, w, b):
    global launches
    _check(x, w, b)
    if x.device.type == 'cpu':
        return plain(x, w, b)
    device = _build.check_cuda_f32(x=x, w=w, b=b)
    if w.data_ptr() % 16:
        raise ValueError('tconv2x2 reads w as float4: it must be 16-byte '
                         'aligned')
    bsz, ci, h, wd = x.shape
    co = w.shape[1]
    out = torch.empty((bsz, co, 2 * h, 2 * wd), device=device,
                      dtype=torch.float32)
    _build.launch('dnnca_tconv2x2', x.data_ptr(), w.data_ptr(), b.data_ptr(),
                  out.data_ptr(), bsz, ci, co, h, wd, device.index,
                  _build.stream_of(device))
    launches += 1
    return out
