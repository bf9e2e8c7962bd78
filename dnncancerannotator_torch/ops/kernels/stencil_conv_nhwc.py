'''Stride-1 conv with explicit pads, bias and an optional fused relu, NHWC
f32, small channels: the NHWC form of stencil_conv (ops/kernels/
stencil_conv.py).

The CUDA kernel (csrc/stencil_conv.cu, entry ``dnnca_stencil_conv_nhwc``)
replaces conv_kernel.stencil_conv2d_pallas of the JAX package with
``nchw=False``. x is [B, H, W, Ci]; its channels must be contiguous, but
its pixels may lie further apart than Ci floats: a channel slice
``x[..., i:i + 1]`` of a batch (MulmoUNet's per-channel encoders) is read
in place. The weight is PyTorch OIHW [Co, Ci, KH, KW]; ``pads`` is ((top,
bottom), (left, right)) as in the JAX package. The output is a contiguous
[B, OH, OW, Co].

``eligible`` is the routing: the JAX package's ``small`` conv
(fastconv.py:365-372) and the unroll bound of ``conv_kernel.supported``
(kh * kw * Ci * Co <= 1024). ``supported``'s per-program VMEM bound is not
kept: it is the TPU kernel's whole padded image a program in VMEM, and
this kernel keeps no image resident (one thread an output pixel).

``stencil_conv_nhwc`` launches the kernel for CUDA tensors and runs
``plain`` (``F.conv2d`` on the padded NCHW view) for CPU tensors; it raises
on any other input. Its backward is the plain version's gradient, the
library's conv backward (ops/functions.py): at these shapes the JAX package
computes that backward in XLA too (the Pallas backward's per-program bound
is over its VMEM limit there).

bf16 form: x, w and b bf16 take the kernel's bf16 entry (computed in f32
from the exact upcast values in the f32 form's order, the output rounded to
bf16), and ``plain`` does the same on the CPU; ``grads`` then runs the
library's conv backward in bf16, as XLA's in the JAX package (f32
accumulation, bf16 results).
'''

import torch
import torch.nn.functional as F

from . import _build
from . import stencil_conv as nchw

MAX_CHANNELS = nchw.MAX_CHANNELS
MAX_TERMS = nchw.MAX_TERMS

launches = 0  # kernel launches in this process
launches_bf16 = 0  # those of the bf16 form


def plain(x, w, b, pads, relu=False):
    '''Plain PyTorch version: NHWC in, an NHWC view out.'''
    out = nchw.plain(x.permute(0, 3, 1, 2), w, b, pads, relu)
    return out.permute(0, 2, 3, 1)


def eligible(ci, co, kh, kw, padding):
    '''Whether an NHWC stride-1 conv of Ci -> Co channels with a kh x kw
    kernel and ``padding`` routes to this kernel.'''
    return (ci <= MAX_CHANNELS and co <= MAX_CHANNELS
            and isinstance(padding, str)
            and kh * kw * ci * co <= MAX_TERMS)


def pixel_stride(x):
    '''Floats between neighbouring pixels of x [B, H, W, C] whose channels
    are contiguous and whose pixels are evenly spaced (a contiguous tensor,
    or a channel slice of one); raises otherwise.'''
    _, h, w, c = x.shape
    xs = x.stride(2)
    if ((c > 1 and x.stride(3) != 1) or xs < c or x.stride(1) != w * xs
            or x.stride(0) != h * w * xs):
        raise ValueError(f'stencil_conv_nhwc needs x with contiguous channels '
                         f'and evenly spaced pixels; got shape '
                         f'{tuple(x.shape)}, strides {tuple(x.stride())}')
    return xs


def check(x, w, b, pads):
    '''(OH, OW, pixel stride of x); raises on what the kernel does not
    take.'''
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, H, W, C] tensor, '
                         f'got {tuple(x.shape)}')
    nchw_shape = (x.shape[0], x.shape[3], x.shape[1], x.shape[2])
    oh, ow = nchw.out_hw(nchw_shape, tuple(w.shape), tuple(b.shape),
                         nchw._pads(pads))
    return oh, ow, pixel_stride(x)


def stencil_conv_nhwc(x, w, b, pads, relu=False):
    global launches, launches_bf16
    pads = nchw._pads(pads)
    oh, ow, xs = check(x, w, b, pads)
    if x.device.type == 'cpu':
        return plain(x, w, b, pads, relu)
    entry, dtype = _build.form('dnnca_stencil_conv_nhwc', x.dtype)
    device = _build.check_cuda(dtype, w=w, b=b)
    if not x.is_cuda or x.device != device:
        raise ValueError(f'x must be a CUDA tensor on {device}, got '
                         f'{x.dtype} on {x.device}')
    bsz, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    out = torch.empty((bsz, oh, ow, co), device=device, dtype=dtype)
    vec_in = (ci % 4 == 0 and xs % 4 == 0
              and x.data_ptr() % (4 * x.element_size()) == 0)
    _build.launch(entry, x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), out.data_ptr(), bsz, ci, co, h, wd, xs, kh,
                  kw, pads[0][0], pads[1][0], oh, ow, int(bool(relu)),
                  int(vec_in), device.index, _build.stream_of(device))
    if dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def grads(x, g, w, pads, need_dx=True):
    '''(dx or None, dw, db) of the conv at x [B, H, W, Ci] for the
    cotangent g [B, OH, OW, Co] of its output (after any relu mask): the
    library's conv backward on the NCHW views, the padded input where the
    pads are not symmetric.'''
    (pt, pb), (pl, pr) = nchw._pads(pads)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    sym = (pt, pl) == (pb, pr)
    if not sym:
        xn = F.pad(xn, (pl, pr, pt, pb))
    dx, dw, db = torch.ops.aten.convolution_backward(
        gn, xn, w, [w.shape[0]], [1, 1], [pt, pl] if sym else [0, 0],
        [1, 1], False, [0, 0], 1, [need_dx, True, True])
    if dx is not None:
        if not sym:
            dx = dx[:, :, pt:dx.shape[2] - pb, pl:dx.shape[3] - pr]
        dx = dx.permute(0, 2, 3, 1)
    return dx, dw, db
