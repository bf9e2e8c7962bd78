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

bf16 form: x, w and b bf16 (the JAX stencil conv takes bf16, upcasts and
computes in f32; its caller rounds, fastconv.py:182) take the kernels' bf16
entries, which compute from the exact upcast values in the f32 form's
order and round the output to bf16; ``plain`` does the same on the CPU.
'''

import functools

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 32
# conv_kernel.supported: kh * kw * Ci * Co terms unrolled a program
MAX_TERMS = 1024
# the pointwise kernel's offsets inside one batch item are 32-bit
MAX_PLANE_FLOATS = 2**31 - 1
# past this many bytes a call (the H100's 50 MB of L2) the pointwise
# kernel streams its loads (evict-first)
L2_BYTES = 50 * 2**20

launches = 0  # kernel launches in this process
launches_bf16 = 0  # those of the bf16 form


def plain(x, w, b, pads, relu=False):
    '''Plain PyTorch version, in x's dtype (computed in f32 from bf16
    inputs, then rounded).'''
    dtype = x.dtype
    x, w, b = _build.upcast(x, w, b)
    (pt, pb), (pl, pr) = pads
    out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, b)
    return (F.relu(out) if relu else out).to(dtype)


def _smem_bytes(ci, co, kh, kw):
    '''Weights and bias, padded to the kernel's Co bucket
    (csrc/stencil_conv.cu).'''
    width = next(b for b in (1, 4, 8, 16, 32) if co <= b)
    return 4 * (ci * kh * kw + 1) * width


@functools.lru_cache(maxsize=None)
def supported(ci, co, kh, kw):
    return (max(ci, co) <= MAX_CHANNELS
            and _smem_bytes(ci, co, kh, kw) <= _build.MAX_SMEM_BYTES)


def eligible(ci, co, kh, kw):
    '''Whether a stride-1 NCHW conv of Ci -> Co channels with a kh x kw
    kernel routes to this kernel: the JAX package's ``small`` conv that
    reaches ``stencil_conv2d_pallas`` (conv_kernel.supported's unroll
    bound, kh * kw * Ci * Co <= MAX_TERMS; its VMEM bound is a TPU limit
    and is not kept), where the kernel and its backward take it.'''
    from . import stencil_conv_bwd
    return (kh * kw * ci * co <= MAX_TERMS
            and stencil_conv_bwd.supported(ci, co, kh, kw))


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
    global launches, launches_bf16
    pads = _pads(pads)
    oh, ow = check(x, w, b, pads)
    if x.device.type == 'cpu':
        return plain(x, w, b, pads, relu)
    entry, dtype = _build.form('dnnca_stencil_conv', x.dtype)
    device = _build.check_cuda(dtype, x=x, w=w, b=b)
    bsz, ci, h, wd = x.shape
    co, _, kh, kw = w.shape
    out = torch.empty((bsz, co, oh, ow), device=device, dtype=dtype)
    stream = _build.stream_of(device)
    if route(ci, co, kh, kw, pads, h, wd) == 'pointwise':
        size = x.element_size()
        vec = (h * wd) % 4 == 0 and x.data_ptr() % (4 * size) == 0
        streaming = size * (x.numel() + out.numel()) > L2_BYTES
        _build.launch(_build.form('dnnca_pointwise_conv', dtype)[0],
                      x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), out.data_ptr(), bsz, ci, co, h * wd,
                      int(bool(relu)), int(streaming), int(vec),
                      device.index, stream)
    else:
        _build.launch(entry, x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), out.data_ptr(), bsz, ci, co, h, wd, kh,
                      kw, pads[0][0], pads[1][0], oh, ow, int(bool(relu)),
                      device.index, stream)
    if dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out
