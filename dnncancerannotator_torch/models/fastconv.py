'''Convolution modules and the chain routing (counterpart of
dnncancerannotator_tpu.models.fastconv).

Where the JAX package routes a convolution to a Pallas kernel, the port
runs one of its CUDA kernels (ops/kernels) on the card, or its plain
PyTorch version on the CPU, forward and backward (the autograd Functions of
ops/functions.py):

- ``Conv2DFast``: NCHW stride-1 convs with at most 32 channels and kh *
  kw * Ci * Co <= 1024 -> stencil_conv; NHWC stride-1 convs with at most 32 channels, a string
  padding and kh * kw * Ci * Co <= 1024 -> stencil_conv_nhwc (the JAX
  package's ``small`` convs that reach ``stencil_conv2d_pallas`` with
  ``nchw=False``: MulmoUNet's first conv of each encoder and its head);
- ``ConvTranspose2DFast``: kernel == stride == 2 -> tconv2x2 (NCHW, at most
  64 channels), or tconv2x2_nhwc (NHWC where its gate and eligibility hold,
  ops/kernels/tconv2x2_nhwc.py);
- ``chain_ok``: which ConvChain cells run whole through conv_chain.

Inside ``gates.library_only()`` none of these routes is taken: every conv
and transposed conv is the library call below.

Under ``deploy_options.spatial_partition`` (parallel/mesh.py) a SAME conv
with a kernel taller than one row runs, on whichever route, on its rank's
slab: its rows plus (kh - 1) // 2 rows of the rank above and kh - 1 - (kh
- 1) // 2 of the rank below, exchanged, and keeps its own rows; a 1x1 conv
and a transposed conv (2x2, stride 2, on whole blocks) stay on the rank's
rows.

Wider convs, strided convs and transposed convs of another kernel than
2x2 / stride 2 are plain ``F.conv2d`` / ``F.conv_transpose2d``, as the JAX
package leaves them to XLA or to its einsum forms (``lax.conv_general_dilated``,
``_stencil_conv2d_raw``, ``lax.conv_transpose``,
``stencil_conv_transpose2d``; no Pallas kernel); an NHWC tensor goes in as
its ``channels_last`` NCHW view, with no copy. A strided conv takes the JAX
package's geometry (``conv_geometry``: SAME pads of ``(out - 1) * s + k -
h`` split with the smaller half on top). Where a geometry leaves a conv or
transposed conv an empty plane (a pool of fewer rows than its rate), the
port gives what the JAX package gives: an empty output, or for a wide
transposed conv ``lax.conv_transpose``'s ``rate - 1`` rows of bias, and it
raises where the JAX package's small strided conv raises (a negative slice
limit).

``Conv2DFast`` also takes a tuple of NHWC parts, the conv of their channel
concat, computed as the split-kernel sum conv(a, k[:, :ca]) + conv(b,
k[:, ca:]) without the concat, then bias, then relu (fastconv.py:343-389).

Parameters use PyTorch layouts: ``weight`` [Co, Ci, kh, kw] for convs and
[Ci, Co, kh, kw] for transposed convs; convert.py carries flax checkpoints
across.

Compute dtype (``dtype``; None takes the input's, as flax's ``self.dtype or
x.dtype``): the parameters stay f32, and a module casts its input, weight
and bias to the dtype where the JAX module does (fastconv.py:360-362,
:284, :388, :452-456). Under bfloat16 a library conv or transposed conv
returns bf16 and its bias is added in bf16 after the rounding; the kernels
take their bf16 forms (f32 accumulation, the output rounded once), and the
kernel gates read the dtype as the JAX gates do: the NHWC and NCHW
transposed-conv kernels are f32 only, the stencil conv takes any dtype,
and a chain runs whole in bf16 only where the JAX stencil chain takes it
(``chain_ok``).
'''

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import functions, gates
from ..ops.kernels import conv_chain_bwd as conv_chain_bwd_mod
from ..ops.kernels import stencil_conv as stencil_mod
from ..ops.kernels import stencil_conv_nhwc as stencil_nhwc_mod
from ..ops.kernels import tconv2x2 as tconv_mod
from ..ops.kernels import tconv2x2_nhwc as tconv_nhwc_mod
from ..parallel import mesh

# the JAX package's small-conv bound (fastconv._SMALL_CHANNEL_LIMIT): its
# small convs and transposed convs take its einsum forms, the others XLA's
SMALL_CHANNELS = 32
# the JAX stencil chain's unroll bound (conv_kernel.chain_supported): K * K
# * Ci * Cm and K * K * Cm * Co terms at most
CHAIN_TERMS = 1024
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'bf16': torch.bfloat16}


def resolve_dtype(dtype):
    '''The torch dtype of a compute dtype option (a torch dtype, its name,
    or None for the input's own).'''
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f'dtype must be float32 or bfloat16, got {dtype!r}')
    return _DTYPES[str(dtype)]


def conv_geometry(h, w, kh, kw, strides, padding):
    '''(((top, bottom), (left, right)), out_h, out_w) of a conv with SAME
    or VALID padding at any stride (the JAX package's ``_conv_geometry``):
    SAME gives ceil(h / s) rows and pads ``max((out - 1) * s + kh - h, 0)``
    rows, the smaller half on top (at stride 1: kh - 1 rows, the odd one
    at the bottom, as XLA pads); VALID pads nothing and gives ``(h - kh)
    // s + 1`` rows, which is below 1 where the input is smaller than the
    kernel.'''
    (sy, sx), mode = strides, padding.upper()
    if mode == 'VALID':
        return ((0, 0), (0, 0)), (h - kh) // sy + 1, (w - kw) // sx + 1
    if mode != 'SAME':
        raise ValueError(f'padding must be SAME or VALID, got {padding!r}')
    out_h, out_w = -(-h // sy), -(-w // sx)
    pad_h = max((out_h - 1) * sy + kh - h, 0)
    pad_w = max((out_w - 1) * sx + kw - w, 0)
    return (((pad_h // 2, pad_h - pad_h // 2),
             (pad_w // 2, pad_w - pad_w // 2)), out_h, out_w)


def small(ci, co):
    '''Whether the JAX package takes its small-channel einsum forms for a
    conv or transposed conv of ``ci`` -> ``co`` channels.'''
    return ci <= SMALL_CHANNELS and co <= SMALL_CHANNELS


def _glorot_uniform_(weight, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


def _nchw(x):
    '''The NCHW view of an NHWC tensor (channels_last, no copy).'''
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def plain_tconv(x, w, b):
    '''F.conv_transpose2d of an NCHW (view) tensor with kernel == stride
    (the weight's [kh, kw]) plus its bias: fused in f32 (and f64), and in
    bf16 added after the output's rounding, in bf16, as the JAX modules add
    it.'''
    stride = tuple(w.shape[2:])
    if x.dtype == torch.bfloat16:
        return (F.conv_transpose2d(x, w, stride=stride)
                + b.reshape(1, -1, 1, 1))
    return F.conv_transpose2d(x, w, b, stride=stride)


def _empty_conv(x, b, out_h, out_w, relu):
    '''The output of a conv whose geometry leaves no output pixel, or no
    input pixel: [B, Co, out_h, out_w] (an NCHW view) of the bias alone,
    as XLA gives it.'''
    out = b.reshape(1, -1, 1, 1).expand(x.shape[0], -1, out_h, out_w)
    return F.relu(out) if relu else out.clone()


def _plain_conv(x, w, pads, strides=(1, 1)):
    '''F.conv2d of an NCHW (view) tensor with explicit pads, no bias.'''
    (pt, pb), (pl, pr) = pads
    if (pt, pl) == (pb, pr):
        return F.conv2d(x, w, stride=strides, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, stride=strides)


class Conv2DFast(nn.Module):
    '''Conv2D with optional fused relu: at stride 1 and small channel
    counts the stencil_conv kernel (NCHW) or the stencil_conv_nhwc kernel
    (NHWC, where ``stencil_conv_nhwc.eligible``), plain F.conv2d otherwise
    (``_library`` for a strided conv or an empty plane).
    ``activation='relu'`` applies the relu after the bias; callers that
    pass it must not apply it again. In NHWC the input may be a tuple of
    parts (see the module docstring); a tuple that routes to the kernel is
    concatenated first, as the JAX package does.'''

    def __init__(self, in_channels, features, kernel_size, strides=(1, 1),
                 padding='SAME', activation=None, data_format='NCHW',
                 dtype=None, generator=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        if activation not in (None, 'relu'):
            raise ValueError(f'Conv2DFast fuses only relu, got {activation}')
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.relu = activation == 'relu'
        self.data_format = data_format
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        co, ci, kh, kw = self.weight.shape
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        dtype = self.dtype or parts[0].dtype
        parts = tuple(part.to(dtype) for part in parts)
        h, wd = parts[0].shape[1:3] if self.data_format == 'NHWC' \
            else parts[0].shape[2:]
        geometry = conv_geometry(h, wd, kh, kw, self.strides, self.padding)
        pads, out_h, out_w = geometry
        if self.strides != (1, 1) or min(h, wd, out_h, out_w) <= 0:
            return self._library(parts, h, wd, *geometry)
        if kh > 1 and self.padding.upper() != 'SAME':
            mesh.check_whole(f'a {self.padding} {kh}x{kw} conv')
        # under spatial_partition: on this rank's slab of the SAME pads
        return mesh.on_slab(lambda *slabs: self._conv(slabs, pads),
                            parts, *pads[0],
                            1 if self.data_format == 'NHWC' else 2)

    def _conv(self, parts, pads):
        co, ci, kh, kw = self.weight.shape
        nhwc = self.data_format == 'NHWC'
        w, b = self.weight.to(parts[0].dtype), self.bias.to(parts[0].dtype)
        kernel = not gates.forced_off()
        if kernel and not nhwc and stencil_mod.eligible(ci, co, kh, kw):
            return functions.stencil_conv(parts[0], w, b, pads, self.relu)
        if kernel and nhwc and stencil_nhwc_mod.eligible(ci, co, kh, kw,
                                                         self.padding):
            x = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
            return functions.stencil_conv_nhwc(x, w, b, pads, self.relu)
        return self._plain(parts, w, b, pads)

    def _plain(self, parts, w, b, pads, strides=(1, 1)):
        '''The library conv: the split-kernel sum over the parts, then the
        bias, then the relu.'''
        nhwc = self.data_format == 'NHWC'
        out, off = None, 0
        for part in parts:
            c = part.shape[-1] if nhwc else part.shape[1]
            y = _plain_conv(_nchw(part) if nhwc else part,
                            w[:, off:off + c], pads, strides)
            out = y if out is None else out + y
            off += c
        out = out + b.reshape(1, -1, 1, 1)
        if self.relu:
            out = F.relu(out)
        return _nhwc(out) if nhwc else out

    def _library(self, parts, h, wd, pads, out_h, out_w):
        '''A strided conv, or one with no input or output pixel: no
        kernel, as in the JAX package (``_stencil_conv2d_raw`` for a small
        conv, which takes a tuple's concat, else
        ``lax.conv_general_dilated`` part by part), with its degenerate
        shapes.'''
        co, ci, kh, kw = self.weight.shape
        nhwc = self.data_format == 'NHWC'
        if kh > 1 or self.strides != (1, 1):
            mesh.check_whole(f'a stride {self.strides} {self.padding} '
                             f'{kh}x{kw} conv')
        w, b = self.weight.to(parts[0].dtype), self.bias.to(parts[0].dtype)
        if small(ci, co):
            # the JAX einsum form slices rows dy .. dy + (out - 1) * s + 1,
            # which lax.slice refuses below 0
            (sy, sx) = self.strides
            if min((out_h - 1) * sy + 1, (out_w - 1) * sx + 1) < 0:
                raise ValueError(
                    f'Conv2DFast: a {kh}x{kw} stride {self.strides} '
                    f'{self.padding} conv of a {h}x{wd} plane has {out_h}x'
                    f'{out_w} output pixels')
            if len(parts) > 1:
                parts = (torch.cat(parts, -1 if nhwc else 1),)
        out_h, out_w = max(out_h, 0), max(out_w, 0)
        if min(h, wd, out_h, out_w) == 0:
            out = _empty_conv(parts[0], b, out_h, out_w, self.relu)
            return _nhwc(out) if nhwc else out
        return self._plain(parts, w, b, pads, self.strides)


class ConvTranspose2DFast(nn.Module):
    '''ConvTranspose for the kernel == stride upsampling case (SAME and
    VALID agree when kernel == stride), NCHW or NHWC: the 2x2 / stride-2
    kernels where they take the call, else ``plain_tconv``.'''

    def __init__(self, in_channels, features, kernel_size, strides,
                 data_format='NCHW', dtype=None, generator=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        kh, kw = kernel_size
        if tuple(kernel_size) != tuple(strides):
            raise ValueError(f'ConvTranspose2DFast takes kernel == stride, '
                             f'got kernel {kernel_size} stride {strides}')
        self.data_format = data_format
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        ci, co, kh, kw = self.weight.shape
        dtype = self.dtype or x.dtype
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if x.numel() == 0 or (kh, kw) != (2, 2):
            return self._library(x, w, b)
        if self.data_format == 'NHWC':
            # the gate reads the module's dtype, as tconv_pallas_ok does
            if tconv_nhwc_mod.eligible(x.shape, (2, 2), (2, 2), co, 'NHWC',
                                       dtype):
                return functions.tconv2x2_nhwc(x.contiguous(), w, b)
            return _nhwc(plain_tconv(_nchw(x), w, b))
        # f32 only, as tconv_flat_ok (f64 stands for f32 in the checks)
        if tconv_mod.supported(ci, co) and dtype != torch.bfloat16 \
                and not gates.forced_off():
            return functions.tconv2x2(x, w, b)
        return plain_tconv(x, w, b)

    def _library(self, x, w, b):
        '''``plain_tconv``, as the JAX package computes a transposed conv of
        another kernel than 2x2 (``stencil_conv_transpose2d``, or
        ``lax.conv_transpose`` past SMALL_CHANNELS); on an empty plane a
        small one gives an empty output and a wide one what
        ``lax.conv_transpose`` gives: ``rate - 1`` rows (columns) of bias
        where the input has none.'''
        ci, co, kh, kw = self.weight.shape
        nhwc = self.data_format == 'NHWC'
        xc = _nchw(x) if nhwc else x
        if xc.numel() == 0:
            h, wd = xc.shape[2:]
            if small(ci, co):
                out_h, out_w = h * kh, wd * kw
            else:
                out_h, out_w = h * kh or kh - 1, wd * kw or kw - 1
            out = _empty_conv(xc, b, out_h, out_w, False)
        else:
            out = plain_tconv(xc, w, b)
        return _nhwc(out) if nhwc else out


def chain_ok(ci, filters, kernel_size, padding, dtype=None):
    '''Whether a relu ConvChain cell (two stride-1 convs, no BN) runs as one
    conv_chain kernel: SAME padding with an odd kernel (size-preserving,
    symmetric pads) and channels within the bounds of the chain kernel and
    its backward. In f32 this one test covers both JAX chain kernels (the
    scalar stencil chain and the "flatland" chain), which the port folds
    into one kernel. The flat chain is f32 only (flatchain.py:475), so in
    bf16 a chain also needs the stencil chain's unroll bound, K * K * Ci *
    Cm and K * K * Cm * Co at most CHAIN_TERMS (conv_kernel.py:319-330; its
    VMEM bound is a TPU limit and is not kept); the others run conv by
    conv, each rounded to bf16.'''
    k = int(kernel_size)
    if (resolve_dtype(dtype) == torch.bfloat16
            and k * k * filters * max(ci, filters) > CHAIN_TERMS):
        return False
    return (isinstance(padding, str) and padding.upper() == 'SAME'
            and conv_chain_bwd_mod.supported(ci, filters, filters, k))
