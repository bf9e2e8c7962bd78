'''Convolution modules and the chain routing (counterpart of
dnncancerannotator_tpu.models.fastconv).

Where the JAX package routes a convolution to a Pallas kernel, the port
runs one of its CUDA kernels (ops/kernels) on the card, or its plain
PyTorch version on the CPU, forward and backward (the autograd Functions of
ops/functions.py):

- ``Conv2DFast``: NCHW stride-1 convs with at most 32 channels ->
  stencil_conv;
- ``ConvTranspose2DFast``: kernel == stride == 2 -> tconv2x2 (NCHW, at most
  64 channels), or tconv2x2_nhwc (NHWC where its gate and eligibility hold,
  ops/kernels/tconv2x2_nhwc.py);
- ``chain_ok``: which ConvChain cells run whole through conv_chain.

Wider convs and transposed convs are plain ``F.conv2d`` /
``F.conv_transpose2d``, as the JAX package leaves them to XLA
(``lax.conv_general_dilated``, ``lax.conv_transpose``); an NHWC tensor goes
in as its ``channels_last`` NCHW view, with no copy. Strided convs belong to
a model the port does not run yet and raise NotImplementedError.

``Conv2DFast`` also takes a tuple of NHWC parts, the conv of their channel
concat, computed as the split-kernel sum conv(a, k[:, :ca]) + conv(b,
k[:, ca:]) without the concat, then bias, then relu (fastconv.py:343-389).

Parameters use PyTorch layouts: ``weight`` [Co, Ci, kh, kw] for convs and
[Ci, Co, kh, kw] for transposed convs; convert.py carries flax checkpoints
across.
'''

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import functions
from ..ops.kernels import conv_chain_bwd as conv_chain_bwd_mod
from ..ops.kernels import stencil_conv_bwd as stencil_bwd_mod
from ..ops.kernels import tconv2x2 as tconv_mod
from ..ops.kernels import tconv2x2_nhwc as tconv_nhwc_mod

_NOT_PORTED = ('not ported yet (ROADMAP.md queue 2: the strided convs of '
               'MultiResUnet)')


def same_or_valid_pads(kh, kw, padding):
    '''((top, bottom), (left, right)) pads of a stride-1 conv with SAME or
    VALID padding (SAME puts the odd pixel at the bottom/right, as XLA
    does).'''
    mode = padding.upper()
    if mode == 'VALID':
        return ((0, 0), (0, 0))
    if mode != 'SAME':
        raise ValueError(f'padding must be SAME or VALID, got {padding!r}')
    return (((kh - 1) // 2, kh - 1 - (kh - 1) // 2),
            ((kw - 1) // 2, kw - 1 - (kw - 1) // 2))


def _glorot_uniform_(weight, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


def _nchw(x):
    '''The NCHW view of an NHWC tensor (channels_last, no copy).'''
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _plain_conv(x, w, pads):
    '''F.conv2d of an NCHW (view) tensor with explicit pads, no bias.'''
    (pt, pb), (pl, pr) = pads
    if (pt, pl) == (pb, pr):
        return F.conv2d(x, w, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w)


class Conv2DFast(nn.Module):
    '''Conv2D with optional fused relu: in NCHW the stencil_conv kernel at
    small channel counts, plain F.conv2d otherwise (every conv of the
    BatchNorm models the port runs, which are NHWC, is wider than the
    kernel takes). ``activation='relu'`` applies the relu after the bias;
    callers that pass it must not apply it again. In NHWC the input may be a
    tuple of parts (see the module docstring).'''

    def __init__(self, in_channels, features, kernel_size, strides=(1, 1),
                 padding='SAME', activation=None, data_format='NCHW',
                 generator=None):
        super().__init__()
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
        if self.strides != (1, 1):
            raise NotImplementedError(
                f'Conv2DFast stride {self.strides}: ' + _NOT_PORTED)
        pads = same_or_valid_pads(kh, kw, self.padding)
        nhwc = self.data_format == 'NHWC'
        if not nhwc and stencil_bwd_mod.supported(ci, co, kh, kw):
            return functions.stencil_conv(x, self.weight, self.bias, pads,
                                          self.relu)
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        out, off = None, 0
        for part in parts:
            c = part.shape[-1] if nhwc else part.shape[1]
            y = _plain_conv(_nchw(part) if nhwc else part,
                            self.weight[:, off:off + c], pads)
            out = y if out is None else out + y
            off += c
        out = out + self.bias.reshape(1, -1, 1, 1)
        if self.relu:
            out = F.relu(out)
        return _nhwc(out) if nhwc else out


class ConvTranspose2DFast(nn.Module):
    '''ConvTranspose for the kernel == stride == 2 upsampling case (SAME and
    VALID agree when kernel == stride), NCHW or NHWC.'''

    def __init__(self, in_channels, features, kernel_size, strides,
                 data_format='NCHW', generator=None):
        super().__init__()
        kh, kw = kernel_size
        if (kh, kw) != (2, 2) or tuple(strides) != (2, 2):
            raise NotImplementedError(
                f'ConvTranspose2DFast kernel {kernel_size} stride {strides}: '
                + _NOT_PORTED)
        self.data_format = data_format
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        ci, co = self.weight.shape[:2]
        if self.data_format == 'NHWC':
            if tconv_nhwc_mod.eligible(x.shape, (2, 2), (2, 2), co, 'NHWC',
                                       x.dtype):
                return functions.tconv2x2_nhwc(x.contiguous(), self.weight,
                                               self.bias)
            return _nhwc(F.conv_transpose2d(_nchw(x), self.weight, self.bias,
                                            stride=2))
        if tconv_mod.supported(ci, co):
            return functions.tconv2x2(x, self.weight, self.bias)
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


def chain_ok(ci, filters, kernel_size, padding):
    '''Whether a relu ConvChain cell (two stride-1 convs, no BN) runs as one
    conv_chain kernel: SAME padding with an odd kernel (size-preserving,
    symmetric pads) and channels within the bounds of the chain kernel and
    its backward. This one test
    covers both JAX chain kernels (the scalar stencil chain and the
    "flatland" chain), which the port folds into one kernel.'''
    return (isinstance(padding, str) and padding.upper() == 'SAME'
            and conv_chain_bwd_mod.supported(ci, filters, filters,
                                             int(kernel_size)))
