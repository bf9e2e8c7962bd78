'''Convolution modules and the chain routing, forward only (counterpart of
dnncancerannotator_tpu.models.fastconv).

Every convolution of the supported models runs through one of the port's
CUDA kernels (ops/kernels) on the card, or its plain PyTorch version on
the CPU:

- ``Conv2DFast``: stride-1 convs with at most 32 channels -> stencil_conv;
- ``ConvTranspose2DFast``: kernel == stride == 2, at most 64 channels ->
  tconv2x2;
- ``chain_ok``: which ConvChain cells run whole through conv_chain.

Shapes outside these bounds (strided convs, wide channels) belong to the
models the port does not run yet and raise NotImplementedError.

Parameters use PyTorch layouts: ``weight`` [Co, Ci, kh, kw] for convs and
[Ci, Co, kh, kw] for transposed convs; convert.py carries flax checkpoints
across.
'''

import math

import torch
from torch import nn

from ..ops.kernels import conv_chain as conv_chain_mod
from ..ops.kernels import stencil_conv as stencil_mod
from ..ops.kernels import tconv2x2 as tconv_mod

_NOT_PORTED = ('not ported yet (ROADMAP.md queue 2: the wide-channel and '
               'strided convs of unet_big / MultiResUnet)')


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


class Conv2DFast(nn.Module):
    '''Conv2D (NCHW) with optional fused relu, run by the stencil_conv
    kernel. ``activation='relu'`` applies the relu after the bias; callers
    that pass it must not apply it again.'''

    def __init__(self, in_channels, features, kernel_size, strides=(1, 1),
                 padding='SAME', activation=None, generator=None):
        super().__init__()
        if activation not in (None, 'relu'):
            raise ValueError(f'Conv2DFast fuses only relu, got {activation}')
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.relu = activation == 'relu'
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        co, ci, kh, kw = self.weight.shape
        if self.strides != (1, 1) or not stencil_mod.supported(
                ci, co, kh, kw):
            raise NotImplementedError(
                f'Conv2DFast stride {self.strides}, {ci}->{co} channels: '
                + _NOT_PORTED)
        pads = same_or_valid_pads(kh, kw, self.padding)
        return stencil_mod.stencil_conv(x, self.weight, self.bias, pads,
                                        self.relu)


class ConvTranspose2DFast(nn.Module):
    '''ConvTranspose for the kernel == stride == 2 upsampling case, run by
    the tconv2x2 kernel (SAME and VALID agree when kernel == stride).'''

    def __init__(self, in_channels, features, kernel_size, strides,
                 generator=None):
        super().__init__()
        kh, kw = kernel_size
        if (kh, kw) != (2, 2) or tuple(strides) != (2, 2):
            raise NotImplementedError(
                f'ConvTranspose2DFast kernel {kernel_size} stride {strides}: '
                + _NOT_PORTED)
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        ci, co = self.weight.shape[:2]
        if not tconv_mod.supported(ci, co):
            raise NotImplementedError(
                f'ConvTranspose2DFast {ci}->{co} channels: ' + _NOT_PORTED)
        return tconv_mod.tconv2x2(x, self.weight, self.bias)


def chain_ok(ci, filters, kernel_size, padding):
    '''Whether a relu ConvChain cell (two stride-1 convs, no BN) runs as one
    conv_chain kernel: SAME padding with an odd kernel (size-preserving,
    symmetric pads) and channels within the kernel's bounds. This one test
    covers both JAX chain kernels (the scalar stencil chain and the
    "flatland" chain), which the port folds into one kernel.'''
    return (isinstance(padding, str) and padding.upper() == 'SAME'
            and conv_chain_mod.supported(ci, filters, filters,
                                         int(kernel_size)))
