'''U-Net building blocks, NCHW, forward only (counterpart of
dnncancerannotator_tpu.models.blocks).

- ``Downsample``: conv chain -> (skip, max-pooled);
- ``Upsample``: 2x2 tconv -> center-crop the skip to the upsampled size ->
  channel concat ``[up, skip]`` -> conv chain;
- ``Encoder``: ``n_downsample`` Downsample blocks, filters scaled by
  ``rate`` per level (``int(rate * filters)``);
- ``Decoder``: Upsample blocks over the reversed skips, each with the skip's
  channel count as its filters.

Submodules carry the flax names (``down_0``, ``convchain``, ``conv_0``,
``tconv``, ...) so a state_dict key is the flax parameter path with dots.
BatchNorm is not ported yet.
'''

import collections.abc
import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pooling
from ..ops.kernels import conv_chain as conv_chain_mod
from . import fastconv

_BN_NOT_PORTED = 'BatchNorm is not ported yet (ROADMAP.md queue 2)'


def solve_activation(identifier):
    '''Resolve an activation spec: callable, name string, or Keras-style
    dict (``{'class_name': 'LeakyReLU', 'config': {'alpha': 0.3}}``).'''
    if identifier is None:
        return lambda x: x
    if callable(identifier):
        return identifier
    if isinstance(identifier, str):
        table = {
            'relu': F.relu,
            'sigmoid': torch.sigmoid,
            'tanh': torch.tanh,
            'gelu': functools.partial(F.gelu, approximate='tanh'),
            'elu': F.elu,
            'selu': F.selu,
            'softplus': F.softplus,
            'leaky_relu': F.leaky_relu,
            'leakyrelu': F.leaky_relu,
            'linear': lambda x: x,
            'none': lambda x: x,
        }
        name = identifier.lower()
        if name not in table:
            raise ValueError(f'Failed to resolve activation: {identifier}')
        return table[name]
    if isinstance(identifier, collections.abc.Mapping):
        class_name = identifier.get('class_name')
        config = dict(identifier.get('config', {}) or {})
        if class_name in ('LeakyReLU', 'leaky_relu'):
            alpha = config.get('alpha', config.get('negative_slope', 0.3))
            return functools.partial(F.leaky_relu, negative_slope=alpha)
        if class_name in ('ReLU', 'relu'):
            return F.relu
        if class_name in ('ELU', 'elu'):
            return functools.partial(F.elu, alpha=config.get('alpha', 1.0))
    raise ValueError(f'Failed to resolve activation: {identifier}')


def center_crop_to(x, target_h, target_w):
    '''Center-crop an NCHW tensor spatially to (target_h, target_w).'''
    h, w = x.shape[2], x.shape[3]
    top = (h - target_h) // 2
    left = (w - target_w) // 2
    return x[:, :, top:top + target_h, left:left + target_w]


class ConvChain(nn.Module):
    '''``n_conv`` stacked convs. A relu chain of two stride-1 SAME convs
    runs whole as one conv_chain kernel; otherwise each conv runs on its
    own. The parameters are the same either way.'''

    def __init__(self, in_channels, filters, kernel_size, conv_stride, bn,
                 n_conv=2, padding='VALID', activation='relu',
                 generator=None):
        super().__init__()
        if bn:
            raise NotImplementedError(_BN_NOT_PORTED)
        self.fuse_relu = activation in ('relu', 'ReLU')
        self.act = None if self.fuse_relu else solve_activation(activation)
        self.fused = (self.fuse_relu and n_conv == 2 and conv_stride == 1
                      and fastconv.chain_ok(in_channels, filters,
                                            kernel_size, padding))
        ci = in_channels
        for i in range(n_conv):
            self.add_module(f'conv_{i}', fastconv.Conv2DFast(
                ci, filters, (kernel_size, kernel_size),
                strides=(conv_stride, conv_stride), padding=padding,
                activation='relu' if self.fuse_relu else None,
                generator=generator))
            ci = filters
        self.n_conv = n_conv

    def forward(self, x):
        if self.fused:
            _, c2 = conv_chain_mod.conv_chain(
                x, self.conv_0.weight, self.conv_0.bias,
                self.conv_1.weight, self.conv_1.bias)
            return c2
        for i in range(self.n_conv):
            x = getattr(self, f'conv_{i}')(x)
            if self.act is not None:
                x = self.act(x)
        return x


class Downsample(nn.Module):
    '''Downsampling block: conv chain -> (skip, max-pooled).'''

    def __init__(self, in_channels, filters, rate, kernel_size, conv_stride,
                 bn, n_conv=2, padding='VALID', activation='relu',
                 generator=None):
        super().__init__()
        self.rate = rate
        self.convchain = ConvChain(
            in_channels, filters, kernel_size, conv_stride, bn,
            n_conv=n_conv, padding=padding, activation=activation,
            generator=generator)

    def forward(self, x):
        conv = self.convchain(x)
        return conv, pooling.max_pool2d(conv, self.rate)


class Upsample(nn.Module):
    '''Upsampling block: tconv -> center-crop skip -> concat -> conv chain.'''

    def __init__(self, in_channels, filters, rate, kernel_size, conv_stride,
                 bn, n_conv=2, padding='VALID', activation='relu',
                 generator=None):
        super().__init__()
        if bn:
            raise NotImplementedError(_BN_NOT_PORTED)
        self.tconv = fastconv.ConvTranspose2DFast(
            in_channels, filters, (rate, rate), (rate, rate),
            generator=generator)
        # the chain sees [up, skip]: the up channels come first
        self.convchain = ConvChain(
            2 * filters, filters, kernel_size, conv_stride, bn,
            n_conv=n_conv, padding=padding, activation=activation,
            generator=generator)

    def forward(self, x, reference):
        up = self.tconv(x)
        cropped = center_crop_to(reference, up.shape[2], up.shape[3])
        return self.convchain(torch.cat([up, cropped], dim=1))


class Encoder(nn.Module):
    '''Chain of Downsample blocks; filters scale by ``rate`` per level.'''

    def __init__(self, in_channels, filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn, n_conv=2, padding='VALID',
                 activation='relu', generator=None):
        super().__init__()
        self.n_downsample = n_downsample
        self.skip_channels = []
        ci, filters = in_channels, filters_first
        for i in range(n_downsample):
            self.add_module(f'down_{i}', Downsample(
                ci, filters, rate, kernel_size, conv_stride, bn,
                n_conv=n_conv, padding=padding, activation=activation,
                generator=generator))
            self.skip_channels.append(filters)
            ci = filters
            filters = int(rate * filters)

    def forward(self, x):
        skips = []
        for i in range(self.n_downsample):
            skip, x = getattr(self, f'down_{i}')(x)
            skips.append(skip)
        return skips, x


class Decoder(nn.Module):
    '''Chain of Upsample blocks driven by the reversed skip list.'''

    def __init__(self, in_channels, skip_channels, rate, kernel_size,
                 conv_stride, bn, n_conv=2, padding='VALID',
                 activation='relu', generator=None):
        super().__init__()
        self.n_up = len(skip_channels)
        ci = in_channels
        for i, filters in enumerate(reversed(skip_channels)):
            self.add_module(f'up_{i}', Upsample(
                ci, filters, rate, kernel_size, conv_stride, bn,
                n_conv=n_conv, padding=padding, activation=activation,
                generator=generator))
            ci = filters

    def forward(self, x, skips):
        for i, skip in enumerate(reversed(skips)):
            x = getattr(self, f'up_{i}')(x, skip)
        return x
