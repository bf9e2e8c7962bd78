'''U-Net building blocks, NCHW or NHWC (counterpart of
dnncancerannotator_tpu.models.blocks). Gradients flow through the kernels'
autograd Functions (ops/functions.py); the skip crop and concat are plain
autograd.

- ``ConvChain``: ``n_conv`` convs, each ``conv -> relu [-> bn_i]``;
- ``Downsample``: conv chain -> (skip, max-pooled [-> pool_bn]);
- ``Upsample``: 2x2 tconv [-> tconv_bn] -> center-crop the skip to the
  upsampled size -> ``[up, skip]`` (a channel concat in NCHW, a tuple the
  first conv takes part by part in NHWC) -> conv chain;
- ``Encoder``: ``n_downsample`` Downsample blocks, filters scaled by
  ``rate`` per level (``int(rate * filters)``);
- ``Decoder``: Upsample blocks over the reversed skips, each with the skip's
  channel count as its filters.

Submodules carry the flax names (``down_0``, ``convchain``, ``conv_0``,
``bn_0``, ``pool_bn``, ``tconv``, ``tconv_bn``, ...) so a state_dict key is
the flax parameter path with dots. BatchNorm (models/fastbn.py) normalizes
the last axis, so a BN model runs NHWC, as in the JAX package.
'''

import collections.abc
import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import functions, pooling
from . import fastbn, fastconv


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


def center_crop_to(x, target_h, target_w, data_format='NCHW'):
    '''Center-crop a batched image tensor spatially to (target_h,
    target_w).'''
    ay, ax = (2, 3) if data_format == 'NCHW' else (1, 2)
    top = (x.shape[ay] - target_h) // 2
    left = (x.shape[ax] - target_w) // 2
    if data_format == 'NCHW':
        return x[:, :, top:top + target_h, left:left + target_w]
    return x[:, top:top + target_h, left:left + target_w]


def _bn(bn, features):
    '''A block's BatchNorm over ``features`` channels, or None without BN.'''
    return fastbn.BatchNormFast(features) if bn else None


class ConvChain(nn.Module):
    '''``n_conv`` stacked convs, each followed by its BatchNorm ``bn_i``
    when ``bn``. A relu chain of two stride-1 SAME convs without BN in NCHW
    runs whole as one conv_chain kernel; otherwise each conv runs on its
    own. The parameters are the same either way.'''

    def __init__(self, in_channels, filters, kernel_size, conv_stride, bn,
                 n_conv=2, padding='VALID', activation='relu',
                 data_format='NCHW', generator=None):
        super().__init__()
        self.fuse_relu = activation in ('relu', 'ReLU')
        self.act = None if self.fuse_relu else solve_activation(activation)
        self.fused = (self.fuse_relu and not bn and n_conv == 2
                      and conv_stride == 1 and data_format == 'NCHW'
                      and fastconv.chain_ok(in_channels, filters,
                                            kernel_size, padding))
        ci = in_channels
        for i in range(n_conv):
            self.add_module(f'conv_{i}', fastconv.Conv2DFast(
                ci, filters, (kernel_size, kernel_size),
                strides=(conv_stride, conv_stride), padding=padding,
                activation='relu' if self.fuse_relu else None,
                data_format=data_format, generator=generator))
            if bn:
                self.add_module(f'bn_{i}', fastbn.BatchNormFast(filters))
            ci = filters
        self.n_conv = n_conv
        self.bn = bn

    def forward(self, x):
        if self.fused:
            return functions.conv_chain(
                x, self.conv_0.weight, self.conv_0.bias,
                self.conv_1.weight, self.conv_1.bias)
        for i in range(self.n_conv):
            x = getattr(self, f'conv_{i}')(x)
            if self.act is not None:
                x = self.act(x)
            if self.bn:
                x = getattr(self, f'bn_{i}')(x)
        return x


class Downsample(nn.Module):
    '''Downsampling block: conv chain -> (skip, max-pooled [-> pool_bn]).'''

    def __init__(self, in_channels, filters, rate, kernel_size, conv_stride,
                 bn, n_conv=2, padding='VALID', activation='relu',
                 data_format='NCHW', generator=None):
        super().__init__()
        self.rate = rate
        self.data_format = data_format
        self.convchain = ConvChain(
            in_channels, filters, kernel_size, conv_stride, bn,
            n_conv=n_conv, padding=padding, activation=activation,
            data_format=data_format, generator=generator)
        self.pool_bn = _bn(bn, filters)

    def forward(self, x):
        conv = self.convchain(x)
        pooled = pooling.max_pool2d(conv, self.rate, self.data_format)
        if self.pool_bn is not None:
            pooled = self.pool_bn(pooled)
        return conv, pooled


class Upsample(nn.Module):
    '''Upsampling block: tconv [-> tconv_bn] -> center-crop skip ->
    [up, skip] -> conv chain.'''

    def __init__(self, in_channels, filters, rate, kernel_size, conv_stride,
                 bn, n_conv=2, padding='VALID', activation='relu',
                 data_format='NCHW', generator=None):
        super().__init__()
        self.data_format = data_format
        self.tconv = fastconv.ConvTranspose2DFast(
            in_channels, filters, (rate, rate), (rate, rate),
            data_format=data_format, generator=generator)
        self.tconv_bn = _bn(bn, filters)
        # the chain sees [up, skip]: the up channels come first
        self.convchain = ConvChain(
            2 * filters, filters, kernel_size, conv_stride, bn,
            n_conv=n_conv, padding=padding, activation=activation,
            data_format=data_format, generator=generator)

    def forward(self, x, reference):
        up = self.tconv(x)
        if self.tconv_bn is not None:
            up = self.tconv_bn(up)
        if self.data_format == 'NCHW':
            cropped = center_crop_to(reference, up.shape[2], up.shape[3])
            return self.convchain(torch.cat([up, cropped], dim=1))
        cropped = center_crop_to(reference, up.shape[1], up.shape[2], 'NHWC')
        return self.convchain((up, cropped))


class Encoder(nn.Module):
    '''Chain of Downsample blocks; filters scale by ``rate`` per level.'''

    def __init__(self, in_channels, filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn, n_conv=2, padding='VALID',
                 activation='relu', data_format='NCHW', generator=None):
        super().__init__()
        self.n_downsample = n_downsample
        self.skip_channels = []
        ci, filters = in_channels, filters_first
        for i in range(n_downsample):
            self.add_module(f'down_{i}', Downsample(
                ci, filters, rate, kernel_size, conv_stride, bn,
                n_conv=n_conv, padding=padding, activation=activation,
                data_format=data_format, generator=generator))
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
                 activation='relu', data_format='NCHW', generator=None):
        super().__init__()
        self.n_up = len(skip_channels)
        ci = in_channels
        for i, filters in enumerate(reversed(skip_channels)):
            self.add_module(f'up_{i}', Upsample(
                ci, filters, rate, kernel_size, conv_stride, bn,
                n_conv=n_conv, padding=padding, activation=activation,
                data_format=data_format, generator=generator))
            ci = filters

    def forward(self, x, skips):
        for i, skip in enumerate(reversed(skips)):
            x = getattr(self, f'up_{i}')(x, skip)
        return x
