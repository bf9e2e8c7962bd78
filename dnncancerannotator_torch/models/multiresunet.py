'''MultiResUNet (counterpart of dnncancerannotator_tpu.models.multiresunet).

The JAX model's topology, names and arithmetic:

- ``ConvBN``: a SAME conv without bias (``conv``), then BatchNorm without a
  scale (``bn``), then an optional relu;
- ``MultiResBlock``: chained 3x3 ConvBNs (``conv3x3``, ``conv5x5``,
  ``conv7x7``) of int(W * .167), int(W * .333), int(W * .5) filters with W
  = 1.67 * U in Python floats, concatenated, BatchNorm ``bn_cat``, plus a
  1x1 ConvBN ``shortcut``, relu, BatchNorm ``bn_out``;
- ``ResPath``: ``length`` steps of a 1x1 ConvBN ``shortcut_i`` plus a 3x3
  ConvBN ``conv_i``, relu, BatchNorm ``bn_i``;
- ``UpTconv``: a raw 2x2 / stride-2 transposed conv with bias (``tconv``),
  no BatchNorm (multiresunet.py:53-72);
- ``MultiResUnet``: ``mres1..9``, ``respath1..4``, ``up6..9``, the 2x2 max
  pools of ops/pooling.py, a 1x1 conv without bias ``head_conv`` and a
  BatchNorm without a scale ``head_bn``; f32 logits [B, H, W, 1].

The JAX model uses flax's ``nn.Conv`` and ``nn.ConvTranspose`` here, not its
fast modules, so no conv reaches a Pallas kernel, and the port runs them as
library calls (cuDNN, TF32 off). Layout: the tensors are NHWC like the JAX
model's, kept in channels-last memory; a conv takes the NCHW view of its
NHWC input (``permute``, no copy), which cuDNN reads as channels_last, and
returns the NHWC view of its channels_last output, so no layout copy is
made around a conv; BatchNorm normalizes the last axis, and the skip joins
are concatenations on the last axis (one copy each, as in the JAX model).

``dtype`` (bfloat16) is every conv's and BatchNorm's compute dtype, as
flax's ``dtype`` there: a conv casts its input and weight, a transposed
conv its bias too, added in bf16 after the output's rounding; the
parameters stay f32 and the logits come back in f32
(multiresunet.py:189). It has no f32_head / f32_level0 policy.

Under ``deploy_options.spatial_partition`` (parallel/mesh.py) a rank runs
its image rows, whole blocks of 16 (``row_block``): each 3x3 ``Conv`` on
its slab of one row of each neighbour, the 1x1 convs, the pools and
``UpTconv`` on its own rows, BatchNorm on every rank's statistics.
'''

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import pooling
from ..parallel import mesh
from . import fastbn
from .fastconv import (_glorot_uniform_, _nchw, _nhwc, plain_tconv,
                       resolve_dtype)


def _glorot(shape, fan_in, fan_out, generator):
    weight = nn.Parameter(torch.empty(shape))
    _glorot_uniform_(weight, fan_in, fan_out, generator)
    return weight


class Conv(nn.Module):
    '''flax ``nn.Conv`` without bias: a stride-1 SAME conv of NHWC tensors,
    ``weight`` [Co, Ci, k, k].'''

    def __init__(self, in_channels, features, kernel, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        if kernel % 2 != 1:
            raise NotImplementedError(f'kernel {kernel}: MultiResUnet uses '
                                      'odd kernels only')
        self.weight = _glorot((features, in_channels, kernel, kernel),
                              kernel * kernel * in_channels,
                              kernel * kernel * features, generator)

    def forward(self, x):
        pad = self.weight.shape[-1] // 2
        dtype = self.dtype or x.dtype
        w = self.weight.to(dtype)
        # under spatial_partition: on this rank's slab of ``pad`` rows
        return mesh.on_slab(
            lambda slab: _nhwc(F.conv2d(_nchw(slab), w, padding=pad)),
            (x.to(dtype),), pad, pad, 1)


class ConvBN(nn.Module):
    '''Conv (no bias) -> BatchNorm (no scale) -> optional relu.'''

    def __init__(self, in_channels, filters, kernel, activation='relu',
                 dtype=None, generator=None):
        super().__init__()
        if activation not in (None, 'relu'):
            raise ValueError(f'ConvBN activation {activation!r}: relu or None')
        self.conv = Conv(in_channels, filters, kernel, dtype, generator)
        self.bn = fastbn.BatchNormFast(filters, use_scale=False, dtype=dtype)
        self.relu = activation == 'relu'
        self.out_channels = filters

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class UpTconv(nn.Module):
    '''The decoder's upsample: a raw ConvTranspose(2x2, stride 2) with bias,
    ``tconv.weight`` [Ci, Co, 2, 2] applied unflipped (convert.py flips the
    flax kernel once).'''

    def __init__(self, in_channels, filters, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.tconv = nn.Module()
        self.tconv.weight = _glorot((in_channels, filters, 2, 2),
                                    4 * in_channels, 4 * filters, generator)
        self.tconv.bias = nn.Parameter(torch.zeros(filters))

    def forward(self, x):
        dtype = self.dtype or x.dtype
        return _nhwc(plain_tconv(_nchw(x.to(dtype)),
                                 self.tconv.weight.to(dtype),
                                 self.tconv.bias.to(dtype)))


def multires_filters(u, alpha=1.67):
    '''(f3, f5, f7) of a MultiResBlock of U = ``u``, in the JAX model's
    Python float arithmetic.'''
    w = alpha * u
    return int(w * 0.167), int(w * 0.333), int(w * 0.5)


class MultiResBlock(nn.Module):

    def __init__(self, in_channels, u, alpha=1.67, dtype=None,
                 generator=None):
        super().__init__()
        f3, f5, f7 = multires_filters(u, alpha)
        self.out_channels = f3 + f5 + f7
        self.shortcut = ConvBN(in_channels, self.out_channels, 1,
                               activation=None, dtype=dtype,
                               generator=generator)
        self.conv3x3 = ConvBN(in_channels, f3, 3, dtype=dtype,
                              generator=generator)
        self.conv5x5 = ConvBN(f3, f5, 3, dtype=dtype, generator=generator)
        self.conv7x7 = ConvBN(f5, f7, 3, dtype=dtype, generator=generator)
        self.bn_cat = fastbn.BatchNormFast(self.out_channels, dtype=dtype)
        self.bn_out = fastbn.BatchNormFast(self.out_channels, dtype=dtype)

    def forward(self, x):
        shortcut = self.shortcut(x)
        c3 = self.conv3x3(x)
        c5 = self.conv5x5(c3)
        c7 = self.conv7x7(c5)
        out = self.bn_cat(torch.cat([c3, c5, c7], -1))
        return self.bn_out(F.relu(shortcut + out))


class ResPath(nn.Module):

    def __init__(self, in_channels, filters, length, dtype=None,
                 generator=None):
        super().__init__()
        self.length = length
        ci = in_channels
        for i in range(length):
            self.add_module(f'shortcut_{i}', ConvBN(
                ci, filters, 1, activation=None, dtype=dtype,
                generator=generator))
            self.add_module(f'conv_{i}', ConvBN(ci, filters, 3, dtype=dtype,
                                                generator=generator))
            self.add_module(f'bn_{i}', fastbn.BatchNormFast(filters,
                                                            dtype=dtype))
            ci = filters

    def forward(self, x):
        for i in range(self.length):
            out = (getattr(self, f'shortcut_{i}')(x)
                   + getattr(self, f'conv_{i}')(x))
            x = getattr(self, f'bn_{i}')(F.relu(out))
        return x


class MultiResUnet(nn.Module):
    '''MultiResUNet: NHWC features [B, H, W, in_channels] -> [B, H, W, 1]
    probabilities (or f32 logits). ``height``, ``width`` and
    ``n_channels`` are accepted for config parity and not read, as in the
    JAX model; the first conv's width comes from ``in_channels``;
    ``dtype`` as in the module docstring.'''

    def __init__(self, in_channels, height=None, width=None, n_channels=None,
                 base_filters=32, dtype=None, generator=None):
        super().__init__()
        del height, width, n_channels
        # four 2x2 pools: a rank's rows under spatial_partition are whole
        # blocks of 16
        self.row_block = 16
        dt = resolve_dtype(dtype)
        u = base_filters
        ci = in_channels
        skips = []
        for i, (scale, length) in enumerate(((1, 4), (2, 3), (4, 2),
                                             (8, 1)), start=1):
            block = MultiResBlock(ci, u * scale, dtype=dt,
                                  generator=generator)
            self.add_module(f'mres{i}', block)
            self.add_module(f'respath{i}', ResPath(
                block.out_channels, u * scale, length, dtype=dt,
                generator=generator))
            skips.append(u * scale)
            ci = block.out_channels
        self.mres5 = MultiResBlock(ci, u * 16, dtype=dt, generator=generator)
        ci = self.mres5.out_channels
        for i, scale in zip(range(6, 10), (8, 4, 2, 1)):
            self.add_module(f'up{i}', UpTconv(ci, u * scale, dt, generator))
            block = MultiResBlock(u * scale + skips[9 - i], u * scale,
                                  dtype=dt, generator=generator)
            self.add_module(f'mres{i}', block)
            ci = block.out_channels
        self.head_conv = Conv(ci, 1, 1, dt, generator)
        self.head_bn = fastbn.BatchNormFast(1, use_scale=False, dtype=dt)

    def forward(self, x, return_logits=False):
        mesh.check_aligned(x.shape[1], self.row_block)
        skips = []
        for i in range(1, 5):
            m = getattr(self, f'mres{i}')(x)
            x = pooling.max_pool2d(m, 2, 'NHWC')
            skips.append(getattr(self, f'respath{i}')(m))
        x = self.mres5(x)
        for i in range(6, 10):
            up = getattr(self, f'up{i}')(x)
            x = getattr(self, f'mres{i}')(torch.cat([up, skips[9 - i]], -1))
        logits = fastbn.wide(self.head_bn(self.head_conv(x)))
        if return_logits:
            return logits
        return torch.sigmoid(logits)
