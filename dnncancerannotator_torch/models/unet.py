'''UNet annotator (counterpart of dnncancerannotator_tpu.models.unet),
differentiable through the kernels' autograd Functions.

``UNetAnnotator`` takes NHWC input like the JAX model and returns
[B, H, W, 1] logits or probabilities. Its ``data_format='auto'`` picks the
JAX model's layout (unet.py:132-135): channel-major NCHW for the body and
the 1x1 logits head when BatchNorm is off, NHWC with BatchNorm (which
normalizes the last axis).
'''

import torch
from torch import nn

from . import blocks, fastconv


class UNet(nn.Module):
    '''Plain U-Net body (no head), NCHW or NHWC.'''

    def __init__(self, in_channels, filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn=False, padding='valid',
                 activation='relu', data_format='NCHW', generator=None):
        super().__init__()
        common = dict(rate=rate, kernel_size=kernel_size,
                      conv_stride=conv_stride, bn=bn, padding=padding,
                      activation=activation, data_format=data_format,
                      generator=generator)
        self.encoder = blocks.Encoder(in_channels, filters_first,
                                      n_downsample, **common)
        skips = self.encoder.skip_channels
        self.decoder = blocks.Decoder(skips[-1], skips, **common)
        self.out_channels = skips[0]

    def forward(self, x):
        skips, x = self.encoder(x)
        return self.decoder(x, skips)


class UNetAnnotator(nn.Module):
    '''U-Net + 1x1 conv head -> [B, H, W, 1] probabilities (or logits).

    Accepts the JAX model's options. f32 only: ``dtype`` bfloat16 is not
    ported yet; ``f32_head``/``f32_level0`` are no-ops under f32, as they
    are in the JAX model. ``train()`` / ``eval()`` select the BatchNorm
    batch or running statistics (the JAX model's ``training``).
    '''

    def __init__(self, in_channels, n_filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn=False, padding='valid',
                 activation='relu', kernel_regularizer=None, dtype=None,
                 data_format='auto', f32_head=False, f32_level0=False,
                 generator=None):
        super().__init__()
        del kernel_regularizer, f32_head, f32_level0
        if dtype not in (None, 'float32', torch.float32):
            raise NotImplementedError(
                f'dtype {dtype}: bf16 compute is not ported yet '
                '(ROADMAP.md queue 2)')
        if data_format == 'auto':
            data_format = 'NHWC' if bn else 'NCHW'
        if data_format not in ('NCHW', 'NHWC'):
            raise ValueError(f'data_format must be auto, NCHW or NHWC, got '
                             f'{data_format!r}')
        if bn and data_format != 'NHWC':
            raise ValueError('BatchNorm models run NHWC (BatchNorm normalizes '
                             'the last axis)')
        self.data_format = data_format
        self.unet = UNet(in_channels, n_filters_first, n_downsample, rate,
                         kernel_size, conv_stride, bn=bn, padding=padding,
                         activation=activation, data_format=data_format,
                         generator=generator)
        self.last_conv = fastconv.Conv2DFast(
            self.unet.out_channels, 1, (1, 1), padding=padding,
            data_format=data_format, generator=generator)

    def forward(self, x, return_logits=False):
        if self.data_format == 'NHWC':
            logits = self.last_conv(self.unet(x))
        else:
            x = x.permute(0, 3, 1, 2).contiguous()
            logits = self.last_conv(self.unet(x)).permute(0, 2, 3, 1)
        if return_logits:
            return logits
        return torch.sigmoid(logits)
