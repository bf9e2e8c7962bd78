'''UNet and MulmoUNet annotators (counterpart of
dnncancerannotator_tpu.models.unet), differentiable through the kernels'
autograd Functions.

``UNetAnnotator`` takes NHWC input like the JAX model and returns
[B, H, W, 1] logits or probabilities. Its ``data_format='auto'`` picks the
JAX model's layout (unet.py:132-135): channel-major NCHW for the body and
the 1x1 logits head when BatchNorm is off, NHWC with BatchNorm (which
normalizes the last axis).

``dtype`` (bfloat16, from ``deploy_options.precision``) is the compute
dtype of the convs and BatchNorms; the parameters stay f32 and the logits
come back in f32 (unet.py:165). Two policies of the JAX model keep parts in
f32 under bf16 (no-ops under f32): ``f32_head`` casts the body's output to
f32 and runs the 1x1 head in f32 (unet.py:154-161); ``f32_level0`` runs
``down_0`` and the last Upsample in f32 (unet.py:48-61). MulmoUNet takes
``f32_head`` and ignores ``f32_level0``, as the JAX model does.

``MulmoUNetAnnotator`` (unet.py:67-105, :171-185) runs NHWC whatever
``bn`` is: one Encoder per input channel (``encoder_{i}``, fed its channel
``x[..., i:i + 1]``, a view of the batch), the bottlenecks concatenated on
the channel axis, one Decoder fed the skips of ``encoders[reference_index]``
alone, and the 1x1 head.

Under ``deploy_options.spatial_partition`` (parallel/mesh.py) both take a
rank's image rows, whole blocks of ``row_block`` = rate ** n_downsample
rows (checked at the input): the SAME convs and chains exchange their halos
(models/fastconv.py, blocks.py), the pools, transposed convs, skip joins
and the 1x1 head stay on the rank's rows.
'''

import torch
from torch import nn

from ..parallel import mesh
from . import blocks, fastbn, fastconv


def _policy_dtypes(dtype, f32_head, f32_level0):
    '''(dtype, head dtype, level-0 dtype) of an annotator: the policies
    take f32 only where there is a compute dtype to depart from.'''
    dtype = fastconv.resolve_dtype(dtype)
    f32 = torch.float32 if dtype is not None else None
    return (dtype, f32 if f32_head else dtype, f32 if f32_level0 else None)


class UNet(nn.Module):
    '''Plain U-Net body (no head), NCHW or NHWC.'''

    def __init__(self, in_channels, filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn=False, padding='valid',
                 activation='relu', data_format='NCHW', dtype=None,
                 level0_dtype=None, generator=None):
        super().__init__()
        common = dict(rate=rate, kernel_size=kernel_size,
                      conv_stride=conv_stride, bn=bn, padding=padding,
                      activation=activation, data_format=data_format,
                      dtype=dtype, level0_dtype=level0_dtype,
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

    Accepts the JAX model's options, ``dtype`` and its two policies (module
    docstring). ``train()`` / ``eval()`` select the BatchNorm batch or
    running statistics (the JAX model's ``training``).
    '''

    def __init__(self, in_channels, n_filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn=False, padding='valid',
                 activation='relu', kernel_regularizer=None, dtype=None,
                 data_format='auto', f32_head=False, f32_level0=False,
                 generator=None):
        super().__init__()
        del kernel_regularizer
        dtype, head_dtype, level0_dtype = _policy_dtypes(dtype, f32_head,
                                                         f32_level0)
        if data_format == 'auto':
            data_format = 'NHWC' if bn else 'NCHW'
        if data_format not in ('NCHW', 'NHWC'):
            raise ValueError(f'data_format must be auto, NCHW or NHWC, got '
                             f'{data_format!r}')
        if bn and data_format != 'NHWC':
            raise ValueError('BatchNorm models run NHWC (BatchNorm normalizes '
                             'the last axis)')
        self.data_format = data_format
        # under spatial_partition a rank's rows are whole blocks of this
        # many rows, so every pool and transposed conv stays on its rank
        self.row_block = int(rate) ** int(n_downsample)
        self.unet = UNet(in_channels, n_filters_first, n_downsample, rate,
                         kernel_size, conv_stride, bn=bn, padding=padding,
                         activation=activation, data_format=data_format,
                         dtype=dtype, level0_dtype=level0_dtype,
                         generator=generator)
        self.last_conv = fastconv.Conv2DFast(
            self.unet.out_channels, 1, (1, 1), padding=padding,
            data_format=data_format, dtype=head_dtype, generator=generator)

    def forward(self, x, return_logits=False):
        mesh.check_aligned(x.shape[1], self.row_block)
        if self.data_format == 'NHWC':
            body = self.unet(x)
        else:
            body = self.unet(x.permute(0, 3, 1, 2).contiguous())
        # under f32_head the head conv casts its input to f32
        logits = self.last_conv(body)
        if self.data_format == 'NCHW':
            logits = logits.permute(0, 2, 3, 1)
        logits = fastbn.wide(logits)
        if return_logits:
            return logits
        return torch.sigmoid(logits)


class MulmoUNet(nn.Module):
    '''Multimodal U-Net body (no head), NHWC: an Encoder per input
    channel, the bottlenecks concatenated, one Decoder on the skips of
    encoder ``reference_index``.'''

    def __init__(self, in_channels, filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn=False, padding='valid',
                 activation='relu', reference_index=0, dtype=None,
                 generator=None):
        super().__init__()
        common = dict(rate=rate, kernel_size=kernel_size,
                      conv_stride=conv_stride, bn=bn, padding=padding,
                      activation=activation, data_format='NHWC',
                      dtype=dtype, generator=generator)
        self.n_channels = in_channels
        self.reference_index = reference_index
        for idx in range(in_channels):
            self.add_module(f'encoder_{idx}', blocks.Encoder(
                1, filters_first, n_downsample, **common))
        skips = self.encoder_0.skip_channels
        self.decoder = blocks.Decoder(in_channels * skips[-1], skips,
                                      **common)
        self.out_channels = skips[0]

    def forward(self, x):
        skips, bottoms = [], []
        for idx in range(self.n_channels):
            enc_skips, bottom = getattr(self, f'encoder_{idx}')(
                x[..., idx:idx + 1])
            skips.append(enc_skips)
            bottoms.append(bottom)
        return self.decoder(torch.cat(bottoms, -1),
                            skips[self.reference_index])


class MulmoUNetAnnotator(nn.Module):
    '''MulmoUNet + 1x1 conv head -> [B, H, W, 1] probabilities (or
    logits), NHWC whatever ``bn`` is (the per-channel encoders slice the
    last axis). Accepts the JAX model's options; ``dtype`` and
    ``f32_head`` as UNetAnnotator, ``f32_level0`` ignored.'''

    def __init__(self, in_channels, n_filters_first, n_downsample, rate,
                 kernel_size, conv_stride, bn=False, padding='valid',
                 activation='relu', kernel_regularizer=None, dtype=None,
                 reference_index=0, data_format='NHWC', f32_head=False,
                 f32_level0=False, generator=None):
        super().__init__()
        del kernel_regularizer, f32_level0
        dtype, head_dtype, _ = _policy_dtypes(dtype, f32_head, False)
        if data_format not in ('NHWC', 'auto'):
            raise ValueError(f'MulmoUNetAnnotator runs NHWC, got '
                             f'data_format {data_format!r}')
        self.data_format = 'NHWC'
        self.row_block = int(rate) ** int(n_downsample)
        self.mulmo_unet = MulmoUNet(
            in_channels, n_filters_first, n_downsample, rate, kernel_size,
            conv_stride, bn=bn, padding=padding, activation=activation,
            reference_index=reference_index, dtype=dtype,
            generator=generator)
        self.last_conv = fastconv.Conv2DFast(
            self.mulmo_unet.out_channels, 1, (1, 1), padding=padding,
            data_format='NHWC', dtype=head_dtype, generator=generator)

    def forward(self, x, return_logits=False):
        mesh.check_aligned(x.shape[1], self.row_block)
        logits = fastbn.wide(self.last_conv(self.mulmo_unet(x)))
        if return_logits:
            return logits
        return torch.sigmoid(logits)
