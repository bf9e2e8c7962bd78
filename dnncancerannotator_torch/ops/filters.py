'''Gaussian blur of NHWC images (counterpart of
dnncancerannotator_tpu.ops.filters).

``gaussian_filter2d`` is the label smoothing of the loss: a normalised,
truncated Gaussian kernel (the outer product of two normalised 1-D kernels)
applied per channel with REFLECT padding, as ``tfa.image.gaussian_filter2d``
and the JAX package apply it.
'''

import torch
import torch.nn.functional as F


def _gaussian_kernel1d(size, sigma, dtype, device):
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1.0) / 2.0
    g = torch.exp(-0.5 * torch.square(x / sigma))
    return g / g.sum()


def _pair(value):
    return tuple(value) if isinstance(value, (tuple, list)) else (value,
                                                                   value)


def gaussian_filter2d(image, filter_shape=3, sigma=1.0):
    '''Gaussian blur of an NHWC image [B, H, W, C], each channel alone.

    Args:
        image: [B, H, W, C] tensor (a non-float one is blurred in f32).
        filter_shape: int or (h, w) kernel size; even sizes pad one more
            pixel after than before, as the JAX package pads them.
        sigma: the Gaussian's standard deviation, a scalar or (sy, sx).
    '''
    fh, fw = _pair(filter_shape)
    sy, sx = _pair(sigma)
    dtype = image.dtype if image.is_floating_point() else torch.float32
    image = image.to(dtype)
    kernel = torch.outer(_gaussian_kernel1d(fh, sy, dtype, image.device),
                         _gaussian_kernel1d(fw, sx, dtype, image.device))
    c = image.shape[-1]
    # F.pad's order is (W before, W after, H before, H after); numpy's and
    # torch's 'reflect' both leave the edge pixel unrepeated
    padded = F.pad(image.permute(0, 3, 1, 2),
                   ((fw - 1) // 2, fw - 1 - (fw - 1) // 2,
                    (fh - 1) // 2, fh - 1 - (fh - 1) // 2), mode='reflect')
    out = F.conv2d(padded, kernel.expand(c, 1, fh, fw), groups=c)
    return out.permute(0, 2, 3, 1)
