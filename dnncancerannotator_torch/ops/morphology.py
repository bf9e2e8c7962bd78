'''Grayscale morphology with a flat square window (counterpart of
dnncancerannotator_tpu.ops.morphology).

Erosion is a windowed minimum and dilation a windowed maximum, stride 1,
with SAME padding split as ((size - 1) // 2, size - 1 - that) and the
identities +inf (erosion) and -inf (dilation) in the pads, so an even window
pads one more on the high side, as XLA's reduce_window does in the JAX
package. Min and max are exact, so the results equal the JAX package's.
'''

import torch
import torch.nn.functional as F


def _same_pads(size):
    lo = (size - 1) // 2
    return lo, size - 1 - lo


def _window_max(image, filter_size, fill):
    '''Windowed max over the last two dims of [..., H, W], SAME-padded with
    ``fill``.'''
    lo, hi = _same_pads(filter_size)
    shape = image.shape
    x = image.reshape(-1, 1, shape[-2], shape[-1])
    x = F.pad(x, (lo, hi, lo, hi), value=fill)
    return F.max_pool2d(x, filter_size, stride=1).reshape(shape)


def erode2d(image, filter_size):
    '''Grayscale erosion over the last two dims (windowed min, +inf pads).'''
    return -_window_max(-image, filter_size, float('-inf'))


def dilate2d(image, filter_size):
    '''Grayscale dilation over the last two dims (windowed max, -inf pads).'''
    return _window_max(image, filter_size, float('-inf'))


def morph_open(image, filter_size):
    '''Opening (erosion, then dilation) over the last two dims of a float
    [..., H, W] tensor.'''
    return dilate2d(erode2d(image, filter_size), filter_size)
