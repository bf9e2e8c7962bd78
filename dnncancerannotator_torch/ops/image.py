'''Image ops of the augmentation chain, NHWC (counterpart of
dnncancerannotator_tpu.ops.image).'''

import functools

import torch


def crop_to_bounding_box(images, top, left, target_h, target_w):
    '''Crop each image of [B, H, W, C] at its own offset (``top``, ``left``:
    [B] integer tensors) to target_h x target_w, as one gather
    (``tf.image.crop_to_bounding_box`` per image).'''
    b = images.shape[0]
    rows = top[:, None] + torch.arange(target_h, device=images.device)
    cols = left[:, None] + torch.arange(target_w, device=images.device)
    batch = torch.arange(b, device=images.device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def adjust_contrast(images, factors, target_channels=None, means=None):
    '''``(x - mean_c) * factor + mean_c`` per image of [B, H, W, C], with the
    per-channel spatial mean (or ``means`` [B, 1, 1, C]) and one factor per
    image ([B]); channels outside ``target_channels`` pass through untouched
    (``tf.image.adjust_contrast`` on selected channels).'''
    if means is None:
        means = images.mean(dim=(1, 2), keepdim=True)
    adjusted = (images - means) * factors[:, None, None, None] + means
    if target_channels is None:
        return adjusted
    mask = _channel_mask(images.shape[-1], tuple(target_channels),
                         images.device)
    return torch.where(mask, adjusted, images)


@functools.lru_cache(maxsize=None)
def _channel_mask(n, channels, device):
    '''[n] bool, True at ``channels`` (made once per device).'''
    mask = torch.zeros(n, dtype=torch.bool)
    mask[list(channels)] = True
    return mask.to(device)


def _resize_weights(n_in, n_out, device):
    '''[n_out, n_in] interpolation matrix of TF's half-pixel bilinear
    sampling: row i weighs source rows floor(q) and floor(q) + 1 by 1 - r
    and r, q = clip((i + 0.5) * n_in / n_out - 0.5, 0, n_in - 1).'''
    q = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * (n_in / n_out)
         - 0.5).clamp(0.0, n_in - 1.0)
    lo = torch.floor(q).long().clamp(0, max(n_in - 2, 0))
    r = q - lo
    rows = torch.arange(n_out)
    w = torch.zeros((n_out, n_in), dtype=torch.float32)
    w[rows, lo] = 1.0 - r
    if n_in > 1:
        w[rows, lo + 1] += r
    return w.to(device)


def resize_bilinear(images, target_h, target_w):
    '''Bilinear resize of [..., H, W, C] with half-pixel centers and no
    antialiasing (``tf.image.resize(method='bilinear')``), as two
    interpolation matmuls over H, then W (ops/image.py of the JAX
    package).'''
    images = images.float()
    wy = _resize_weights(images.shape[-3], target_h, images.device)
    wx = _resize_weights(images.shape[-2], target_w, images.device)
    tmp = torch.einsum('oh,...hwc->...owc', wy, images)
    return torch.einsum('pw,...owc->...opc', wx, tmp)


def flip_left_right(images, flips):
    '''Reverse the width axis of the images of [B, H, W, C] where ``flips``
    ([B] bool) is set.'''
    return torch.where(flips[:, None, None, None], images.flip(2), images)
