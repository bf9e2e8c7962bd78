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


def adjust_contrast(images, factors, target_channels=None):
    '''``(x - mean_c) * factor + mean_c`` per image of [B, H, W, C], with the
    per-channel spatial mean and one factor per image ([B]); channels
    outside ``target_channels`` pass through untouched
    (``tf.image.adjust_contrast`` on selected channels).'''
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


def flip_left_right(images, flips):
    '''Reverse the width axis of the images of [B, H, W, C] where ``flips``
    ([B] bool) is set.'''
    return torch.where(flips[:, None, None, None], images.flip(2), images)
