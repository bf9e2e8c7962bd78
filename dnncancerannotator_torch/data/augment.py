'''The augmentation chain on the device, over NHWC batches (counterpart of
dnncancerannotator_tpu.data.augment).

Every random op is two functions: ``draw_*`` takes its random numbers from
a ``torch.Generator`` on the device, and ``apply_*`` is a function of the
images and those draws alone. JAX's threefry streams cannot be replayed in
torch, so the parity tests feed the JAX package's own draws to the apply
functions, and the samplers have distribution tests.

Ported, with the JAX package's semantics:
- random_crop: jittered center crop; the jitter is N(0, stddev) cast to an
  integer (truncation) and clipped to [min_, max_];
- random_flip: left-right flip with p = 0.5;
- random_contrast: one factor per image in [lower, upper), on the feature
  channels only (``target_channels``), so the label is untouched;
- random_warp through a warp bank (``build_warp_bank``, the default
  ``deploy_options.warp_bank``): a random bank field per image with random
  up/down and left/right mirrors, resampled by the two-pass warp. Crop,
  flip and warp move the label with the image; after the warp it is no
  longer binary, and the loss takes it as it is.

Not ported yet, and raising NotImplementedError: random_warp's per-step
spline solve (``warp_bank: false``, or a bank whose size differs from the
images at that point of the chain), random_intrachannelwarp and the fused
chain (``fused_aug``).
'''

import numpy as np
import torch

from ..ops import image as image_ops
from ..ops import warp as warp_ops

_NOT_PORTED_WARP = ('random_warp runs only through a warp bank of the '
                    'image size at that point of the chain; the per-step '
                    'spline solve is not ported yet (ROADMAP.md queue 1)')


# -- random_crop ---------------------------------------------------------------
def draw_crop(gen, b, stddev=4, max_=6, min_=-6):
    '''Integer jitter [B, 2]: trunc(N(0, stddev)) clipped to [min_, max_].'''
    noise = torch.randn(b, 2, generator=gen, device=gen.device) * stddev
    return noise.to(torch.int32).clamp(int(min_), int(max_)).long()


def apply_crop(images, diff, output_size):
    '''Crop [B, H, W, C] to output_size at the center offset plus ``diff``,
    clipped into the image.'''
    _, h, w, _ = images.shape
    th, tw = output_size
    top = (diff[:, 0] + (h - th) // 2).clamp(0, h - th)
    left = (diff[:, 1] + (w - tw) // 2).clamp(0, w - tw)
    return image_ops.crop_to_bounding_box(images, top, left, th, tw)


# -- random_flip -------------------------------------------------------------------
def draw_flip(gen, b):
    '''[B] bool, each True with probability 0.5.'''
    return torch.rand(b, generator=gen, device=gen.device) < 0.5


def apply_flip(images, flips):
    return image_ops.flip_left_right(images, flips)


# -- random_contrast -----------------------------------------------------------
def draw_contrast(gen, b, lower=0.8, upper=1.2):
    '''[B] contrast factors, uniform in [lower, upper).'''
    u = torch.rand(b, generator=gen, device=gen.device)
    return lower + (upper - lower) * u


def apply_contrast(images, factors, target_channels=None):
    return image_ops.adjust_contrast(images, factors, target_channels)


# -- random_warp through a warp bank -----------------------------------------------
def _warp_points(gen, n_images, n_points, size, stddev, max_diff):
    '''Control points: uniform locations in [0, size)^2 and clipped
    Gaussian displacements; returns (source, dest) [n, n_points, 2].'''
    shape = (n_images, n_points, 2)
    raw = torch.rand(shape, generator=gen, device=gen.device) * float(size)
    diff = torch.randn(shape, generator=gen, device=gen.device) * stddev
    return raw, raw + diff.clamp(-float(max_diff), float(max_diff))


def build_warp_bank(gen, n_bank, out_size, n_points=100, max_diff=5,
                    stddev=2.0, process_in_batch=None, method='two_pass',
                    flow_grid_stride=4, chunk=8):
    '''Solve ``n_bank`` coarse warp flows once (the JAX package's warp-bank
    gate): control points drawn as the per-step warp draws them (size = the
    crop width), solved ``chunk`` at a time. Returns {flows [n, hc, wc, 2],
    stride, max_displacement = ceil(max_diff) + 3, out_size}.'''
    del process_in_batch
    if method != 'two_pass':
        raise ValueError('warp_bank requires the two_pass warp method')
    th, tw = int(out_size[0]), int(out_size[1])
    md = int(np.ceil(max_diff)) + 3
    src, dst = _warp_points(gen, int(n_bank), n_points, tw, stddev, max_diff)
    flows = torch.cat([
        warp_ops.coarse_twopass_flow(
            src[i:i + chunk], dst[i:i + chunk], (th, tw), max_displacement=md,
            flow_grid_stride=int(flow_grid_stride))
        for i in range(0, int(n_bank), int(chunk))])
    return dict(flows=flows, stride=int(flow_grid_stride),
                max_displacement=md, out_size=(th, tw))


def draw_banked_warp(gen, b, n_bank):
    '''(bank index [B], up/down mirror [B] bool, left/right mirror [B]
    bool).'''
    idx = torch.randint(0, n_bank, (b,), generator=gen, device=gen.device)
    return idx, draw_flip(gen, b), draw_flip(gen, b)


def apply_banked_warp(images, bank, draws):
    '''Warp [B, H, W, C] at bank fields: a vertical mirror reverses the rows
    and negates fy, a horizontal one reverses the columns and negates fx.'''
    idx, ud, lr = draws
    fl = bank['flows'][idx]
    up = fl.flip(1)
    fl = torch.where(ud[:, None, None, None],
                     torch.stack([-up[..., 0], up[..., 1]], dim=-1), fl)
    left = fl.flip(2)
    fl = torch.where(lr[:, None, None, None],
                     torch.stack([left[..., 0], -left[..., 1]], dim=-1), fl)
    return warp_ops.warp_with_coarse_flow(
        images, fl, max_displacement=bank['max_displacement'],
        flow_grid_stride=bank['stride'])


# -- the chain -------------------------------------------------------------------
_KNOWN = ('random_crop', 'random_flip', 'random_contrast', 'random_warp',
          'random_intrachannelwarp', 'random_hue')


def parse_augment_options(augment_options, slice_types, output_size=(256, 256)):
    '''Resolve config augment specs to an ordered [(name, options)] list
    with the per-op defaults merged in.'''
    if augment_options is None:
        augment_options = {'random_crop': {}}
    defaults = {
        'random_crop': dict(output_size=tuple(output_size)),
        'random_flip': {},
        'random_contrast': dict(
            target_channels=list(range(len(slice_types[:-1])))),
        'random_warp': {},
    }
    resolved = []
    for name, conf in augment_options.items():
        if name not in _KNOWN:
            raise KeyError(f'Unknown augmentation {name!r}')
        if name == 'random_hue':
            raise NotImplementedError('random_hue needs RGB data')
        merged = dict(defaults.get(name, {}))
        merged.update(conf or {})
        if 'output_size' in merged:
            merged['output_size'] = tuple(merged['output_size'])
        if 'paired' in merged:
            merged['paired'] = tuple(map(tuple, merged['paired']))
        if merged.get('target_channels') is not None:
            merged['target_channels'] = tuple(merged['target_channels'])
        resolved.append((name, merged))
    return resolved


def draw_chain(methods, b, gen, warp_bank=None):
    '''The random draws of one batch of size b, one entry per method.'''
    draws = []
    for name, o in methods:
        if name == 'random_crop':
            draws.append(draw_crop(gen, b, o.get('stddev', 4),
                                   o.get('max_', 6), o.get('min_', -6)))
        elif name == 'random_flip':
            draws.append(draw_flip(gen, b))
        elif name == 'random_contrast':
            draws.append(draw_contrast(gen, b, o.get('lower', 0.8),
                                       o.get('upper', 1.2)))
        else:
            _check_portable(name, o, warp_bank)
            draws.append(draw_banked_warp(gen, b, warp_bank['flows'].shape[0]))
    return draws


def _check_portable(name, options, warp_bank):
    if name == 'random_warp':
        if warp_bank is None or options.get('method',
                                            'two_pass') != 'two_pass':
            raise NotImplementedError(_NOT_PORTED_WARP)
    elif name not in ('random_crop', 'random_flip', 'random_contrast'):
        raise NotImplementedError(
            f'{name} is not ported yet (ROADMAP.md queue 1)')


def apply_chain(methods, images, draws, warp_bank=None):
    '''Apply the chain to [B, H, W, C] float images with given draws.'''
    for (name, o), draw in zip(methods, draws):
        if name == 'random_crop':
            images = apply_crop(images, draw, o['output_size'])
        elif name == 'random_flip':
            images = apply_flip(images, draw)
        elif name == 'random_contrast':
            images = apply_contrast(images, draw, o.get('target_channels'))
        elif (name == 'random_warp' and warp_bank is not None
              and o.get('method', 'two_pass') == 'two_pass'
              and tuple(images.shape[1:3]) == warp_bank['out_size']):
            images = apply_banked_warp(images, warp_bank, draw)
        else:
            raise NotImplementedError(_NOT_PORTED_WARP)
    return images


def build_augment_fn(methods, warp_bank=None):
    '''Compose [(name, options)] into ``fn(images [B,H,W,C] float, gen) ->
    images``; ``warp_bank`` (build_warp_bank) serves random_warp. Raises
    NotImplementedError for a chain the port cannot run.'''
    for name, options in methods:
        _check_portable(name, options, warp_bank)

    def apply_all(images, gen):
        draws = draw_chain(methods, images.shape[0], gen, warp_bank)
        return apply_chain(methods, images, draws, warp_bank)

    return apply_all


def to_feature_label(images, slice_types):
    '''Split [B, H, W, C] into (x [B,H,W,C-1], y [B,H,W]) by the label
    channel.'''
    slice_types = list(slice_types)
    label_index = slice_types.index('label')
    feature_indices = [i for i in range(len(slice_types)) if i != label_index]
    x = images[..., feature_indices]
    y = images[..., label_index]
    return x, y
