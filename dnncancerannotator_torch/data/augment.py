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
- random_warp: a thin-plate-spline warp with ``n_points`` uniform control
  points (over the image width at that point of the chain) and clipped
  Gaussian displacements, the flow clamped to +-(ceil(max_diff) + 3). It
  runs through a warp bank (``build_warp_bank``, the default
  ``deploy_options.warp_bank``) of the image size at that point: a random
  bank field per image with random up/down and left/right mirrors; else
  through the per-step spline solve (``method`` two_pass or exact);
- random_intrachannelwarp: an exact, unclamped warp per channel group
  (``paired`` groups first, then every other channel alone), each group
  with its own control points; no bank serves it;
- the fused chain (the ``fused_aug`` gate): crop -> flip -> contrast ->
  two-pass warp in one crop-fused resample (``apply_fused_chain``), with
  the same draws as the composed per-step chain.
Crop, flip and the warps move the label with the image; after a warp it is
no longer binary, and the loss takes it as it is.
'''

import numpy as np
import torch

from ..ops import gates as gates_lib
from ..ops import image as image_ops
from ..ops import warp as warp_ops


# -- random_crop --------------------------------------------------------------
def draw_crop(gen, b, stddev=4, max_=6, min_=-6):
    '''Integer jitter [B, 2]: trunc(N(0, stddev)) clipped to [min_, max_].'''
    noise = torch.randn(b, 2, generator=gen, device=gen.device) * stddev
    return noise.to(torch.int32).clamp(int(min_), int(max_)).long()


def _crop_offsets(diff, in_size, output_size):
    '''(top [B], left [B]): the center offset plus ``diff``, clipped into
    the image.'''
    (h, w), (th, tw) = in_size, output_size
    return ((diff[:, 0] + (h - th) // 2).clamp(0, h - th),
            (diff[:, 1] + (w - tw) // 2).clamp(0, w - tw))


def apply_crop(images, diff, output_size):
    '''Crop [B, H, W, C] to output_size at the center offset plus ``diff``,
    clipped into the image.'''
    top, left = _crop_offsets(diff, images.shape[1:3], output_size)
    return image_ops.crop_to_bounding_box(images, top, left, *output_size)


# -- random_flip --------------------------------------------------------------
def draw_flip(gen, b):
    '''[B] bool, each True with probability 0.5.'''
    return torch.rand(b, generator=gen, device=gen.device) < 0.5


def apply_flip(images, flips):
    return image_ops.flip_left_right(images, flips)


# -- random_contrast ----------------------------------------------------------
def draw_contrast(gen, b, lower=0.8, upper=1.2):
    '''[B] contrast factors, uniform in [lower, upper).'''
    u = torch.rand(b, generator=gen, device=gen.device)
    return lower + (upper - lower) * u


def apply_contrast(images, factors, target_channels=None):
    return image_ops.adjust_contrast(images, factors, target_channels)


# -- random_warp --------------------------------------------------------------
def _warp_points(gen, n_images, n_points, size, stddev, max_diff):
    '''Control points: uniform locations in [0, size)^2 and clipped
    Gaussian displacements; returns (source, dest) [n, n_points, 2].'''
    shape = (n_images, n_points, 2)
    raw = torch.rand(shape, generator=gen, device=gen.device) * float(size)
    diff = torch.randn(shape, generator=gen, device=gen.device) * stddev
    return raw, raw + diff.clamp(-float(max_diff), float(max_diff))


def draw_warp(gen, b, size, n_points=100, max_diff=5, stddev=2.0):
    '''The per-step warp's control points (source, dest) [B, n_points, 2]
    over images ``size`` wide.'''
    return _warp_points(gen, b, n_points, size, stddev, max_diff)


def _max_displacement(max_diff):
    return int(np.ceil(max_diff)) + 3


def apply_warp(images, points, max_diff=5, method='two_pass',
               flow_grid_stride=4):
    '''The per-step warp of [B, H, W, C] at control points (source, dest):
    one spline solve per image, the flow clamped to
    +-(ceil(max_diff) + 3).'''
    src, dst = points
    return warp_ops.sparse_image_warp(
        images, src, dst, method=method,
        max_displacement=_max_displacement(max_diff), clamp_flow=True,
        flow_grid_stride=flow_grid_stride if method == 'two_pass' else 1)


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
    md = _max_displacement(max_diff)
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


def _banked(options, size, warp_bank):
    '''Whether ``warp_bank`` serves a random_warp of ``size`` images.'''
    return (warp_bank is not None
            and options.get('method', 'two_pass') == 'two_pass'
            and tuple(size) == warp_bank['out_size'])


# -- random_intrachannelwarp --------------------------------------------------
def _channel_groups(c, paired):
    '''The ``paired`` groups (negative channels resolved), then every other
    channel alone.'''
    paired = [[ch if ch >= 0 else c + ch for ch in group] for group in paired]
    grouped = {ch for group in paired for ch in group}
    return paired + [[ch] for ch in range(c) if ch not in grouped]


def draw_intrachannelwarp(gen, b, c, size, n_points=100, max_diff=5,
                          stddev=2.0, paired=((0, -1),)):
    '''One draw of control points (source, dest) per channel group.'''
    return [_warp_points(gen, b, n_points, size, stddev, max_diff)
            for _ in _channel_groups(c, paired)]


def apply_intrachannelwarp(images, draws, paired=((0, -1),)):
    '''Warp each channel group of [B, H, W, C] at its own control points,
    exact and unclamped.'''
    c = images.shape[-1]
    out = [None] * c
    for group, (src, dst) in zip(_channel_groups(c, paired), draws):
        warped = warp_ops.sparse_image_warp(images[..., group], src, dst)
        for j, ch in enumerate(group):
            out[ch] = warped[..., j]
    return torch.stack(out, dim=-1)


# -- the chain ----------------------------------------------------------------
_KNOWN = ('random_crop', 'random_flip', 'random_contrast', 'random_warp',
          'random_intrachannelwarp', 'random_hue')
_WARP_KEYS = ('max_diff', 'method', 'flow_grid_stride')
_POINT_KEYS = ('n_points', 'max_diff', 'stddev')


def _pick(options, keys):
    return {k: options[k] for k in keys if k in options}


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


def draw_chain(methods, shape, gen, warp_bank=None):
    '''The random draws of one batch of images of ``shape`` [B, H, W, C],
    one entry per method: random_warp draws bank indices and mirrors where
    ``warp_bank`` serves it, else control points over the image width at
    that point of the chain.'''
    b, h, w, c = shape
    draws = []
    for name, o in methods:
        if name == 'random_crop':
            draws.append(draw_crop(gen, b, o.get('stddev', 4),
                                   o.get('max_', 6), o.get('min_', -6)))
            h, w = o['output_size']
        elif name == 'random_flip':
            draws.append(draw_flip(gen, b))
        elif name == 'random_contrast':
            draws.append(draw_contrast(gen, b, o.get('lower', 0.8),
                                       o.get('upper', 1.2)))
        elif name == 'random_warp':
            draws.append(
                draw_banked_warp(gen, b, warp_bank['flows'].shape[0])
                if _banked(o, (h, w), warp_bank)
                else draw_warp(gen, b, w, **_pick(o, _POINT_KEYS)))
        else:
            draws.append(draw_intrachannelwarp(
                gen, b, c, w, **_pick(o, _POINT_KEYS + ('paired',))))
    return draws


def apply_chain(methods, images, draws, warp_bank=None):
    '''Apply the composed chain to [B, H, W, C] float images with given
    draws (``draw_chain`` with the same ``warp_bank``).'''
    for (name, o), draw in zip(methods, draws):
        if name == 'random_crop':
            images = apply_crop(images, draw, o['output_size'])
        elif name == 'random_flip':
            images = apply_flip(images, draw)
        elif name == 'random_contrast':
            images = apply_contrast(images, draw, o.get('target_channels'))
        elif name == 'random_warp':
            images = (apply_banked_warp(images, warp_bank, draw)
                      if _banked(o, images.shape[1:3], warp_bank)
                      else apply_warp(images, draw, **_pick(o, _WARP_KEYS)))
        else:
            images = apply_intrachannelwarp(images, draw,
                                            o.get('paired', ((0, -1),)))
    return images


# -- the fused chain ----------------------------------------------------------
_FUSED_PATTERN = ('random_crop', 'random_flip', 'random_contrast',
                  'random_warp')


def fused_chain_eligible(methods):
    '''The fused chain takes exactly crop -> flip -> contrast (on a
    non-empty ``target_channels``) -> two-pass warp.'''
    if tuple(n for n, _ in methods) != _FUSED_PATTERN:
        return False
    if not methods[2][1].get('target_channels'):
        return False
    return methods[3][1].get('method', 'two_pass') == 'two_pass'


def routes_fused(methods, shape):
    '''Whether the chain on [B, H, W, C] windows of ``shape`` runs fused:
    the ``fused_aug`` gate on (read in the caller's gate scope), the chain
    eligible and the crop within the window. The JAX package also asks for
    a single device and a VMEM budget, and on the CPU runs the composed
    chain; neither applies here.'''
    if not (gates_lib.enabled('fused_aug') and fused_chain_eligible(methods)):
        return False
    th, tw = methods[0][1]['output_size']
    return th <= shape[1] and tw <= shape[2]


def apply_fused_chain(methods, images, draws):
    '''Crop, flip, contrast and the two-pass warp of [B, h_in, w_in, C]
    windows in one resample, with the composed per-step chain's draws
    (``draw_chain`` without a bank). The identities: contrast with the crop
    window's mean commutes with the crop, the flip and the convex bilinear
    resample, so it runs on the whole window; crop-then-flip is
    flip-the-window-then-crop at the mirrored offset w_in - w_out - ox; the
    crop offsets ride the resample's addresses
    (ops/warp.py:sparse_image_warp_cropped).'''
    crop_o, _, con_o, warp_o = (o for _, o in methods)
    diff, flips, factors, (src, dst) = draws
    th, tw = crop_o['output_size']
    w_in = images.shape[2]
    top, left = _crop_offsets(diff, images.shape[1:3], (th, tw))
    means = image_ops.crop_to_bounding_box(images, top, left, th, tw).mean(
        dim=(1, 2), keepdim=True)   # the crop window's
    images = image_ops.adjust_contrast(images, factors,
                                       con_o['target_channels'], means)
    images = image_ops.flip_left_right(images, flips)
    left = torch.where(flips, (w_in - tw) - left, left)
    return warp_ops.sparse_image_warp_cropped(
        images, src, dst, torch.stack([top, left], dim=1), (th, tw),
        max_displacement=_max_displacement(warp_o.get('max_diff', 5)),
        clamp_flow=True, flow_grid_stride=warp_o.get('flow_grid_stride', 4))


def take_rows(draws, lo, hi):
    '''Rows [lo, hi) of every tensor of a chain's draws (``draw_chain``),
    nested lists and tuples kept.'''
    if torch.is_tensor(draws):
        return draws[lo:hi]
    return type(draws)(take_rows(d, lo, hi) for d in draws)


def build_augment_fn(methods, warp_bank=None, rows=None):
    '''Compose [(name, options)] into ``fn(images [B,H,W,C] float, gen) ->
    images``, routed as in the JAX package: the fused chain where
    ``routes_fused`` holds (even when a bank exists), else the composed
    chain, with ``warp_bank`` (build_warp_bank) serving a random_warp of
    its size and the per-step solve any other. With ``rows`` (lo, hi, b)
    the images are rows [lo, hi) of a batch of b (a data-parallel rank's):
    the draws are the whole batch's, and the images take their rows of
    them, so every rank augments as one device augmenting the batch.'''

    def draw(shape, gen, bank):
        if rows is None:
            return draw_chain(methods, shape, gen, bank)
        lo, hi, b = rows
        return take_rows(draw_chain(methods, (b,) + tuple(shape[1:]), gen,
                                    bank), lo, hi)

    def apply_all(images, gen):
        if routes_fused(methods, images.shape):
            return apply_fused_chain(methods, images,
                                     draw(images.shape, gen, None))
        draws = draw(images.shape, gen, warp_bank)
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
