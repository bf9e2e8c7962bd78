'''Device time of the CCA, NCHW tconv backward, head conv (forward and
backward) and warp resample kernels at the shapes their paths call them
with:

    python3 tools/profile_torch_sites.py [--repo DIR] [--out FILE] [--warp]
        [--stencil | --leaky | --rate3] [--sweep | --sweep-head | --sweep-warp |
        --sweep-stencil]

On one GPU, with seeded inputs, it times:

- ``cca`` (ops/kernels/cca.py) on the evaluate path's region-metric calls:
  the thresholded, opened predictions of 20 slices of chip_smoke.py's
  phase-4 records (a seeded unet.yaml checkpoint, resized by 0.5 as
  metrics.yaml and the Visualizer do) at the 100 PR thresholds,
  [2000, 128, 128], and their labels, [20, 128, 128]; chip_smoke.py's
  phase-3c plane sets; and one set above the shared-memory route's cap,
  [2, 384, 384] noise;
- ``tconv2x2_bwd`` (ops/kernels/tconv2x2_bwd.py) at unet.yaml's decoder
  sites up_0-up_2 at the training batch of 8, with dx;
- ``stencil_conv`` (the 1x1 logits head, 3 -> 1 at 256 x 256) at B=8 (the
  training forward) and B=64 (prediction), and ``stencil_conv_bwd`` at the
  head at B=8 (the training backward, with dx);
- ``warp_twopass`` (ops/kernels/warp_twopass.py) at chip_smoke.py's two
  banked-step sites, [8, 256, 256, 6] d=8 at a bank flow and a random flow
  past +-d, and at a zero flow; ``warp_crop`` at chip_smoke.py's four
  fused-chain sites, [8, 268, 268, 6] -> 256 x 256 at d=8 and 18, and at a
  zero flow; and beside each kernel's shape, ``copy_`` of a buffer that
  moves the same bytes (read once, written once: the bytes of its bound),
  what a plain 16-byte stream of those bytes takes on the card. ``--warp``
  times these alone. Each warp row names its route (``route``; a parent
  without one has only the direct kernel).

Each call is split by the name of every kernel it launches, with
chip_smoke.py's yardstick: torch.profiler over 10 calls, the fullest of
three windows, beside the CUDA-event time around one Python call (median
of 20, host time inside) and the call's bound (chip_smoke.bound: each
input read once and each output written once). ``--repo`` imports the port
from another checkout (a parent commit unpacked with ``git archive``) and
times it with this checkout's yardstick and inputs, so two versions can be
compared on one card; ``--out`` writes the numbers as JSON;
``--sweep-head`` times the head backward's pointwise route at every tile
size (ops/kernels/stencil_conv_bwd.py: MAX_TILE). ``--sweep``
times instead ``tconv2x2_bwd`` at every tile height its plan allows at the
three sites (ops/kernels/tconv2x2_bwd.py: TUNED) and ``cca`` on both
routes (ops/kernels/cca.py: route), for the rules' choices;
``--sweep-warp`` times both warp kernels at their main-path shapes, at a
smooth and a random flow, at every strip width and segment height whose
tile fits (ops/kernels/warp_twopass.py: TUNED) and on the direct route,
beside the plan's choice. ``--stencil`` times instead the NHWC stencil
conv at MulmoUNet's encoder conv_0 and head (f32 and bf16, B=8 and 64),
the NCHW stencil conv and backward at unet.yaml + bf16.yaml's
down_2.conv_0 (bf16 and f32, B=8), and the NCHW stencil conv at
unet.yaml + leakyReLU.yaml's nine sites (``LEAKY_SITES``: seven shapes,
f32 and bf16, B=8 and 64, no relu: the leaky relu is a separate op), each
labelled with its route and beside ``F.conv2d`` with the bias
(``--leaky`` these alone);
``--rate3`` times instead the sites of unet.yaml at upsampling rate 3
(243 x 243 crops, chip_smoke.py phase 21): the 1x1 head (3 -> 1) forward
and backward at B=8 beside ``F.conv2d`` and ``convolution_backward``, and
``cca`` on the rate-3 evaluate path's planes, 121 x 121 (243 resized by
0.5): the thresholded, opened predictions of 22, 20 and 10 slices at the
100 PR thresholds and the labels of 64, 32, 22, 20 and 10 slices, from the
seeded checkpoint's probabilities on the phase-4 records, resized to
243 x 243 first;
``--sweep-stencil`` times the three stencil tiles at every tile height
that fits (the NCHW forward's also at runs of 4 and 8 pixels, each
exact channel group and one or two lanes an item; the backward's at
several block caps), beside the plans' choices.
It imports nothing of JAX and builds the kernels with nvcc.
'''

import argparse
import functools
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (before --repo goes on the path)

# (site, Ci, Co, input H = W) of unet.yaml's transposed convs at 256 x 256
TCONV_SITES = (('up_0', 12, 12, 32), ('up_1', 12, 6, 64), ('up_2', 6, 3, 128))
TRAIN_BATCH, PREDICT_BATCH = 8, 64
# unet.yaml + leakyReLU.yaml's stencil sites: (names, Ci, Co, H = W), 3 x 3
# SAME, each conv alone (down_1.conv_1 and up_1.conv_1, down_0.conv_1 and
# up_2.conv_1 share a shape)
LEAKY_SITES = (('down_0.conv_0', 5, 3, 256),
               ('down_0.conv_1 up_2.conv_1', 3, 3, 256),
               ('down_1.conv_0', 3, 6, 128),
               ('down_1.conv_1 up_1.conv_1', 6, 6, 128),
               ('down_2.conv_0', 6, 12, 64),
               ('up_1.conv_0', 12, 6, 128),
               ('up_2.conv_0', 6, 3, 256))
EVAL_SLICES = 20   # metrics/region.py: PIXEL_BUDGET // (100 * 128 * 128)


def _short(name):
    name = name.replace('(anonymous namespace)::', '')
    return name.split('(')[0].replace('void ', '')[:60]


def cca_sets(device):
    '''{label: [N, H, W] bool on the card}: the evaluate path's two calls
    of a chunk, chip_smoke.py's phase-3c sets and a set over the cap.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.metrics import region
    from dnncancerannotator_torch.ops.morphology import morph_open
    from dnncancerannotator_torch.utils.viz import PR_THRESHOLDS

    work = os.path.join(HERE, 'build', 'profile_torch_sites')
    data_paths = chip_smoke.write_records(os.path.join(work, 'data'))
    save_path = os.path.join(work, 'run')
    config = chip_smoke.write_save_path(save_path, data_paths, device)
    eng = engine.Engine(config, seed=chip_smoke.SEED, device=device)
    eng.build((chip_smoke.BATCH, chip_smoke.SIZE, chip_smoke.SIZE, 5))
    eng.load(os.path.join(save_path, 'checkpoints', 'ckpt-1'))
    with torch.no_grad():
        y, probs, _, _ = chip_smoke._first_batch(eng, data_paths)
        # the Visualizer at a ratio of 1: 256 x 256 planes, chunks of 5
        _, p1 = region._resized(y[:5], probs[:5], 1.0)
        y, p = region._resized(y[:EVAL_SLICES], probs[:EVAL_SLICES], 0.5)
        thresholds = torch.tensor(PR_THRESHOLDS, dtype=torch.float32,
                                  device=device)
        opened = morph_open(p, 5)
        preds = opened[:, None] >= thresholds[None, :, None, None]
        preds1 = morph_open(p1, 5)[:, None] >= \
            thresholds[None, :, None, None]
    size = chip_smoke.SIZE
    rng = np.random.default_rng(chip_smoke.SEED)
    ii, jj = np.mgrid[:size, :size]
    sets = {
        f'eval predictions [{EVAL_SLICES * len(PR_THRESHOLDS)},128,128]':
            preds.reshape(-1, *preds.shape[2:]),
        f'eval labels [{EVAL_SLICES},128,128]': y > 0.5,
        'one slice x 100 thresholds [100,128,128]': preds[0],
        'spiral [1,256,256]': chip_smoke.spiral_mask(size, size)[None],
        'checkerboard [1,256,256]': ((ii + jj) % 2 == 0)[None],
        'all ones [1,256,256]': np.ones((1, size, size), bool),
        'all zeros [1,256,256]': np.zeros((1, size, size), bool),
        'noise p=0.6 [4,256,256]': rng.random((4, size, size)) < 0.6,
        'noise [3,192,300]': rng.random((3, 192, 300)) < 0.55,
        'noise over the cap [2,384,384]': rng.random((2, 384, 384)) < 0.55,
        'eval predictions 256 [500,256,256]':
            preds1.reshape(-1, *preds1.shape[2:]),
    }
    return {k: torch.as_tensor(v, device=device).contiguous()
            for k, v in sets.items()}


def rate3_jobs(device):
    '''(label, call, bound ms) of ``--rate3``'s head and CCA calls, each
    kernel checked against its plain version.'''
    from dnncancerannotator_torch.metrics import region
    from dnncancerannotator_torch.ops import image as image_ops
    from dnncancerannotator_torch.ops.kernels import cca as K
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.morphology import morph_open
    from dnncancerannotator_torch.utils.viz import PR_THRESHOLDS
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward

    side, jobs = 243, []
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 17)
    x = torch.rand((TRAIN_BATCH, 3, side, side), generator=gen,
                   device=device)
    w = torch.randn((1, 3, 1, 1), generator=gen, device=device)
    bias = torch.randn((1,), generator=gen, device=device)
    pads = ((0, 0), (0, 0))
    out = SC.stencil_conv(x, w, bias, pads)
    chip_smoke._check_close('head @243', out, SC.plain(x, w, bias, pads))
    g = torch.randn(out.shape, generator=gen, device=device)
    got = SCB.stencil_conv_bwd(x, g, w, pads)
    for a, b, tol in zip(got, SCB.plain(x, g, w, pads),
                         (chip_smoke.DX_TOL, chip_smoke.DW_TOL,
                          chip_smoke.DW_TOL)):
        chip_smoke._check_close('head bwd @243', a, b, tol)
    fwd_bound = chip_smoke.bound(chip_smoke.nbytes(x, w, bias, out),
                                 2 * out.numel() * 3)[0]
    bwd_bound = chip_smoke.bound(chip_smoke.nbytes(x, g, w, *got),
                                 4 * g.numel() * 3)[0]
    label = f'1x1 3->1 @{side} B={TRAIN_BATCH}'
    jobs += [
        (f'stencil_conv head {label} '
         f'({SC.route(3, 1, 1, 1, pads, side, side)})',
         functools.partial(SC.stencil_conv, x, w, bias, pads), fwd_bound),
        (f'F.conv2d head {label}', functools.partial(F.conv2d, x, w, bias),
         fwd_bound),
        (f'stencil_conv_bwd head {label}',
         functools.partial(SCB.stencil_conv_bwd, x, g, w, pads), bwd_bound),
        (f'convolution_backward head {label}',
         functools.partial(conv_bwd, g, x, w, [1], [1, 1], [0, 0], [1, 1],
                           False, [0, 0], 1, [True, True, True]), bwd_bound)]

    from dnncancerannotator_torch import engine
    work = os.path.join(HERE, 'build', 'profile_torch_sites')
    data_paths = chip_smoke.write_records(os.path.join(work, 'data'))
    save_path = os.path.join(work, 'run')
    config = chip_smoke.write_save_path(save_path, data_paths, device)
    eng = engine.Engine(config, seed=chip_smoke.SEED, device=device)
    eng.build((chip_smoke.BATCH, chip_smoke.SIZE, chip_smoke.SIZE, 5))
    eng.load(os.path.join(save_path, 'checkpoints', 'ckpt-1'))
    with torch.no_grad():
        y, probs, _, _ = chip_smoke._first_batch(eng, data_paths)
        both = image_ops.resize_bilinear(
            torch.stack([y.float(), probs.squeeze(-1)], -1), side, side)
        y, p = region._resized(both[..., 0], both[..., 1], 0.5)
        thresholds = torch.tensor(PR_THRESHOLDS, dtype=torch.float32,
                                  device=device)
        preds = morph_open(p, 5)[:, None] >= thresholds[None, :, None, None]
    hw = tuple(p.shape[1:])
    sets = {f'eval predictions [{n * 100},{hw[0]},{hw[1]}]':
            preds[:n].reshape(-1, *hw) for n in (22, 20, 10)}
    sets.update({f'eval labels [{n},{hw[0]},{hw[1]}]': y[:n] > 0.5
                 for n in (64, 32, 22, 20, 10)})
    for name, masks in sets.items():
        masks = masks.contiguous()
        got = K.cca_raw_labels(masks)
        if not torch.equal(got, K.plain(masks)):
            raise AssertionError(f'cca {name} differs from its plain version')
        jobs.append((f'cca rate 3 {name} ({K.route(*masks.shape)})',
                     functools.partial(K.cca_raw_labels, masks),
                     chip_smoke.bound(chip_smoke.nbytes(masks, got),
                                      4 * masks.numel())[0]))
    return jobs


def sweep_cca(device):
    '''Device ms of cca on either route at a range of plane counts: slices
    of the evaluate path's predictions at 128 x 128 and 256 x 256, and the
    phase-3c sets at 256 x 256.'''
    from dnncancerannotator_torch.ops.kernels import cca as K

    sets = cca_sets(device)
    preds = next(iter(sets.values()))
    cases = {f'eval predictions [{n},128,128]': preds[:n]
             for n in (1, 4, 20, 100, 400, 2000)}
    cases.update((k, v) for k, v in sets.items() if '256' in k)
    big = sets['eval predictions 256 [500,256,256]']
    cases.update((f'eval predictions [{n},256,256]', big[:n])
                 for n in (20, 132, 500))
    rng = np.random.default_rng(1)
    cases['noise p=0.6 [132,256,256]'] = torch.as_tensor(
        rng.random((132, 256, 256)) < 0.6, device=device)
    min_planes, label32 = K.MIN_PLANES, K.LABEL32_MAX
    for label, masks in cases.items():
        line = []
        for route in ('global', 'shared'):
            K.MIN_PLANES = len(masks) + 1 if route == 'global' else 1
            K.LABEL32_MAX = 0 if route == 'global' else label32
            if not torch.equal(K.cca_raw_labels(masks), K.plain(masks)):
                raise AssertionError(f'cca {label} ({route}) differs')
            split = chip_smoke._fullest_split(
                functools.partial(K.cca_raw_labels, masks))
            line.append(f'{route} {sum(v for v, _ in split.values()):.4f}')
        print(f'cca {label:36s} device ms  ' + '  '.join(line), flush=True)
    K.MIN_PLANES, K.LABEL32_MAX = min_planes, label32


def sweep(device):
    '''Device ms of tconv2x2_bwd at every tile height that fits, per site
    (B=8, with dx), beside the rule's plan; then ``sweep_cca``.'''
    from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    b = TRAIN_BATCH
    for site, ci, co, hw in TCONV_SITES:
        x = torch.rand((b, ci, hw, hw), generator=gen, device=device)
        g = torch.randn((b, co, 2 * hw, 2 * hw), generator=gen,
                        device=device)
        w = torch.randn((ci, co, 2, 2), generator=gen, device=device) * 0.3
        want = TCB.plain(x, g, w)
        key = (b, ci, co, hw, hw, True)
        tuned = TCB.TUNED.pop(key, None)
        print(f'{site}: rule {TCB.rule(*key)}', flush=True)
        for th in TCB.TILE_HEIGHTS:
            TCB.TUNED[key] = th
            pl = TCB.plan(*key)
            if th > hw or pl.smem > TCB.SMEM_CAP:
                continue
            got = TCB.tconv2x2_bwd(x, g, w)
            err = max(float((a - c).abs().max() / c.abs().max())
                      for a, c in zip(got, want))
            split = chip_smoke._fullest_split(
                functools.partial(TCB.tconv2x2_bwd, x, g, w))
            ms = sum(v for v, _ in split.values())
            n = sum(c for _, c in split.values())
            print(f'  tile_h {th:2d} cluster {pl.cluster} blocks '
                  f'{pl.blocks:4d} smem {pl.smem:6d} device {ms:.4f} ms '
                  f'launches {n:.1f} rel err {err:.2e}', flush=True)
        del TCB.TUNED[key]
        if tuned is not None:
            TCB.TUNED[key] = tuned
    sweep_cca(device)


def sweep_head(device):
    '''Device ms of stencil_conv_bwd's pointwise route at the head (B=8,
    with dx) at every tile size from 256 to 4096 pixels (the plan's
    MAX_TILE, with STAGE_BYTES to hold it), beside the plan's own.'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    x = torch.rand((TRAIN_BATCH, 3, chip_smoke.SIZE, chip_smoke.SIZE),
                   generator=gen, device=device)
    g = torch.randn((TRAIN_BATCH, 1, chip_smoke.SIZE, chip_smoke.SIZE),
                    generator=gen, device=device)
    w = torch.randn((1, 3, 1, 1), generator=gen, device=device)
    pads = ((0, 0), (0, 0))
    want = SCB.plain(x, g, w, pads)
    saved = SCB.MAX_TILE, SCB.STAGE_BYTES
    print(f'stencil_conv_bwd head B={TRAIN_BATCH}: plan '
          f'{SCB.plan(TRAIN_BATCH, 3, 1, 256, 256)}', flush=True)
    for tile in (256, 512, 1024, 2048, 4096):
        SCB.MAX_TILE, SCB.STAGE_BYTES = tile, max(saved[1], 16 * tile)
        SCB.plan.cache_clear()
        pl = SCB.plan(TRAIN_BATCH, 3, 1, 256, 256)
        got = SCB.stencil_conv_bwd(x, g, w, pads)
        err = max(float((a - c).abs().max() / c.abs().max())
                  for a, c in zip(got, want))
        split = chip_smoke._fullest_split(
            functools.partial(SCB.stencil_conv_bwd, x, g, w, pads))
        print(f'  tile {tile:5d} blocks {pl.blocks:4d} slices {pl.slices:3d} '
              f'smem {pl.smem:6d} device '
              f'{sum(v for v, _ in split.values()):.4f} ms launches '
              f'{sum(c for _, c in split.values()):.1f} rel err {err:.2e}',
              flush=True)
    SCB.MAX_TILE, SCB.STAGE_BYTES = saved
    SCB.plan.cache_clear()


def _route(module, *shape):
    route = getattr(module, 'route', None)
    return route(*shape) if route else 'direct'


def _copy_job(label, n_bytes, device):
    '''(label, call, bound ms): ``copy_`` of n_bytes / 8 floats, which reads
    and writes n_bytes in all.'''
    n = n_bytes // 8
    src = torch.rand(n, device=device)
    dst = torch.empty_like(src)
    return (f'copy_ of the same bytes ({label})',
            functools.partial(dst.copy_, src),
            chip_smoke.bound(n_bytes, 0)[0])


def warp_jobs(device):
    '''(label, call, bound ms) of the two warp kernels at their main-path
    sites and a zero flow, each checked equal to its plain version, and a
    copy of each shape's bytes.'''
    from dnncancerannotator_torch.ops.kernels import warp_crop as WC
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

    jobs = []
    d, image, flows = chip_smoke.warp_inputs(device)
    flows['zero flow'] = torch.zeros_like(flows['bank flow'])
    for label, flow in flows.items():
        got = WT.warp_twopass(image, flow, d)
        if not torch.equal(got, WT.plain(image, flow, d)):
            raise AssertionError(f'warp_twopass {label} differs')
        n_bytes = chip_smoke.nbytes(image, flow, got)
        jobs.append((f'warp_twopass {list(image.shape)} d={d} {label} '
                     f'({_route(WT, *image.shape, d)})',
                     functools.partial(WT.warp_twopass, image, flow, d),
                     chip_smoke.bound(n_bytes, 12 * got.numel())[0]))
    jobs.append(_copy_job('warp_twopass', n_bytes, device))
    image, off, sites = chip_smoke.crop_inputs(device)
    sites.append((sites[0][0], 'zero flow', torch.zeros_like(sites[0][2]),
                  torch.zeros_like(sites[0][3])))
    b, size = image.shape[0], chip_smoke.SIZE
    for d, label, fy, fx in sites:
        got = WC.warp_crop(image, fy, fx, off, d)
        if not torch.equal(got, WC.plain(image, fy, fx, off, d)):
            raise AssertionError(f'warp_crop d={d} {label} differs')
        n_bytes = 2 * chip_smoke.nbytes(got) + chip_smoke.nbytes(fy, fx, off)
        jobs.append((f'warp_crop d={d} {label} '
                     f'({_route(WC, b, size, size, image.shape[3], d)})',
                     functools.partial(WC.warp_crop, image, fy, fx, off, d),
                     chip_smoke.bound(n_bytes, 12 * got.numel())[0]))
    jobs.append(_copy_job('warp_crop', n_bytes, device))
    return jobs


def sweep_warp(device):
    '''Device ms of both warp kernels at their main-path shapes, at a smooth
    and a random flow, for every strip width and segment height whose tile
    fits a block, and on the direct route; the plan's choice marked.'''
    from dnncancerannotator_torch.ops.kernels import warp_crop as WC
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

    d, image, flows = chip_smoke.warp_inputs(device)
    cases = [(f'warp_twopass d={d} {label}', image.shape, d,
              functools.partial(WT.warp_twopass, image, flow, d),
              WT.plain(image, flow, d)) for label, flow in flows.items()]
    image, off, sites = chip_smoke.crop_inputs(device)
    b, size, c = image.shape[0], chip_smoke.SIZE, image.shape[3]
    cases += [(f'warp_crop d={d} {label}', (b, size, size, c), d,
               functools.partial(WC.warp_crop, image, fy, fx, off, d),
               WC.plain(image, fy, fx, off, d))
              for d, label, fy, fx in sites]

    def device_ms(call, want):
        if not torch.equal(call(), want):
            raise AssertionError('differs from the plain version')
        split = chip_smoke._fullest_split(call)
        return sum(ms for ms, _ in split.values())

    for label, shape, d, call, want in cases:
        key = (*shape, d)
        WT.plan.cache_clear()
        chosen = WT.plan(*key)[:2]
        print(f'{label}: plan tw {chosen[0]} seg {chosen[1]} '
              f'({WT.route(*key)})', flush=True)
        for tw, seg in itertools.product((32, 64, 128), (8, 16, 32, 64, 128)):
            WT.TUNED[key] = (tw, seg)
            WT.plan.cache_clear()
            if WT.route(*key) != 'tile':
                continue
            pl = WT.plan(*key)
            mark = '  <- plan' if (tw, seg) == chosen else ''
            print(f'  tw {tw:3d} seg {seg:3d} blocks '
                  f'{pl.grid[0] * pl.grid[1] * pl.grid[2]:4d} smem '
                  f'{pl.smem:6d} reread {pl.reread:.2f} device '
                  f'{device_ms(call, want):.4f} ms{mark}', flush=True)
        del WT.TUNED[key]
        cap, WT.MAX_REREAD = WT.MAX_REREAD, 0.0
        WT.plan.cache_clear()
        print(f'  direct route device {device_ms(call, want):.4f} ms',
              flush=True)
        WT.MAX_REREAD = cap
        WT.plan.cache_clear()


def stencil_jobs(device):
    '''(label, call, bound ms) of the stencil kernels at their main-path
    shapes on seeded inputs: the NHWC stencil conv at
    MulmoUNet's encoder conv_0 (3x3 SAME 1 -> 16 with relu, channel 2 of a
    [B, 256, 256, 5] batch read in place in f32; the cast channel,
    contiguous, in bf16) and at its head (1x1 16 -> 1), at B=8 and 64; the
    NCHW stencil conv and its backward at unet.yaml + bf16.yaml's
    down_2.conv_0 (3x3 6 -> 12 with relu at 64 x 64, B=8, the cotangent
    masked by the forward's relu) and at its head (1x1 3 -> 1 at 256 x 256,
    the pointwise route), in bf16 and f32; and beside each NCHW site its
    library call (``F.conv2d``, ``convolution_backward``). Each checked
    against its plain version; each label names its route (a parent without
    one has the direct kernels).'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
    F = torch.nn.functional

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 13)
    size, same, zero = chip_smoke.SIZE, ((1, 1), (1, 1)), ((0, 0), (0, 0))
    jobs = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = 'f32' if dtype == torch.float32 else 'bf16'
        for nb in (TRAIN_BATCH, PREDICT_BATCH):
            batch = torch.rand((nb, size, size, 5), generator=gen,
                               device=device)
            feats = torch.rand((nb, size, size, 16), generator=gen,
                               device=device).to(dtype)
            sites = (('encoder conv_0 3x3 1->16 relu',
                      batch[..., 2:3] if dtype == torch.float32
                      else batch[..., 2:3].to(dtype), 16, 3, same, True),
                     ('head 1x1 16->1', feats, 1, 1, zero, False))
            for label, x, co, k, pads, relu in sites:
                ci = x.shape[3]
                w = (torch.randn((co, ci, k, k), generator=gen,
                                 device=device) * 0.3).to(dtype)
                b = torch.randn((co,), generator=gen, device=device).to(dtype)
                got = SN.stencil_conv_nhwc(x, w, b, pads, relu)
                want = SN.plain(x, w, b, pads, relu)
                err = float((got.float() - want.float()).abs().max())
                # bf16: an ulp where the plain version's sum order rounds
                # the other way
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                if err > tol * float(want.float().abs().max()):
                    raise AssertionError(f'stencil_conv_nhwc {label} differs '
                                         f'by {err}')
                route = (SN.route(nb, size, size, ci, co, k, k, pads,
                                  x.element_size())
                         if hasattr(SN, 'route') else 'direct')
                work = (x.element_size() * x[..., :ci].numel()
                        + chip_smoke.nbytes(w, b, got),
                        2 * got.numel() * ci * k * k)
                jobs.append((f'stencil_conv_nhwc {tag} B={nb} {label} '
                             f'({route})',
                             functools.partial(SN.stencil_conv_nhwc, x, w, b,
                                               pads, relu),
                             chip_smoke.bound(*work)[0]))
        conv_bwd = torch.ops.aten.convolution_backward
        for label, ci, co, hw, k, pads, relu in (
                ('down_2.conv_0 3x3 6->12 relu', 6, 12, 64, 3, same, True),
                ('head 1x1 3->1', 3, 1, size, 1, zero, False)):
            x = torch.rand((TRAIN_BATCH, ci, hw, hw), generator=gen,
                           device=device).to(dtype)
            w = (torch.randn((co, ci, k, k), generator=gen, device=device)
                 * 0.3).to(dtype)
            b = torch.randn((co,), generator=gen, device=device).to(dtype)
            out = SC.stencil_conv(x, w, b, pads, relu)
            err = float((out.float() - SC.plain(x, w, b, pads, relu)
                         .float()).abs().max())
            if err > 1e-2 * float(out.float().abs().max()):
                raise AssertionError(f'stencil_conv {tag} {label} differs by '
                                     f'{err}')
            fwd_route = SC.route(ci, co, k, k, pads, hw, hw)
            name = f'{tag} B={TRAIN_BATCH} {label} @{hw}'
            jobs.append((f'stencil_conv {name} ({fwd_route})',
                         functools.partial(SC.stencil_conv, x, w, b, pads,
                                           relu),
                         chip_smoke.bound(chip_smoke.nbytes(x, w, b, out),
                                          2 * out.numel() * ci * k * k)[0]))
            jobs.append((f'library F.conv2d {name}',
                         functools.partial(F.conv2d, x, w, b,
                                           padding=k // 2), None))
            g = torch.randn(out.shape, generator=gen, device=device).to(dtype)
            if relu:
                g = g * (out > 0)
            got = SCB.stencil_conv_bwd(x, g, w, pads)
            want = SCB.plain(x, g, w, pads)
            for a, c in zip(got, want):
                err = float((a.float() - c.float()).abs().max())
                scale = float(c.float().abs().max())
                if err > (1e-4 if dtype == torch.float32 else 2e-2) * scale:
                    raise AssertionError(f'stencil_conv_bwd {tag} {label} '
                                         f'differs by {err} of {scale}')
            route = (SCB.route(TRAIN_BATCH, ci, co, hw, hw, k, k, pads)
                     if hasattr(SCB, 'route') else
                     'split' if fwd_route == 'stencil' else fwd_route)
            jobs.append((f'stencil_conv_bwd {name} ({route})',
                         functools.partial(SCB.stencil_conv_bwd, x, g, w,
                                           pads),
                         chip_smoke.bound(chip_smoke.nbytes(x, g, w, *got),
                                          4 * g.numel() * ci * k * k)[0]))
            jobs.append((f'library convolution_backward {name}',
                         functools.partial(conv_bwd, g, x, w, [co], [1, 1],
                                           [k // 2, k // 2], [1, 1], False,
                                           [0, 0], 1, [True] * 3), None))
    return jobs + leaky_jobs(device)


def leaky_jobs(device, batches=(TRAIN_BATCH, PREDICT_BATCH),
               dtypes=(torch.float32, torch.bfloat16)):
    '''(label, call, bound ms) of the NCHW stencil conv at unet.yaml +
    leakyReLU.yaml's sites (LEAKY_SITES, no relu), and beside each
    ``F.conv2d`` with the bias; each checked against its plain version.'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    F = torch.nn.functional
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 14)
    same, jobs = ((1, 1), (1, 1)), []
    for dtype in dtypes:
        tag = 'f32' if dtype == torch.float32 else 'bf16'
        for nb in batches:
            for names, ci, co, hw in LEAKY_SITES:
                x = torch.rand((nb, ci, hw, hw), generator=gen,
                               device=device).to(dtype)
                w = (torch.randn((co, ci, 3, 3), generator=gen,
                                 device=device) * 0.3).to(dtype)
                b = torch.randn((co,), generator=gen, device=device).to(dtype)
                out = SC.stencil_conv(x, w, b, same)
                err = float((out.float() - SC.plain(x, w, b, same)
                             .float()).abs().max())
                if err > (1e-5 if dtype == torch.float32 else 1e-2) * float(
                        out.float().abs().max()):
                    raise AssertionError(f'stencil_conv {tag} {names} '
                                         f'differs by {err}')
                route = SC.route(ci, co, 3, 3, same, hw, hw)
                name = f'{tag} B={nb} leaky {names} 3x3 {ci}->{co} @{hw}'
                jobs.append((f'stencil_conv {name} ({route})',
                             functools.partial(SC.stencil_conv, x, w, b,
                                               same),
                             chip_smoke.bound(
                                 chip_smoke.nbytes(x, w, b, out),
                                 2 * out.numel() * ci * 9)[0]))
                jobs.append((f'library F.conv2d {name}',
                             functools.partial(F.conv2d, x, w, b, padding=1),
                             None))
    return jobs


def sweep_nchw_stencil(device):
    '''Device ms of the NCHW forward's tile at unet.yaml + leakyReLU.yaml's
    seven shapes in f32 (B=8 and 64) at every channel group, run length,
    lanes an item (1 or 2) and height (1, 2, 4, 8 or 16 rows) that fits,
    beside the plan's choice.'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC

    def device_ms(call):
        split = chip_smoke._fullest_split(call)
        return sum(ms for ms, _ in split.values())

    nchw_plan = SC.plan
    for label, call, _ in leaky_jobs(device, dtypes=(torch.float32,)):
        if not label.startswith('stencil_conv'):
            continue
        x, w = call.args[0], call.args[1]
        shape = (x.shape[0], x.shape[1], w.shape[0], *x.shape[2:],
                 *w.shape[2:], call.args[3])
        print(f'{label}: plan {nchw_plan(*shape)} device '
              f'{device_ms(call):.4f} ms', flush=True)
        for (cpt, px), ks, rows in itertools.product(
                SC.TILES, (1, 2), (1, 2, 4, 8, 16)):
            if cpt not in SC.tile_groups(w.shape[0]) or rows > x.shape[2]:
                continue
            pl = nchw_plan(*shape, rows=rows, px=px, cpt=cpt, ks=ks)
            if pl.smem > SC._build.MAX_SMEM_BYTES:
                continue
            SC.plan = functools.partial(nchw_plan, rows=rows, px=px,
                                        cpt=cpt, ks=ks)
            print(f'  cpt {cpt:2d} px {px} ks {ks} rows {rows:2d}: blocks '
                  f'{pl.blocks:5d} threads {pl.threads:3d} smem '
                  f'{pl.smem:6d} device {device_ms(call):.4f} ms',
                  flush=True)
        SC.plan = nchw_plan


def sweep_stencil(device):
    '''Device ms of the three stencil tiles at their main-path shapes at
    every tile height that fits: the NCHW forward's (``sweep_nchw_stencil``),
    the NHWC tile route at 1-8 rows (as ``stencil_jobs``), and the
    backward's tile form at 1-8 rows, a cap of 64-256 blocks and clusters
    of 2-8 blocks, beside the plans' own choices.'''
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN

    def device_ms(call):
        split = chip_smoke._fullest_split(call)
        return sum(ms for ms, _ in split.values())

    sweep_nchw_stencil(device)
    jobs = stencil_jobs(device)
    plan, route = SN.plan, SN.route
    for label, call, _ in jobs:
        if not label.startswith('stencil_conv_nhwc') or 'B=64' in label:
            continue
        print(f'{label}: plan device {device_ms(call):.4f} ms', flush=True)
        for rows in (1, 2, 3, 4, 6, 8):
            SN.plan = functools.partial(plan, rows=rows)
            SN.route.cache_clear()
            x = call.args[0]
            shape = (*x.shape[:3], x.shape[3], call.args[1].shape[0],
                     *call.args[1].shape[2:], call.args[3], x.element_size())
            if SN.route(*shape) != 'tile':
                continue
            print(f'  rows {rows}: smem {SN.plan(*shape).smem:6d} device '
                  f'{device_ms(call):.4f} ms', flush=True)
        SN.plan, SN.route = plan, route
        SN.route.cache_clear()

    tile_plan, cap, cluster = SCB.tile_plan, SCB.MAX_TILE_BLOCKS, SCB.CLUSTER
    for label, call, _ in jobs:
        if not label.startswith('stencil_conv_bwd') or 'down_2' not in label:
            continue
        shape = (TRAIN_BATCH, 6, 12, 64, 64, 3, 3, ((1, 1), (1, 1)))
        print(f'{label}: plan {SCB.tile_plan(*shape)} device '
              f'{device_ms(call):.4f} ms', flush=True)
        for rows, blocks, size in itertools.product((1, 2, 4, 8),
                                                    (64, 128, 256), (2, 4, 8)):
            SCB.MAX_TILE_BLOCKS, SCB.CLUSTER = blocks, size
            tile_plan.cache_clear()
            SCB.tile_plan = functools.partial(tile_plan, rows=rows)
            SCB.route.cache_clear()
            if SCB.route(*shape) != 'tile':
                continue
            pl = SCB.tile_plan(*shape)
            print(f'  rows {rows:2d} cap {blocks:3d} cluster {size}: blocks '
                  f'{pl.blocks:3d} smem {pl.smem:6d} device '
                  f'{device_ms(call):.4f} ms', flush=True)
        SCB.tile_plan, SCB.MAX_TILE_BLOCKS = tile_plan, cap
        SCB.CLUSTER = cluster
        tile_plan.cache_clear()
        SCB.route.cache_clear()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--repo', default=HERE)
    parser.add_argument('--out', default=None)
    parser.add_argument('--sweep', action='store_true')
    parser.add_argument('--sweep-head', action='store_true',
                        help='time the head backward at every tile size')
    parser.add_argument('--sweep-warp', action='store_true',
                        help='time the warp kernels at every tile shape')
    parser.add_argument('--warp', action='store_true',
                        help='time the warp kernels\' sites alone')
    parser.add_argument('--stencil', action='store_true',
                        help='time the NHWC stencil conv and the stencil '
                             'backward\'s sites alone')
    parser.add_argument('--sweep-stencil', action='store_true',
                        help='time the stencil tiles at every tile height')
    parser.add_argument('--rate3', action='store_true',
                        help='time the rate-3 head and CCA sites alone')
    parser.add_argument('--leaky', action='store_true',
                        help='time unet.yaml + leakyReLU.yaml\'s NCHW stencil '
                             'sites alone')
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops.kernels import cca as K
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB

    device = engine.resolve_device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'port from {os.path.abspath(args.repo)}; card: {card}', flush=True)
    if args.sweep:
        return sweep(device)
    if args.sweep_head:
        return sweep_head(device)
    if args.sweep_warp:
        return sweep_warp(device)
    if args.sweep_stencil:
        return sweep_stencil(device)
    jobs = []   # (label, call, bound ms)
    if args.warp:
        return report(warp_jobs(device), args, card)
    if args.stencil:
        return report(stencil_jobs(device), args, card)
    if args.leaky:
        return report(leaky_jobs(device), args, card)
    if args.rate3:
        return report(rate3_jobs(device), args, card)
    for label, masks in cca_sets(device).items():
        got = K.cca_raw_labels(masks)
        if not torch.equal(got, K.plain(masks)):
            raise AssertionError(f'cca {label} differs from its plain version')
        jobs.append((f'cca {label}', functools.partial(K.cca_raw_labels,
                                                       masks),
                     chip_smoke.bound(chip_smoke.nbytes(masks, got),
                                      4 * masks.numel())[0]))
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    b = TRAIN_BATCH
    for site, ci, co, hw in TCONV_SITES:
        x = torch.rand((b, ci, hw, hw), generator=gen, device=device)
        g = torch.randn((b, co, 2 * hw, 2 * hw), generator=gen,
                        device=device)
        w = torch.randn((ci, co, 2, 2), generator=gen, device=device) * 0.3
        got = TCB.tconv2x2_bwd(x, g, w)
        jobs.append((f'tconv2x2_bwd {site} {ci}->{co} @{hw} B={b}',
                     functools.partial(TCB.tconv2x2_bwd, x, g, w),
                     chip_smoke.bound(chip_smoke.nbytes(x, g, w, *got),
                                      4 * g.numel() * ci)[0]))
    w = torch.randn((1, 3, 1, 1), generator=gen, device=device)
    bias = torch.randn((1,), generator=gen, device=device)
    pads = ((0, 0), (0, 0))
    for nb in (TRAIN_BATCH, PREDICT_BATCH):
        x = torch.rand((nb, 3, chip_smoke.SIZE, chip_smoke.SIZE),
                       generator=gen, device=device)
        out = SC.stencil_conv(x, w, bias, pads)
        jobs.append((f'stencil_conv head 1x1 3->1 @256 B={nb}',
                     functools.partial(SC.stencil_conv, x, w, bias, pads),
                     chip_smoke.bound(chip_smoke.nbytes(x, w, bias, out),
                                      2 * out.numel() * 3)[0]))
        if nb == TRAIN_BATCH:
            g = torch.randn(out.shape, generator=gen, device=device)
            got = SCB.stencil_conv_bwd(x, g, w, pads)
            jobs.append((f'stencil_conv_bwd head 1x1 3->1 @256 B={nb}',
                         functools.partial(SCB.stencil_conv_bwd, x, g, w,
                                           pads),
                         chip_smoke.bound(chip_smoke.nbytes(x, g, w, *got),
                                          4 * g.numel() * 3)[0]))
    report(jobs + warp_jobs(device), args, card)


def report(jobs, args, card):
    '''Times each job (CUDA events, then the profiler) and prints and
    writes its row.'''
    # CUDA events first: a profiler session slows later calls on the host
    rows = [dict(call=label, bound_ms=bd,
                 event_ms=chip_smoke._time_fns({'': call})[''])
            for label, call, bd in jobs]
    for row, (_, call, _) in zip(rows, jobs):
        split = chip_smoke._fullest_split(call)
        row['device_ms'] = sum(ms for ms, _ in split.values())
        row['launches'] = sum(n for _, n in split.values())
        row['split'] = {_short(k): v for k, v in split.items()}
        bd = row['bound_ms']
        print(f'{row["call"]:58s} device {row["device_ms"]:.4f} ms  event '
              f'{row["event_ms"]:.4f} ms  bound '
              f'{"-" if bd is None else f"{bd:.4f}"} ms  launches '
              f'{row["launches"]:.1f}', flush=True)
        for name, (ms, n) in sorted(row['split'].items(),
                                    key=lambda kv: -kv[1][0]):
            print(f'         {ms:.4f} ms {n:4.1f}x  {name}', flush=True)
    tconv = [r for r in rows if r['call'].startswith('tconv2x2_bwd')]
    if tconv:
        print(f'tconv2x2_bwd, three sites: device '
              f'{sum(r["device_ms"] for r in tconv):.4f} ms  bound '
              f'{sum(r["bound_ms"] for r in tconv):.4f} ms', flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(dict(card=card, repo=args.repo, rows=rows), fh,
                      indent=1)


if __name__ == '__main__':
    main()
