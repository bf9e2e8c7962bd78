'''Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from dnncancerannotator_torch/csrc;
3. forward kernels: at every site of the unet.yaml prediction path (B=64,
   256 x 256) each kernel against its plain PyTorch version on the same
   inputs, TF32 off, to max|diff| <= 1e-4 * max|ref| (the chain also no
   further from its f64 plain version than F64_RATIO times the plain f32
   version, and again at B=8 with c1 as training calls it, with its bound
   counting c1's write), and the median of 20
   CUDA-event timings of each around the Python call, taken in turns, and
   its device time alone (torch.profiler's summed kernel time of 10 calls,
   over 10; the larger of two such windows), for the kernel, its plain
   version and the library call;
3b. backward and warp kernels: at every site of the training step (B=8,
   256 x 256 crops) each backward kernel against its plain version (the
   data and weight gradients of the plain forward, with the same saved relu
   masks): dx to 1e-5 * max|ref|, dw and db to 2e-5 * max|ref|, with the
   plain f32 version's own error against f64 printed beside (the chain
   backward held to F64_RATIO of it, its dw and db the same bits on two
   calls, and its device time by kernel name and its launches a call,
   CHAIN_BWD_LAUNCHES, from the fullest of three deferred profiler
   windows); the two-pass
   warp on [8, 256, 256, 6] at a flow from a real warp bank and at a random
   flow past +-8 px, exactly equal to its plain version; timings as in 3;
4. prediction: seeded synthetic .tfrecords and a seeded checkpoint, then the
   port's ``predict`` CLI at batch 64 on the card. Checks the file count,
   that every map is finite and in [0, 1], that every kernel launched at
   least (sites x batches) times during the run, and that the maps equal a
   plain-PyTorch forward of the same weights on the card (<= 1e-5);
5. training: seeded synthetic 512 x 512 exams, then the port's ``train``
   CLI with the unet.yaml stack (B=8 256 x 256 crops, banked warp, weighted
   BCE, Adam) for 50 steps in chunks of 25, checkpointing every 25. Checks
   every loss is finite, ckpt-25 and ckpt-50 hold params and optimizer
   state, every kernel launched at least (steps x sites) times, a second
   call resumes at step 50, and ``predict`` maps from the trained
   checkpoint equal the plain forward of its weights. Then one train step's
   loss and every parameter gradient through the kernels against a plain
   train step on the same batch and draws (loss to 1e-5 relative, each
   gradient to 1e-4 * max|ref|, else no further from an f64 step than
   F64_RATIO times the plain step), the train step's time with the kernels and
   plain (CUDA events, median of 20, in turns), its device busy time (a
   deferred profiler window of 5 steps), and the train throughput in
   slices/s, measured differentially: the difference of two ``train`` calls
   that differ only in step count, each the minimum of three.
3c. connected components: the CCA kernel against its plain version, exactly
   equal, on the thresholded, opened predictions of one real slice at the
   region PR curve's 100 thresholds ([100, 128, 128]), on 256 x 256 planes
   of a spiral, a checkerboard, all ones, all zeros and noise at p = 0.6,
   and on [3, 192, 300] noise (H != W, W not a multiple of 32); timings as
   in 3;
3d. input sensitivity: the chain backward with dx at down_0 (which
   training never asks for) on the first predict batch (B=64, 256 x 256)
   against its plain version with the same relu masks, to DX_TOL *
   max|ref|; then d(sum of probabilities)/d(input) through the kernels
   against plain autograd of the plain forward, where a relu or pool
   decision rounded the other way may change a few pixels (see
   sensitivity_site), and the normalized per-channel sensitivity of
   utils/viz.py to DX_TOL * its max;
6. evaluation: the ``train`` CLI with metrics.yaml, ``--validate`` on the
   phase-4 records, ``--early_stop_steps`` and ``--visualize`` for 4 steps
   (val_loss and every metric in the history); then the ``evaluate`` CLI
   with metrics.yaml and every export over phase 5's checkpoints on the
   phase-4 records (160 slices, batch 64). Checks one results.csv row a
   checkpoint with the loss and the 13 metrics, 160 casewise rows and PNGs
   a checkpoint, that the event file reads back with the port's record
   reader, that the CCA kernel ran at least once a batch and checkpoint,
   and that every region count (the metrics.yaml suite, the casewise rows,
   the region PR curves) equals the counts from the plain CCA on the same
   probabilities on the card. Prints the seconds per checkpoint and the
   evaluated slices/s.
3e. unet_big kernel sites: a seeded unet_big forward (64 first filters, 4
   levels, BatchNorm, NHWC, B=8, 256 x 256, train mode) gives the inputs of
   the NHWC pool (down_1..3) and transposed conv (up_0..2) kernels; each
   kernel against its plain version there: the pool forward and backward
   exactly equal, the tconv forward and dx to DX_TOL * max|ref|, dw and db
   to DW_TOL * max|ref|, each no further from its f64 plain version than
   F64_RATIO times the plain f32 version (the 3xTF32 tensor-core GEMM), the
   backward bit-equal across two calls; timings as in 3;
7. unet_big training: the ``train`` CLI with the unet_big + f32 +
   pallas_decoder stack (BIG_CONFIGS; B=8 256 x 256 crops, banked warp,
   weighted BCE, Adam) for 20 steps in chunks of 10, checkpointing every 10,
   then a second call that resumes to 30. Checks every loss is finite, each
   checkpoint holds batch_stats that moved, each of the four NHWC kernels
   launched at least 3 x steps times and the warp kernel every step,
   ``predict`` from ckpt-30 equals a plain forward of its weights (BatchNorm
   on its running statistics; where the two f32 forwards differ by more
   than 1e-5, the maps are held to an f64 forward, no further from it than
   F64_RATIO times the plain f32 forward), one train step's loss, gradients
   and updated batch_stats through the kernels equal a plain step on the
   same batch and draws (held to an f64 step likewise), and the stack without pallas_decoder.yaml launches none
   of the four. Times the train step (kernels and plain) and the train
   throughput as in 5.
3f. crop-fused warp: the warp_crop kernel against its plain version, exactly
   equal, on [8, 268, 268, 6] windows (256 + 2 x 6 of crop jitter) cropped
   to 256 x 256 at d = 8 (data_options.yaml's warp) and d = 18
   (augment_options.yaml's), at the flows of a real per-step solve
   (ops/warp.py:cropped_twopass_flows) and at a random flow past +-d, with
   crop offsets 0, in - out and mirrored ones; timings as in 3;
8. fused augmentation: the ``train`` CLI with the unet.yaml stack and an
   overlay ``deploy_options.fused_aug: true`` after deploy_options.yaml
   (which replaces the whole dict) for 50 steps in chunks of 25 on the
   phase-5 exams: every loss finite, warp_crop launched once a step,
   warp_twopass never, no warp bank solved; then 4 steps with
   ``deploy_options.warp_bank: false`` (the composed per-step solve,
   warp_twopass once a step) and 4 with intra_channelwarp_std5.yaml
   stacked (the exact per-group warps beside the banked warp). On one
   smooth batch and one draw list the fused route against the composed
   per-step route within tests/test_augment_fused.py's bounds (mean |diff|
   < 5e-3, max < 0.25, 99.9th percentile < 0.1); both routes against an f64
   oracle with the rule of tools/chip_fusedaug_parity.py (B=4, 268 -> 256, 6
   channels, 100 points); the augmentation's ms a step on the banked, the
   per-step composed and the fused route (CUDA events, median of 20, in
   turns); the fused chain's train throughput as in 5.

9. profiler windows: torch.profiler slows every later CUDA call on the host,
   so the device times of phases 3-3f and the train-step profiles of
   phases 5, 7 and 8 are taken last, after every host-clock and CUDA-event
   measurement; then a line of the B=8 chain forward's times summed over
   the six sites.

Each phase's wall time is printed when it ends. The last three lines of
stdout are a JSON object of per-kernel results for all thirteen kernels
(with each kernel's bound:
the larger of its bytes over 3.35 TB/s and its FLOPs over the 67 TFLOP/s of
f32 outside the tensor cores, from the inputs of this run, for the 3xTF32
tconv GEMM also 3 x its FLOPs over the 495 TFLOP/s of TF32, the device
times, and the time of one PyTorch call computing the same function where
one exists), the card's
name and power limit, and {"ok": true, "device": {...}}. Without a CUDA
device it exits non-zero before printing any of them.
'''

import contextlib
import copy
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, 'build', 'chip_smoke')
CONFIGS = ('configs/unet.yaml', 'configs/additionals/deploy_options.yaml',
           'configs/additionals/data_options.yaml')
BATCH = 64
SIZE = 256
N_EXAMS = (5, 5)        # cancer, healthy: 160 slices -> batches 64, 64, 32
SLICES_PER_EXAM = 16
SEED = 0
KERNEL_TOL = 1e-4       # relative to max|ref|: f32, <= 9 * 32 terms a sum
MAP_TOL = 1e-5          # absolute, on probabilities
TIMED_RUNS = 20
# training: B=8 256 x 256 crops of 512 x 512 exams (configs/unet.yaml stack)
TRAIN_BATCH = 8
EXAM_SIZE = 512
TRAIN_EXAMS = (2, 2)    # cancer, healthy
TRAIN_SLICES = 4
TRAIN_STEPS = 50
SAVE_FREQ = 25
STEPS_PER_CALL = 25
# relative to max|ref|, each about 10x the worst error measured on an H100
# (dx <= 2.4e-7, dw and db <= 1.9e-6; the plain f32 versions are as far from
# f64): dx sums at most 9 * 32 terms a pixel, dw and db up to 8 * 256 * 256
# pixels a tap
DX_TOL = 1e-5
DW_TOL = 2e-5
# one train step, kernels vs plain: the loss (relative), and each parameter
# gradient relative to its max|ref| (1.0e-6 measured; the forward kernels'
# own rounding can flip a relu mask where a pre-activation is near 0)
LOSS_TOL = 1e-5
STEP_TOL = 1e-4
# the unet_big step's updated BatchNorm statistics, relative to max|ref|
STATS_TOL = 1e-5
# input gradient end to end: the share of values past DX_TOL that relu and
# max-pool decisions rounded the other way may leave (2.3e-4 measured)
SENS_FLIP_SHARE = 1e-3

# sites of the unet.yaml prediction path: (module path, JAX kernel there)
CHAIN_SITES = (
    ('unet.encoder.down_0', 'conv_kernel.py:340'),
    ('unet.encoder.down_1', 'conv_kernel.py:340'),
    ('unet.encoder.down_2', 'flatchain.py:416'),
    ('unet.decoder.up_0', 'flatchain.py:416'),
    ('unet.decoder.up_1', 'flatchain.py:416'),
    ('unet.decoder.up_2', 'conv_kernel.py:340'),
)
TCONV_SITES = ('unet.decoder.up_0', 'unet.decoder.up_1', 'unet.decoder.up_2')
PALLAS = 'dnncancerannotator_tpu/ops/pallas/'
# the Pallas kernels each CUDA kernel replaces (function definitions)
REPLACES = {
    'conv_chain': ('conv_kernel.py:340 conv_chain_pallas',
                   'flatchain.py:416 conv_chain_flat_nchw'),
    'conv_chain_bwd': ('conv_kernel.py:487 conv_chain_bwd_pallas',
                       'flatchain.py:293 _bwd_call_im2col',
                       'flatchain.py:372 _bwd_call'),
    'tconv2x2': ('flattconv.py:200 conv_transpose2x2_flat_nchw',),
    'tconv2x2_bwd': ('flattconv.py:156 _bwd_call',),
    'stencil_conv': ('conv_kernel.py:84 stencil_conv2d_pallas',),
    'stencil_conv_bwd': ('conv_kernel.py:175 stencil_conv2d_bwd_pallas',),
    'warp_twopass': ('warp_kernel.py:242 dense_image_warp_twopass_pallas',),
    'cca': ('cca_kernel.py:105 cca_raw_labels_pallas',),
    'pool2x2_nhwc': ('pool_kernel.py:120 max_pool2x2_nhwc',),
    'pool2x2_nhwc_bwd': ('pool_kernel.py:96 _bwd_call',),
    'tconv2x2_nhwc': ('tconv_kernel.py:161 conv_transpose2x2_nhwc',),
    'tconv2x2_nhwc_bwd': ('tconv_kernel.py:123 _bwd_call',),
    'warp_crop': ('warp_kernel.py:194 dense_image_warp_crop_pallas',),
}
METRICS_CONFIG = 'configs/additionals/metrics.yaml'
EVAL_TAG = 'smoke'
# unet_big in f32 with the NHWC pool and tconv gates on; the overlays come
# after deploy_options.yaml, which replaces the whole deploy_options dict
BIG_CONFIGS = ('configs/unet_big.yaml',
               'configs/additionals/data_options.yaml',
               'configs/additionals/deploy_options.yaml',
               'configs/additionals/f32.yaml',
               'configs/additionals/pallas_decoder.yaml')
BIG_STEPS = 20
BIG_SAVE_FREQ = 10
POOL_SITES = ('unet.encoder.down_1', 'unet.encoder.down_2',
              'unet.encoder.down_3')
BIG_TCONV_SITES = ('unet.decoder.up_0', 'unet.decoder.up_1',
                   'unet.decoder.up_2')
NHWC_KERNELS = ('pool2x2_nhwc', 'pool2x2_nhwc_bwd', 'tconv2x2_nhwc',
                'tconv2x2_nhwc_bwd')
# the fused augmentation chain: 268 x 268 host windows (256 + 2 x 6 of crop
# jitter, data/pipeline.py:host_crop) cropped to 256 x 256, with the warp
# options of data_options.yaml (d = 8) and of augment_options.yaml (d = 18)
CROP_IN = SIZE + 12
CROP_WARPS = (dict(n_points=100, max_diff=5, stddev=2.0),
              dict(n_points=150, max_diff=15, stddev=20.0))
FUSED_STEPS = 50
ROUTE_STEPS = 4
INTRA_CONFIG = 'configs/additionals/intra_channelwarp_std5.yaml'
# the fused route against the composed per-step route on the same draws and
# smooth images (tests/test_augment_fused.py:76-80): their stride-4 coarse
# grids differ by the crop shift, which can move a sample ~0.3 px
FUSED_MEAN, FUSED_MAX, FUSED_Q999 = 5e-3, 0.25, 0.1
ORACLE_BATCH = 4
# the H100 SXM's published peaks: HBM bytes/s, f32 FLOP/s outside the
# tensor cores (the port keeps TF32 off but in the 3xTF32 tconv GEMM) and
# dense TF32 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# device time: calls under torch.profiler per kernel, plain version or
# library call
DEVICE_RUNS = 10
# the 3xTF32 tconv GEMM's error against f64, at most this many times the
# plain f32 version's (the dropped small*small term, ~2^-22 a product)
F64_RATIO = 4.0


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name):
    start = time.perf_counter()
    yield
    log(f'phase {name}: {time.perf_counter() - start:.2f} s')


def spiral_mask(h, w):
    '''[h, w] bool: one path one pixel wide that spirals inward from the
    top-left corner with one pixel between its arms (a single 4-connected
    component that turns about (h + w) / 2 times).'''
    mask = np.zeros((h, w), bool)
    r = c = 0
    dr, dc = 0, 1
    mask[0, 0] = True

    def free(y, x):
        return 0 <= y < h and 0 <= x < w and not mask[y, x]

    def taken(y, x):
        return 0 <= y < h and 0 <= x < w and mask[y, x]

    while True:
        for _ in range(2):   # straight on, else turn right once
            if free(r + dr, c + dc) and not taken(r + 2 * dr, c + 2 * dc):
                r, c = r + dr, c + dc
                mask[r, c] = True
                break
            dr, dc = dc, -dr
        else:
            return mask


# -- phase 1 -----------------------------------------------------------------
def environment():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False; '
                 'this script needs a CUDA GPU')
    log(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
        f'cuda {torch.version.cuda}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f'card: {smi}')
    for mod in ('yaml', 'PIL', 'pandas', 'matplotlib'):
        try:
            __import__(mod)
            log(f'{mod}: importable')
        except ImportError:
            log(f'{mod}: missing')
    return smi


# -- phase 2 -----------------------------------------------------------------
def build():
    from dnncancerannotator_torch.ops.kernels import _build
    stale = _build.library_path()
    if os.path.exists(stale):
        os.remove(stale)  # build from the checkout's sources, every run
    _build.library()
    log(f'build: {_build.build_seconds:.2f} s -> {_build.library_path()}')
    with open(os.path.join(_build.BUILD_DIR, 'nvcc.log')) as fh:
        for line in fh:
            if 'Compiling entry function' in line:
                log('  nvcc:', line.split("'")[1][:72])
            elif 'registers' in line or 'spill' in line:
                log('  nvcc:   ', line.strip())


# -- phase 3 -----------------------------------------------------------------
def _time_fns(fns):
    '''{name: median CUDA-event ms} of each callable, timed in turns after
    warm-up.'''
    for _ in range(3):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(TIMED_RUNS):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def _time_pair(kernel_fn, plain_fn):
    '''Median CUDA-event ms of each, timed in turns after warm-up.'''
    t = _time_fns({'plain': plain_fn, 'kernel': kernel_fn})
    return t['kernel'], t['plain']


# torch.profiler's tracing can leave later CUDA calls of the process slower
# on the host (a call that took device times in phases 3-3f measured the
# unet.yaml train throughput 40% below the call before it), so every
# profiler window is queued here and run after the last host-clock or
# CUDA-event measurement
_DEFERRED = []


def _frozen(fn):
    '''A copy of ``fn`` whose free variables keep the values they have now:
    the sites' lambdas close over their loops' variables, and a queued call
    must see its own site's tensors.'''
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(types.CellType(cell.cell_contents))
        except ValueError:   # not bound yet
            cells.append(cell)
    return types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, tuple(cells) or None)


def _device_ms(fn, runs=DEVICE_RUNS):
    '''Device time of one call of ``fn``: the device time of every kernel,
    copy and fill that ``runs`` calls launched, summed by torch.profiler,
    over ``runs``; no host time.'''
    cuda = torch.profiler.ProfilerActivity.CUDA
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, cuda]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, 'is_user_annotation', False))
    return us / 1e3 / runs


def _device_split(fn, runs=DEVICE_RUNS):
    '''{kernel name: (device ms, launches)} of one call of ``fn``, from
    one torch.profiler window of ``runs`` calls (``_device_ms``'s window,
    by name).'''
    cuda = torch.profiler.ProfilerActivity.CUDA
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, cuda]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / runs, e.count / runs)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and e.self_device_time_total > 0}


def _fullest_split(fn, windows=3):
    '''``_device_split`` of the window, of ``windows``, that recorded the
    most launches (then the most time): now and then a window misses the
    records of some kernels or of all of them (seen once or twice a run),
    never adds any.'''
    splits = [_device_split(fn) for _ in range(windows)]
    return max(splits, key=lambda s: (sum(c for _, c in s.values()),
                                      sum(ms for ms, _ in s.values())))


def _time_site(kernel_fn, plain_fn, library_fn=None):
    '''{ms, plain_ms, library_ms}: median CUDA-event ms around each call
    (host time included), timed in turns; and {device_ms, plain_device_ms,
    library_device_ms}: the device time alone (``_device_ms``); the
    library's None without a library call.'''
    fns = {'': kernel_fn, 'plain_': plain_fn}
    if library_fn is not None:
        fns['library_'] = library_fn
    t = _time_fns(fns)
    times = {'library_ms': None, 'library_device_ms': None}
    for key in fns:
        times[key + 'ms'] = t[key]
    log('    ' + '  '.join(f'{key or "kernel_"}ms {t[key]:.4f}' for key in fns))

    frozen = {key: _frozen(fn) for key, fn in fns.items()}

    def device_times():
        for key, fn in frozen.items():
            # the larger of two windows: now and then a window misses the
            # records of some kernels (seen once or twice a run, as a time
            # near 0)
            times[key + 'device_ms'] = max(_device_ms(fn), _device_ms(fn))
        log(f'  {times["label"]:44s} ' + '  '.join(
            f'{key or "kernel_"}device_ms {times[key + "device_ms"]:.4f}'
            for key in fns))
    _DEFERRED.append(device_times)
    return times


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops, rate=F32_FLOP_PER_S):
    '''(ms, what bounds it): the least time the H100 could take to move
    ``n_bytes`` and do ``flops`` operations at ``rate`` (f32 FMAs outside
    the tensor cores by default).'''
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def tf32x3_bound(n_bytes, flops):
    '''``bound`` of a 3xTF32 product: three TF32 products for each f32
    one, on the tensor cores.'''
    return bound(n_bytes, 3 * flops, TF32_FLOP_PER_S)


def _check_close(name, got, want, tol=KERNEL_TOL):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f'  {name:44s} max|diff| {err:.3e}  max|ref| {scale:.3e}')
    if not err <= tol * scale:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version: {err} > {tol} * {scale}')
    return err


def record(results, name, err, times, site_bound, tc_bound=None):
    '''Sum a site's times (``_time_site``) and its bound (ms, what bounds
    it; and for a tensor-core kernel its ``tf32x3_bound`` as well) into its
    kernel's entry; keep the worst error. The entry is bound by what bounds
    the larger share of its summed bound.'''
    acc = results.setdefault(name, dict(
        max_abs_err=0.0, site_times=[], bound_ms=0.0,
        by={'bytes': 0.0, 'operations': 0.0}, sites=0))
    acc['max_abs_err'] = max(acc['max_abs_err'], err)
    times['label'] = f'{name} site {acc["sites"] + 1}'
    acc['site_times'].append(times)
    acc['bound_ms'] += site_bound[0]
    acc['by'][site_bound[1]] += site_bound[0]
    if tc_bound is not None:
        acc['tf32x3_bound_ms'] = acc.get('tf32x3_bound_ms', 0.0) + tc_bound[0]
    acc['sites'] += 1


def summed_times(acc):
    '''A kernel's times (``_time_site``) summed over its sites; None where
    a site has no library call.'''
    out = {}
    for times in acc['site_times']:
        for key, value in times.items():
            if key != 'label':
                out[key] = (None if value is None or out.get(key, 0.0) is None
                            else out.get(key, 0.0) + value)
    return out


def _site_hw(path, size):
    '''Spatial size of a chain site's input at crop size ``size``.'''
    level = int(path[-1])
    return size >> level if 'encoder' in path else size >> (2 - level)


# the forward as the 300 training launches call it: B=8, need_c1=True;
# (site label, times of _time_site, bound ms) for the summary line
TRAIN_FORWARD = []


def train_chain_site(path, w1, b1, w2, b2, hw, gen):
    '''The chain forward at a site as training calls it (B=8 with c1 for
    the backward's mask): c1 and c2 against the plain version, within
    F64_RATIO of it against f64, its times and its bound (c1's write
    counted).'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    x = torch.rand((TRAIN_BATCH, w1.shape[1], hw, hw), generator=gen,
                   device=gen.device)
    c1, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True)
    want = CC.plain(x, w1, b1, w2, b2)
    want64 = CC.plain(*_f64(x, w1, b1, w2, b2))
    name = f'conv_chain B={TRAIN_BATCH} need_c1 {path}'
    for label, got_t, want_t, want64_t in zip(('c1', 'c2'), (c1, c2), want,
                                              want64):
        _check_close(f'{name} {label}', got_t, want_t)
        _f64_errors(f'{name} {label}', got_t, want_t, want64_t, F64_RATIO)
    times = _time_site(lambda: CC.conv_chain(x, w1, b1, w2, b2, need_c1=True),
                       lambda: CC.plain(x, w1, b1, w2, b2))
    times['label'] = name
    taps = w1.shape[2] * w1.shape[3]
    flops = 2 * x[:, :1].numel() * taps * (w1.shape[0] * w1.shape[1]
                                           + w2.shape[0] * w2.shape[1])
    site_bound = bound(nbytes(x, w1, b1, w2, b2, c1, c2), flops)[0]
    log(f'  {name:44s} bound {site_bound:.4f} ms (c1 written)')
    TRAIN_FORWARD.append((name, times, site_bound))


@torch.no_grad()
def kernel_sites(model, device, results):
    '''Each kernel against its plain version at every main-path site.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC

    gen = torch.Generator(device=device).manual_seed(SEED)
    modules = dict(model.named_modules())

    log(f'kernels (B={BATCH}, {SIZE}x{SIZE} input):')
    F = torch.nn.functional
    for path, _ in CHAIN_SITES:
        chain = modules[path + '.convchain']
        w1, b1 = chain.conv_0.weight, chain.conv_0.bias
        w2, b2 = chain.conv_1.weight, chain.conv_1.bias
        hw = _site_hw(path, SIZE)
        x = torch.rand((BATCH, w1.shape[1], hw, hw), generator=gen,
                       device=device)
        _, got = CC.conv_chain(x, w1, b1, w2, b2)
        _, want = CC.plain(x, w1, b1, w2, b2)
        name = (f'conv_chain {path} {w1.shape[1]}->{w1.shape[0]}->'
                f'{w2.shape[0]} @{hw}')
        err = _check_close(name, got, want)
        _f64_errors(name, got, want, CC.plain(*_f64(x, w1, b1, w2, b2))[1],
                    F64_RATIO)
        times = _time_site(lambda: CC.conv_chain(x, w1, b1, w2, b2),
                           lambda: CC.plain(x, w1, b1, w2, b2))
        taps = w1.shape[2] * w1.shape[3]
        flops = 2 * x[:, :1].numel() * taps * (w1.shape[0] * w1.shape[1]
                                               + w2.shape[0] * w2.shape[1])
        record(results, 'conv_chain', err, times,
               bound(nbytes(x, w1, b1, w2, b2, got), flops))
        train_chain_site(path, w1, b1, w2, b2, hw, gen)
    for path in TCONV_SITES:
        tconv = modules[path + '.tconv']
        w, b = tconv.weight, tconv.bias
        hw = SIZE >> (3 - int(path[-1]))
        x = torch.rand((BATCH, w.shape[0], hw, hw), generator=gen,
                       device=device)
        got, want = TC.tconv2x2(x, w, b), TC.plain(x, w, b)
        err = _check_close(
            f'tconv2x2 {path} {w.shape[0]}->{w.shape[1]} @{hw}', got, want)
        times = _time_site(lambda: TC.tconv2x2(x, w, b),
                           lambda: TC.plain(x, w, b),
                           lambda: F.conv_transpose2d(x, w, b, stride=2))
        record(results, 'tconv2x2', err, times,
               bound(nbytes(x, w, b, got), 2 * got.numel() * w.shape[0]))
    head = modules['last_conv']
    w, b = head.weight, head.bias
    pads = ((0, 0), (0, 0))
    x = torch.rand((BATCH, w.shape[1], SIZE, SIZE), generator=gen,
                   device=device)
    got, want = SC.stencil_conv(x, w, b, pads), SC.plain(x, w, b, pads)
    err = _check_close(f'stencil_conv last_conv 1x1 {w.shape[1]}->1 @{SIZE}',
                       got, want)
    times = _time_site(lambda: SC.stencil_conv(x, w, b, pads),
                       lambda: SC.plain(x, w, b, pads),
                       lambda: F.conv2d(x, w, b))
    record(results, 'stencil_conv', err, times,
           bound(nbytes(x, w, b, got), 2 * got.numel() * w[0].numel()))


# -- phase 3b ----------------------------------------------------------------
# the chain backward's launches a call at the unet.yaml sites: the fused
# kernel and the partial sums' finish
CHAIN_BWD_LAUNCHES = 2


def _chain_bwd_split(name, call):
    '''Prints the chain backward's device time by kernel (deferred profiler
    windows, ``_fullest_split``) and raises unless it launched
    CHAIN_BWD_LAUNCHES kernels a call.'''
    split = _fullest_split(call)
    log(f'  {name} by kernel, device ms a call:')
    for key, (ms, count) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        log(f'    {ms:.4f} ms {count:4.1f}x  {key[:90]}')
    count = sum(c for _, c in split.values())
    if count != CHAIN_BWD_LAUNCHES:
        raise AssertionError(f'{name}: {count} launches a call, want '
                             f'{CHAIN_BWD_LAUNCHES}')


def _f64_errors(name, got, want, want64, ratio=None):
    '''Prints the kernel's and the plain f32 version's max|diff| from the
    f64 plain version and their ratio; with ``ratio``, raises where the
    kernel's is more than ``ratio`` times the plain version's.'''
    err = float((got.double() - want64).abs().max())
    plain_err = float((want.double() - want64).abs().max())
    share = err / plain_err if plain_err else float('inf') if err else 1.0
    log(f'  {"":44s} vs f64: kernel {err:.3e}  plain f32 {plain_err:.3e}  '
        f'ratio {share:.2f}')
    if ratio is not None and not err <= ratio * plain_err:
        raise AssertionError(f'{name}: the kernel is {share:.2f}x as far from '
                             f'f64 as the plain f32 version (> {ratio})')


def _check_grads(name, got, want, want64, ratio=None):
    '''(dx or None, weight and bias gradients...) of a backward kernel
    against its plain version: dx to DX_TOL, the rest to DW_TOL, relative
    to max|ref|; prints the kernel's and the plain f32 version's error
    against f64 (``_f64_errors``, ``ratio`` as there).'''
    worst = 0.0
    for label, g, w, w64 in zip(('dx', 'dw1', 'db1', 'dw2', 'db2')
                                if len(got) == 5 else ('dx', 'dw', 'db'),
                                got, want, want64):
        if w is None:
            continue
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        tol = DX_TOL if label == 'dx' else DW_TOL
        log(f'  {name:40s} {label:3s} max|diff| {err:.3e}  max|ref| '
            f'{scale:.3e}')
        _f64_errors(f'{name} {label}', g, w, w64, ratio)
        if not err <= tol * scale:
            raise AssertionError(f'{name} {label}: kernel disagrees with its '
                                 f'plain version: {err} > {tol} * {scale}')
        worst = max(worst, err)
    return worst


def _f64(*tensors):
    return [t.double() for t in tensors]


@torch.no_grad()
def backward_sites(model, device, results):
    '''Each backward kernel against its plain version at every site of the
    training step, and the warp kernel at the augmentation's shapes.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops import warp
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
    from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
    from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    modules = dict(model.named_modules())
    conv_bwd = torch.ops.aten.convolution_backward
    b = TRAIN_BATCH
    log(f'backward kernels (B={b}, {SIZE}x{SIZE} crops):')
    for path, _ in CHAIN_SITES:
        chain = modules[path + '.convchain']
        w1, b1 = chain.conv_0.weight, chain.conv_0.bias
        w2, b2 = chain.conv_1.weight, chain.conv_1.bias
        hw = _site_hw(path, SIZE)
        x = torch.rand((b, w1.shape[1], hw, hw), generator=gen, device=device)
        c1, c2 = CC.plain(x, w1, b1, w2, b2)
        g = torch.randn(c2.shape, generator=gen, device=device)
        need_dx = path != 'unet.encoder.down_0'   # the input needs no grad
        args = (x, c1, c2, g, w1, w2, need_dx)
        name = (f'conv_chain_bwd {path} {w1.shape[1]}->{w1.shape[0]}->'
                f'{w2.shape[0]} @{hw}')
        got = CCB.conv_chain_bwd(*args)
        again = CCB.conv_chain_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
            raise AssertionError(f'{name}: dw, db differ between two calls')
        err = _check_grads(name, got, CCB.plain(*args),
                           CCB.plain(*_f64(*args[:-1]), need_dx), F64_RATIO)
        times = _time_site(lambda: CCB.conv_chain_bwd(*args),
                           lambda: CCB.plain(*args))
        _DEFERRED.append(functools.partial(
            _chain_bwd_split, name, functools.partial(CCB.conv_chain_bwd,
                                                      *args)))
        # dc1 and dw2 through conv_1, dw1 (and dx) through conv_0
        pix = x[:, :1].numel() * w1.shape[2] * w1.shape[3]
        flops = 2 * pix * (2 * w2.shape[0] * w2.shape[1]
                           + (2 if need_dx else 1) * w1.shape[0] * w1.shape[1])
        record(results, 'conv_chain_bwd', err, times,
               bound(nbytes(*args[:6], *got), flops))
    for path in TCONV_SITES:
        w = modules[path + '.tconv'].weight
        hw = SIZE >> (3 - int(path[-1]))
        x = torch.rand((b, w.shape[0], hw, hw), generator=gen, device=device)
        g = torch.randn((b, w.shape[1], 2 * hw, 2 * hw), generator=gen,
                        device=device)
        name = f'tconv2x2_bwd {path} {w.shape[0]}->{w.shape[1]} @{hw}'
        got = TCB.tconv2x2_bwd(x, g, w)
        err = _check_grads(name, got, TCB.plain(x, g, w),
                           TCB.plain(*_f64(x, g, w)))
        times = _time_site(
            lambda: TCB.tconv2x2_bwd(x, g, w), lambda: TCB.plain(x, g, w),
            lambda: conv_bwd(g, x, w, [w.shape[1]], [2, 2], [0, 0], [1, 1],
                             True, [0, 0], 1, [True, True, True]))
        record(results, 'tconv2x2_bwd', err, times,
               bound(nbytes(x, g, w, *got), 4 * g.numel() * w.shape[0]))
    w = modules['last_conv'].weight
    pads = ((0, 0), (0, 0))
    x = torch.rand((b, w.shape[1], SIZE, SIZE), generator=gen, device=device)
    g = torch.randn((b, 1, SIZE, SIZE), generator=gen, device=device)
    name = f'stencil_conv_bwd last_conv 1x1 {w.shape[1]}->1 @{SIZE}'
    got = SCB.stencil_conv_bwd(x, g, w, pads)
    err = _check_grads(name, got, SCB.plain(x, g, w, pads),
                       SCB.plain(*_f64(x, g, w), pads))
    times = _time_site(
        lambda: SCB.stencil_conv_bwd(x, g, w, pads),
        lambda: SCB.plain(x, g, w, pads),
        lambda: conv_bwd(g, x, w, [w.shape[0]], [1, 1], [0, 0], [1, 1],
                         False, [0, 0], 1, [True, True, True]))
    record(results, 'stencil_conv_bwd', err, times,
           bound(nbytes(x, g, w, *got), 4 * g.numel() * w[0].numel()))

    # the warp: a dense flow from a real bank, and a random one past +-d
    bank = augment.build_warp_bank(
        torch.Generator(device=device).manual_seed(SEED + 3), b, (SIZE, SIZE))
    d = bank['max_displacement']
    image = torch.rand((b, SIZE, SIZE, 6), generator=gen, device=device)
    flows = {
        'bank flow': warp._upsample_flow(bank['flows'], SIZE, SIZE,
                                         bank['stride']).contiguous(),
        'random flow past +-d': torch.randn(
            (b, SIZE, SIZE, 2), generator=gen, device=device) * 12.0,
    }
    for label, flow in flows.items():
        got, want = WT.warp_twopass(image, flow, d), WT.plain(image, flow, d)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f'  warp_twopass [{b},{SIZE},{SIZE},6] d={d} {label:22s} '
            f'max|diff| {err:.3e}  max|ref| {float(want.abs().max()):.3e}')
        if not torch.equal(got, want):   # same rounded operations: exact
            raise AssertionError(f'warp_twopass ({label}) differs from its '
                                 f'plain version by {err}')
        times = _time_site(lambda: WT.warp_twopass(image, flow, d),
                           lambda: WT.plain(image, flow, d))
        # about 12 operations an output value (two clamped bilinear passes)
        record(results, 'warp_twopass', err, times,
               bound(nbytes(image, flow, got), 12 * got.numel()))


# -- phase 4 -----------------------------------------------------------------
def write_records(data_dir, size=SIZE, n_exams=N_EXAMS,
                  slices_per_exam=SLICES_PER_EXAM):
    '''Seeded synthetic exams (uint8 [S, size, size, 6], disc lesions) in
    two .tfrecords files, written with the port's codec.'''
    from dnncancerannotator_torch.data import tfrecord as tfr
    from dnncancerannotator_torch.data.records import DEFAULT_SLICE_TYPES

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:size, :size]
    paths = []
    for category, n_exams in zip(('cancer', 'healthy'), n_exams):
        path = os.path.join(data_dir, f'{category}.tfrecords')
        with open(path, 'wb') as f:
            for pid in range(1, n_exams + 1):
                slices = rng.integers(
                    0, 255, (slices_per_exam, size, size, 6), np.uint8)
                slices[..., 5] = 0
                if category == 'cancer':
                    for s in range(slices_per_exam):
                        cy, cx = rng.integers(size // 5, size - size // 5, 2)
                        r = rng.integers(size // 32, size // 8)
                        disk = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
                        slices[s][disk, :5] = 220
                        slices[s][disk, 5] = 255
                example = tfr.encode_example({
                    'slices': tfr.serialize_tensor(slices),
                    'patientID': pid,
                    'examID': 1,
                    'path': f'/exams/{category}/{pid}/1'.encode(),
                    'category': category.encode(),
                    'shape': list(slices.shape),
                    'slice_types': [t.encode() for t in DEFAULT_SLICE_TYPES],
                })
                tfr.write_record(f, example)
        paths.append(path)
    return paths


def write_save_path(save_path, data_paths, device):
    '''options.yaml (JSON, which is YAML) with the stacked unet.yaml options,
    and a seeded checkpoint ckpt-1/params.npz.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.utils import config as config_lib

    config = config_lib.load_config([os.path.join(REPO, c) for c in CONFIGS])
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, 'options.yaml'), 'w') as fh:
        json.dump(dict(config=config, save_path=save_path,
                       data_path=data_paths), fh)
    eng = engine.Engine(config, seed=SEED, device=device)
    eng.build((BATCH, SIZE, SIZE, 5))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():  # non-zero biases, so a misplaced bias shows
        for name, param in eng.model.named_parameters():
            if name.endswith('.bias'):
                param.copy_(torch.randn(param.shape, generator=gen) * 0.1)
    eng.save_ckpt(os.path.join(save_path, 'checkpoints'), 1)
    return config


def plain_logits(model, x):
    '''The UNetAnnotator forward written out with the kernels' plain
    PyTorch versions (differentiable by autograd): the reference for the
    maps and the gradients. x: NHWC features -> NHWC logits.'''
    from dnncancerannotator_torch.models.blocks import center_crop_to
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC
    from dnncancerannotator_torch.ops.pooling import max_pool2d

    def chain(cc, h):
        return CC.plain(h, cc.conv_0.weight, cc.conv_0.bias,
                        cc.conv_1.weight, cc.conv_1.bias)[1]

    h = x.permute(0, 3, 1, 2).contiguous()
    skips = []
    for i in range(3):
        skip = chain(getattr(model.unet.encoder, f'down_{i}').convchain, h)
        skips.append(skip)
        h = max_pool2d(skip, 2)
    for i, skip in enumerate(reversed(skips)):
        up_mod = getattr(model.unet.decoder, f'up_{i}')
        up = TC.plain(h, up_mod.tconv.weight, up_mod.tconv.bias)
        skip = center_crop_to(skip, up.shape[2], up.shape[3])
        h = chain(up_mod.convchain, torch.cat([up, skip], dim=1))
    logits = SC.plain(h, model.last_conv.weight, model.last_conv.bias,
                      ((0, 0), (0, 0)))
    return logits.permute(0, 2, 3, 1)


def plain_forward(model, x):
    '''Probabilities of plain_logits.'''
    return torch.sigmoid(plain_logits(model, x))


def _check_maps(model, data_paths, out_dir, n_slices, reference=None,
                exact=None):
    '''The predict CLI's maps: one file per slice, finite, in [0, 1], and
    within MAP_TOL of the plain forward of ``model`` on the card (or of
    ``reference``, NHWC features -> probabilities).

    With ``exact`` (the f64 forward, the same features -> probabilities),
    maps further than that from the plain f32 forward are held to it as
    ``_compare_step`` holds a step: they pass if they are no further from
    it than F64_RATIO times the plain f32 forward's maps, the kernels' own
    rule (phase 3e). Two f32 forwards of a deep model on the same weights
    differ by the rounding of every layer, which no fixed tolerance
    bounds.'''
    from dnncancerannotator_torch.data import pipeline

    reference = reference or (lambda x: plain_forward(model, x))
    device = next(model.parameters()).device
    ds = pipeline.predict_ds(data_paths, output_size=(SIZE, SIZE),
                             batch_size=BATCH)
    worst, n_files = 0.0, 0
    worst64 = plain64 = 0.0   # from the f64 forward: the maps, the plain
    with torch.no_grad():
        for batch in ds.batches():
            x = torch.from_numpy(batch['slices']).to(device).float() / 255.0
            ref = reference(x[..., :5]).cpu().numpy()
            ref64 = (exact(x[..., :5]).cpu().numpy() if exact is not None
                     else None)
            for i, meta in enumerate(batch['meta']):
                path = os.path.join(out_dir, *meta['path'].split('/')[-3:],
                                    f"{meta['sliceID']:02d}.npy")
                got = np.load(path)
                if got.shape != (SIZE, SIZE) or not np.isfinite(got).all() \
                        or got.min() < 0 or got.max() > 1:
                    raise AssertionError(f'bad map {path}: {got.shape}, '
                                         f'[{got.min()}, {got.max()}]')
                worst = max(worst, float(np.abs(got - ref[i, :, :, 0]).max()))
                if ref64 is not None:
                    worst64 = max(worst64, float(
                        np.abs(got - ref64[i, :, :, 0]).max()))
                    plain64 = max(plain64, float(
                        np.abs(ref[i, :, :, 0] - ref64[i, :, :, 0]).max()))
                n_files += 1
    log(f'maps vs plain forward on the card: {n_files} maps, '
        f'max|diff| {worst:.3e}' + (
            '' if exact is None else f'; from the f64 forward: maps '
            f'{worst64:.3e}, plain f32 forward {plain64:.3e}'))
    if n_files != n_slices:
        raise AssertionError(f'{n_files} maps, want {n_slices}')
    if not worst <= MAP_TOL and not (exact is not None
                                     and worst64 <= F64_RATIO * plain64):
        raise AssertionError(f'maps disagree with the plain forward: '
                             f'{worst} (tol {MAP_TOL}), {n_files} maps' + (
                                 '' if exact is None else
                                 f'; from the f64 forward {worst64} against '
                                 f'the plain f32 forward\'s {plain64}'))


def run_slice(eng, data_paths, save_path, out_dir):
    '''The predict CLI, then its maps against the plain forward of the
    same loaded weights (``eng``).'''
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main

    argv = ['predict', '--save_path', save_path, '--data_path', *data_paths,
            '--output_path', out_dir, '--batch_size', str(BATCH),
            '--output_format', 'npy', '--device', eng.device.type]
    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    count = main(argv=argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()

    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    n_batches = -(-n_slices // BATCH)
    log(f'predict: {count} maps in {seconds:.3f} s -> '
        f'{count / seconds:.2f} slices/s (host clock, build excluded)')
    log(f'launches during predict: {launches}')
    if count != n_slices:
        raise AssertionError(f'predict wrote {count} maps, want {n_slices}')
    for name, sites in (('conv_chain', len(CHAIN_SITES)),
                        ('tconv2x2', len(TCONV_SITES)), ('stencil_conv', 1)):
        if launches[name] < sites * n_batches:
            raise AssertionError(
                f'{name} launched {launches[name]} times during predict, '
                f'want >= {sites} x {n_batches}')

    _check_maps(eng.model, data_paths, out_dir, n_slices)

    # whole-model forward at B=64: kernels vs plain versions, in turns
    x = torch.rand((BATCH, SIZE, SIZE, 5), device=eng.device)
    with torch.no_grad():
        ms, plain_ms = _time_pair(lambda: eng.model(x),
                                  lambda: plain_forward(eng.model, x))
    log(f'model forward B={BATCH}: kernels {ms:.4f} ms  plain {plain_ms:.4f} '
        f'ms  ({BATCH * 1000 / ms:.1f} vs {BATCH * 1000 / plain_ms:.1f} '
        'slices/s device-side)')
    return launches


# -- phase 5 -----------------------------------------------------------------
# every kernel of the train step, and its sites in one step
TRAIN_SITES = {'conv_chain': 6, 'conv_chain_bwd': 6, 'tconv2x2': 3,
               'tconv2x2_bwd': 3, 'stencil_conv': 1, 'stencil_conv_bwd': 1,
               'warp_twopass': 1}


@contextlib.contextmanager
def _plain_versions(*modules):
    '''Within the block each kernel module's wrapper (the function named as
    the module) runs the module's plain version instead of the kernel.'''
    saved = [(mod, mod.__name__.rsplit('.', 1)[-1]) for mod in modules]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    for mod, name, _ in saved:
        setattr(mod, name, mod.plain)
    try:
        yield
    finally:
        for mod, name, kernel in saved:
            setattr(mod, name, kernel)


def _plain_warp():
    '''Within the block, the augmentation's resample runs its plain
    version instead of the kernel.'''
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
    return _plain_versions(WT)


def _step_grads(eng, ds, raw, draws, plain, f64=False):
    '''Loss and parameter gradients of one train step on ``raw`` with the
    given augmentation draws, through the kernels or their plain
    versions. With ``f64`` the plain step's model and loss run in f64 on
    the same augmented f32 batch, and the model is put back in f32 after
    (as ``_big_step``).'''
    from dnncancerannotator_torch.data import augment

    bank = eng._warp_bank(ds)
    with _plain_warp() if plain else contextlib.nullcontext():
        images = augment.apply_chain(ds.augment_methods, raw.float() / 255.0,
                                     draws, bank)
    x, y = augment.to_feature_label(images, ds.slice_types)
    try:
        if f64:
            eng.model.double()
            x = x.double()
        eng.model.zero_grad(set_to_none=True)
        logits = plain_logits(eng.model, x) if plain else eng.model(
            x, return_logits=True)
        loss = eng.loss(y, logits)
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                                      for n, p in eng.model.named_parameters()}
    finally:
        if f64:
            eng.model.float()
            eng.model.zero_grad(set_to_none=True)


def train_slice(device):
    '''Phase 5; returns the launch counts of the first train CLI call, the
    run's save_path and its data paths.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    data_paths = write_records(os.path.join(WORK, 'train_data'), EXAM_SIZE,
                               TRAIN_EXAMS, TRAIN_SLICES)
    overlay = os.path.join(WORK, 'steps_per_call.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': STEPS_PER_CALL}, fh)
    save_path = os.path.join(WORK, 'train_run')
    ckpt_dir = os.path.join(save_path, 'checkpoints')
    argv = ['train', '--config', *[os.path.join(REPO, c) for c in CONFIGS],
            overlay, '--save_path', save_path, '--data_path', *data_paths,
            '--save_freq', str(SAVE_FREQ), '--seed', str(SEED), '--device',
            device.type, '--max_steps']

    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = cli(argv=argv + [str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'train: {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {seconds:.3f} s '
        f'(host clock; the warp bank solve, data load and checkpoints '
        f'included); loss {losses[0]:.4f} -> {losses[-1]:.4f}')
    log(f'launches during train: {launches}')
    if res.epoch != list(range(1, TRAIN_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    for step in range(SAVE_FREQ, TRAIN_STEPS + 1, SAVE_FREQ):
        files = set(os.listdir(os.path.join(ckpt_dir, f'ckpt-{step}')))
        if files != {'params.npz', 'opt_state.npz'}:
            raise AssertionError(f'ckpt-{step} holds {sorted(files)}')
    for name, sites in TRAIN_SITES.items():
        if launches[name] < sites * TRAIN_STEPS:
            raise AssertionError(
                f'{name} launched {launches[name]} times during train, '
                f'want >= {sites} x {TRAIN_STEPS}')

    last = TRAIN_STEPS + SAVE_FREQ
    res = cli(argv=argv + [str(last)])
    if res.epoch != list(range(TRAIN_STEPS + 1, last + 1)):
        raise AssertionError(f'the second train call ran steps {res.epoch}, '
                             f'want {TRAIN_STEPS + 1}..{last}')
    log(f'train resumed at step {TRAIN_STEPS}: steps {res.epoch[0]}-'
        f'{res.epoch[-1]}, loss {res.history["loss"][-1]:.4f}')

    # predict from the trained checkpoint
    config = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    eng._setup_training(ds)
    eng.load(os.path.join(ckpt_dir, f'ckpt-{last}'))
    out_dir = os.path.join(WORK, 'train_maps')
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *data_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    log(f'predict from ckpt-{last}: {count} maps')
    _check_maps(eng.model, data_paths, out_dir,
                sum(TRAIN_EXAMS) * TRAIN_SLICES)

    # one step: the kernels against a plain train step, same batch and draws
    resident = eng._resident(ds)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    raw = eng.sample_batch(resident, TRAIN_BATCH, gen)
    draws = augment.draw_chain(ds.augment_methods, raw.shape, gen,
                               eng._warp_bank(ds))
    loss, grads = _step_grads(eng, ds, raw, draws, plain=False)
    plain_loss, plain_grads = _step_grads(eng, ds, raw, draws, plain=True)
    log(f'one train step: loss {loss:.7f} kernels, {plain_loss:.7f} plain')
    if not abs(loss - plain_loss) <= LOSS_TOL * abs(plain_loss):
        raise AssertionError(f'train-step loss {loss} vs plain {plain_loss}')
    # a gradient further than STEP_TOL from the plain step is held to the
    # f64 step, as _compare_step holds unet_big's: no further from it than
    # F64_RATIO times the plain f32 step
    worst, exact = 0.0, []
    for name, want in plain_grads.items():
        err = float((grads[name] - want).abs().max())
        scale = float(want.abs().max())
        if err <= STEP_TOL * scale:
            worst = max(worst, err / scale)
            continue
        if not exact:
            exact.append(_step_grads(eng, ds, raw, draws, plain=True,
                                     f64=True)[1])
        err64, plain64 = (float((t.double() - exact[0][name]).abs().max())
                          for t in (grads[name], want))
        log(f'  {name}: {err:.3e} > {STEP_TOL} * {scale:.3e} from the plain '
            f'step; from the f64 step: kernels {err64:.3e}, plain '
            f'{plain64:.3e}')
        if not err64 <= F64_RATIO * plain64:
            raise AssertionError(f'{name}: gradient {err} > {STEP_TOL} * '
                                 f'{scale} from the plain train step, and '
                                 f'{err64} from the f64 step against the '
                                 f'plain step\'s {plain64}')
    log(f'one train step: {len(grads)} parameter gradients within '
        f'{worst:.3e} * max|ref| of the plain step, but for those held to '
        'the f64 step above')

    # the train step's time, kernels vs plain (a copy of the model and its
    # own Adam for the plain step)
    plain_model = copy.deepcopy(eng.model)
    plain_opt = torch.optim.Adam(plain_model.parameters(), lr=1e-3, eps=1e-7)

    def plain_step():
        with _plain_warp():
            images = eng._augment(raw.float() / 255.0, gen)
        x, y = augment.to_feature_label(images, ds.slice_types)
        plain_opt.zero_grad(set_to_none=True)
        eng.loss(y, plain_logits(plain_model, x)).backward()
        plain_opt.step()

    ms, plain_ms = _time_pair(lambda: eng.train_step(raw, last, gen),
                              plain_step)
    log(f'train step B={TRAIN_BATCH}: kernels {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms (CUDA events, median of {TIMED_RUNS})')
    _DEFERRED.append(lambda: _profile_steps(
        'unet.yaml train step', lambda: eng.train_step(raw, last, gen)))

    # throughput: train calls that differ only in step count, min of three
    short, long = 25, 100
    eng.train(ds, max_steps=eng.current_step + 10, save_freq=1 << 30)
    times = {}
    for n in (short, long):
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
            torch.cuda.synchronize()
            times.setdefault(n, []).append(time.perf_counter() - start)
    rate = (long - short) * TRAIN_BATCH / (min(times[long]) -
                                           min(times[short]))
    log(f'train throughput: {rate:.2f} slices/s ({short}-step calls '
        f'{times[short]} s, {long}-step calls {times[long]} s; '
        f'steps_per_call {STEPS_PER_CALL})')
    return launches, save_path, data_paths


# -- phase 3c ----------------------------------------------------------------
def _first_batch(eng, data_paths):
    '''(y, probs) of the first predict batch through the kernels, the
    raw uint8 batch and its slice types.'''
    from dnncancerannotator_torch.data import pipeline

    ds = pipeline.eval_ds(data_paths, batch_size=BATCH,
                          output_size=(SIZE, SIZE))
    raw = next(ds.batches())['slices']
    _, probs, y = eng._make_eval_step(ds.slice_types)(raw)
    return y, probs, raw, ds.slice_types


@torch.no_grad()
def cca_sites(eng, data_paths, results):
    '''The CCA kernel against its plain version: exactly equal labels.'''
    from dnncancerannotator_torch.metrics import region
    from dnncancerannotator_torch.ops.kernels import cca as K
    from dnncancerannotator_torch.ops.morphology import morph_open
    from dnncancerannotator_torch.utils.viz import PR_THRESHOLDS

    device = eng.device
    y, probs, _, _ = _first_batch(eng, data_paths)
    _, p = region._resized(y[:1], probs[:1], 0.5)
    thresholds = torch.tensor(PR_THRESHOLDS, dtype=torch.float32,
                              device=device)
    real = morph_open(p, 5)[0] >= thresholds[:, None, None]
    rng = np.random.default_rng(SEED)
    ii, jj = np.mgrid[:SIZE, :SIZE]
    planes = {
        'thresholded opened predictions': real,
        'spiral': spiral_mask(SIZE, SIZE)[None],
        'checkerboard': ((ii + jj) % 2 == 0)[None],
        'all ones': np.ones((1, SIZE, SIZE), bool),
        'all zeros': np.zeros((1, SIZE, SIZE), bool),
        'noise p=0.6': rng.random((4, SIZE, SIZE)) < 0.6,
        'noise, H != W, W % 32 != 0': rng.random((3, 192, 300)) < 0.55,
    }
    log('connected components (CCA kernel vs plain, exact):')
    for name, masks in planes.items():
        x = torch.as_tensor(masks, device=device).contiguous()
        got, want = K.cca_raw_labels(x), K.plain(x)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        n_regions = int((want.reshape(len(x), -1) == torch.arange(
            x[0].numel(), device=device)).sum())
        log(f'  cca {name:32s} {list(x.shape)} regions {n_regions:6d}  '
            f'max|diff| {err}')
        if not torch.equal(got, want):
            raise AssertionError(f'cca ({name}) differs from its plain '
                                 f'version by {err}')
        times = _time_site(lambda: K.cca_raw_labels(x), lambda: K.plain(x))
        # a few integer operations a pixel (runs, unions, flattening)
        record(results, 'cca', float(err), times,
               bound(nbytes(x, got), 4 * x.numel()))


# -- phase 3d ----------------------------------------------------------------
def sensitivity_site(eng, data_paths):
    '''d(sum of probs)/d(input) at B=64 through the kernels (dx at down_0)
    against plain autograd of the plain forward.

    The chain backward at down_0 is held to DX_TOL * max|ref| on the
    model's own activations with the same saved relu masks. End to end a
    relu or max-pool decision can fall the other way where the kernels'
    forward and the plain one round a value near 0 or a near-tie
    differently (1 in 10^9 a value, but 10^7 values a batch); the gradient
    then differs at full size in the few pixels behind that decision (on an
    H100: 4,827 of 21 M values, all in one slice, 2.2e-3 of max|ref| 0.13;
    summed over the batch 9.2e-7 relative). So end to end: at most
    SENS_FLIP_SHARE of the values beyond DX_TOL * max|ref|, the summed
    absolute difference within DX_TOL of the summed |ref|, and the
    normalized per-channel sensitivity within DX_TOL * its max.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
    from dnncancerannotator_torch.utils import viz

    with torch.no_grad():
        _, _, raw, slice_types = _first_batch(eng, data_paths)
        images = torch.from_numpy(raw).to(eng.device).float() / 255.0
        x, _ = augment.to_feature_label(images, slice_types)
        chain = eng.model.unet.encoder.down_0.convchain
        w1, w2 = chain.conv_0.weight.detach(), chain.conv_1.weight.detach()
        xc = x.permute(0, 3, 1, 2).contiguous()
        c1, c2 = CC.plain(xc, w1, chain.conv_0.bias, w2, chain.conv_1.bias)
        g = torch.randn(c2.shape, device=eng.device,
                        generator=torch.Generator(device=eng.device)
                        .manual_seed(SEED + 5))
        _check_grads(f'conv_chain_bwd down_0 with dx (B={BATCH})',
                     CCB.conv_chain_bwd(xc, c1, c2, g, w1, w2),
                     CCB.plain(xc, c1, c2, g, w1, w2),
                     CCB.plain(*_f64(xc, c1, c2, g, w1, w2)))

    def input_grad(forward):
        v = x.detach().requires_grad_()
        (dx,) = torch.autograd.grad(forward(v).sum(), v)
        return dx

    got = input_grad(eng.model)
    want = input_grad(lambda v: plain_forward(eng.model, v))
    diff = (got - want).abs()
    scale = float(want.abs().max())
    beyond = float((diff > DX_TOL * scale).float().mean())
    summed = float(diff.sum() / want.abs().sum())
    log(f'input gradient B={BATCH} {SIZE}x{SIZE}x5 vs plain autograd: '
        f'max|diff| {float(diff.max()):.3e} (max|ref| {scale:.3e}) in slices '
        f'{sorted(set(torch.nonzero(diff > DX_TOL * scale)[:, 0].tolist()))}'
        f'; share beyond {DX_TOL} * max|ref| {beyond:.3e}; summed |diff| / '
        f'summed |ref| {summed:.3e}')
    if not (beyond <= SENS_FLIP_SHARE and summed <= DX_TOL):
        raise AssertionError('input gradient through the kernels disagrees '
                             'with plain autograd')
    _, sens = viz.input_sensitivity(eng.model, x)
    ref = want.abs().sum(dim=(1, 2))
    ref = ref / ref.sum(dim=1, keepdim=True)
    sens_err = float((sens - ref).abs().max())
    log(f'  normalized sensitivity [{BATCH}, 5]: max|diff| {sens_err:.3e}')
    if not sens_err <= DX_TOL * float(ref.abs().max()):
        raise AssertionError(f'sensitivity differs by {sens_err}')
    ms, plain_ms = _time_pair(
        lambda: input_grad(eng.model),
        lambda: input_grad(lambda v: plain_forward(eng.model, v)))
    log(f'    forward + input gradient: kernels {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms')


# -- phase 6 -----------------------------------------------------------------
@contextlib.contextmanager
def _plain_cca():
    '''Within the block, connected components run the plain version on
    the card instead of the kernel.'''
    from dnncancerannotator_torch.ops.kernels import cca as K
    kernel = K.cca_raw_labels
    K.cca_raw_labels = K.plain
    try:
        yield
    finally:
        K.cca_raw_labels = kernel


def _read_csv(path):
    import csv
    with open(path, newline='') as fh:
        return list(csv.reader(fh))


def _pr_curves(path):
    '''(number of records, {(step, tag): [6, T] array}) of an event file,
    read with the port's record reader.'''
    from dnncancerannotator_torch.data import tfrecord as tfr
    count, curves = 0, {}
    for record_bytes in tfr.read_records(path, verify_crc=True):
        count += 1
        event = {f: v for f, _, v in tfr.iter_fields(record_bytes)}
        if 5 not in event:
            continue
        for _, _, value in tfr.iter_fields(event[5]):
            fields = {f: v for f, _, v in tfr.iter_fields(value)}
            if 8 in fields:
                curves[(event[2], bytes(fields[1]).decode())] = \
                    tfr.parse_tensor(fields[8])
    return count, curves


def _check_region_counts(device, run, data_paths, header, rows, casewise,
                         curves):
    '''Recompute every region count of the evaluate run with the plain
    CCA on the card, from the same probabilities, and require equality.'''
    from dnncancerannotator_torch import engine, metrics
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.utils import config as config_lib
    from dnncancerannotator_torch.utils import viz

    config = config_lib.load_config(os.path.join(run, 'options.yaml'))[
        'config']
    config = config_lib.apply_config(config, config_lib.load_config(
        os.path.join(REPO, METRICS_CONFIG)))
    eng = engine.Engine(config, device=device)
    ds = pipeline.eval_ds(data_paths, **config['data_options']['eval'])
    eng.build(ds.feature_shape)
    visualizer = viz.Visualizer('plain', ds, 1, save_dir=WORK)
    step_fn = eng._make_eval_step(ds.slice_types)
    region_cols = [i for i, name in enumerate(header)
                   if name.startswith('region/')]
    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    for i, row in enumerate(rows):
        step = int(row[0])
        eng.load(os.path.join(run, 'checkpoints', f'ckpt-{step}'))
        suite = eng._build_metrics()
        cm = metrics.RegionBasedConfusionMatrix(
            viz.PR_THRESHOLDS, viz.PR_IOU_THRESHOLD, resize_factor=0.5)
        per_slice = []
        with _plain_cca():
            for batch in ds.batches():
                _, probs, y = step_fn(batch['slices'])
                for metric in suite:
                    metric.update_state(y, probs)
                _, y, probs, _ = visualizer._viz_batch(eng, batch['slices'])
                per_slice.append(np.concatenate(
                    cm.update_state_raw(y, probs), axis=1))
        values = {m.name: float(m.result()) for m in suite}
        for c in region_cols:
            if float(row[c]) != values[header[c]]:
                raise AssertionError(
                    f'ckpt-{step} {header[c]}: evaluate wrote {row[c]}, the '
                    f'plain CCA gives {values[header[c]]}')
        want = np.concatenate(per_slice)
        got = np.asarray([r[1:-1] for r in casewise[
            1 + i * n_slices:1 + (i + 1) * n_slices]], np.int64)
        if not np.array_equal(got, want):
            raise AssertionError(f'ckpt-{step}: casewise region counts differ '
                                 'from the plain CCA in '
                                 f'{int((got != want).sum())} entries')
        curve = curves[(step, 'region/PR_curve/pr_curves')]
        result = cm.result_dict()
        for r, key in ((0, 'true_positive_counts'),
                       (1, 'false_positive_counts'),
                       (3, 'false_negative_counts')):
            if not np.array_equal(curve[r], result[key].astype(np.float32)):
                raise AssertionError(f'ckpt-{step}: region PR curve {key} '
                                     'differs from the plain CCA')
        log(f'  ckpt-{step}: region counts equal the plain CCA\'s: '
            f'{", ".join(header[c] + "=" + row[c] for c in region_cols[2:5])}'
            f'; PR curve TP at 0.5 {int(result["true_positive_counts"][50])}')


def eval_slice(device, val_paths, train_paths, run):
    '''Phase 6: train --validate with metrics, then evaluate over the
    checkpoints of ``run``; returns the launch counts of the evaluate
    call.'''
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli

    metrics_config = os.path.join(REPO, METRICS_CONFIG)
    overlay = os.path.join(WORK, 'validate.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': 2}, fh)
    start = time.perf_counter()
    res = cli(argv=['train', '--config', *[os.path.join(REPO, c)
                                           for c in CONFIGS],
                    metrics_config, overlay, '--save_path',
                    os.path.join(WORK, 'val_run'), '--data_path', *train_paths,
                    '--save_freq', '2', '--max_steps', '4', '--validate',
                    '--val_data_path', *val_paths, '--early_stop_steps', '4',
                    '--visualize', '--seed', str(SEED), '--device',
                    device.type])
    seconds = time.perf_counter() - start
    val_keys = sorted(k for k in res.history if k.startswith('val_'))
    log(f'train --validate --visualize: steps {res.epoch} in {seconds:.3f} s; '
        f'val_loss {res.history.get("val_loss")}; {len(val_keys)} val '
        f'scalars, {len(res.history) - len(val_keys) - 2} train metrics')
    if res.epoch != [1, 2, 3, 4] or len(res.history.get('val_loss', [])) != 2 \
            or len(val_keys) != 14 or len(res.history) != 2 + 13 + 14 or \
            not np.isfinite(res.history['val_loss']).all():
        raise AssertionError(f'train --validate history: {res.history}')

    kernels.reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result_rows = cli(argv=[
        'evaluate', '--save_path', run, '--data_path', *val_paths, '--tag',
        EVAL_TAG, '--config', metrics_config, '--export_csv',
        '--export_images', '--export_casewise_metrics', '--device',
        device.type])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    n_ckpt = len(result_rows)
    n_slices = sum(N_EXAMS) * SLICES_PER_EXAM
    log(f'evaluate: {n_ckpt} checkpoints x {n_slices} slices in '
        f'{seconds:.3f} s -> {seconds / n_ckpt:.3f} s per checkpoint, '
        f'{n_ckpt * n_slices / seconds:.2f} slices/s (host clock, the '
        'metrics pass and the Visualizer pass with every export)')
    log(f'launches during evaluate: {launches}')

    out = os.path.join(run, 'tfevents', EVAL_TAG)
    table = _read_csv(os.path.join(out, 'results.csv'))
    header, rows = table[0], table[1:]
    n_saved = len(os.listdir(os.path.join(run, 'checkpoints')))
    if n_ckpt != n_saved or len(rows) != n_ckpt or \
            header[:2] != ['step', 'loss'] or len(header) != 2 + 13:
        raise AssertionError(f'results.csv: {header}, {len(rows)} rows for '
                             f'{n_ckpt} checkpoints')
    casewise = _read_csv(os.path.join(out, 'casewise_results.csv'))
    pngs = sum(f.endswith('.png') for _, _, files in
               os.walk(os.path.join(out, 'images')) for f in files)
    (events,) = [os.path.join(out, f) for f in os.listdir(out)
                 if f.startswith('events')]
    n_records, curves = _pr_curves(events)
    log(f'  results.csv {len(rows)} rows x {len(header)} columns, '
        f'casewise_results.csv {len(casewise) - 1} rows, {pngs} PNGs, '
        f'{n_records} event records')
    if len(casewise) - 1 != n_slices * n_ckpt or pngs != n_slices * n_ckpt \
            or n_records != 1 + n_ckpt * (n_slices + 2):
        raise AssertionError('evaluate exports are incomplete')
    n_batches = -(-n_slices // BATCH)
    if launches['cca'] < n_batches * n_ckpt:
        raise AssertionError(f'cca launched {launches["cca"]} times during '
                             f'evaluate, want >= {n_batches} x {n_ckpt}')
    _check_region_counts(device, run, val_paths, header, rows, casewise,
                         curves)
    return launches


# -- phase 3e ----------------------------------------------------------------
def _big_config(gates_on=True):
    '''The unet_big stack, with or without pallas_decoder.yaml.'''
    from dnncancerannotator_torch.utils import config as config_lib
    configs = BIG_CONFIGS if gates_on else BIG_CONFIGS[:-1]
    return config_lib.load_config([os.path.join(REPO, c) for c in configs])


def _nhwc_modules():
    from dnncancerannotator_torch.ops.kernels import (
        pool2x2_nhwc, pool2x2_nhwc_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd)
    return pool2x2_nhwc, pool2x2_nhwc_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd


@torch.no_grad()
def big_kernel_sites(device, results):
    '''The four NHWC kernels against their plain versions at their
    unet_big sites, on the activations of a seeded unet_big forward.'''
    from dnncancerannotator_torch import engine
    PN, PNB, TN, TNB = _nhwc_modules()
    F = torch.nn.functional
    conv_bwd = torch.ops.aten.convolution_backward

    eng = engine.Engine(_big_config(), seed=SEED, device=device)
    eng.build((TRAIN_BATCH, SIZE, SIZE, 5))
    modules = dict(eng.model.named_modules())
    seen = {}
    hooks = [modules[path + '.convchain'].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, out))
        for path in POOL_SITES]
    hooks += [modules[path + '.tconv'].register_forward_hook(
        lambda mod, args, out, path=path: seen.__setitem__(path, args[0]))
        for path in BIG_TCONV_SITES]
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    with eng.scope(training=True):
        eng.model(torch.rand((TRAIN_BATCH, SIZE, SIZE, 5), generator=gen,
                             device=device))
    for hook in hooks:
        hook.remove()

    log(f'unet_big NHWC kernels (B={TRAIN_BATCH}, {SIZE}x{SIZE} input, '
        'activations of a train-mode forward):')
    for path in POOL_SITES:
        x = seen[path].contiguous()
        b, h, w, c = x.shape
        got, want = PN.pool2x2_nhwc(x), PN.plain(x)
        g = torch.randn(want.shape, generator=gen, device=device)
        dx, dx_want = PNB.pool2x2_nhwc_bwd(x, g), PNB.plain(x, g)
        torch.cuda.synchronize()
        tied = float(((x.view(b, h // 2, 2, w // 2, 2, c)
                       == want[:, :, None, :, None]).sum((2, 4)) > 1)
                     .float().mean())
        errs = []
        for name, k, ref in (('pool2x2_nhwc', got, want),
                             ('pool2x2_nhwc_bwd', dx, dx_want)):
            errs.append(float((k - ref).abs().max()))
            log(f'  {name} {path} {list(x.shape)} max|diff| {errs[-1]:.3e} '
                f'(windows with a tie {tied:.3%})')
            if not torch.equal(k, ref):   # maxima, g * {1, 0.5, 0.25}: exact
                raise AssertionError(f'{name} at {path} differs from its '
                                     f'plain version by {errs[-1]}')
        times = _time_site(lambda: PN.pool2x2_nhwc(x), lambda: PN.plain(x),
                           lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2))
        record(results, 'pool2x2_nhwc', errs[0], times,
               bound(nbytes(x, got), 3 * got.numel()))
        # no library call: max_pool2d's backward sends a tie to one input
        times = _time_site(lambda: PNB.pool2x2_nhwc_bwd(x, g),
                           lambda: PNB.plain(x, g))
        record(results, 'pool2x2_nhwc_bwd', errs[1], times,
               bound(nbytes(x, g, dx), 12 * g.numel()))
    for path in BIG_TCONV_SITES:
        tconv = modules[path + '.tconv']
        x, w, bias = seen[path].contiguous(), tconv.weight, tconv.bias
        site = f'{path} {w.shape[0]}->{w.shape[1]} @{x.shape[1]}'
        got, want = TN.tconv2x2_nhwc(x, w, bias), TN.plain(x, w, bias)
        name = f'tconv2x2_nhwc {site}'
        err = _check_close(name, got, want, DX_TOL)
        _f64_errors(name, got, want, TN.plain(*_f64(x, w, bias)), F64_RATIO)
        # the forward as predict calls it (the weight packed in the call)
        times = _time_site(
            lambda: TN.tconv2x2_nhwc(x, w, bias),
            lambda: TN.plain(x, w, bias),
            lambda: F.conv_transpose2d(x.permute(0, 3, 1, 2), w, bias,
                                       stride=2))
        work = (nbytes(x, w, bias, got), 2 * got.numel() * w.shape[0])
        record(results, 'tconv2x2_nhwc', err, times, bound(*work),
               tf32x3_bound(*work))
        g = torch.randn(got.shape, generator=gen, device=device)
        # the backward as training calls it: the weight packed by the
        # forward; two calls give the same bits
        wpt = TN.pack(w)
        grads = TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt)
        again = TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'tconv2x2_nhwc_bwd {site}: two calls differ')
        err = _check_grads(f'tconv2x2_nhwc_bwd {site}', grads,
                           TNB.plain(x, g, w), TNB.plain(*_f64(x, g, w)),
                           F64_RATIO)
        times = _time_site(
            lambda: TNB.tconv2x2_nhwc_bwd(x, g, w, wpt=wpt),
            lambda: TNB.plain(x, g, w),
            lambda: conv_bwd(g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w,
                             [w.shape[1]], [2, 2], [0, 0], [1, 1], True,
                             [0, 0], 1, [True, True, True]))
        work = (nbytes(x, g, w, *grads), 4 * g.numel() * w.shape[0])
        record(results, 'tconv2x2_nhwc_bwd', err, times, bound(*work),
               tf32x3_bound(*work))


# -- phase 7 -----------------------------------------------------------------
def _profile_steps(label, step, steps=5, top=12):
    '''Where a step's device time goes: ``steps`` calls of ``step`` under
    torch.profiler, the device's busy share of the wall time and the
    ``top`` kernels by device time.'''
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy_us = sum(e.self_device_time_total for e in device)
    log(f'{label} under torch.profiler: {wall * 1e3 / steps:.3f} ms a step, '
        f'device busy {busy_us / 1e3 / steps:.3f} ms a step '
        f'({100 * busy_us / 1e6 / wall:.1f}% of the wall time); by kernel:')
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:top]:
        log(f'  {e.self_device_time_total / 1e3 / steps:9.3f} ms '
            f'{e.count // steps:4d}x  {e.key[:90]}')


def _batch_stats(path):
    with np.load(os.path.join(path, 'params.npz')) as npz:
        return {k: npz[k] for k in npz.files if k.startswith('batch_stats/')}


def _big_step(eng, ds, raw, draws, plain, f64=False):
    '''Loss, parameter gradients and updated BatchNorm statistics of one
    train-mode step on ``raw`` with the given draws, through the kernels or
    their plain versions; the statistics are put back after. With ``f64``
    the plain step's model and loss run in f64 on the same augmented f32
    batch (the kernels take f32 only, so none routes), and the model is
    put back in f32 after: an exact reference for ``_compare_step``.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

    start = {n: b.clone() for n, b in eng.model.named_buffers()}
    try:
        with (_plain_versions(*_nhwc_modules(), WT) if plain
              else contextlib.nullcontext()):
            images = augment.apply_chain(
                ds.augment_methods, raw.float() / 255.0, draws,
                eng._warp_bank(ds))
            x, y = augment.to_feature_label(images, ds.slice_types)
            if f64:
                eng.model.double()
                x = x.double()
            eng.model.zero_grad(set_to_none=True)
            with eng.scope(training=True):
                logits = eng.model(x, return_logits=True)
            loss = eng.loss(y, logits)
            loss.backward()
        grads = {n: p.grad.clone() for n, p in eng.model.named_parameters()}
        stats = {}
        for n, b in eng.model.named_buffers():
            stats[n] = b.clone()
            b.copy_(start[n])
    finally:
        if f64:
            eng.model.float()
            eng.model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, stats


def _compare_step(got, want, exact):
    '''One step through the kernels against the plain step: the loss to
    LOSS_TOL relative, each gradient to STEP_TOL and each statistic to
    STATS_TOL of max|ref|. A bias right before a BatchNorm (the tconv
    biases) has an exact gradient of 0, so both sides hold rounding noise
    there: a bias is held on the scale of its layer's weight gradient.

    Where the kernel step is further than that from the plain f32 step,
    both are held to the f64 step (``exact()``, made once, when first
    needed): the kernel step passes if it is no further from it than
    F64_RATIO times the plain step, the kernels' own rule (phase 3e). A
    gradient that is a sum cancelling to near 0 (a BatchNorm bias whose
    incoming gradient has zero pixel mean before a relu mask) holds the
    rounding of every term it sums, and the plain f32 step is no truth
    there.'''
    (loss, grads, stats), (plain_loss, plain_grads, plain_stats) = got, want
    exact_step = []
    log(f'one unet_big train step: loss {loss:.7f} kernels, {plain_loss:.7f} '
        'plain')
    if not abs(loss - plain_loss) <= LOSS_TOL * abs(plain_loss):
        raise AssertionError(f'train-step loss {loss} vs plain {plain_loss}')
    worst = {'grad': 0.0, 'stat': 0.0}
    for kind, tol, ours, ref in (('grad', STEP_TOL, grads, plain_grads),
                                 ('stat', STATS_TOL, stats, plain_stats)):
        for name, w in ref.items():
            layer = name.rsplit('.', 1)[0]
            scale = max(float(w.abs().max()), float(
                ref.get(layer + '.weight', w).abs().max()))
            err = float((ours[name] - w).abs().max())
            if err <= tol * scale:
                worst[kind] = max(worst[kind], err / scale)
                continue
            if not exact_step:
                exact_step.append(exact())
            ref64 = exact_step[0][1 if kind == 'grad' else 2][name]
            err64, plain64 = (float((t.double() - ref64).abs().max())
                              for t in (ours[name], w))
            log(f'  {name}: {err:.3e} > {tol} * {scale:.3e} from the plain '
                f'step; from the f64 step: kernels {err64:.3e}, plain '
                f'{plain64:.3e}')
            if not err64 <= F64_RATIO * plain64:
                raise AssertionError(f'{name}: {err} > {tol} * {scale} from '
                                     'the plain train step, and the kernels '
                                     f'are {err64} from the f64 step against '
                                     f'the plain step\'s {plain64}')
    log(f'  {len(grads)} parameter gradients within {worst["grad"]:.3e} and '
        f'{len(stats)} BatchNorm statistics within {worst["stat"]:.3e} of '
        'max|ref| of the plain step, but for those held to the f64 step '
        'above')


def big_train_slice(device, data_paths):
    '''Phase 7; returns the launch counts of the first train call and of
    the predict call.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.ops import kernels
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    overlay = os.path.join(WORK, 'big_steps_per_call.json')
    with open(overlay, 'w') as fh:
        json.dump({'deploy_options.steps_per_call': BIG_SAVE_FREQ}, fh)
    save_path = os.path.join(WORK, 'big_run')
    ckpt_dir = os.path.join(save_path, 'checkpoints')

    def argv(configs, save, save_freq, steps):
        return ['train', '--config', *[os.path.join(REPO, c) for c in configs],
                overlay, '--save_path', save, '--data_path', *data_paths,
                '--save_freq', str(save_freq), '--seed', str(SEED),
                '--device', device.type, '--max_steps', str(steps)]

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.perf_counter()
    res = cli(argv=argv(BIG_CONFIGS, save_path, BIG_SAVE_FREQ, BIG_STEPS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernels.launch_counts()
    losses = res.history['loss']
    log(f'unet_big train: {BIG_STEPS} steps of B={TRAIN_BATCH} in '
        f'{seconds:.3f} s (host clock; bank solve, data load and checkpoints '
        f'included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak device '
        f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log(f'launches during unet_big train: {launches}')
    if res.epoch != list(range(1, BIG_STEPS + 1)) or \
            not np.isfinite(losses).all():
        raise AssertionError(f'train steps {res.epoch}, losses {losses}')
    for name in NHWC_KERNELS:
        if launches[name] < 3 * BIG_STEPS:
            raise AssertionError(f'{name} launched {launches[name]} times, '
                                 f'want >= 3 x {BIG_STEPS}')
    if launches['warp_twopass'] < BIG_STEPS:
        raise AssertionError('the warp kernel did not run every step')
    for step in range(BIG_SAVE_FREQ, BIG_STEPS + 1, BIG_SAVE_FREQ):
        path = os.path.join(ckpt_dir, f'ckpt-{step}')
        with np.load(os.path.join(path, 'opt_state.npz')) as npz:
            if any('batch_stats' in k for k in npz.files):
                raise AssertionError('optimizer state for batch_stats')
        stats = _batch_stats(path)
        still = [k for k, v in stats.items()
                 if np.array_equal(v, np.full_like(v, k.endswith('/var')))]
        # mean and var of 24 BatchNorms: 4 levels x (bn_0, bn_1 and pool_bn
        # down, tconv_bn, bn_0 and bn_1 up)
        if len(stats) != 2 * 4 * 6 or still:
            raise AssertionError(f'ckpt-{step}: {len(stats)} batch_stats, '
                                 f'unmoved {still}')
    last = BIG_STEPS + BIG_SAVE_FREQ
    res = cli(argv=argv(BIG_CONFIGS, save_path, BIG_SAVE_FREQ, last))
    if res.epoch != list(range(BIG_STEPS + 1, last + 1)):
        raise AssertionError(f'the second train call ran steps {res.epoch}')
    before, after = (_batch_stats(os.path.join(ckpt_dir, f'ckpt-{s}'))
                     for s in (BIG_STEPS, last))
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    log(f'unet_big train resumed at step {BIG_STEPS}: steps {res.epoch[0]}-'
        f'{res.epoch[-1]}, loss {res.history["loss"][-1]:.4f}; '
        f'{len(before)} batch_stats in each checkpoint, {moved} moved from '
        f'ckpt-{BIG_STEPS} to ckpt-{last}')
    if moved != len(before):
        raise AssertionError('batch_stats did not move after the resume')

    # predict from ckpt-30 against the plain forward in eval mode
    config = config_lib.load_config(
        os.path.join(save_path, 'options.yaml'))['config']
    eng = engine.Engine(config, seed=SEED, device=device)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    eng._setup_training(ds)
    eng.load(os.path.join(ckpt_dir, f'ckpt-{last}'))
    out_dir = os.path.join(WORK, 'big_maps')
    kernels.reset_launches()
    count = cli(argv=['predict', '--save_path', save_path, '--data_path',
                      *data_paths, '--output_path', out_dir, '--batch_size',
                      str(BATCH), '--output_format', 'npy', '--device',
                      device.type])
    predict_launches = kernels.launch_counts()
    log(f'predict from unet_big ckpt-{last}: {count} maps; launches '
        f'{predict_launches}')
    if min(predict_launches['pool2x2_nhwc'],
           predict_launches['tconv2x2_nhwc']) < 3:
        raise AssertionError('predict did not run the NHWC kernels')

    def reference(x):
        with _plain_versions(*_nhwc_modules()), eng.scope():
            return eng.model(x)

    def exact(x):
        # the kernels take f32 only: in f64 the plain versions run
        try:
            eng.model.double()
            return reference(x.double())
        finally:
            eng.model.float()

    _check_maps(eng.model, data_paths, out_dir,
                sum(TRAIN_EXAMS) * TRAIN_SLICES, reference, exact)

    # one step: the kernels against a plain step, same batch and draws
    resident = eng._resident(ds)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    raw = eng.sample_batch(resident, TRAIN_BATCH, gen)
    draws = augment.draw_chain(ds.augment_methods, raw.shape, gen,
                               eng._warp_bank(ds))
    _compare_step(_big_step(eng, ds, raw, draws, plain=False),
                  _big_step(eng, ds, raw, draws, plain=True),
                  lambda: _big_step(eng, ds, raw, draws, plain=True,
                                    f64=True))

    # the stack without pallas_decoder.yaml: the NHWC kernels stay off
    kernels.reset_launches()
    cli(argv=argv(BIG_CONFIGS[:-1], os.path.join(WORK, 'big_run_off'), 2, 2))
    off = kernels.launch_counts()
    log(f'unet_big without pallas_decoder.yaml, 2 steps: launches {off}')
    if any(off[name] for name in NHWC_KERNELS) or off['warp_twopass'] < 2:
        raise AssertionError('a gate that is off launched a kernel')

    # the train step's time, kernels vs plain (the same engine)
    def plain_step():
        with _plain_versions(*_nhwc_modules(), WT):
            eng.train_step(raw, last, gen)

    ms, plain_ms = _time_pair(lambda: eng.train_step(raw, last, gen),
                              plain_step)
    log(f'unet_big train step B={TRAIN_BATCH}: kernels {ms:.4f} ms  plain '
        f'{plain_ms:.4f} ms (CUDA events, median of {TIMED_RUNS})')

    _DEFERRED.append(lambda: _profile_steps(
        'unet_big train step', lambda: eng.train_step(raw, last, gen)))

    # throughput: train calls that differ only in step count, min of three
    short, long = 10, 40
    eng.train(ds, max_steps=eng.current_step + 5, save_freq=1 << 30)
    times = {}
    for n in (short, long):
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
            torch.cuda.synchronize()
            times.setdefault(n, []).append(time.perf_counter() - start)
    rate = (long - short) * TRAIN_BATCH / (min(times[long]) -
                                           min(times[short]))
    log(f'unet_big train throughput: {rate:.2f} slices/s ({short}-step calls '
        f'{times[short]} s, {long}-step calls {times[long]} s; '
        f'steps_per_call {BIG_SAVE_FREQ})')
    return launches, predict_launches

# -- phase 3f ----------------------------------------------------------------
@torch.no_grad()
def crop_kernel_sites(device, results):
    '''The crop-fused warp kernel against its plain version on [8, 268, 268,
    6] windows cropped to 256 x 256 at d = 8 and 18: at the flows of a real
    per-step solve and at a random flow past +-d; offsets 0, in - out and
    mirrored ones (w_in - w_out - ox). Exactly equal.'''
    from dnncancerannotator_torch.data import augment
    from dnncancerannotator_torch.ops import warp
    from dnncancerannotator_torch.ops.kernels import warp_crop as WC

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    b, span = TRAIN_BATCH, CROP_IN - SIZE
    image = torch.rand((b, CROP_IN, CROP_IN, 6), generator=gen, device=device)
    oy = (0, span, 6, 3, span, 0, 9, 6)
    ox = (0, span, span - 6, span - 2, 0, span, span - 9, 6)
    off = torch.tensor(list(zip(oy, ox)), dtype=torch.int32, device=device)
    log(f'crop-fused warp (B={b}, {CROP_IN}x{CROP_IN}x6 -> {SIZE}x{SIZE}, '
        f'offsets {off.tolist()}):')
    for opts in CROP_WARPS:
        d = augment._max_displacement(opts['max_diff'])
        src, dst = augment.draw_warp(gen, b, SIZE, **opts)
        flows = {
            'per-step solve': warp.cropped_twopass_flows(
                src, dst, off, (CROP_IN, CROP_IN), (SIZE, SIZE),
                max_displacement=d),
            'random flow past +-d': tuple(torch.randn(
                shape, generator=gen, device=device) * 1.5 * d
                for shape in ((b, SIZE, CROP_IN), (b, SIZE, SIZE))),
        }
        for label, (fy, fx) in flows.items():
            fy, fx = fy.contiguous(), fx.contiguous()
            got = WC.warp_crop(image, fy, fx, off, d)
            want = WC.plain(image, fy, fx, off, d)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            log(f'  warp_crop d={d:2d} {label:22s} max|diff| {err:.3e}  '
                f'max|ref| {float(want.abs().max()):.3e}')
            if not torch.equal(got, want):   # same rounded operations: exact
                raise AssertionError(f'warp_crop ({label}, d={d}) differs '
                                     f'from its plain version by {err}')
            times = _time_site(lambda: WC.warp_crop(image, fy, fx, off, d),
                               lambda: WC.plain(image, fy, fx, off, d))
            # reads the crop region (as large as the output) and the flows,
            # writes the output; about 12 operations an output value
            record(results, 'warp_crop', err, times,
                   bound(2 * nbytes(got) + nbytes(fy, fx, off),
                         12 * got.numel()))


# -- phase 8 -----------------------------------------------------------------
def smooth_batch(b, size, c, seed):
    '''[b, size, size, c] f32 Gaussian blobs in [0, 1] (the batch of
    tools/chip_fusedaug_parity.py): the fused and composed routes differ by
    where their coarse flow grids fall, so they are compared on smooth
    content.'''
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    imgs = np.zeros((b, size, size, c), np.float32)
    for i in range(b):
        for _ in range(6):
            cy, cx = rng.uniform(10, size - 10, 2)
            imgs[i, ..., rng.integers(0, c)] += np.exp(
                -(((yy - cy) ** 2 + (xx - cx) ** 2) / (0.02 * size * size))
            ).astype(np.float32)
    return np.clip(imgs, 0, 1)


def _phi(r2):
    return 0.5 * r2 * np.log(np.maximum(r2, 1e-10))


def _spline(q, tp, vals):
    '''The thin-plate spline through (tp, vals) at q, in f64.'''
    n = tp.shape[0]
    a = _phi(((tp[:, None, :] - tp[None, :, :]) ** 2).sum(-1))
    bm = np.concatenate([np.ones((n, 1)), tp], axis=1)
    sol = np.linalg.solve(np.block([[a, bm], [bm.T, np.zeros((3, 3))]]),
                          np.concatenate([vals, np.zeros((3, 2))], axis=0))
    d2 = ((q[:, None, :] - tp[None, :, :]) ** 2).sum(-1)
    return _phi(d2) @ sol[:n] + np.concatenate(
        [np.ones((q.shape[0], 1)), q], axis=1) @ sol[n:]


def _resample(img, q, axis):
    '''Bilinear resample of [h, w, c] along ``axis`` at positions q [h, w]
    (clipped to the image), taps clamped to the edge.'''
    n = img.shape[axis]
    q0 = np.floor(q).astype(int)
    r = (q - q0)[..., None]
    rows, cols = np.mgrid[:img.shape[0], :img.shape[1]]
    lo = np.clip(q0, 0, n - 1)
    hi = np.clip(q0 + 1, 0, n - 1)
    if axis == 0:
        return img[lo, cols] * (1.0 - r) + img[hi, cols] * r
    return img[rows, lo] * (1.0 - r) + img[rows, hi] * r


def oracle_chain(images, off, flip, factors, src, dst, out_size, tmask,
                 max_diff):
    '''The fused chain in f64 with the spline evaluated at every output
    pixel (no coarse grid): crop, flip, contrast on the crop's mean, the
    clamped flow with fy at the source column, the two-pass resample (a
    copy of tools/chip_fusedaug_parity.py:oracle_chain, which imports
    JAX).'''
    th, tw = out_size
    d = float(int(np.ceil(max_diff)) + 3)
    scale = 1.0 / float(max(th, tw))
    gy, gx = np.mgrid[:th, :tw].astype(np.float64)
    out = np.empty((images.shape[0], th, tw, images.shape[-1]))
    for i in range(images.shape[0]):
        oy, ox = int(off[i, 0]), int(off[i, 1])
        win = images[i, oy:oy + th, ox:ox + tw].astype(np.float64)
        if flip[i]:
            win = win[:, ::-1]
        m = win.mean(axis=(0, 1))
        win = np.where(tmask[None, None, :], (win - m) * float(factors[i]) + m,
                       win)
        tp = dst[i].astype(np.float64) * scale
        vals = (dst[i] - src[i]).astype(np.float64)
        q = np.stack([gy.ravel(), gx.ravel()], axis=-1) * scale
        fl = np.clip(_spline(q, tp, vals).reshape(th, tw, 2), -d, d)
        q2 = np.stack([gy.ravel(), (gx + fl[..., 1]).ravel()], axis=-1) * scale
        fy = np.clip(_spline(q2, tp, vals)[:, 0].reshape(th, tw), -d, d)
        qy = np.clip(gy - fy, 0.0, th - 1.0)
        qx = np.clip(gx - fl[..., 1], 0.0, tw - 1.0)
        out[i] = _resample(_resample(win, qy, 0), qx, 1)
    return out


def _routes(augment, methods, images, draws):
    '''(fused, composed per-step) outputs of one batch and draw list, and
    the launches of the two resample kernels.'''
    from dnncancerannotator_torch.ops import kernels
    kernels.reset_launches()
    fused = augment.apply_fused_chain(methods, images, draws)
    composed = augment.apply_chain(methods, images, draws)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if (counts['warp_crop'], counts['warp_twopass']) != (1, 1):
        raise AssertionError(f'the two routes launched {counts}')
    return fused, composed


def fused_aug_slice(device, data_paths):
    '''Phase 8; returns the launch counts of the fused train call.'''
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.ops import gates, kernels
    from dnncancerannotator_torch.runs.__main__ import main as cli
    from dnncancerannotator_torch.utils import config as config_lib

    def overlay(name, options):
        path = os.path.join(WORK, f'{name}.json')
        with open(path, 'w') as fh:
            json.dump({'deploy_options.steps_per_call': STEPS_PER_CALL,
                       **options}, fh)
        return path

    solved = []
    build_bank = augment.build_warp_bank

    def counted_bank(*args, **kwargs):
        solved.append(args[1])
        return build_bank(*args, **kwargs)

    def train(name, configs, steps):
        '''One train CLI call: (history, launches, banks solved).'''
        solved.clear()
        kernels.reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = cli(argv=['train', '--config', *configs, '--save_path',
                        os.path.join(WORK, name), '--data_path', *data_paths,
                        '--save_freq', str(min(steps, SAVE_FREQ)), '--seed',
                        str(SEED), '--device', device.type, '--max_steps',
                        str(steps)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = kernels.launch_counts()
        losses = res.history['loss']
        log(f'train {name}: {steps} steps in {seconds:.3f} s (host clock, '
            f'data load and checkpoints included); loss {losses[0]:.4f} -> '
            f'{losses[-1]:.4f}; banks solved {solved}; warp_crop '
            f'{launches["warp_crop"]}, warp_twopass '
            f'{launches["warp_twopass"]} launches')
        if res.epoch != list(range(1, steps + 1)) or \
                not np.isfinite(losses).all():
            raise AssertionError(f'{name}: steps {res.epoch}, losses {losses}')
        return launches, list(solved)

    base = [os.path.join(REPO, c) for c in CONFIGS]
    fused_configs = base + [overlay('fused', {'deploy_options.fused_aug':
                                              True})]
    augment.build_warp_bank = counted_bank
    try:
        launches, banks = train('fused_run', fused_configs, FUSED_STEPS)
        if (launches['warp_crop'], launches['warp_twopass'], banks) != (
                FUSED_STEPS, 0, []):
            raise AssertionError('the fused train run did not launch '
                                 'warp_crop once a step, and only it, or '
                                 'solved a bank')
        step_launches, banks = train(
            'per_step_run', base + [overlay('per_step', {
                'deploy_options.warp_bank': False})], ROUTE_STEPS)
        if (step_launches['warp_crop'], step_launches['warp_twopass'],
                banks) != (0, ROUTE_STEPS, []):
            raise AssertionError('the per-step train run did not launch '
                                 'warp_twopass once a step')
        intra_launches, banks = train(
            'intra_run', base + [os.path.join(REPO, INTRA_CONFIG),
                                 overlay('intra', {})], ROUTE_STEPS)
        if (intra_launches['warp_crop'], intra_launches['warp_twopass'],
                len(banks)) != (0, ROUTE_STEPS, 1):
            raise AssertionError('the intra-channel train run did not take '
                                 'the banked warp once a step')
    finally:
        augment.build_warp_bank = build_bank

    # the two routes on one batch and one draw list
    config = config_lib.load_config(fused_configs)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    methods = ds.augment_methods
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    images = torch.from_numpy(smooth_batch(
        TRAIN_BATCH, CROP_IN, 6, SEED)).to(device)
    fused, composed = _routes(augment, methods, images, augment.draw_chain(
        methods, images.shape, gen))
    err = (fused - composed).abs()
    mean, worst = float(err.mean()), float(err.max())
    q999 = float(torch.quantile(err.reshape(-1), 0.999))
    log(f'fused vs composed per-step route [{TRAIN_BATCH},{CROP_IN},'
        f'{CROP_IN},6] -> {SIZE}: mean|diff| {mean:.3e}, max {worst:.3e}, '
        f'99.9th percentile {q999:.3e}')
    if not (mean < FUSED_MEAN and worst < FUSED_MAX and q999 < FUSED_Q999):
        raise AssertionError('the fused route strays from the composed one')

    # both routes against the f64 oracle (tools/chip_fusedaug_parity.py's
    # production case and rule)
    images = torch.from_numpy(smooth_batch(
        ORACLE_BATCH, CROP_IN, 6, SEED + 1)).to(device)
    draws = augment.draw_chain(methods, images.shape, gen)
    fused, composed = (t.cpu().numpy() for t in _routes(
        augment, methods, images, draws))
    diff, flips, factors, (src, dst) = draws
    top, left = augment._crop_offsets(diff, images.shape[1:3], (SIZE, SIZE))
    tmask = np.zeros(6, bool)
    tmask[list(methods[2][1]['target_channels'])] = True
    oracle = oracle_chain(
        images.cpu().numpy(), torch.stack([top, left], 1).cpu().numpy(),
        flips.cpu().numpy(), factors.cpu().numpy(), src.cpu().numpy(),
        dst.cpu().numpy(), (SIZE, SIZE), tmask,
        methods[3][1].get('max_diff', 5))
    e_c, e_f = np.abs(composed - oracle), np.abs(fused - oracle)
    log(f'f64 oracle [{ORACLE_BATCH},{CROP_IN},{CROP_IN},6] -> {SIZE}, '
        f'{src.shape[1]} points: composed mean {e_c.mean():.3e} max '
        f'{e_c.max():.3e}; fused mean {e_f.mean():.3e} max {e_f.max():.3e}')
    # the fused route as close to the truth as the composed one, and both
    # within the interpolation envelope
    if not (e_f.mean() <= 1.5 * e_c.mean() + 2e-3
            and e_f.max() <= 1.5 * e_c.max() + 2e-2
            and e_f.mean() < 2e-2 and e_c.mean() < 2e-2):
        raise AssertionError('the f64 oracle adjudication failed')

    # the augmentation's time a step on each route
    raw = torch.randint(0, 256, (TRAIN_BATCH, CROP_IN, CROP_IN, 6),
                        generator=gen, device=device, dtype=torch.uint8)
    bank = augment.build_warp_bank(
        torch.Generator(device=device).manual_seed(SEED + 10),
        int(config['deploy_options'].get('warp_bank_size', 512)),
        (SIZE, SIZE), **methods[3][1])

    def route(fused_gate, warp_bank):
        fn = augment.build_augment_fn(methods, warp_bank)

        def run():
            with gates.active(gates.KernelGates(fused_aug=fused_gate)):
                return fn(raw.float() / 255.0, gen)
        return run

    t = _time_fns({'banked': route(False, bank),
                   'per-step composed': route(False, None),
                   'fused': route(True, bank)})
    log(f'augmentation a step, B={TRAIN_BATCH} {CROP_IN}x{CROP_IN}x6 uint8 -> '
        f'{SIZE}x{SIZE}: ' + ', '.join(
        f'{name} {ms:.4f} ms' for name, ms in t.items())
        + f' (CUDA events, median of {TIMED_RUNS}, in turns)')

    # throughput of the fused chain: train calls that differ only in step
    # count, min of three (as phase 5)
    eng = engine.Engine(config, seed=SEED, device=device)
    short, long = 25, 100
    eng.train(ds, max_steps=10, save_freq=1 << 30)
    batch = eng.sample_batch(eng._resident(ds), TRAIN_BATCH, gen)
    _DEFERRED.append(lambda: _profile_steps(
        'fused-chain train step',
        lambda: eng.train_step(batch, eng.current_step, gen), top=8))
    times = {}
    for n in (short, long):
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            eng.train(ds, max_steps=eng.current_step + n, save_freq=1 << 30)
            torch.cuda.synchronize()
            times.setdefault(n, []).append(time.perf_counter() - start)
    rate = (long - short) * TRAIN_BATCH / (min(times[long]) -
                                           min(times[short]))
    log(f'fused-chain train throughput: {rate:.2f} slices/s ({short}-step '
        f'calls {times[short]} s, {long}-step calls {times[long]} s; '
        f'steps_per_call {STEPS_PER_CALL})')
    return launches


def main():
    with phase('1 environment'):
        smi = environment()
    from dnncancerannotator_torch import engine
    device = engine.resolve_device('cuda')
    with phase('2 build'):
        build()

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    results = {}
    try:
        data_paths = write_records(os.path.join(WORK, 'data'))
        save_path = os.path.join(WORK, 'run')
        config = write_save_path(save_path, data_paths, device)
        eng = engine.Engine(config, seed=SEED, device=device)
        eng.build((BATCH, SIZE, SIZE, 5))
        eng.load(os.path.join(save_path, 'checkpoints', 'ckpt-1'))
        with phase('3 forward kernels'):
            kernel_sites(eng.model, device, results)
        with phase('3b backward and warp kernels'):
            backward_sites(eng.model, device, results)
        with phase('3c cca kernel'):
            cca_sites(eng, data_paths, results)
        with phase('3d input sensitivity'):
            sensitivity_site(eng, data_paths)
        with phase('3e unet_big kernels'):
            big_kernel_sites(device, results)
        with phase('3f crop-fused warp kernel'):
            crop_kernel_sites(device, results)
        with phase('4 predict'):
            predict_launches = run_slice(eng, data_paths, save_path,
                                         os.path.join(WORK, 'maps'))
        with phase('5 train'):
            launches, train_run, train_paths = train_slice(device)
        with phase('6 evaluate'):
            eval_launches = eval_slice(device, data_paths, train_paths,
                                       train_run)
        with phase('7 unet_big train'):
            big_launches, big_predict = big_train_slice(device, train_paths)
        with phase('8 fused augmentation'):
            fused_launches = fused_aug_slice(device, train_paths)
        with phase('9 profiler windows'):
            for job in _DEFERRED:
                job()
            sums = {key: sum(t[key] for _, t, _ in TRAIN_FORWARD)
                    for key in ('ms', 'plain_ms', 'device_ms',
                                'plain_device_ms')}
            sums['bound_ms'] = sum(b for _, _, b in TRAIN_FORWARD)
            log(f'conv_chain B={TRAIN_BATCH} need_c1, six sites: '
                + json.dumps(sums))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    # each kernel's launches in the run of its path: train for the seven of
    # the unet.yaml train step, evaluate for the CCA, the unet_big train and
    # predict for the four NHWC kernels, the fused-chain train for the crop
    # warp
    launches['cca'] = eval_launches['cca']
    launches['warp_crop'] = fused_launches['warp_crop']
    for name in NHWC_KERNELS:
        launches[name] = big_launches[name]
        predict_launches[name] = big_predict[name]
    csrc = 'dnncancerannotator_torch/csrc/'
    kernels_line = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': f'{csrc}{name}.cu',
         'replaces': ', '.join(PALLAS + r for r in REPLACES[name]),
         'launches': launches[name],
         'predict_launches': predict_launches[name],
         'eval_launches': eval_launches[name],
         'max_abs_err': acc['max_abs_err'], **summed_times(acc),
         'bound_ms': acc['bound_ms'],
         'bound_by': max(acc['by'], key=acc['by'].get),
         **({'tf32x3_bound_ms': acc['tf32x3_bound_ms']}
            if 'tf32x3_bound_ms' in acc else {}),
         'sites': acc['sites']}
        for name, acc in results.items()]}
    log(json.dumps(kernels_line))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
