'''Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from dnncancerannotator_torch/csrc;
3. forward kernels: at every site of the unet.yaml prediction path (B=64,
   256 x 256) each kernel against its plain PyTorch version on the same
   inputs, TF32 off, to max|diff| <= 1e-4 * max|ref|, and the median of 20
   CUDA-event timings of each, taken in turns;
3b. backward and warp kernels: at every site of the training step (B=8,
   256 x 256 crops) each backward kernel against its plain version (the
   data and weight gradients of the plain forward, with the same saved relu
   masks): dx to 1e-5 * max|ref|, dw and db to 2e-5 * max|ref|, with the
   plain f32 version's own error against f64 printed beside; the two-pass
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
   gradient to 1e-4 * max|ref|), the train step's time with the kernels and
   plain (CUDA events, median of 20, in turns), and the train throughput in
   slices/s, measured differentially: the difference of two ``train`` calls
   that differ only in step count, each the minimum of three.

The last three lines of stdout are a JSON object of per-kernel results, the
card's name and power limit, and {"ok": true, "device": {...}}. Without a
CUDA device it exits non-zero before printing any of them.
'''

import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

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
}


def log(*args):
    print(*args, flush=True)


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
    for mod in ('yaml', 'PIL'):
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
            if 'registers' in line or 'spill' in line:
                log('  nvcc:', line.strip())


# -- phase 3 -----------------------------------------------------------------
def _time_pair(kernel_fn, plain_fn):
    '''Median CUDA-event ms of each, timed in turns after warm-up.'''
    for _ in range(3):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    times = {'kernel': [], 'plain': []}
    for _ in range(TIMED_RUNS):
        for name, fn in (('plain', plain_fn), ('kernel', kernel_fn)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return statistics.median(times['kernel']), statistics.median(
        times['plain'])


def _check_close(name, got, want):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f'  {name:44s} max|diff| {err:.3e}  max|ref| {scale:.3e}')
    if not err <= KERNEL_TOL * scale:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version: {err} > {KERNEL_TOL} * {scale}')
    return err


def record(results, name, err, ms, plain_ms):
    '''Sum a site's times into its kernel's entry; keep the worst error.'''
    acc = results.setdefault(name, dict(max_abs_err=0.0, ms=0.0,
                                        plain_ms=0.0, sites=0))
    acc['max_abs_err'] = max(acc['max_abs_err'], err)
    acc['ms'] += ms
    acc['plain_ms'] += plain_ms
    acc['sites'] += 1


def _site_hw(path, size):
    '''Spatial size of a chain site's input at crop size ``size``.'''
    level = int(path[-1])
    return size >> level if 'encoder' in path else size >> (2 - level)


@torch.no_grad()
def kernel_sites(model, device, results):
    '''Each kernel against its plain version at every main-path site.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC

    gen = torch.Generator(device=device).manual_seed(SEED)
    modules = dict(model.named_modules())

    log(f'kernels (B={BATCH}, {SIZE}x{SIZE} input):')
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
        ms, plain_ms = _time_pair(lambda: CC.conv_chain(x, w1, b1, w2, b2),
                                  lambda: CC.plain(x, w1, b1, w2, b2))
        log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
        record(results, 'conv_chain', err, ms, plain_ms)
    for path in TCONV_SITES:
        tconv = modules[path + '.tconv']
        w, b = tconv.weight, tconv.bias
        hw = SIZE >> (3 - int(path[-1]))
        x = torch.rand((BATCH, w.shape[0], hw, hw), generator=gen,
                       device=device)
        got, want = TC.tconv2x2(x, w, b), TC.plain(x, w, b)
        err = _check_close(
            f'tconv2x2 {path} {w.shape[0]}->{w.shape[1]} @{hw}', got, want)
        ms, plain_ms = _time_pair(lambda: TC.tconv2x2(x, w, b),
                                  lambda: TC.plain(x, w, b))
        log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
        record(results, 'tconv2x2', err, ms, plain_ms)
    head = modules['last_conv']
    w, b = head.weight, head.bias
    pads = ((0, 0), (0, 0))
    x = torch.rand((BATCH, w.shape[1], SIZE, SIZE), generator=gen,
                   device=device)
    got, want = SC.stencil_conv(x, w, b, pads), SC.plain(x, w, b, pads)
    err = _check_close(f'stencil_conv last_conv 1x1 {w.shape[1]}->1 @{SIZE}',
                       got, want)
    ms, plain_ms = _time_pair(lambda: SC.stencil_conv(x, w, b, pads),
                              lambda: SC.plain(x, w, b, pads))
    log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
    record(results, 'stencil_conv', err, ms, plain_ms)


# -- phase 3b ----------------------------------------------------------------
def _check_grads(name, got, want, want64):
    '''(dx or None, weight and bias gradients...) of a backward kernel
    against its plain version: dx to DX_TOL, the rest to DW_TOL, relative
    to max|ref|; prints the plain f32 version's own error against f64.'''
    worst = 0.0
    for label, g, w, w64 in zip(('dx', 'dw1', 'db1', 'dw2', 'db2')
                                if len(got) == 5 else ('dx', 'dw', 'db'),
                                got, want, want64):
        if w is None:
            continue
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        f64_err = float((w.double() - w64).abs().max())
        tol = DX_TOL if label == 'dx' else DW_TOL
        log(f'  {name:40s} {label:3s} max|diff| {err:.3e}  max|ref| '
            f'{scale:.3e}  plain f32 vs f64 {f64_err:.3e}')
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
        err = _check_grads(name, CCB.conv_chain_bwd(*args), CCB.plain(*args),
                           CCB.plain(*_f64(*args[:-1]), need_dx))
        ms, plain_ms = _time_pair(lambda: CCB.conv_chain_bwd(*args),
                                  lambda: CCB.plain(*args))
        log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
        record(results, 'conv_chain_bwd', err, ms, plain_ms)
    for path in TCONV_SITES:
        w = modules[path + '.tconv'].weight
        hw = SIZE >> (3 - int(path[-1]))
        x = torch.rand((b, w.shape[0], hw, hw), generator=gen, device=device)
        g = torch.randn((b, w.shape[1], 2 * hw, 2 * hw), generator=gen,
                        device=device)
        name = f'tconv2x2_bwd {path} {w.shape[0]}->{w.shape[1]} @{hw}'
        err = _check_grads(name, TCB.tconv2x2_bwd(x, g, w), TCB.plain(x, g, w),
                           TCB.plain(*_f64(x, g, w)))
        ms, plain_ms = _time_pair(lambda: TCB.tconv2x2_bwd(x, g, w),
                                  lambda: TCB.plain(x, g, w))
        log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
        record(results, 'tconv2x2_bwd', err, ms, plain_ms)
    w = modules['last_conv'].weight
    pads = ((0, 0), (0, 0))
    x = torch.rand((b, w.shape[1], SIZE, SIZE), generator=gen, device=device)
    g = torch.randn((b, 1, SIZE, SIZE), generator=gen, device=device)
    name = f'stencil_conv_bwd last_conv 1x1 {w.shape[1]}->1 @{SIZE}'
    err = _check_grads(name, SCB.stencil_conv_bwd(x, g, w, pads),
                       SCB.plain(x, g, w, pads),
                       SCB.plain(*_f64(x, g, w), pads))
    ms, plain_ms = _time_pair(lambda: SCB.stencil_conv_bwd(x, g, w, pads),
                              lambda: SCB.plain(x, g, w, pads))
    log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
    record(results, 'stencil_conv_bwd', err, ms, plain_ms)

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
        ms, plain_ms = _time_pair(lambda: WT.warp_twopass(image, flow, d),
                                  lambda: WT.plain(image, flow, d))
        log(f'    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms')
        record(results, 'warp_twopass', err, ms, plain_ms)


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


def _check_maps(model, data_paths, out_dir, n_slices):
    '''The predict CLI's maps: one file per slice, finite, in [0, 1], and
    within MAP_TOL of the plain forward of ``model`` on the card.'''
    from dnncancerannotator_torch.data import pipeline

    device = next(model.parameters()).device
    ds = pipeline.predict_ds(data_paths, output_size=(SIZE, SIZE),
                             batch_size=BATCH)
    worst, n_files = 0.0, 0
    with torch.no_grad():
        for batch in ds.batches():
            x = torch.from_numpy(batch['slices']).to(device).float() / 255.0
            ref = plain_forward(model, x[..., :5]).cpu().numpy()
            for i, meta in enumerate(batch['meta']):
                path = os.path.join(out_dir, *meta['path'].split('/')[-3:],
                                    f"{meta['sliceID']:02d}.npy")
                got = np.load(path)
                if got.shape != (SIZE, SIZE) or not np.isfinite(got).all() \
                        or got.min() < 0 or got.max() > 1:
                    raise AssertionError(f'bad map {path}: {got.shape}, '
                                         f'[{got.min()}, {got.max()}]')
                worst = max(worst, float(np.abs(got - ref[i, :, :, 0]).max()))
                n_files += 1
    log(f'maps vs plain forward on the card: {n_files} maps, '
        f'max|diff| {worst:.3e}')
    if n_files != n_slices or not worst <= MAP_TOL:
        raise AssertionError(f'maps disagree with the plain forward: '
                             f'{worst} (tol {MAP_TOL}), {n_files} maps')


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
def _plain_warp():
    '''Within the block, the augmentation's resample runs its plain
    version instead of the kernel.'''
    from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
    kernel = WT.warp_twopass
    WT.warp_twopass = WT.plain
    try:
        yield
    finally:
        WT.warp_twopass = kernel


def _step_grads(eng, ds, raw, draws, plain):
    '''Loss and parameter gradients of one train step on ``raw`` with the
    given augmentation draws, through the kernels or their plain
    versions.'''
    from dnncancerannotator_torch.data import augment

    bank = eng._warp_bank(ds)
    with _plain_warp() if plain else contextlib.nullcontext():
        images = augment.apply_chain(ds.augment_methods, raw.float() / 255.0,
                                     draws, bank)
    x, y = augment.to_feature_label(images, ds.slice_types)
    eng.model.zero_grad(set_to_none=True)
    logits = plain_logits(eng.model, x) if plain else eng.model(
        x, return_logits=True)
    loss = eng.loss(y, logits)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                         for n, p in eng.model.named_parameters()}


def train_slice(device):
    '''Phase 5; returns the launch counts of the first train CLI call.'''
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
    draws = augment.draw_chain(ds.augment_methods, TRAIN_BATCH, gen,
                               eng._warp_bank(ds))
    loss, grads = _step_grads(eng, ds, raw, draws, plain=False)
    plain_loss, plain_grads = _step_grads(eng, ds, raw, draws, plain=True)
    log(f'one train step: loss {loss:.7f} kernels, {plain_loss:.7f} plain')
    if not abs(loss - plain_loss) <= LOSS_TOL * abs(plain_loss):
        raise AssertionError(f'train-step loss {loss} vs plain {plain_loss}')
    worst = 0.0
    for name, want in plain_grads.items():
        err = float((grads[name] - want).abs().max())
        scale = float(want.abs().max())
        worst = max(worst, err / scale)
        if not err <= STEP_TOL * scale:
            raise AssertionError(f'{name}: gradient {err} > {STEP_TOL} * '
                                 f'{scale} from the plain train step')
    log(f'one train step: {len(grads)} parameter gradients within '
        f'{worst:.3e} * max|ref| of the plain step')

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
    return launches


def main():
    smi = environment()
    from dnncancerannotator_torch import engine
    device = engine.resolve_device('cuda')
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
        kernel_sites(eng.model, device, results)
        backward_sites(eng.model, device, results)
        predict_launches = run_slice(eng, data_paths, save_path,
                                     os.path.join(WORK, 'maps'))
        launches = train_slice(device)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    csrc = 'dnncancerannotator_torch/csrc/'
    kernels_line = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': f'{csrc}{name}.cu',
         'replaces': ', '.join(PALLAS + r for r in REPLACES[name]),
         'launches': launches[name],
         'predict_launches': predict_launches[name],
         'max_abs_err': acc['max_abs_err'], 'ms': acc['ms'],
         'plain_ms': acc['plain_ms'], 'sites': acc['sites']}
        for name, acc in results.items()]}
    log(json.dumps(kernels_line))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
