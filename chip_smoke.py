'''Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: compile the CUDA kernels from dnncancerannotator_torch/csrc;
3. kernels: at every site of the unet.yaml prediction path (B=64, 256 x 256)
   each kernel against its plain PyTorch version on the same inputs, TF32
   off, to max|diff| <= 1e-4 * max|ref|, and the median of 20 CUDA-event
   timings of each, taken in turns;
4. the slice: seeded synthetic .tfrecords and a seeded checkpoint, then the
   port's ``predict`` CLI at batch 64 on the card. Checks the file count,
   that every map is finite and in [0, 1], that every kernel launched at
   least (sites x batches) times during the run, and that the maps equal a
   plain-PyTorch forward of the same weights on the card (<= 1e-5).

The last two lines of stdout are a JSON object of per-kernel results and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before printing either.
'''

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


@torch.no_grad()
def kernel_sites(model, device):
    '''Each kernel against its plain version at every main-path site.'''
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
    from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC

    gen = torch.Generator(device=device).manual_seed(SEED)
    modules = dict(model.named_modules())
    results = {}

    def record(entry, err, ms, plain_ms):
        acc = results.setdefault(entry, dict(max_abs_err=0.0, ms=0.0,
                                             plain_ms=0.0, sites=0))
        acc['max_abs_err'] = max(acc['max_abs_err'], err)
        acc['ms'] += ms
        acc['plain_ms'] += plain_ms
        acc['sites'] += 1

    log(f'kernels (B={BATCH}, {SIZE}x{SIZE} input):')
    for path, replaces in CHAIN_SITES:
        chain = modules[path + '.convchain']
        w1, b1 = chain.conv_0.weight, chain.conv_0.bias
        w2, b2 = chain.conv_1.weight, chain.conv_1.bias
        level = int(path[-1])
        hw = SIZE >> level if 'encoder' in path else SIZE >> (2 - level)
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
        record(('conv_chain', replaces), err, ms, plain_ms)
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
        record(('tconv2x2', 'flattconv.py:200'), err, ms, plain_ms)
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
    record(('stencil_conv', 'conv_kernel.py:84'), err, ms, plain_ms)
    return results


# -- phase 4 -----------------------------------------------------------------
def write_records(data_dir):
    '''Seeded synthetic exams (uint8 [S, H, W, 6], circle lesions) in two
    .tfrecords files, written with the port's codec.'''
    from dnncancerannotator_torch.data import tfrecord as tfr
    from dnncancerannotator_torch.data.records import DEFAULT_SLICE_TYPES

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    paths = []
    for category, n_exams in zip(('cancer', 'healthy'), N_EXAMS):
        path = os.path.join(data_dir, f'{category}.tfrecords')
        with open(path, 'wb') as f:
            for pid in range(1, n_exams + 1):
                slices = rng.integers(
                    0, 255, (SLICES_PER_EXAM, SIZE, SIZE, 6), np.uint8)
                slices[..., 5] = 0
                if category == 'cancer':
                    for s in range(SLICES_PER_EXAM):
                        cy, cx = rng.integers(SIZE // 5, SIZE - SIZE // 5, 2)
                        r = rng.integers(SIZE // 32, SIZE // 8)
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


def plain_forward(model, x):
    '''The UNetAnnotator forward written out with the kernels' plain
    PyTorch versions: the reference for the maps. x: NHWC features.'''
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
    return torch.sigmoid(logits.permute(0, 2, 3, 1))


def run_slice(eng, data_paths, save_path, out_dir):
    '''The predict CLI, then its maps against the plain forward of the
    same loaded weights (``eng``).'''
    from dnncancerannotator_torch.data import pipeline
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

    # the maps: files, range, and the plain-PyTorch reference on the card
    device = eng.device
    ds = pipeline.predict_ds(data_paths, output_size=(SIZE, SIZE),
                             batch_size=BATCH)
    worst, n_files = 0.0, 0
    with torch.no_grad():
        for batch in ds.batches():
            x = torch.from_numpy(batch['slices']).to(device).float() / 255.0
            ref = plain_forward(eng.model, x[..., :5]).cpu().numpy()
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

    # whole-model forward at B=64: kernels vs plain versions, in turns
    x = torch.rand((BATCH, SIZE, SIZE, 5), device=device)
    with torch.no_grad():
        ms, plain_ms = _time_pair(lambda: eng.model(x),
                                  lambda: plain_forward(eng.model, x))
    log(f'model forward B={BATCH}: kernels {ms:.4f} ms  plain {plain_ms:.4f} '
        f'ms  ({BATCH * 1000 / ms:.1f} vs {BATCH * 1000 / plain_ms:.1f} '
        'slices/s device-side)')
    return launches


def main():
    smi = environment()
    from dnncancerannotator_torch import engine
    device = engine.resolve_device('cuda')
    build()

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        data_paths = write_records(os.path.join(WORK, 'data'))
        save_path = os.path.join(WORK, 'run')
        config = write_save_path(save_path, data_paths, device)
        eng = engine.Engine(config, seed=SEED, device=device)
        eng.build((BATCH, SIZE, SIZE, 5))
        eng.load(os.path.join(save_path, 'checkpoints', 'ckpt-1'))
        results = kernel_sites(eng.model, device)
        launches = run_slice(eng, data_paths, save_path,
                             os.path.join(WORK, 'maps'))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    csrc = 'dnncancerannotator_torch/csrc/'
    kernels_line = {'kernels': [
        {'name': name, 'route': 'cuda', 'source': f'{csrc}{name}.cu',
         'replaces': PALLAS + replaces, 'launches': launches[name],
         'max_abs_err': acc['max_abs_err'], 'ms': acc['ms'],
         'plain_ms': acc['plain_ms'], 'sites': acc['sites']}
        for (name, replaces), acc in results.items()]}
    log(json.dumps(kernels_line))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
