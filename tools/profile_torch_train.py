'''Where the time of the port's train step goes, on one GPU:

    python3 tools/profile_torch_train.py

Trains the unet.yaml stack (B=8 256 x 256 crops of seeded synthetic
512 x 512 exams, banked warp, weighted BCE, Adam) through the engine, then:

- times each stage of the step (augmentation, forward and loss, backward,
  optimizer) with CUDA events around it, median of 20 steps;
- traces 25 steps with torch.profiler and prints the device time by kernel
  and the device's busy share of the traced wall time.

It imports nothing of JAX and needs the port's kernels to build (nvcc).
'''

import os
import shutil
import statistics
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the seeded synthetic exams)

WORK = os.path.join(REPO, 'build', 'profile_torch_train')
STEPS = 25


def main():
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import augment, pipeline
    from dnncancerannotator_torch.utils import config as config_lib

    device = engine.resolve_device('cuda')
    print(chip_smoke.environment())
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        paths = chip_smoke.write_records(WORK, chip_smoke.EXAM_SIZE,
                                         chip_smoke.TRAIN_EXAMS,
                                         chip_smoke.TRAIN_SLICES)
        config = config_lib.load_config(
            [os.path.join(REPO, c) for c in chip_smoke.CONFIGS])
        ds = pipeline.train_ds(paths, **config['data_options']['train'])
        eng = engine.Engine(config, device=device)
        eng.train(ds, max_steps=30, save_freq=1 << 30)   # warm-up
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    resident = eng._resident(ds)
    gen = torch.Generator(device=device).manual_seed(0)

    stages = {k: [] for k in ('sample', 'augment', 'forward+loss',
                              'backward', 'optimizer', 'step')}
    for step in range(20):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        raw = eng.sample_batch(resident, ds.batch_size, gen)
        ev[1].record()
        images = eng._augment(raw.float() / 255.0, gen)
        x, y = augment.to_feature_label(images, ds.slice_types)
        ev[2].record()
        eng.optimizer.zero_grad(set_to_none=True)
        loss = eng.loss(y, eng.model(x, return_logits=True))
        ev[3].record()
        loss.backward()
        ev[4].record()
        eng.optimizer.step()
        ev[5].record()
        ev[5].synchronize()
        for name, (a, b) in zip(stages, zip(ev, ev[1:])):
            stages[name].append(a.elapsed_time(b))
        stages['step'].append(ev[0].elapsed_time(ev[5]))
    print('stage medians (ms, CUDA events, B=8):')
    for name, times in stages.items():
        print(f'  {name:14s} {statistics.median(times):.4f}')

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for step in range(STEPS):
            eng.train_step(eng.sample_batch(resident, ds.batch_size, gen),
                           step, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = prof.key_averages()
    # device work only: the autograd and optimizer ranges the profiler
    # also shows on the device (user annotations) span kernels counted here
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, 'is_user_annotation', False))
    print(f'{STEPS} traced steps: wall {wall * 1e3:.3f} ms, device busy '
          f'{device_us / 1e3:.3f} ms ({100 * device_us / 1e6 / wall:.1f}%), '
          f'{wall * 1e3 / STEPS:.4f} ms a step')
    print(events.table(sort_by='self_device_time_total', row_limit=45,
                       max_name_column_width=60))


if __name__ == '__main__':
    main()
