'''Where the time of the port's ``evaluate`` goes, on one GPU:

    python3 tools/profile_torch_eval.py [--repo DIR]

Writes chip_smoke's seeded synthetic exams (160 slices of 256 x 256) and a
seeded checkpoint, runs the ``evaluate`` CLI once to warm up (the kernel
build, allocator and caches), then with the metrics.yaml suite and every
export (``--export_csv --export_images --export_casewise_metrics``) three
times on the host clock (the seconds of each), and again:

- under cProfile, printing the functions with the most cumulative and own
  host time;
- under torch.profiler, printing the device time by kernel and the device's
  busy share of the traced wall time.

``--repo`` imports the port from another checkout (a parent commit
unpacked with ``git archive``) and runs it on the same data and weights, so
two versions can be compared on one card. It imports nothing of JAX and
needs the port's kernels to build (nvcc).
'''

import argparse
import cProfile
import os
import pstats
import shutil
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the seeded synthetic exams and checkpoint)

WORK = os.path.join(REPO, 'build', 'profile_torch_eval')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--repo', default=REPO)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.runs.__main__ import main as cli

    device = engine.resolve_device('cuda')
    print(chip_smoke.environment(), f'port from {os.path.abspath(args.repo)}')
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        paths = chip_smoke.write_records(os.path.join(WORK, 'data'))
        save = os.path.join(WORK, 'run')
        chip_smoke.write_save_path(save, paths, device)

        def evaluate(tag):
            torch.cuda.synchronize()
            start = time.perf_counter()
            cli(argv=['evaluate', '--save_path', save, '--data_path', *paths,
                      '--tag', tag, '--config',
                      os.path.join(REPO, chip_smoke.METRICS_CONFIG),
                      '--export_csv', '--export_images',
                      '--export_casewise_metrics', '--device', 'cuda'])
            torch.cuda.synchronize()
            return time.perf_counter() - start

        print(f'warm-up evaluate: {evaluate("warmup"):.3f} s')
        print('evaluate (one checkpoint, 160 slices): '
              + ', '.join(f'{evaluate(f"timed{i}"):.3f}' for i in range(3))
              + ' s')
        profiler = cProfile.Profile()
        profiler.enable()
        seconds = evaluate('cprofile')
        profiler.disable()
        print(f'evaluate under cProfile: {seconds:.3f} s (one checkpoint, '
              '160 slices)')
        stats = pstats.Stats(profiler)
        stats.sort_stats('cumulative').print_stats(30)
        stats.sort_stats('tottime').print_stats(20)

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            seconds = evaluate('traced')
        events = prof.key_averages()
        # device work only, as in tools/profile_torch_train.py
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not getattr(e, 'is_user_annotation', False))
        print(events.table(sort_by='self_device_time_total', row_limit=20,
                           max_name_column_width=60))
        print(f'traced evaluate: {seconds:.3f} s wall, device busy '
              f'{device_us / 1e6:.4f} s ({100 * device_us / 1e6 / seconds:.2f}'
              '% of the wall time)')
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == '__main__':
    main()
