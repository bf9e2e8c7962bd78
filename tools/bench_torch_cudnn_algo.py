'''cuDNN's algorithm choice on the unet_big train step, on one GPU:

    python3 tools/bench_torch_cudnn_algo.py [--runs 20] [--out FILE]

Times one unet_big train step (B=8 256 x 256 crops of chip_smoke.py's
phase-5 exams, the banked warp, Adam) in f32 (chip_smoke.BIG_CONFIGS:
f32.yaml and pallas_decoder.yaml, the NHWC pool and tconv kernels on) and
in bf16 (chip_smoke.BF16_BIG_CONFIGS: unet_big.yaml as shipped), each with
``torch.backends.cudnn.benchmark`` off (the port's default: cuDNN's
heuristics pick an algorithm) and on (cuDNN times its algorithms at the
first call of each shape and keeps the fastest). TF32 stays off, as the
engine sets it on the card. Each setting's step is the median of ``runs``
CUDA-event timings after a warm-up of five steps (which also holds
benchmark mode's search), taken in turns off, on, on, off, so that the
card's drift falls on both; prints each median and the ratio of the
settings' best. ``--out`` writes them as JSON. The port's default does
not change here. It imports nothing of JAX and builds the kernels with
nvcc.
'''

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402


def step_ms(eng, raw, gen, runs):
    '''Median CUDA-event ms of ``runs`` train steps after five warm-up
    steps.'''
    step = eng.current_step
    for _ in range(5):
        step += 1
        eng.train_step(raw, step, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        step += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.train_step(raw, step, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    eng.current_step = step
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--runs', type=int, default=20)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline
    from dnncancerannotator_torch.ops.kernels import _build

    device = engine.resolve_device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    chip_smoke.WORK = os.path.join(HERE, 'build', 'bench_torch_cudnn_algo')
    data_paths = chip_smoke.write_records(
        os.path.join(chip_smoke.WORK, 'train_data'), chip_smoke.EXAM_SIZE,
        chip_smoke.TRAIN_EXAMS, chip_smoke.TRAIN_SLICES)
    _build.library()
    out = dict(card=card, runs=args.runs, step_ms={})
    for label, configs in (('f32', chip_smoke.BIG_CONFIGS),
                           ('bf16', chip_smoke.BF16_BIG_CONFIGS)):
        config = chip_smoke._config(configs)
        ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
        eng = engine.Engine(config, seed=chip_smoke.SEED, device=device)
        eng._setup_training(ds)
        gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
        raw = eng.sample_batch(eng._resident(ds), chip_smoke.TRAIN_BATCH,
                               gen)
        times = {False: [], True: []}
        for bench in (False, True, True, False):
            torch.backends.cudnn.benchmark = bench
            times[bench].append(step_ms(eng, raw, gen, args.runs))
        torch.backends.cudnn.benchmark = False
        best = {k: min(v) for k, v in times.items()}
        out['step_ms'][label] = {'benchmark_off': times[False],
                                 'benchmark_on': times[True]}
        print(f'unet_big {label} train step B={chip_smoke.TRAIN_BATCH}: '
              f'cudnn.benchmark off {times[False]} ms, on {times[True]} ms '
              f'(median of {args.runs} each, in turns); on / off '
              f'{best[True] / best[False]:.3f}', flush=True)
        del eng
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(out, fh, indent=1)


if __name__ == '__main__':
    main()
