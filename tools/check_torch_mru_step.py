'''Controls for phase 11's one-step check of MultiResUnet, on one GPU:

    python3 tools/check_torch_mru_step.py [--out FILE]

Phase 11 holds one seeded MultiResUnet train step (chip_smoke.MRU_CONFIGS:
f32, BatchNorm, B=8 256 x 256 crops of chip_smoke.py's phase-5 exams, the
initial weights, batch and draws of chip_smoke.SEED; cuDNN deterministic)
to the f64 step of the same weights, batch and draws
(chip_smoke.check_f64_step). This prints that check's readings
(chip_smoke.f64_step_shares: the loss's, the worst gradient's and the
worst statistic's distance from the f64 step, as a share of its scale)
for the sound step and for two steps that must fail it:

- ``tf32``: the same step with TF32 on for cuDNN's convs and for matmuls
  (a lower-precision step);
- ``stale statistic``: the sound step with the running mean of one
  BatchNorm (STALE) left at its value before the step, as a BatchNorm
  that failed to update it would leave it.

and whether MRU_F64_TOL and MRU_STAT_TOL pass each. ``--out`` writes the
readings as JSON. It imports nothing of JAX and builds the kernels with
nvcc.
'''

import argparse
import contextlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

STALE = 'mres1.shortcut.bn.mean'


@contextlib.contextmanager
def tf32():
    '''TF32 on for cuDNN and matmuls inside the block, put back after.'''
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', default=None)
    args = parser.parse_args()

    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.data import pipeline

    device = engine.resolve_device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    chip_smoke.WORK = os.path.join(HERE, 'build', 'check_torch_mru_step')
    data_paths = chip_smoke.write_records(
        os.path.join(chip_smoke.WORK, 'train_data'), chip_smoke.EXAM_SIZE,
        chip_smoke.TRAIN_EXAMS, chip_smoke.TRAIN_SLICES)
    config = chip_smoke._config(chip_smoke.MRU_CONFIGS)
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
    eng, raw, draws = chip_smoke.big_check_state(config, ds, chip_smoke.SEED,
                                                 device)
    modules = chip_smoke.MRU_SPEC['modules']()
    before = dict(eng.model.named_buffers())[STALE].clone()

    def step(precision=contextlib.nullcontext):
        with chip_smoke._deterministic_cudnn(), precision():
            return chip_smoke._big_step(eng, ds, raw, draws, plain=False,
                                        modules=modules)

    with chip_smoke._deterministic_cudnn():
        exact = chip_smoke._big_step(eng, ds, raw, draws, plain=True,
                                     f64=True, modules=modules)
    sound = step()
    print(f'loss {sound[0]:.7f}, f64 step {exact[0]:.7f}', flush=True)
    stale = (sound[0], sound[1], {**sound[2], STALE: before})
    readings = {}
    for label, got in (('sound', sound), ('tf32', step(tf32)),
                       ('stale statistic', stale)):
        loss, worst = chip_smoke.f64_step_shares(got, exact)
        passes = (max(loss, worst['stat'][0]) <= chip_smoke.MRU_STAT_TOL
                  and worst['grad'][0] <= chip_smoke.MRU_F64_TOL)
        readings[label] = dict(loss=loss, grad=worst['grad'],
                               stat=worst['stat'], passes=passes)
        print(f'{label:16s} loss {loss:.3e}  worst gradient '
              f'{worst["grad"][0]:.3e} ({worst["grad"][1]})  worst statistic '
              f'{worst["stat"][0]:.3e} ({worst["stat"][1]})  '
              f'{"passes" if passes else "fails"} MRU_F64_TOL '
              f'{chip_smoke.MRU_F64_TOL} / MRU_STAT_TOL '
              f'{chip_smoke.MRU_STAT_TOL}', flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(dict(card=card, stale=STALE, readings=readings),
                      fh, indent=1)


if __name__ == '__main__':
    main()
