'''Readings for phase 12's one-step check of unet_big in bf16, on one GPU:

    python3 tools/check_torch_bf16_step.py [--seeds 0 1 2] [--out FILE]

Phase 12 holds one seeded unet_big train step in bf16
(chip_smoke.BF16_BIG_CONFIGS: unet_big.yaml as shipped, B=8 256 x 256
crops of chip_smoke.py's phase-5 exams; cuDNN deterministic) to the f64
step of the same weights, batch and draws (chip_smoke.check_bf16_step).
For each seed and for bf16.yaml and its two policies this prints the
check's readings (chip_smoke.f64_step_shares: the loss's, the worst
gradient's and the worst statistic's distance from the f64 step as a share
of its scale; chip_smoke.grad_rms_share: all gradients' root-mean-square
distance as a share of theirs) for:

- ``bf16``: the sound step;
- ``f32``: the f32 step of the same weights (and its distance from the
  bf16 step, which the check's "bf16 is on" guard reads);
- ``control``: the bf16 step with models/fastbn.py's ``wide`` the
  identity (BatchNorm statistics, its backward's sums and the logits left
  in bf16), a step that must fail the check;
- ``stale statistic``: the sound step with one running mean (STALE) left
  at its value before the step.

``--out`` writes the readings as JSON. It imports nothing of JAX and
builds the kernels with nvcc.
'''

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

STALE = 'unet.encoder.down_1.pool_bn.mean'


def readings(got, exact):
    loss, worst = chip_smoke.f64_step_shares(got, exact)
    return dict(loss=loss, grad=worst['grad'], stat=worst['stat'],
                grad_rms=chip_smoke.grad_rms_share(got, exact))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
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
    chip_smoke.WORK = os.path.join(HERE, 'build', 'check_torch_bf16_step')
    data_paths = chip_smoke.write_records(
        os.path.join(chip_smoke.WORK, 'train_data'), chip_smoke.EXAM_SIZE,
        chip_smoke.TRAIN_EXAMS, chip_smoke.TRAIN_SLICES)
    from dnncancerannotator_torch.ops.kernels import _build
    _build.library()
    out = []
    for overlay in (None,) + chip_smoke.BF16_POLICIES:
        configs = chip_smoke.BF16_BIG_CONFIGS + ((overlay,) if overlay
                                                 else ())
        config = chip_smoke._config(configs)
        ds = pipeline.train_ds(data_paths, **config['data_options']['train'])
        name = os.path.basename(overlay or chip_smoke.BF16)[:-5]
        for seed in args.seeds:
            got, f32, exact, ctl, eng, _ = chip_smoke.bf16_step(
                config, ds, device, seed, control=True)
            before = dict(eng.model.named_buffers())[STALE]
            stale = (got[0], got[1], {**got[2], STALE: before})
            row = dict(config=name, seed=seed, f32_from_bf16=readings(
                got, f32))
            for label, step in (('bf16', got), ('f32', f32),
                                ('control', ctl), ('stale statistic', stale)):
                row[label] = readings(step, exact)
                r = row[label]
                print(f'{name} seed {seed} {label:16s} loss {r["loss"]:.3e}  '
                      f'grad worst {r["grad"][0]:.3e} ({r["grad"][1]})  '
                      f'grad rms {r["grad_rms"]:.3e}  stat worst '
                      f'{r["stat"][0]:.3e} ({r["stat"][1]})', flush=True)
            r = row['f32_from_bf16']
            print(f'{name} seed {seed} bf16 from f32: grad worst '
                  f'{r["grad"][0]:.3e}, grad rms {r["grad_rms"]:.3e}',
                  flush=True)
            out.append(row)
            del eng
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(dict(card=card, stale=STALE, rows=out), fh, indent=1)


if __name__ == '__main__':
    main()
