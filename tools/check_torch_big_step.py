'''Phase 7's one-step check of unet_big over many seeds, on one GPU:

    python3 tools/check_torch_big_step.py [--seeds 16] [--trained 20]
                                          [--out FILE]

For each seed a unet_big engine (chip_smoke.BIG_CONFIGS: f32, BatchNorm,
NHWC, the pool and tconv gates on; B=8, 256 x 256 crops of chip_smoke.py's
phase-5 exams) takes one train step on a batch and draws of its own
(chip_smoke.big_check_state) in five ways, with cuDNN deterministic:

- ``kernels``: every kernel of the path (phase 7's check);
- ``tconv``: the NHWC tconv kernels only (the pools plain);
- ``pool``: the NHWC pool kernels only (the tconvs plain);
- ``plain``: every plain version;
- ``f64``: the plain step with the model and loss in f64.

Two populations: the seed's initial weights (what phase 7 checks), and
``--trained`` steps after them through the kernels (cuDNN as the train CLI
runs it), as phase 7 checked before. For every entry (each parameter
gradient and BatchNorm statistic) of each kernel way it prints where
phase 7's rule (chip_smoke._compare_step) holds it to the f64 step (past
STEP_TOL / STATS_TOL of the plain step): its error from f64 beside the
plain step's and their ratio, against F64_RATIO. Then, over the seeds, the
entries whose ratio of errors from f64 (kernel way / plain) is largest by
its median, and how many seeds failed the rule. ``--out`` writes every
entry's numbers as JSON. It imports nothing of JAX and builds the kernels
with nvcc.
'''

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

WAYS = ('kernels', 'tconv', 'pool')


def _ways():
    '''{way: context manager factory} of the kernel ways.'''
    pn, pnb, tn, tnb = chip_smoke._nhwc_modules()
    return {'kernels': contextlib.nullcontext,
            'tconv': lambda: chip_smoke._plain_versions(pn, pnb),
            'pool': lambda: chip_smoke._plain_versions(tn, tnb)}


def _errors64(step, exact):
    '''{entry: max|diff| from the f64 step} of a step's gradients and
    statistics.'''
    out = {}
    for i in (1, 2):
        for name, t in step[i].items():
            out[name] = float((t.double() - exact[i][name]).abs().max())
    return out


def check_seed(eng, ds, raw, draws):
    '''({way: {entry: dict}}, {way: digest}) of one state: each kernel
    way's entry errors (chip_smoke._step_errors), every entry's error from
    f64, and the digest of the way's step (chip_smoke.step_digest).'''
    big_step = chip_smoke._big_step
    with chip_smoke._deterministic_cudnn():
        plain = big_step(eng, ds, raw, draws, plain=True)
        exact = big_step(eng, ds, raw, draws, plain=True, f64=True)
        plain64 = _errors64(plain, exact)
        out, digests = {}, {'plain': chip_smoke.step_digest(plain)}
        for way, ctx in _ways().items():
            with ctx():
                got = big_step(eng, ds, raw, draws, plain=False)
            digests[way] = chip_smoke.step_digest(got)
            entries = chip_smoke._step_errors(got, plain, lambda: exact)
            errs64 = _errors64(got, exact)
            for name, e in entries.items():
                if name == 'loss':
                    continue
                e['all_err64'], e['all_plain64'] = errs64[name], plain64[name]
            out[way] = entries
    return out, digests


def _train(eng, ds, steps, seed):
    '''``steps`` optimizer steps through the kernels on seeded batches.'''
    resident = eng._resident(ds)
    gen = torch.Generator(device=eng.device).manual_seed(seed + 1000)
    for step in range(steps):
        raw = eng.sample_batch(resident, chip_smoke.TRAIN_BATCH, gen)
        eng.train_step(raw, step, gen)
    eng.current_step = steps


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seeds', type=int, default=16)
    parser.add_argument('--trained', type=int, default=20,
                        help='steps before the check in the second '
                             'population (0: none)')
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
    chip_smoke.WORK = os.path.join(HERE, 'build', 'check_torch_big_step')
    data_paths = chip_smoke.write_records(
        os.path.join(chip_smoke.WORK, 'train_data'), chip_smoke.EXAM_SIZE,
        chip_smoke.TRAIN_EXAMS, chip_smoke.TRAIN_SLICES)
    config = chip_smoke._big_config()
    ds = pipeline.train_ds(data_paths, **config['data_options']['train'])

    populations = [('initial', 0)] + ([('trained', args.trained)]
                                      if args.trained else [])
    records = []
    for label, steps in populations:
        for seed in range(args.seeds):
            eng, raw, draws = chip_smoke.big_check_state(config, ds, seed,
                                                         device)
            if steps:
                _train(eng, ds, steps, seed)
            result, digests = check_seed(eng, ds, raw, draws)
            print(f'{label} seed {seed:2d} digests {digests}', flush=True)
            for way, entries in result.items():
                held = {n: e for n, e in entries.items() if 'err64' in e}
                fails = [n for n, e in held.items()
                         if not e['err64'] <= chip_smoke.F64_RATIO *
                         e['plain64']]
                print(f'{label} seed {seed:2d} {way:7s}: loss diff '
                      f'{entries["loss"]["err"]:.2e}; {len(held)} entries '
                      f'held to f64, {len(fails)} past F64_RATIO', flush=True)
                for name, e in held.items():
                    ratio = e['err64'] / e['plain64'] if e['plain64'] else \
                        float('inf')
                    print(f'    {name:44s} vs plain {e["err"]:.3e} (tol '
                          f'{e["tol"]:.0e} x {e["scale"]:.3e}); from f64: '
                          f'{way} {e["err64"]:.3e}  plain '
                          f'{e["plain64"]:.3e}  ratio {ratio:.2f}'
                          + ('  FAIL' if name in fails else ''), flush=True)
                records.append(dict(population=label, seed=seed, way=way,
                                    entries=entries, fails=fails,
                                    digest=digests[way]))
            del eng
            torch.cuda.empty_cache()

    # over the seeds: each entry's ratio of errors from f64, way / plain
    for label, _ in populations:
        for way in WAYS:
            rows = [r for r in records
                    if r['population'] == label and r['way'] == way]
            ratios = {}
            for r in rows:
                for name, e in r['entries'].items():
                    if name != 'loss' and e['all_plain64'] > 0:
                        ratios.setdefault(name, []).append(
                            e['all_err64'] / e['all_plain64'])
            ranked = sorted(ratios.items(),
                            key=lambda kv: -statistics.median(kv[1]))
            failed = sum(bool(r['fails']) for r in rows)
            print(f'{label} {way}: {failed} of {len(rows)} seeds past '
                  f'F64_RATIO; entries by the median over the seeds of '
                  f'(error from f64) / (plain step\'s):', flush=True)
            for name, rs in ranked[:12]:
                print(f'    {name:44s} median {statistics.median(rs):6.2f}  '
                      f'max {max(rs):6.2f}  min {min(rs):6.2f}', flush=True)
            allr = [x for rs in ratios.values() for x in rs]
            print(f'    all {len(ratios)} entries: median '
                  f'{statistics.median(allr):.2f}, share above 1 '
                  f'{sum(x > 1 for x in allr) / len(allr):.2f}', flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(dict(card=card, records=records), fh)


if __name__ == '__main__':
    main()
