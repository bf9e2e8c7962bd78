'''Phase 7's one-step check of unet_big over many seeds, on one GPU:

    python3 tools/check_torch_big_step.py [--seeds 16] [--trained 20]
                                          [--decisions] [--out FILE]

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

``--decisions`` also records, in the kernel step, the plain step and the
f64 step, every relu decision (the sign of each relu conv's output) and
every 2x2 max-pool decision (the argmax of each window of each pool's
input) of the forward, and prints for each seed how many of them the
kernel step and the plain step take otherwise than the f64 step, by
layer; then it takes the f64 step twice more, each time with the relu
decisions of the kernel step or of the plain step forced on it, and holds
each step to the f64 step of its own decisions: an entry past F64_RATIO
there is not explained by flipped decisions.
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


def _argmax2x2(x):
    '''Argmax (0-3, the first at a tie) of each 2x2 window of NHWC x.'''
    b, h, w, c = x.shape
    win = x[:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, c)
    return win.permute(0, 1, 3, 5, 2, 4).reshape(
        b, h // 2, w // 2, c, 4).argmax(-1).to(torch.uint8)


@contextlib.contextmanager
def recording(model, store):
    '''Within the block a forward of ``model`` records its relu and pool
    decisions into ``store`` ({layer: tensor}).'''
    from dnncancerannotator_torch.models import blocks, fastconv
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, fastconv.Conv2DFast) and mod.relu:
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, name=name: store.__setitem__(
                    'relu ' + name, out > 0)))
        elif isinstance(mod, blocks.Downsample):
            hooks.append(mod.convchain.register_forward_hook(
                lambda m, a, out, name=name: store.__setitem__(
                    'pool ' + name, _argmax2x2(out))))
    try:
        yield store
    finally:
        for hook in hooks:
            hook.remove()


@contextlib.contextmanager
def forcing(model, masks):
    '''Within the block every relu conv of ``model`` takes the relu
    decisions recorded in ``masks`` (``recording``): its output is its
    pre-activation times the recorded mask.'''
    from dnncancerannotator_torch.models import fastconv
    hooks, convs = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, fastconv.Conv2DFast) and mod.relu:
            mod.relu = False
            convs.append(mod)
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, mask=masks['relu ' + name]:
                out * mask.to(out.dtype)))
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()
        for mod in convs:
            mod.relu = True


def flips(got, exact):
    '''{layer: decisions taken otherwise than in ``exact``}, nonzero ones.'''
    out = {}
    for name, want in exact.items():
        n = int((got[name] != want).sum())
        if n:
            out[name] = n
    return out


def check_seed(eng, ds, raw, draws, decisions=False):
    '''({way: {entry: dict}}, {way: digest}) of one state: each kernel
    way's entry errors (chip_smoke._step_errors), every entry's error from
    f64, and the digest of the way's step (chip_smoke.step_digest). With
    ``decisions`` also {way: {layer: flips}} of the kernel and plain steps
    against the f64 step's decisions, and {entry: (kernel step's error,
    plain step's error)} each from the f64 step that takes that step's own
    relu decisions (``forcing``): what is left once no decision differs.'''
    big_step = chip_smoke._big_step
    seen = {}
    with chip_smoke._deterministic_cudnn():
        with recording(eng.model, seen.setdefault('plain', {})) \
                if decisions else contextlib.nullcontext():
            plain = big_step(eng, ds, raw, draws, plain=True)
        with recording(eng.model, seen.setdefault('f64', {})) \
                if decisions else contextlib.nullcontext():
            exact = big_step(eng, ds, raw, draws, plain=True, f64=True)
        plain64 = _errors64(plain, exact)
        out, digests = {}, {'plain': chip_smoke.step_digest(plain)}
        for way, ctx in _ways().items():
            with ctx(), (recording(eng.model, seen.setdefault(way, {}))
                         if decisions and way == 'kernels'
                         else contextlib.nullcontext()):
                got = big_step(eng, ds, raw, draws, plain=False)
            digests[way] = chip_smoke.step_digest(got)
            if way == 'kernels':
                kernel_step = got
            entries = chip_smoke._step_errors(got, plain, lambda: exact)
            errs64 = _errors64(got, exact)
            for name, e in entries.items():
                if name == 'loss':
                    continue
                e['all_err64'], e['all_plain64'] = errs64[name], plain64[name]
            out[way] = entries
        if decisions:
            same = {}
            for way, step in (('kernels', kernel_step), ('plain', plain)):
                with forcing(eng.model, seen[way]):
                    same[way] = _errors64(step, big_step(
                        eng, ds, raw, draws, plain=True, f64=True))
            forced = {n: (same['kernels'][n], same['plain'][n])
                      for n in same['plain']}
    if decisions:
        return out, digests, {way: flips(seen[way], seen['f64'])
                              for way in ('kernels', 'plain')}, forced
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
    parser.add_argument('--decisions', action='store_true',
                        help='count the relu and pool decisions each step '
                             'takes otherwise than the f64 step')
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
            result, digests, *flipped = check_seed(eng, ds, raw, draws,
                                                   args.decisions)
            print(f'{label} seed {seed:2d} digests {digests}', flush=True)
            for way, layers in (flipped[0].items() if flipped else ()):
                print(f'{label} seed {seed:2d} {way:7s} decisions other than '
                      f'f64: {sum(layers.values())} {layers}', flush=True)
            if flipped:
                ratios = {n: k / p if p else float('inf') if k else 1.0
                          for n, (k, p) in flipped[1].items()}
                worst = max(ratios, key=ratios.get)
                print(f'{label} seed {seed:2d} with the f64 step taking each '
                      f'step\'s own relu decisions: worst entry {worst} '
                      f'kernels {flipped[1][worst][0]:.3e} plain '
                      f'{flipped[1][worst][1]:.3e} ratio {ratios[worst]:.2f}; '
                      f'{sum(r > chip_smoke.F64_RATIO for r in ratios.values())}'
                      f' entries past F64_RATIO', flush=True)
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
                                    digest=digests[way],
                                    flips=flipped[0] if flipped else None,
                                    forced=flipped[1] if flipped else None))
                if flipped:
                    for name in fails:
                        k, p = flipped[1][name]
                        print(f'    {name:44s} with its own decisions in the '
                              f'f64 step: {way} {k:.3e}  plain {p:.3e}  '
                              f'ratio {k / p if p else float("inf"):.2f}',
                              flush=True)
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
