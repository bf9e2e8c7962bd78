'''Time every launch geometry of the conv chain kernels at the unet.yaml sites:

    python3 tools/sweep_torch_chain.py [--calls C ...] [--out FILE] [--top N]

For each ConvChain site of configs/unet.yaml (profile_torch_chain.SITES) it
takes every geometry that the kernels take and that fits shared memory
(channel group, tile and block size; ops/kernels/conv_chain.py: geometry,
conv_chain_bwd.py: geometry), for the forward at B=64 and B=32 (prediction
and evaluation: 160 slices make batches of 64, 64 and 32) and at B=8 with c1
(training) and for the backward at B=8 (the kernel that the wrapper's rule
picks, fused or not), launches the kernel with that geometry on one GPU and
takes its device time with chip_smoke.py's yardstick (torch.profiler over
10 calls, the larger of two windows). It prints, per site and call, the
rule's geometry and the wrapper's plan (TUNED's where it has one) with their
rank and time, the fastest N, checks each geometry's result against the
wrapper's, and prints the geometries by which the rule loses more than 3%,
as the wrappers' TUNED tables take them. It imports nothing of JAX and
builds the kernels with nvcc.
'''

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, 'tools'))

import chip_smoke  # noqa: E402
from profile_torch_chain import K, SITES, TRAIN_BATCH  # noqa: E402

CALLS = {'fwd_b64': 64, 'fwd_b32': 32, 'fwd_b8_c1': TRAIN_BATCH,
         'bwd_b8': TRAIN_BATCH}
MARGIN = 0.03   # TUNED takes a geometry that beats the rule by more


def device_ms(fn):
    return max(chip_smoke._device_ms(fn), chip_smoke._device_ms(fn))


def forward_geometries(CC, b, ci, cm, co, h, w, k):
    '''Every forward Plan the kernel takes that fits: the widest tile of
    each height, channel group and block size.'''
    for cpt in CC.cpt_choices(cm, co):
        for tile_h in CC.TILE_HS:
            for threads in CC.THREADS:
                for tile_w in CC.TILE_WS:
                    if not CC.tile_fits(tile_h, tile_w, h, w):
                        continue
                    pl = CC.geometry(b, ci, cm, co, h, w, k, cpt, tile_h,
                                     tile_w, threads)
                    if pl.smem <= CC._build.MAX_SMEM_BYTES:
                        yield pl
                        break


def backward_geometries(CCB, b, ci, cm, co, h, w, k, need_dx):
    '''As ``forward_geometries``, for the rule's backward kernel.'''
    CC = CCB.fwd
    fused = CCB.rule(b, ci, cm, co, h, w, k, need_dx).fused
    for cpt in CC.cpt_choices(cm, co):
        if cpt not in (CCB.FUSED_CPT if fused else CCB.DGRAD_CPT):
            continue
        for tile_h in CC.TILE_HS:
            for tile_w in CC.TILE_WS:
                if not CC.tile_fits(tile_h, tile_w, h, w):
                    continue
                pl = CCB.geometry(b, ci, cm, co, h, w, k, need_dx, fused,
                                  cpt, tile_h, tile_w, CCB.THREADS)
                if pl.smem <= CC._build.MAX_SMEM_BYTES:
                    yield pl
                    break


def sweep(module, call, geometries, check):
    '''[(device ms, Plan)] of every geometry, fastest first, the call's
    result under each held to the wrapper's own by ``check``.'''
    pick = module.plan
    out = []
    try:
        for pl in geometries:
            module.plan = lambda *args, pl=pl: pl
            check(call())
            out.append((device_ms(call), pl))
    finally:
        module.plan = pick
    return sorted(out, key=lambda r: r[0])


def _close(tol):
    def check(got, want):
        for g, w in zip(got, want):
            if w is not None:
                err = float((g - w).abs().max())
                assert err <= tol * float(w.abs().max()), err
    return check


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--calls', nargs='+', choices=sorted(CALLS),
                        default=list(CALLS))
    parser.add_argument('--out', default=None)
    parser.add_argument('--top', type=int, default=5)
    args = parser.parse_args()
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB

    device = engine.resolve_device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    report, tuned = [], []
    for site, ci, cm, co, hw in SITES:
        w1 = torch.randn((cm, ci, K, K), generator=gen, device=device) * 0.3
        w2 = torch.randn((co, cm, K, K), generator=gen, device=device) * 0.3
        b1 = torch.randn((cm,), generator=gen, device=device) * 0.1
        b2 = torch.randn((co,), generator=gen, device=device) * 0.1
        for label in args.calls:
            b = CALLS[label]
            x = torch.rand((b, ci, hw, hw), generator=gen, device=device)
            if label.startswith('fwd'):
                need_c1 = label.endswith('c1')
                key = (b, ci, cm, co, hw, hw, K)

                def call(x=x, need_c1=need_c1):
                    return CC.conv_chain(x, w1, b1, w2, b2, need_c1=need_c1)
                module, geometries = CC, forward_geometries(CC, *key)
                check = _close(1e-5)
            else:
                c1, c2 = CC.plain(x, w1, b1, w2, b2)
                g = torch.randn(c2.shape, generator=gen, device=device)
                key = (b, ci, cm, co, hw, hw, K, site != 'down_0')

                def call(x=x, c1=c1, c2=c2, g=g, need_dx=key[-1]):
                    return CCB.conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx)
                module = CCB
                geometries = backward_geometries(CCB, *key)
                check = _close(2e-5)
            rows = sweep(module, call, geometries,
                         lambda got, want=call(): check(got, want))

            def rank(pl):
                return next((i, ms) for i, (ms, p) in enumerate(rows)
                            if p == pl)
            best_ms = rows[0][0]
            for name, pl in (('rule', module.rule(*key)),
                             ('plan', module.plan(*key))):
                i, ms = rank(pl)
                print(f'{site:6s} {label:9s} {len(rows)} geometries; {name} '
                      f'{ms:.4f} ms (rank {i + 1}, +{ms / best_ms - 1:.1%}) '
                      f'{tuple(pl)}', flush=True)
            for ms, pl in rows[:args.top]:
                print(f'    {ms:.4f} ms  {tuple(pl)}', flush=True)
            if rank(module.rule(*key))[1] > (1 + MARGIN) * best_ms:
                best = rows[0][1]
                tuned.append((module.__name__.split('.')[-1], key, (
                    best.cpt, best.tile_h, best.tile_w, best.threads)))
            report.append(dict(site=site, call=label, rows=[
                dict(ms=ms, plan=pl._asdict()) for ms, pl in rows]))
    for label in args.calls:
        best = sum(r['rows'][0]['ms'] for r in report if r['call'] == label)
        print(f'sum of six sites {label:9s} fastest geometries {best:.4f} ms',
              flush=True)
    print(f'geometries that beat the rule by more than {MARGIN:.0%} '
          '(TUNED entries):')
    for module, key, geometry in tuned:
        print(f'    {module}: {key}: {geometry},', flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(dict(card=card, sites=report), fh)


if __name__ == '__main__':
    main()
