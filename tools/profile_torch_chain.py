'''Device time of the conv chain kernels at the six unet.yaml sites:

    python3 tools/profile_torch_chain.py [--repo DIR] [--out FILE]

For each ConvChain site of configs/unet.yaml (SITES below) it
times, on one GPU, with seeded random inputs and weights:

- the forward as prediction and evaluation call it (B=64 and the last
  batch of 32 of 160 slices, no c1) and as training calls it (B=8,
  ``need_c1=True``);
- the backward as training calls it (B=8; no dx at down_0), split by the
  name of each kernel that it launches.

Each figure is taken with chip_smoke.py's yardstick: the device time from
torch.profiler over 10 calls (the fullest of three windows), by kernel name,
beside the CUDA-event time around one Python call (median of 20, so the
wrapper's host time is inside) and the site's bound (chip_smoke.bound: each
input read once and each output written once). ``--repo`` imports the port
from another checkout (a parent commit unpacked with ``git archive``) and
times it with this checkout's yardstick, so two versions can be timed in one
process on one card; ``--out`` writes the numbers as JSON. It imports
nothing of JAX and builds the kernels with nvcc.
'''

import argparse
import functools
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (before --repo goes on the path)

# (site, Ci, Cm, Co, H = W) of unet.yaml's six ConvChains at 256 x 256
SITES = (('down_0', 5, 3, 3, 256), ('down_1', 3, 6, 6, 128),
         ('down_2', 6, 12, 12, 64), ('up_0', 24, 12, 12, 64),
         ('up_1', 12, 6, 6, 128), ('up_2', 6, 3, 3, 256))
PREDICT_BATCH, LAST_BATCH, TRAIN_BATCH, K = 64, 32, 8, 3
CALLS = ('fwd_b64', 'fwd_b32', 'fwd_b8_c1', 'bwd_b8')


def bound_ms(n_bytes, flops):
    return chip_smoke.bound(n_bytes, flops)[0]


def event_ms(fn):
    return chip_smoke._time_fns({'': fn})['']


def _short(name):
    name = name.replace('(anonymous namespace)::', '')
    return name.split('(')[0].replace('void ', '')[:60]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--repo', default=HERE)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.ops.kernels import conv_chain as CC
    from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB

    device = engine.resolve_device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'port from {os.path.abspath(args.repo)}; card: {card}', flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, jobs = [], []   # jobs: (row, label, call, bound)
    for site, ci, cm, co, hw in SITES:
        w1 = torch.randn((cm, ci, K, K), generator=gen, device=device) * \
            (2 / (ci * K * K)) ** 0.5
        w2 = torch.randn((co, cm, K, K), generator=gen, device=device) * \
            (2 / (cm * K * K)) ** 0.5
        b1 = torch.randn((cm,), generator=gen, device=device) * 0.1
        b2 = torch.randn((co,), generator=gen, device=device) * 0.1
        row = dict(site=site, shape=f'{ci}->{cm}->{co} @{hw}')
        rows.append(row)
        for label, b, need_c1 in (('fwd_b64', PREDICT_BATCH, False),
                                  ('fwd_b32', LAST_BATCH, False),
                                  ('fwd_b8_c1', TRAIN_BATCH, True)):
            x = torch.rand((b, ci, hw, hw), generator=gen, device=device)
            c1, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=need_c1)
            flops = 2 * b * hw * hw * K * K * (cm * ci + co * cm)
            n_bytes = chip_smoke.nbytes(x, w1, b1, w2, b2, c1, c2)
            jobs.append((row, label, functools.partial(
                CC.conv_chain, x, w1, b1, w2, b2, need_c1=need_c1),
                bound_ms(n_bytes, flops)))
        b = TRAIN_BATCH
        x = torch.rand((b, ci, hw, hw), generator=gen, device=device)
        c1, c2 = CC.plain(x, w1, b1, w2, b2)
        g = torch.randn(c2.shape, generator=gen, device=device)
        need_dx = site != 'down_0'
        got = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx)
        flops = 2 * b * hw * hw * K * K * (
            2 * co * cm + (2 if need_dx else 1) * cm * ci)
        jobs.append((row, 'bwd_b8', functools.partial(
            CCB.conv_chain_bwd, x, c1, c2, g, w1, w2, need_dx),
            bound_ms(chip_smoke.nbytes(x, c1, c2, g, w1, w2, *got), flops)))
    # CUDA events first: a profiler session slows later calls on the host
    for row, label, call, bound in jobs:
        row[label] = dict(event_ms=event_ms(call), bound_ms=bound)
    for row, label, call, _ in jobs:
        split = chip_smoke._fullest_split(call)
        row[label].update(device_ms=sum(ms for ms, _ in split.values()),
                          split={_short(k): v for k, v in split.items()})
        r = row[label]
        print(f'{row["site"]:6s} {row["shape"]:14s} {label:9s} device '
              f'{r["device_ms"]:.4f} ms  event {r["event_ms"]:.4f} ms  '
              f'bound {r["bound_ms"]:.4f} ms', flush=True)
        for name, (ms, n) in sorted(r['split'].items(),
                                    key=lambda kv: -kv[1][0]):
            print(f'         {ms:.4f} ms {n:4.1f}x  {name}', flush=True)
    for label in CALLS:
        dev = sum(r[label]['device_ms'] for r in rows)
        ev = sum(r[label]['event_ms'] for r in rows)
        bd = sum(r[label]['bound_ms'] for r in rows)
        print(f'sum of six sites {label:9s} device {dev:.4f} ms  event '
              f'{ev:.4f} ms  bound {bd:.4f} ms', flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as fh:
            json.dump(dict(card=card, repo=args.repo, sites=rows), fh,
                      indent=1)


if __name__ == '__main__':
    main()
