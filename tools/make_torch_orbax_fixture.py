'''Write the Orbax checkpoint fixtures of the port's checkpoint reader.

Run where the JAX package runs (it saves through the JAX engine's own
``build`` and ``save_ckpt``, with orbax and tensorstore), from the repo root:

    JAX_PLATFORMS=cpu python tools/make_torch_orbax_fixture.py [--seed 0]

It writes, under tests/fixtures_torch/orbax/:
- ``unet/``: a JAX save_path (options.yaml, checkpoints/ckpt-<step>) of
  unet.yaml + deploy_options.yaml + data_options.yaml at full width;
- ``bn/``: the same for unet_big.yaml + data_options.yaml with
  ``n_filters_first`` cut to 4 (BatchNorm, so ``batch_stats``);
- ``<name>.expected.npz`` beside each: the flat arrays of the engine's
  ``_ckpt_view()`` under the port's keys.
Before each save the optimizer state, the BatchNorm statistics and ``step``
are drawn from a numpy generator seeded with ``--seed``, so no moment is
zero. tests/test_torch_orbax.py and chip_smoke.py phase 20 read them.
'''

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', default=None,
                        help='output directory (default: the fixtures)')
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    from tests import util_orbax
    out = args.out or util_orbax.FIXTURES
    os.makedirs(out, exist_ok=True)
    total = 0
    for name in util_orbax.FIXTURE_SPECS:
        run_dir = util_orbax.write_fixture(name, out, args.seed)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(run_dir) for f in files)
        size += os.path.getsize(os.path.join(out, f'{name}.expected.npz'))
        total += size
        print(f'{run_dir}: {size} bytes')
    print(f'total {total} bytes')


if __name__ == '__main__':
    main()
