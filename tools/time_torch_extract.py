'''extract_all's wall time through the CLI on the card, for this checkout
and for other checkouts of the repo, in turns:

    python3 tools/time_torch_extract.py [--rounds 2] [OTHER_CHECKOUT ...]

The tree is chip_smoke.py phase 18's: 4 cancer + 4 healthy exams x 8
seeded 1080 x 1600 collages. Each turn copies it afresh, runs
``python -m dnncancerannotator_torch extract_all --path TREE --debug``
with PYTHONPATH at one checkout (its default pool, the corner correlation
on the card), and reads the CLI's own "Extracted N slices in S s" line.
A round runs the checkouts in order and then in reverse (A B B A), so
each one runs first as often as last. Prints every turn's seconds and the
median collages/s of each checkout, with the card's name and power limit.
'''

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def run(checkout, tree):
    '''One extract_all CLI call over ``tree`` from ``checkout``: the
    seconds extract_all logs for itself.'''
    proc = subprocess.run(
        [sys.executable, '-m', 'dnncancerannotator_torch', 'extract_all',
         '--path', tree, '--debug'], cwd=checkout,
        env=dict(os.environ, PYTHONPATH=checkout), capture_output=True,
        text=True, timeout=600, check=False)
    found = re.search(r'Extracted (\d+) slices in ([0-9.]+) s', proc.stderr)
    if proc.returncode != 0 or not found:
        raise RuntimeError(f'{checkout}: rc {proc.returncode}\n'
                           f'{proc.stderr[-3000:]}')
    return int(found.group(1)), float(found.group(2))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('others', nargs='*',
                        help='other checkouts of the repo to time')
    parser.add_argument('--rounds', type=int, default=2)
    args = parser.parse_args()

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    work = os.path.join(REPO, 'build', 'time_torch_extract')
    shutil.rmtree(work, ignore_errors=True)
    source = os.path.join(work, 'source')
    cs.write_collage_tree(source)
    checkouts = [REPO] + [os.path.abspath(o) for o in args.others]
    seconds = {c: [] for c in checkouts}
    try:
        for _ in range(args.rounds):
            for checkout in checkouts + checkouts[::-1]:
                tree = os.path.join(work, 'tree')
                shutil.rmtree(tree, ignore_errors=True)
                shutil.copytree(source, tree)
                n, s = run(checkout, tree)
                seconds[checkout].append(s)
                print(f'{checkout}: {n} collages in {s:.2f} s [{smi}]',
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for checkout, times in seconds.items():
        print(f'{checkout}: median {statistics.median(times):.2f} s, '
              f'{n / statistics.median(times):.2f} collages/s over '
              f'{len(times)} calls {times} [{smi}]')


if __name__ == '__main__':
    main()
