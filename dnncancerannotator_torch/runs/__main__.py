'''CLI dispatcher: subcommands generated from function docstrings.
``train``, ``evaluate`` and ``predict`` are ported so far.'''

import argparse
import logging

from ..utils import dscli


def main(prog='python3 -m dnncancerannotator_torch', argv=None):
    logging.basicConfig(level=logging.INFO)
    from . import evaluate, predict, train

    parser = argparse.ArgumentParser(prog=prog)
    subparsers = parser.add_subparsers(help='command')
    dscli.add_command(subparsers, train.train)
    dscli.add_command(subparsers, evaluate.evaluate)
    dscli.add_command(subparsers, predict.predict)
    return dscli.run(parser, argv)


if __name__ == '__main__':
    main()
