'''CLI dispatcher: subcommands generated from function docstrings.
``train``, ``evaluate``, ``predict`` and ``generate_tfrecords`` are ported
so far.'''

import argparse
import logging

from ..utils import dscli


def main(prog='python3 -m dnncancerannotator_torch', argv=None):
    logging.basicConfig(level=logging.INFO)
    from . import evaluate, predict, train
    from ..data.records import generate_tfrecords

    parser = argparse.ArgumentParser(prog=prog)
    subparsers = parser.add_subparsers(help='command')
    dscli.add_command(subparsers, train.train)
    dscli.add_command(subparsers, evaluate.evaluate)
    dscli.add_command(subparsers, predict.predict)
    dscli.add_command(subparsers, generate_tfrecords)
    return dscli.run(parser, argv)


if __name__ == '__main__':
    main()
