'''CLI dispatcher: subcommands generated from function docstrings.
Only ``predict`` is ported so far.'''

import argparse
import logging

from ..utils import dscli


def main(prog='python3 -m dnncancerannotator_torch', argv=None):
    logging.basicConfig(level=logging.INFO)
    from . import predict

    parser = argparse.ArgumentParser(prog=prog)
    subparsers = parser.add_subparsers(help='command')
    dscli.add_command(subparsers, predict.predict)
    return dscli.run(parser, argv)


if __name__ == '__main__':
    main()
