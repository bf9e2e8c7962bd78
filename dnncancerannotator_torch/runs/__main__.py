'''CLI dispatcher: subcommands generated from function docstrings, the
seven of the JAX package's CLI: ``train``, ``evaluate``, ``predict``,
``export_model``, ``serve``, ``extract_all`` and ``generate_tfrecords``.'''

import argparse
import logging

from ..utils import dscli


def main(prog='python3 -m dnncancerannotator_torch', argv=None):
    logging.basicConfig(level=logging.INFO)
    from . import evaluate, predict, train
    from . import export as export_mod
    from . import extract
    from . import serve as serve_mod
    from ..data.records import generate_tfrecords

    parser = argparse.ArgumentParser(prog=prog)
    subparsers = parser.add_subparsers(help='command')
    dscli.add_command(subparsers, train.train)
    dscli.add_command(subparsers, evaluate.evaluate)
    dscli.add_command(subparsers, predict.predict)
    dscli.add_command(subparsers, export_mod.export_model)
    dscli.add_command(subparsers, serve_mod.serve)
    dscli.add_command(subparsers, extract.extract_all)
    dscli.add_command(subparsers, generate_tfrecords)
    return dscli.run(parser, argv)


if __name__ == '__main__':
    main()
