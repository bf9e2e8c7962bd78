'''CLI entry: ``python3 -m dnncancerannotator_torch predict ...``.'''

from .runs.__main__ import main

if __name__ == '__main__':
    main(prog='python3 -m dnncancerannotator_torch')
