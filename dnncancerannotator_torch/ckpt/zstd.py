'''Zstandard frames to bytes, in the host library (csrc/host/zstd_decode.cc,
built by data/_native.py; a failed build raises). Nothing falls back: a
malformed frame raises ValueError with the decoder's reason.'''

import ctypes

import numpy as np

from ..data import _native

_ERR_CAP = 512


def decompress(data, size=None) -> bytes:
    '''Decode every frame of ``data``. ``size``, when the caller knows it (a
    zarr chunk's), is the exact decoded length; without it the frames are
    decoded once to count their bytes, then again into the result.'''
    lib = _native.library()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_CAP)
    if size is None:
        size = lib.zstd_decompress(src.ctypes.data, src.size, None, 0, err,
                                   _ERR_CAP)
        if size < 0:
            raise ValueError(f'zstd: {err.value.decode()}')
    out = np.empty(size, np.uint8)
    got = lib.zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                              size, err, _ERR_CAP)
    if got < 0:
        raise ValueError(f'zstd: {err.value.decode()}')
    if got != size:
        raise ValueError(f'zstd: decoded {got} bytes, expected {size}')
    return out.tobytes()
