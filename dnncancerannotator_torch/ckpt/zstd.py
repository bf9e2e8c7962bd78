'''Zstandard frames: ``decompress`` decodes them in the host library
(csrc/host/zstd_decode.cc, built by data/_native.py; a failed build raises),
``compress`` frames bytes for the checkpoint writer. Nothing falls back: a
malformed frame raises ValueError with the decoder's reason.

``compress`` writes one frame (RFC 8878) of raw blocks, with an RLE block
wherever a block is one repeated byte (zero moments and biases), and no
entropy coding. The JAX engine's zarr chunks are zstd at level 1, which
gains nothing on trained f32 weights (the committed fixtures hold 758,852
bytes of arrays in 851,534 bytes on disk), so raw blocks give a checkpoint
no larger than the JAX engine's while keeping the ``zstd`` compressor that
zarr readers expect.
'''

import ctypes
import struct

import numpy as np

from ..data import _native

_ERR_CAP = 512
MAGIC = 0xFD2FB528
BLOCK = 128 << 10   # the largest block a frame may hold
# the largest single-segment frame: its window is its content, and decoders
# refuse windows past 2 ** 27 bytes unless told otherwise
SINGLE_SEGMENT_MAX = 1 << 27
_RAW, _RLE = 0, 1


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


def _header(n):
    '''Magic, frame header descriptor, window descriptor and content size of
    a frame of ``n`` bytes.'''
    if n <= SINGLE_SEGMENT_MAX:
        # single segment: no window descriptor, the content size its window
        if n < 256:
            flag, size = 0, struct.pack('<B', n)
        elif n < 65536 + 256:
            flag, size = 1, struct.pack('<H', n - 256)
        else:
            flag, size = 2, struct.pack('<I', n)
        return struct.pack('<IB', MAGIC, flag << 6 | 1 << 5) + size
    # a 128 KiB window (exponent 7, mantissa 0): raw blocks refer to nothing
    # before them
    return struct.pack('<IBBQ', MAGIC, 3 << 6, 7 << 3, n)


def compress(data) -> bytes:
    '''One zstd frame holding ``data``: raw blocks of at most 128 KiB, RLE
    where a block is one repeated byte, the content size in the header.'''
    arr = np.frombuffer(data, np.uint8)
    n = arr.size
    parts = [_header(n)]
    starts = range(0, n, BLOCK) if n else (0,)
    for start in starts:
        block = arr[start:start + BLOCK]
        size = block.size
        last = int(start + BLOCK >= n)
        if size > 1 and block.min() == block.max():
            parts.append((size << 3 | _RLE << 1 | last).to_bytes(3, 'little'))
            parts.append(block[:1].tobytes())
        else:
            parts.append((size << 3 | _RAW << 1 | last).to_bytes(3, 'little'))
            parts.append(block.data)
    return b''.join(parts)
