'''Launch geometry of the shared weight-gradient kernel (csrc/wgrad.cu),
mirrored here so that the wrappers can size its scratch and check that it
fits shared memory before they launch it.'''

import functools

from . import _build

THREADS = 256
TILE_H, TILE_W = 8, 32
# at most this many blocks (4 per SM of an H100): each walks several tiles,
# so the partial sums stay few
MAX_BLOCKS = 528


def bucket(c):
    '''The kernel's register width for c output channels.'''
    return next(b for b in (4, 8, 16, 32) if c <= b)


def blocks(b, oh, ow, tile_h=TILE_H, tile_w=TILE_W):
    '''Blocks of a weight-gradient launch over B x OH x OW output pixels.'''
    tiles = b * -(-oh // tile_h) * -(-ow // tile_w)
    return min(tiles, MAX_BLOCKS)


def smem_bytes(o, cin, kh, kw):
    '''Shared memory of one wgrad block: A as [pixel][C], X with its halo,
    and the per-slice sums.'''
    width = bucket(o)
    per_pass = min(cin * kh * kw + 1, THREADS)
    slices = THREADS // per_pass
    floats = (TILE_H * TILE_W * width
              + cin * (TILE_H + kh - 1) * (TILE_W + kw - 1)
              + slices * per_pass * width)
    return 4 * floats


@functools.lru_cache(maxsize=None)
def fits(o, cin, kh, kw):
    return o <= 32 and smem_bytes(o, cin, kh, kw) <= _build.MAX_SMEM_BYTES
