'''Fused conv chain relu(conv(relu(conv(x, w1) + b1), w2) + b2), NCHW f32.

One CUDA kernel (csrc/conv_chain.cu) replaces both Pallas chain kernels of
the JAX package: conv_kernel.conv_chain_pallas and
flatchain.conv_chain_flat_nchw. Stride 1, odd K, "same" pads K // 2;
weights in PyTorch OIHW layout ([Cm, Ci, K, K] and [Co, Cm, K, K]).

``conv_chain`` launches the kernel for CUDA tensors and runs ``plain`` (two
``F.conv2d`` + relu) for CPU tensors; it raises on any other input.

The launch geometry lives here, in pure Python, so that the CPU tests can
check it: ``plan`` picks the channel group (CPT), the tile and the block
size of a shape by one rule that the timed sweeps of every geometry at the
unet.yaml sites bear out (tools/sweep_torch_chain.py, PERF.md), with TUNED
overriding it where a sweep measured the rule more than 3% slower.
'''

import collections
import functools

import torch
import torch.nn.functional as F

from . import _build

MAX_CHANNELS = 32
SMS = 132                       # streaming multiprocessors of an H100
SM_SMEM_BYTES = 233472          # shared memory of one SM (228 KB)
SM_THREADS = 2048
MAX_REGS = 128                  # __launch_bounds__(256, 2)
# the geometries the kernel takes (tools/sweep_torch_chain.py times them)
THREADS = (128, 256)
TILE_HS = (2, 3, 4, 6, 8, 12, 16, 32)
TILE_WS = (64, 32, 16, 8)
FILL_TILE_HS = (16, 8, 4)       # the rule's tile heights, tallest first
EXACT_CPT = (3, 6, 12)          # channel groups with no padding
PADDED_CPT = (4, 8)             # any other width, the last group padded

launches = 0  # kernel launches in this process

Plan = collections.namedtuple(
    'Plan', 'cpt tile_h tile_w threads c1_w c1_s xs_w smem blocks')


def plain(x, w1, b1, w2, b2):
    '''Plain PyTorch version: returns (c1, c2), both post-relu.'''
    pad = w1.shape[-1] // 2
    c1 = F.relu(F.conv2d(x, w1, b1, padding=pad))
    c2 = F.relu(F.conv2d(c1, w2, b2, padding=pad))
    return c1, c2


def run_px(cpt):
    '''Pixels of one work item along a row (csrc/conv_tile.cuh).'''
    return 8 if cpt <= 4 else 4


def pad4(n):
    return -(-n // 4) * 4


def cdiv(a, b):
    return -(-a // b)


def cpt_choices(*widths):
    '''Channel groups the kernels take for these output widths: the exact
    ones that divide every width, else the padded ones.'''
    exact = tuple(c for c in EXACT_CPT if all(w % c == 0 for w in widths))
    return exact or PADDED_CPT


def stride(n):
    '''The row stride for rows of at least n floats: 4 mod 8, so that the
    float4 loads of eight lanes on eight consecutive rows hit distinct
    banks.'''
    return n + (4 - n) % 8


def row_widths(tile_w, k, cpt):
    '''(c1_w, c1_s, xs_w): the width of the c1 tile (the tile plus its
    halo, rounded up to whole runs), its row stride, and the row stride of
    the input tile below it (its halo, and room for the float4 reads of the
    last run's window).'''
    p = k // 2
    c1_w = cdiv(tile_w + 2 * p, run_px(cpt)) * run_px(cpt)
    return c1_w, stride(c1_w), stride(c1_w + max(2 * p, 4))


def tile_fits(tile_h, tile_w, h, w):
    '''Whether a tile is worth trying for an h x w image: the smallest
    always, a larger one while it is at most twice the image.'''
    return ((tile_h == min(TILE_HS) or tile_h <= 2 * h)
            and (tile_w == min(TILE_WS) or tile_w <= 2 * pad4(w)))


def resident_blocks(threads, smem):
    '''Blocks of one launch that an SM holds at once.'''
    return min(32, SM_THREADS // threads, SM_SMEM_BYTES // (smem + 1024),
               65536 // (threads * MAX_REGS))


def _smem_bytes(ci, cm, co, k, cpt, tile_h, c1_s, xs_w):
    '''Shared memory of one block (csrc/conv_chain.cu): both weight sets
    and biases in group slots, the input tile and the c1 tile.'''
    p = k // 2
    row1 = cdiv(cm, cpt) * pad4(cpt)
    row2 = cdiv(co, cpt) * pad4(cpt)
    floats = (ci * k * k * row1 + cm * k * k * row2 + row1 + row2
              + ci * (tile_h + 4 * p) * xs_w + cm * (tile_h + 2 * p) * c1_s)
    return 4 * floats


def geometry(b, ci, cm, co, h, w, k, cpt, tile_h, tile_w, threads):
    '''The Plan of one forward launch with this channel group, tile and
    block size.'''
    c1_w, c1_s, xs_w = row_widths(tile_w, k, cpt)
    smem = _smem_bytes(ci, cm, co, k, cpt, tile_h, c1_s, xs_w)
    blocks = b * cdiv(h, tile_h) * cdiv(w, tile_w)
    return Plan(cpt, tile_h, tile_w, threads, c1_w, c1_s, xs_w, smem, blocks)


def pick_tile(b, h, w, fits):
    '''(tile_h, tile_w) of the chain kernels' rule: the widest tile, at
    the tallest height of FILL_TILE_HS that still gives every SM a tile at
    batch b (else the shortest of them); a smaller one only where
    ``fits(tile_h, tile_w)`` (shared memory) needs it. None if none fits.'''
    wide = next(t for t in TILE_WS if tile_fits(min(TILE_HS), t, h, w))
    tall = next((t for t in FILL_TILE_HS
                 if b * cdiv(h, t) * cdiv(w, wide) >= SMS), FILL_TILE_HS[-1])
    for tile_h in sorted((t for t in TILE_HS if t <= tall), reverse=True):
        for tile_w in TILE_WS:
            if tile_fits(tile_h, tile_w, h, w) and fits(tile_h, tile_w):
                return tile_h, tile_w
    return None


def rule(b, ci, cm, co, h, w, k):
    '''The rule's Plan, None if no tile fits: the widest channel group up
    to 6 (exact at every unet.yaml site; 6 and 12 measured within 1% of each
    other), 128 threads for groups of 3 (runs of 8 pixels, half the work
    items of a tile) and 256 otherwise, and ``pick_tile``'s tile.'''
    cpt = max(c for c in cpt_choices(cm, co) if c <= 6)
    shape = (b, ci, cm, co, h, w, k, cpt)
    tile = pick_tile(b, h, w, lambda th, tw: geometry(
        *shape, th, tw, 0).smem <= _build.MAX_SMEM_BYTES)
    return (None if tile is None
            else geometry(*shape, *tile, 128 if cpt == 3 else 256))


# where the rule measured more than 3% slower than the fastest geometry, on
# an NVIDIA H100 80GB HBM3 at 700 W (tools/sweep_torch_chain.py; PERF.md):
# (B, Ci, Cm, Co, H, W, K) -> (cpt, tile_h, tile_w, threads). Prediction and
# evaluation run 64 slices a batch and 32 in the last batch of 160.
TUNED = {
    (64, 5, 3, 3, 256, 256, 3): (3, 12, 64, 128),
    (32, 5, 3, 3, 256, 256, 3): (3, 12, 64, 128),
    (64, 3, 6, 6, 128, 128, 3): (6, 16, 64, 128),
    (32, 3, 6, 6, 128, 128, 3): (6, 16, 64, 128),
    (32, 24, 12, 12, 64, 64, 3): (6, 16, 64, 256),
    (64, 6, 3, 3, 256, 256, 3): (3, 12, 64, 128),
    (32, 6, 3, 3, 256, 256, 3): (3, 12, 64, 128),
}


@functools.lru_cache(maxsize=None)
def plan(b, ci, cm, co, h, w, k):
    '''The launch geometry of one shape: TUNED's, else the rule's.'''
    key = (b, ci, cm, co, h, w, k)
    if key in TUNED:
        return geometry(*key, *TUNED[key])
    return rule(*key)


@functools.lru_cache(maxsize=None)
def supported(ci, cm, co, k):
    '''Whether the kernel takes these channel counts and kernel size: the
    rule's channel group has to fit shared memory at the smallest tile
    (that of a 1 x 1 image).'''
    return (max(ci, cm, co) <= MAX_CHANNELS and k % 2 == 1
            and rule(1, ci, cm, co, 1, 1, k) is not None)


def _check(x, w1, b1, w2, b2):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {tuple(x.shape)}')
    ci = x.shape[1]
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    if (tuple(w1.shape) != (cm, ci, k, k) or tuple(w2.shape) != (co, cm, k, k)
            or tuple(b1.shape) != (cm,) or tuple(b2.shape) != (co,)):
        raise ValueError(
            f'conv_chain shapes do not chain: x {tuple(x.shape)}, '
            f'w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, '
            f'w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}')
    if not supported(ci, cm, co, k):
        raise ValueError(
            f'conv_chain takes odd K and at most {MAX_CHANNELS} channels '
            f'that fit shared memory; got Ci={ci} Cm={cm} Co={co} K={k}')


def conv_chain(x, w1, b1, w2, b2, need_c1=False):
    '''Returns (c1, c2); c1 is None unless ``need_c1``.'''
    global launches
    _check(x, w1, b1, w2, b2)
    if x.device.type == 'cpu':
        c1, c2 = plain(x, w1, b1, w2, b2)
        return (c1 if need_c1 else None), c2
    device = _build.check_cuda_f32(x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    b, ci, h, w = x.shape
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    c2 = torch.empty((b, co, h, w), device=device, dtype=torch.float32)
    c1 = (torch.empty((b, cm, h, w), device=device, dtype=torch.float32)
          if need_c1 else None)
    pl = plan(b, ci, cm, co, h, w, k)
    _build.launch(
        'dnnca_conv_chain', x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(),
        c1.data_ptr() if c1 is not None else None, c2.data_ptr(),
        b, ci, cm, co, h, w, k, pl.cpt, pl.tile_h, pl.tile_w, pl.c1_w,
        pl.c1_s, pl.xs_w, pl.threads, pl.smem, device.index,
        _build.stream_of(device))
    launches += 1
    return c1, c2
