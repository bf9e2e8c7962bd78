'''Backward of the fused conv chain (ops/kernels/conv_chain.py), NCHW f32.

The CUDA kernel (csrc/conv_chain_bwd.cu) replaces the backward kernels of
both JAX chain formulations: conv_kernel.conv_chain_bwd_pallas and
flatchain's _bwd_call_im2col / _bwd_call. Given the forward's input x, its
saved post-relu outputs c1 and c2, the cotangent g of c2 and the weights,
it returns (dx, dw1, db1, dw2, db2); dx is None when ``need_dx`` is false,
which is need_dx=False in the JAX package (the model's first chain, whose
input needs no gradient). The relu masks are c1 > 0 and c2 > 0.

``conv_chain_bwd`` launches the kernel for CUDA tensors and runs ``plain``
(the data and weight gradients of the two ``F.conv2d``, masked by the saved
outputs) for CPU tensors; it raises on any other input.

bf16 form: x, g and the weights bf16 with c1 and c2 f32 (the forward's
residuals) take the kernel's bf16 entry, which computes from the exact
upcast values in the f32 form's order and rounds dx, dw1, db1, dw2 and db2
to bf16, as fastconv.py:568-569 casts conv_chain_bwd_pallas's; ``plain``
does the same on the CPU.

Two launches a chain (``plan(...).fused``): one persistent kernel computes
dc1, dx and every block's partial weight gradients per tile, and one adds
the partials. Where that does not fit (K != 3, or more weight-gradient
items than threads: 32 channels) the kernel writes dc1 instead and
csrc/wgrad.cu takes the weight gradients (five launches). ``plan`` is pure
Python, so the CPU tests check the geometry: the forward's tile rule
(conv_chain.pick_tile) at 256 threads, with TUNED overriding it where a
sweep measured the rule more than 3% slower.
'''

import collections
import functools

import torch
from torch.nn import grad as nn_grad

from . import _build, _wgrad
from . import conv_chain as fwd

FUSED_CPT = (3, 4)              # csrc/conv_chain_bwd.cu's fused cases
DGRAD_CPT = (3, 4, 6, 8)        # and its dgrad-only cases
THREADS = 256                   # the fastest at every unet.yaml site

launches = 0  # kernel launches in this process
launches_bf16 = 0  # those of the bf16 form

Plan = collections.namedtuple(
    'Plan', 'fused cpt tile_h tile_w threads c1_w c1_s gs_w slices smem '
            'blocks wgrad_blocks scratch_floats')


def plain(x, c1, c2, g, w1, w2, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw1, db1, dw2, db2), in
    x's dtype (computed in f32 from bf16 inputs, then rounded).'''
    if x.dtype == torch.bfloat16:
        return tuple(None if t is None else t.to(x.dtype) for t in plain(
            *_build.upcast(x, c1, c2, g, w1, w2), need_dx=need_dx))
    pad = w1.shape[-1] // 2
    g2 = g * (c2 > 0)
    dw2 = nn_grad.conv2d_weight(c1, w2.shape, g2, padding=pad)
    dc1 = nn_grad.conv2d_input(c1.shape, w2, g2, padding=pad) * (c1 > 0)
    dw1 = nn_grad.conv2d_weight(x, w1.shape, dc1, padding=pad)
    dx = (nn_grad.conv2d_input(x.shape, w1, dc1, padding=pad)
          if need_dx else None)
    return dx, dw1, dc1.sum((0, 2, 3)), dw2, g2.sum((0, 2, 3))


def n_out(ci, cm, co, k):
    '''Floats of the result, dw1 | db1 | dw2 | db2.'''
    return cm * ci * k * k + cm + co * cm * k * k + co


def wgrad_items(ci, cm, co, cpt):
    '''Weight-gradient items of the fused kernel: (input channel or bias) x
    (group of cpt outputs), for dw2 and for dw1.'''
    return (cm + 1) * fwd.cdiv(co, cpt) + (ci + 1) * fwd.cdiv(cm, cpt)


def _smem_bytes(ci, cm, co, k, cpt, tile_h, c1_s, gs_w, need_dx, fused,
                threads):
    '''Shared memory of one block (csrc/conv_chain_bwd.cu): the flipped
    weights in group slots, g and c2 with a 2p halo, c1 and dc1 with a p
    halo, and for the fused kernel x with a p halo and, after the last
    tile, one row of weight-gradient sums a thread.'''
    p = k // 2
    weights = (co * k * k * fwd.cdiv(cm, cpt) * fwd.pad4(cpt)
               + (cm * k * k * fwd.cdiv(ci, cpt) * fwd.pad4(cpt)
                  if need_dx else 0))
    c1_plane = (tile_h + 2 * p) * c1_s
    tiles = (2 * co * (tile_h + 4 * p) * gs_w + 2 * cm * c1_plane
             + (ci * c1_plane if fused else 0))
    red = threads * cpt * k * k if fused else 0
    return 4 * (weights + max(tiles, red))


def geometry(b, ci, cm, co, h, w, k, need_dx, fused, cpt, tile_h, tile_w,
             threads):
    '''The Plan of one backward call with this kernel, channel group, tile
    and block size: the persistent grid of the blocks an SM holds at once,
    and the scratch for the partial sums (and dc1 for wgrad.cu).'''
    c1_w, c1_s, gs_w = fwd.row_widths(tile_w, k, cpt)
    smem = _smem_bytes(ci, cm, co, k, cpt, tile_h, c1_s, gs_w, need_dx,
                       fused, threads)
    tiles = b * fwd.cdiv(h, tile_h) * fwd.cdiv(w, tile_w)
    blocks = min(tiles,
                 max(1, fwd.resident_blocks(threads, smem)) * fwd.SMS)
    if fused:
        slices, wblocks = threads // wgrad_items(ci, cm, co, cpt), 0
        scratch = n_out(ci, cm, co, k) * blocks
    else:
        slices, wblocks = 0, _wgrad.blocks(b, h, w)
        scratch = (max(cm * ci * k * k + cm, co * cm * k * k + co) * wblocks
                   + b * cm * h * w)
    return Plan(fused, cpt, tile_h, tile_w, threads, c1_w, c1_s, gs_w,
                slices, smem, blocks, wblocks, scratch)


def rule(b, ci, cm, co, h, w, k, need_dx):
    '''The rule's Plan, None if no tile fits: the fused kernel where K is
    3, its weight-gradient items fit the block and a tile fits shared
    memory (its group of 3, or 4 padded), else the dgrad kernel with the
    forward's group (up to 6); ``fwd.pick_tile``'s tile.'''
    choices = fwd.cpt_choices(cm, co)
    fused_cpt = next(c for c in choices if c in FUSED_CPT)
    kernels = [(False, max(c for c in choices if c in DGRAD_CPT and c <= 6))]
    if k == 3 and wgrad_items(ci, cm, co, fused_cpt) <= THREADS:
        kernels.insert(0, (True, fused_cpt))
    for fused, cpt in kernels:
        shape = (b, ci, cm, co, h, w, k, need_dx, fused, cpt)
        tile = fwd.pick_tile(b, h, w, lambda th, tw: geometry(
            *shape, th, tw, THREADS).smem <= _build.MAX_SMEM_BYTES)
        if tile is not None:
            return geometry(*shape, *tile, THREADS)
    return None


# where the rule measured more than 3% slower than the fastest geometry,
# as conv_chain.TUNED: (B, Ci, Cm, Co, H, W, K, need_dx) -> (cpt, tile_h,
# tile_w, threads) of the fused kernel
TUNED = {
    (8, 12, 6, 6, 128, 128, 3, True): (3, 4, 64, 256),
}


@functools.lru_cache(maxsize=None)
def plan(b, ci, cm, co, h, w, k, need_dx):
    '''The launch geometry of one shape: TUNED's, else the rule's.'''
    key = (b, ci, cm, co, h, w, k, need_dx)
    if key in TUNED:
        return geometry(*key, True, *TUNED[key])
    return rule(*key)


@functools.lru_cache(maxsize=None)
def supported(ci, cm, co, k):
    '''Whether the kernel takes these channel counts and kernel size (with
    dx, the larger case): the rule's kernel has to fit shared memory at the
    smallest tile (that of a 1 x 1 image), and wgrad.cu has to take both
    weight gradients.'''
    return (max(ci, cm, co) <= fwd.MAX_CHANNELS and k % 2 == 1
            and rule(1, ci, cm, co, 1, 1, k, True) is not None
            and _wgrad.fits(co, cm, k, k) and _wgrad.fits(cm, ci, k, k))


def _check(x, c1, c2, g, w1, w2):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty [B, C, H, W] tensor, '
                         f'got {tuple(x.shape)}')
    b, ci, h, w = x.shape
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    if (tuple(w1.shape) != (cm, ci, k, k) or tuple(w2.shape) != (co, cm, k, k)
            or tuple(c1.shape) != (b, cm, h, w)
            or tuple(c2.shape) != (b, co, h, w) or g.shape != c2.shape):
        raise ValueError(
            f'conv_chain_bwd shapes do not chain: x {tuple(x.shape)}, '
            f'c1 {tuple(c1.shape)}, c2 {tuple(c2.shape)}, g {tuple(g.shape)}, '
            f'w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}')
    if not supported(ci, cm, co, k):
        raise ValueError(
            f'conv_chain_bwd takes odd K and at most {fwd.MAX_CHANNELS} '
            f'channels that fit shared memory; got Ci={ci} Cm={cm} Co={co} '
            f'K={k}')


def conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx=True):
    '''Returns (dx or None, dw1, db1, dw2, db2).'''
    global launches, launches_bf16
    _check(x, c1, c2, g, w1, w2)
    if x.device.type == 'cpu':
        return plain(x, c1, c2, g, w1, w2, need_dx)
    entry, dtype = _build.form('dnnca_conv_chain_bwd', x.dtype)
    device = _build.check_cuda(dtype, x=x, g=g, w1=w1, w2=w2)
    if _build.check_cuda(torch.float32, c1=c1, c2=c2) != device:
        raise ValueError(f'c1 and c2 must be on {device}')
    b, ci, h, w = x.shape
    cm, co, k = w1.shape[0], w2.shape[0], w1.shape[-1]
    n1, n2 = cm * ci * k * k, co * cm * k * k
    pl = plan(b, ci, cm, co, h, w, k, need_dx)
    dx = torch.empty_like(x) if need_dx else None
    # the result, [dw1 | db1 | dw2 | db2], apart from the scratch, so that
    # the gradients it returns (views) do not hold the partials or dc1
    out = torch.empty(n_out(ci, cm, co, k), device=device, dtype=dtype)
    scratch = torch.empty(pl.scratch_floats, device=device,
                          dtype=torch.float32)
    _build.launch(
        entry, x.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        g.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        dx.data_ptr() if dx is not None else None, out.data_ptr(),
        scratch.data_ptr(), b, ci, cm, co, h, w, k, pl.cpt, pl.tile_h,
        pl.tile_w, pl.c1_w, pl.c1_s, pl.gs_w, pl.slices, pl.threads,
        pl.blocks, int(pl.fused), pl.smem, pl.wgrad_blocks, device.index,
        _build.stream_of(device))
    if dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    o = n1 + cm
    return (dx, out[:n1].view(cm, ci, k, k), out[n1:o],
            out[o:o + n2].view(co, cm, k, k), out[o + n2:])
