'''The head conv's route and its one-launch backward's plan, computed on
the CPU.

``stencil_conv.route`` sends a 1 x 1 conv with zero pads to the pointwise
kernels, every other shape whose tile fits a block to the tile kernel, and
the rest to the direct stencil kernel. The backward's
pointwise kernel (csrc/stencil_conv_bwd.cu: pointwise_bwd_kernel) trusts
``stencil_conv_bwd.plan``: these tests hold the plan to what the kernel
needs. Its tiles cover every pixel of every plane exactly once, whole
float4 groups of one plane each; its blocks take consecutive tiles; the
items' slices fit a block's threads; the shared memory holds the kernel's
layout and the last block's chunk sums; the scratch holds one partial a
block; and the plan is a function of the shape alone, so dw and db are
the same bits on every card.
'''

import numpy as np
import pytest
import torch

from dnncancerannotator_torch.ops.kernels import _build
from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB

ZERO = ((0, 0), (0, 0))


@pytest.mark.parametrize('ci,co,k,pads,h,w,want', [
    (3, 1, 1, ZERO, 256, 256, 'pointwise'),          # the logits head
    (32, 32, 1, ZERO, 255, 257, 'pointwise'),
    (1, 1, 1, ZERO, 1, 3, 'pointwise'),
    (3, 1, 1, ((0, 1), (0, 0)), 256, 256, 'tile'),  # padded 1 x 1
    (3, 3, 3, ((1, 1), (1, 1)), 16, 16, 'tile'),
    (4, 2, 3, ((0, 2), (1, 0)), 8, 8, 'tile'),
    (32, 1, 1, ZERO, 8192, 8192, 'stencil'),    # past 32-bit plane offsets
])
def test_route(ci, co, k, pads, h, w, want):
    assert SC.route(ci, co, k, k, pads, h, w) == want


def _cover(b, ci, co, h, w):
    '''Each pixel's count over the tiles of the plan's blocks, with the
    kernel's indexing (t0 = block * per_block, b = t / chunks,
    p0 = (t % chunks) * tile).'''
    pl = SCB.plan(b, ci, co, h, w)
    p = h * w
    cover = np.zeros((b, p), np.int64)
    for blk in range(pl.blocks):
        t0 = blk * pl.per_block
        t1 = min(pl.tiles, t0 + pl.per_block)
        assert t1 > t0, 'a block without a tile'
        for t in range(t0, t1):
            bb, p0 = t // pl.chunks, t % pl.chunks * pl.tile
            cover[bb, p0:min(p, p0 + pl.tile)] += 1
    return pl, cover


@pytest.mark.parametrize('b', [1, 8, 64])
@pytest.mark.parametrize('h,w', [(256, 256), (255, 257), (1, 3), (7, 9)])
@pytest.mark.parametrize('ci,co', [(1, 1), (3, 1), (3, 3), (5, 3),
                                   (32, 1), (1, 32), (32, 32)])
def test_plan_covers_each_pixel_once(b, h, w, ci, co):
    pl, cover = _cover(b, ci, co, h, w)
    assert (cover == 1).all()
    p = h * w
    assert pl.tile % 4 == 0 and pl.tile <= SCB.MAX_TILE
    assert pl.chunks == -(-p // pl.tile) and pl.tiles == b * pl.chunks
    # one plane a tile: a tile never reaches past its plane's last group
    assert pl.tile <= -(-p // 4) * 4
    assert 4 * (ci + co) * pl.tile <= SCB.STAGE_BYTES
    assert 1 <= pl.blocks <= SCB.MAX_BLOCKS


@pytest.mark.parametrize('ci,co,h,w', [(3, 1, 256, 256), (5, 3, 255, 257),
                                       (32, 32, 256, 256), (1, 1, 1, 3),
                                       (32, 3, 64, 64)])
@pytest.mark.parametrize('b', [1, 8, 64])
def test_plan_shared_memory_and_scratch(b, ci, co, h, w):
    pl = SCB.plan(b, ci, co, h, w)
    n = ci * co + co
    s = pl.slices
    # slices: a power of two, within a block's threads, a group each at
    # least
    assert s & (s - 1) == 0 and s <= pl.tile // 4
    assert s == 1 or n * s <= SCB.THREADS
    # the kernel's layout: xs, gs, ws to a whole float4, red [warps] and
    # part [n] doubles
    layout = 4 * ((ci + co) * pl.tile + -(-ci * co // 4) * 4) + \
        8 * (SCB.THREADS // 32 + n)
    assert pl.smem >= layout
    # the finish: at least one item's K chunk sums a batch
    k = -(-pl.blocks // SCB.CHUNK)
    assert (pl.smem // 8) // k >= 1
    assert pl.smem <= _build.MAX_SMEM_BYTES
    # one f64 partial of the n items a block
    scratch = SCB.scratch(torch.device('cpu'), pl.blocks * n)
    assert scratch.dtype == torch.float64
    assert scratch.numel() == pl.blocks * n
    assert SCB.scratch(torch.device('cpu'), pl.blocks * n) is scratch


def test_plan_is_a_function_of_the_shape(monkeypatch):
    '''No device query reaches the plan (the same partition, so the same
    sums in the same order, on every card).'''
    def no_device(*args, **kwargs):
        raise AssertionError('the plan asked the device')

    for name in ('get_device_properties', 'device_count', 'is_available'):
        monkeypatch.setattr(torch.cuda, name, no_device)
    shape = (8, 3, 1, 256, 256)
    SCB.plan.cache_clear()
    first = SCB.plan(*shape)
    SCB.plan.cache_clear()
    assert SCB.plan(*shape) == first
    # the head at B=8: one tile a block, 256 partials, 64 slices an item
    assert first == SCB.Plan(tile=2048, chunks=32, tiles=256, per_block=1,
                             blocks=256, slices=64, smem=first.smem)
