'''The NCHW transposed-conv backward's launch plan, computed on the CPU.

The wrapper (ops/kernels/tconv2x2_bwd.py: plan) sizes the one launch of
csrc/tconv2x2_bwd.cu in pure Python: the tile of input pixels a block
owns, the input-channel group CPT, the blocks and the shared memory; it
allocates the scratch of the clusters' partials and keeps one ticket
counter a device. The kernel trusts all of it. These tests hold the plan, at
unet.yaml's three decoder sites (B=8) and at every width Ci, Co <= 64 the
kernel takes, to what the kernel needs: the tiles cover each input pixel
exactly once, CPT divides Ci, the shared memory the kernel lays out fits
the card, the last block's batches of partial sums fit that memory, and
the scratch holds the partials at the offsets the kernel reads.
'''

import numpy as np
import pytest
import torch

from dnncancerannotator_torch.ops.kernels import _build
from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB

# (Ci, Co, input H = W) of unet.yaml's transposed convs at 256 x 256 crops
SITES = {'up_0': (12, 12, 32), 'up_1': (12, 6, 64), 'up_2': (6, 3, 128)}


def _coverage(b, h, w, pl):
    '''How often each input pixel falls in a block's tile, with the
    kernel's tile index (csrc/tconv2x2_bwd.cu: b, y0, x0 of blockIdx.x;
    the blocks past the tiles, which pad the grid to whole clusters, take
    none).'''
    tiles_x, tiles_y = TCB.cdiv(w, pl.tile_w), TCB.cdiv(h, pl.tile_h)
    n_tiles = b * tiles_y * tiles_x
    assert 1 <= pl.cluster <= 8 and pl.blocks % pl.cluster == 0
    assert n_tiles <= pl.blocks < n_tiles + pl.cluster
    cover = np.zeros((b, h, w), np.int64)
    for t in range(n_tiles):
        bb = t // (tiles_y * tiles_x)
        y0 = t // tiles_x % tiles_y * pl.tile_h
        x0 = t % tiles_x * pl.tile_w
        cover[bb, y0:y0 + pl.tile_h, x0:x0 + pl.tile_w] += 1
    return cover


def _kernel_smem(ci, co, pl, need_dx):
    '''The shared memory the kernel addresses: the weight, the x tile (to a
    whole float4), the g tile, kDwThreads (256) x (4 CPT + 1) doubles and the block's partial (4 Ci Co floats to a whole float4, Co
    doubles); then, over it, the finish's batches of (clusters / 16) chunk
    sums of 4 doubles for every row of 4 dw entries and every db entry.'''
    p = pl.tile_h * pl.tile_w
    floats = (4 * ci * co if need_dx else 0) + -(-ci * p // 4) * 4 + 4 * co * p
    tiles = (4 * floats + 8 * 256 * (4 * pl.cpt + 1)
             + 4 * -(-4 * ci * co // 4) * 4 + 8 * co)
    k = -(-(pl.blocks // pl.cluster) // 16)
    batch_rows = 1024 // k
    rows = ci * co + co
    return tiles, 32 * min(batch_rows, rows) * k


def _check(b, ci, co, h, w, need_dx):
    pl = TCB.plan(b, ci, co, h, w, need_dx)
    assert ci % pl.cpt == 0 and pl.cpt in TCB.CPT_CHOICES
    assert pl.cluster == (4 if pl.blocks <= 66 else 2)
    tiles = b * TCB.cdiv(h, pl.tile_h) * TCB.cdiv(w, pl.tile_w)
    assert pl.blocks == -(-tiles // pl.cluster) * pl.cluster
    assert 1 <= pl.blocks // pl.cluster <= TCB.MAX_CLUSTERS
    tiles, finish = _kernel_smem(ci, co, pl, need_dx)
    assert pl.smem >= max(tiles, finish)
    assert pl.smem <= TCB.SMEM_CAP < _build.MAX_SMEM_BYTES
    # the scratch: the clusters' dw partials [clusters][4 Ci Co] f32 in
    # whole float4 rows, then their db partials [clusters][Co] f64 on a
    # 16-byte boundary
    n_w, clusters = 4 * ci * co, pl.blocks // pl.cluster
    assert n_w % 4 == 0 and (4 * clusters * n_w) % 16 == 0
    assert TCB.scratch_floats(pl, ci, co) == clusters * n_w + \
        2 * clusters * co
    return pl


@pytest.mark.parametrize('site', sorted(SITES))
@pytest.mark.parametrize('need_dx', [False, True])
def test_plan_at_the_sites(site, need_dx):
    ci, co, hw = SITES[site]
    pl = _check(8, ci, co, hw, hw, need_dx)
    assert (_coverage(8, hw, hw, pl) == 1).all()
    # whole rows (contiguous 16-byte copies), at most one block an SM
    assert pl.tile_w == hw and pl.blocks <= TCB.SMS
    assert ci % pl.cpt == 0 and pl.cpt == 6   # exact widths, no padding


@pytest.mark.parametrize('ci', range(1, 65))
def test_plan_at_every_width(ci):
    '''Every Co for this Ci, with and without dx, on a small ragged input
    (tiles past the right and bottom edges) and on a wide one (tiles across
    a row).'''
    for co in range(1, 65):
        for need_dx in (False, True):
            for b, h, w in ((2, 7, 10), (1, 3, 300)):
                pl = _check(b, ci, co, h, w, need_dx)
                assert (_coverage(b, h, w, pl) == 1).all()


def test_rule_and_tuned_override():
    key = (8, 12, 12, 32, 32, True)
    rule = TCB.rule(*key)
    tuned = TCB.TUNED.pop(key)
    assert TCB.plan(*key) == rule and rule.tile_h == 2 and rule.cluster == 2
    try:
        TCB.TUNED[key] = 16
        assert TCB.plan(*key).tile_h == 16
        assert TCB.plan(*key).cluster == 4     # 16 tiles
        assert TCB.plan(*key).blocks == 8 * 2
    finally:
        TCB.TUNED[key] = tuned
    assert TCB.plan(*key).tile_h == 4 and TCB.plan(*key).cluster == 4


def test_ticket_is_one_zeroed_counter_a_device():
    device = torch.device('cpu')
    try:
        t = TCB.ticket(device)
        assert t.dtype == torch.int32 and t.shape == (1,) and int(t) == 0
        assert TCB.ticket(device) is t
    finally:
        TCB._tickets.pop(device.index, None)


def test_cpu_tensors_take_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 7, generator=gen)
    g = torch.randn(2, 3, 10, 14, generator=gen)
    w = torch.randn(6, 3, 2, 2, generator=gen)
    before = TCB.launches
    got = TCB.tconv2x2_bwd(x, g, w)
    assert TCB.launches == before
    for a, b in zip(got, TCB.plain(x, g, w)):
        assert torch.equal(a, b)
