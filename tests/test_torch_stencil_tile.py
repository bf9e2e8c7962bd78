'''The three stencil tiles' plans and routes, computed on the CPU.

The NHWC stencil conv's tile kernel (csrc/stencil_conv_nhwc.cu:
stencil_nhwc_tile_kernel) trusts ``stencil_conv_nhwc.plan``, the NCHW
stencil conv's tile kernel (csrc/stencil_conv.cu: stencil_tile_kernel)
trusts ``stencil_conv.plan``, and the NCHW stencil backward's one-launch
kernel (csrc/stencil_conv_bwd.cu: stencil_tile_bwd_kernel) trusts
``stencil_conv_bwd.tile_plan``. These
tests hold each plan to what its kernel needs: every output pixel (and for
the backward every input-gradient pixel and every weight-gradient pixel)
covered exactly once by the blocks' tiles, every tap inside the staged
rows and columns, the shared memory within a block's, the scratch one
partial a block, the plan a function of the shape alone, and the old
kernels (``direct``, ``split``) taken only where the tile cannot fit. Each
kernel's indexing (staging, halo offsets, the swizzled chunks, the
output's chunk layout and its copy) is emulated in numpy at small shapes
and held to the plain version.
'''

import numpy as np
import pytest
import torch

from dnncancerannotator_torch.ops.kernels import _build
from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN

SAME3 = ((1, 1), (1, 1))
ZERO = ((0, 0), (0, 0))
MAX = _build.MAX_SMEM_BYTES


def _out_hw(h, w, kh, kw, pads):
    (pt, pb), (pl, pr) = pads
    return h + pt + pb - kh + 1, w + pl + pr - kw + 1


# -- the NHWC forward's tile ---------------------------------------------------
# (b, h, w, ci, co, k, pads): MulmoUNet's encoder conv_0 and head at B=8 and
# 64, then ragged and odd shapes, every channel layout and Co bucket
NHWC_SHAPES = [
    (8, 256, 256, 1, 16, 3, SAME3), (8, 256, 256, 16, 1, 1, ZERO),
    (64, 256, 256, 1, 16, 3, SAME3), (64, 256, 256, 16, 1, 1, ZERO),
    (1, 37, 70, 1, 16, 3, SAME3), (2, 19, 33, 1, 16, 3, SAME3),
    (2, 21, 22, 4, 3, 3, SAME3), (2, 21, 22, 3, 32, 3, SAME3),
    (2, 17, 24, 1, 1, 3, ZERO), (2, 16, 18, 8, 16, 3, ZERO),
    (2, 20, 20, 32, 1, 1, ZERO), (3, 13, 250, 16, 1, 1, ZERO),
    (2, 9, 9, 2, 3, 5, ((2, 2), (2, 2))), (2, 11, 13, 1, 8, 3, ((0, 2), (2, 0))),
    (1, 1, 1, 1, 1, 1, ZERO), (2, 5, 3, 1, 32, 3, SAME3),
]


def _nhwc_cover(b, h, w, ci, co, k, pads, esize):
    '''Each output pixel's count over the groups of the plan's tiles, with
    the kernel's indexing (tile t: image t // tiles_y, first row
    (t % tiles_y) * rows; group g: row g // gpr, columns from
    (g % gpr) * px), and the largest staged row and column any tap reads.'''
    pl = SN.plan(b, h, w, ci, co, k, k, pads, esize)
    oh, ow = _out_hw(h, w, k, k, pads)
    tiles_y = -(-oh // pl.rows)
    assert pl.tiles == b * tiles_y
    cover = np.zeros((b, oh, ow), np.int64)
    g = np.arange(pl.rows * pl.gpr)
    r, x0 = g // pl.gpr, g % pl.gpr * pl.px
    for t in range(pl.tiles):
        bb, oy0 = t // tiles_y, t % tiles_y * pl.rows
        nr = min(pl.rows, oh - oy0)
        assert nr >= 1, 'a tile without a row'
        live = r < nr
        for p in range(pl.px):
            xs = x0[live] + p
            keep = xs < ow
            np.add.at(cover[bb], (oy0 + r[live][keep], xs[keep]), 1)
    # taps: staged row r + ky < rows + kh - 1, staged column x0 + p + kx
    max_col = (pl.gpr - 1) * pl.px + pl.px - 1 + k - 1
    return pl, cover, max_col


@pytest.mark.parametrize('b,h,w,ci,co,k,pads', NHWC_SHAPES)
@pytest.mark.parametrize('esize', [4, 2])
def test_nhwc_plan_covers_each_output_once(b, h, w, ci, co, k, pads, esize):
    pl, cover, max_col = _nhwc_cover(b, h, w, ci, co, k, pads, esize)
    assert (cover == 1).all()
    assert max_col < pl.sw
    assert pl.in_row % 4 == 0 and pl.in_row >= pl.sw * ci
    assert pl.px == SN.pixels(ci, co, k, k, pads)
    # P * CO sums a thread: at most 32, a window only for the encoder form
    assert pl.px * SN.bucket(co) <= 32 or pl.px == 1
    assert pl.px == 1 or SN.form(ci, k, k, pads) == 3
    # the 1 x 1 form stages nothing: its pixels are its outputs'
    assert (SN.form(ci, k, k, pads) == 1) == (k == 1 and pads == ZERO)


@pytest.mark.parametrize('b,h,w,ci,co,k,pads', NHWC_SHAPES)
@pytest.mark.parametrize('esize', [4, 2])
def test_nhwc_plan_shared_memory(b, h, w, ci, co, k, pads, esize):
    pl = SN.plan(b, h, w, ci, co, k, k, pads, esize)
    oh, ow = _out_hw(h, w, k, k, pads)
    assert 1 <= pl.rows <= oh
    width = SN.bucket(co)
    # the layout: weights and bias (f32, to 16 bytes), the staged rows
    # (f32), the output staging in x's dtype
    staged = SN.form(ci, k, k, pads) != 1
    floats = -(-(k * k * ci * width + width) // 4) * 4 + \
        ((pl.rows + k - 1) * pl.in_row if staged else 0)
    if pl.vec_out:
        assert co == width and ow % pl.px == 0
        assert pl.px * co * esize % 16 == 0
        chunks = pl.px * co * esize // 16
        out = 16 * pl.rows * pl.gpr * (chunks + 1 - chunks % 2)
    else:
        out = -(-(pl.rows * ow * co * esize + 16) // 16) * 16
    assert pl.smem == 4 * floats + out
    assert SN.route(b, h, w, ci, co, k, k, pads, esize) == 'tile'
    assert pl.smem <= MAX
    # rows: TILE_PX pixels, fewer only past TILE_BYTES
    full = min(oh, -(-SN.TILE_PX // ow))
    assert pl.rows == full or (pl.rows < full and SN.plan(
        b, h, w, ci, co, k, k, pads, esize, rows=pl.rows + 1).smem
        > SN.TILE_BYTES)


@pytest.mark.parametrize('b,h,w,ci,co,k,pads,want', [
    (8, 256, 256, 1, 16, 3, SAME3, 'tile'),
    (1, 4, 8192, 1, 32, 3, SAME3, 'direct'),   # one row: 1 MB of output
    (1, 2, 2000, 32, 32, 1, ZERO, 'direct'),
    (1, 2, 800, 32, 32, 1, ZERO, 'tile'),
    (1, 3, 12000, 1, 1, 3, SAME3, 'tile'),
])
@pytest.mark.parametrize('esize', [4, 2])
def test_nhwc_route_direct_only_where_a_row_does_not_fit(b, h, w, ci, co, k,
                                                         pads, want, esize):
    one_row = SN.plan(b, h, w, ci, co, k, k, pads, esize, rows=1)
    got = SN.route(b, h, w, ci, co, k, k, pads, esize)
    assert got == ('direct' if one_row.smem > MAX else 'tile')
    if esize == 4:
        assert got == want


def _emulate_nhwc(x, w, bias, pads, relu, esize):
    '''The tile kernel's indexing in numpy (f64): the staged rows, each
    group's taps (from the staged rows, or for the 1 x 1 form from x), the
    output staging (16-byte chunks of the groups' outputs with the plan's
    padding, or value by value after the shift) and the copy of the tile's
    run.'''
    b, h, wd, ci = x.shape
    co, _, kh, kw = w.shape
    pl = SN.plan(b, h, wd, ci, co, kh, kw, pads, esize)
    (pt, _), (pll, _) = pads
    oh, ow = _out_hw(h, wd, kh, kw, pads)
    v = 16 // esize
    out = np.full(b * oh * ow * co, np.nan)
    tiles_y = -(-oh // pl.rows)
    for t in range(pl.tiles):
        bb, oy0 = t // tiles_y, t % tiles_y * pl.rows
        nr = min(pl.rows, oh - oy0)
        # staging: rows oy0 - pt .., columns -pl .. sw - pl - 1
        stage = np.zeros(((pl.rows + kh - 1), pl.in_row))
        for r in range(pl.rows + kh - 1):
            for col in range(pl.sw):
                iy, ix = oy0 - pt + r, col - pll
                stage[r, col * ci:(col + 1) * ci] = (
                    x[bb, iy, ix] if 0 <= iy < h and 0 <= ix < wd
                    else np.zeros(ci))
        g0 = ((bb * oh + oy0) * ow) * co
        shift = 0 if pl.vec_out else g0 % v
        gc = pl.px * co // v if pl.vec_out else 0
        gs = gc + (1 - gc % 2) if pl.vec_out else 0
        smem = np.full(max(pl.rows * pl.gpr * gs * v,
                           pl.rows * ow * co + v), np.nan)
        for g in range(nr * pl.gpr):
            r, x0 = g // pl.gpr, g % pl.gpr * pl.px
            acc = np.tile(bias.astype(np.float64), (pl.px, 1))
            rows_k = kh
            if SN.form(ci, kh, kw, pads) == 1:
                # the 1 x 1 form reads its pixel from x, nothing staged
                acc += x[bb, oy0 + r, x0] @ w[:, :, 0, 0].T
                rows_k = 0
            for ky in range(rows_k):
                for kx in range(kw):
                    for c in range(ci):
                        for p in range(pl.px):
                            val = stage[r + ky, (x0 + p + kx) * ci + c]
                            acc[p] += val * w[:, c, ky, kx]
            if relu:
                acc = np.maximum(acc, 0)
            if pl.vec_out:
                smem[g * gs * v:g * gs * v + pl.px * co] = acc.reshape(-1)
            else:
                for p in range(pl.px):
                    if x0 + p < ow:
                        e = shift + (r * ow + x0 + p) * co
                        smem[e:e + co] = acc[p]
        n = nr * ow * co
        if pl.vec_out:
            for j in range(n // v):
                src = (j + (j // gc) * (gs - gc)) * v
                out[g0 + j * v:g0 + (j + 1) * v] = smem[src:src + v]
        else:
            for j in range(-(-(shift + n) // v)):
                for e in range(max(j * v, shift), min(j * v + v, shift + n)):
                    out[g0 - shift + e] = smem[e]
    return out.reshape(b, oh, ow, co)


@pytest.mark.parametrize('b,h,w,ci,co,k,pads,relu', [
    (2, 5, 6, 1, 16, 3, SAME3, True),        # the encoder form, P = 2
    (1, 4, 7, 1, 8, 3, ((0, 2), (2, 0)), True),   # P = 4, OW % P != 0
    (2, 3, 5, 8, 4, 3, ZERO, False),         # eight channels a pixel
    (1, 3, 9, 16, 1, 1, ZERO, False),        # the head's 1 x 1 form
    (1, 2, 9, 32, 4, 1, ZERO, True),
    (1, 3, 5, 4, 3, 1, ((1, 0), (0, 1)), False),   # a padded 1 x 1
    (1, 4, 5, 3, 3, 2, ((0, 1), (1, 0)), False),
])
@pytest.mark.parametrize('esize', [4, 2])
def test_nhwc_tile_emulation_matches_plain(b, h, w, ci, co, k, pads, relu,
                                           esize):
    rng = np.random.default_rng(ci * 7 + co)
    x = rng.standard_normal((b, h, w, ci))
    wk = rng.standard_normal((co, ci, k, k))
    bias = rng.standard_normal(co)
    got = _emulate_nhwc(x, wk, bias, pads, relu, esize)
    want = SN.plain(torch.from_numpy(x), torch.from_numpy(wk),
                    torch.from_numpy(bias), pads, relu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _no_device(monkeypatch):
    def no_device(*args, **kwargs):
        raise AssertionError('the plan asked the device')

    for name in ('get_device_properties', 'device_count', 'is_available'):
        monkeypatch.setattr(torch.cuda, name, no_device)


def test_nhwc_plan_is_a_function_of_the_shape(monkeypatch):
    _no_device(monkeypatch)
    shape = (8, 256, 256, 1, 16, 3, 3, SAME3, 4)
    SN.plan.cache_clear()
    first = SN.plan(*shape)
    SN.plan.cache_clear()
    assert SN.plan(*shape) == first
    # the encoder at B=8: two rows a tile, two pixels a thread, its output
    # as chunks
    assert first == SN.Plan(rows=2, px=2, gpr=128, sw=258, in_row=260,
                            vec_out=True, tiles=1024, smem=first.smem)


# -- the NCHW forward's tile ---------------------------------------------------
# (b, ci, co, h, w, kh, kw, pads): unet.yaml + leakyReLU.yaml's nine stencil
# sites (down_2.conv_0 is also unet.yaml + bf16.yaml's) at B=8 and 64, then
# ragged shapes: odd H and W, VALID, asymmetric pads, 1 x 3, 5 x 5, 2 x 2,
# a padded 1 x 1, 32 channels, B=1, a 1 x 1 image
LEAKY_SITES = [  # (ci, co, size) of down_0-2 and up_1-2
    (5, 3, 256), (3, 3, 256), (3, 6, 128), (6, 6, 128), (6, 12, 64),
    (12, 6, 128), (6, 6, 128), (6, 3, 256), (3, 3, 256)]
NCHW_SHAPES = [(b, ci, co, s, s, 3, 3, SAME3)
               for b in (8, 64) for ci, co, s in LEAKY_SITES] + [
    (1, 3, 3, 37, 53, 3, 3, SAME3), (2, 4, 6, 19, 23, 3, 3, ((0, 2), (1, 0))),
    (2, 3, 4, 12, 13, 3, 3, ZERO), (2, 3, 5, 17, 21, 1, 3, ((0, 0), (1, 1))),
    (2, 5, 7, 19, 23, 5, 5, ((2, 2), (2, 2))),
    (3, 2, 3, 10, 12, 2, 2, ((1, 0), (0, 1))),
    (2, 3, 4, 10, 10, 1, 1, ((2, 2), (1, 1))),
    (2, 32, 32, 8, 8, 3, 3, SAME3), (1, 6, 12, 64, 64, 3, 3, SAME3),
    (1, 1, 1, 1, 1, 3, 3, SAME3), (2, 3, 16, 9, 30, 3, 3, SAME3),
]


def _nchw_items(pl, co, ow):
    """(group, row, first column, half) of each lane's work item of a tile,
    with the kernel's mapping: with ks = 2 lane l < 16 of a warp's 32 and
    lane l + 16 share item 16 w + l, the first and the second half of the
    input channels; an item it -> g = it // per_g; the row pair index
    fastest where ri = 2, then the runs of a row, then the rows. Only the
    lanes of a live item are returned."""
    runs = -(-ow // pl.px)
    per_g = pl.rows * runs
    items = -(-co // pl.cpt) * per_g
    if pl.ks == 2:
        w0 = np.arange(-(-items // 16) * 32)
        half, it = (w0 >> 4) & 1, (w0 >> 5) * 16 + (w0 & 15)
    else:
        it = np.arange(items)
        half = np.zeros_like(it)
    live = it < items
    it, half = it[live], half[live]
    g, rem = it // per_g, it % per_g
    rl, t = rem % pl.ri, rem // pl.ri
    r = t // runs * pl.ri + rl
    return g, r, t % runs * pl.px, half


def _window(pl, kw):
    """Staged values a work item reads a kernel row: the kernel's float4
    window where it unrolls a 3-wide row, else its taps."""
    if kw == 3:
        return 4 * -(-(pl.px + kw - 1) // 4)
    return pl.px + kw - 1


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', NCHW_SHAPES)
def test_nchw_tile_plan_covers_each_output_once(b, ci, co, h, w, kh, kw,
                                                pads):
    pl = SC.plan(b, ci, co, h, w, kh, kw, pads)
    oh, ow = _out_hw(h, w, kh, kw, pads)
    assert pl.tiles_y == -(-oh // pl.rows) and pl.blocks == b * pl.tiles_y
    g, r, col, half = _nchw_items(pl, co, ow)
    # the halves of an item: both lanes, the first stores
    assert pl.ks in (1, 2) and (half.sum() == 0 or pl.ks == 2)
    if pl.ks == 2:
        assert (np.sort(g[half == 0]) == np.sort(g[half == 1])).all()
    cover = np.zeros((co, pl.tiles_y * pl.rows, ow), np.int64)
    for p in range(pl.px):
        for o in range(pl.cpt):
            ch, x = g * pl.cpt + o, col + p
            keep = (ch < co) & (x < ow) & (half == 0)
            for ty in range(pl.tiles_y):
                np.add.at(cover, (ch[keep], ty * pl.rows + r[keep], x[keep]),
                          1)
    assert (cover[:, :oh] == 1).all()
    # every row a tile's items name exists; the rows past OH are skipped
    assert r.max() < pl.rows
    # taps: staged row r + ky < rows + kh - 1; the window of the last run
    # inside the staged columns, the columns inside the row stride
    assert r.max() + kh - 1 < pl.rows + kh - 1
    assert col.max() + _window(pl, kw) <= pl.cols <= pl.xs_w
    assert pl.cols >= -(-ow // pl.px) * pl.px + kw - 1
    # 16-byte aligned rows, 4 mod 8 floats apart; runs from a multiple of 4
    assert pl.xs_w % 8 == 4 and (col % 4 == 0).all()
    assert (pl.cpt, pl.px) in SC.TILES
    assert pl.ri == (2 if pl.px == 8 and pl.rows % 2 == 0 else 1)


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', NCHW_SHAPES[:14:3])
def test_nchw_tile_split_covers_each_output_once(b, ci, co, h, w, kh, kw,
                                                 pads):
    '''Each site with the other lanes-an-item than the rule's: every output
    still stored once, by the first lane of its item.'''
    ks = 3 - SC.plan(b, ci, co, h, w, kh, kw, pads).ks
    pl = SC.plan(b, ci, co, h, w, kh, kw, pads, ks=ks)
    oh, ow = _out_hw(h, w, kh, kw, pads)
    g, r, col, half = _nchw_items(pl, co, ow)
    cover = np.zeros((co, pl.rows, ow), np.int64)
    for p in range(pl.px):
        for o in range(pl.cpt):
            ch, x = g * pl.cpt + o, col + p
            keep = (ch < co) & (x < ow) & (half == 0)
            np.add.at(cover, (ch[keep], r[keep], x[keep]), 1)
    assert (cover == 1).all()


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', NCHW_SHAPES)
def test_nchw_tile_plan_shared_memory(b, ci, co, h, w, kh, kw, pads):
    pl = SC.plan(b, ci, co, h, w, kh, kw, pads)
    oh, ow = _out_hw(h, w, kh, kw, pads)
    w_row = -(-co // pl.cpt) * (-(-pl.cpt // 4) * 4)
    assert pl.smem == 4 * (ci * kh * kw * w_row + w_row
                           + ci * (pl.rows + kh - 1) * pl.xs_w)
    assert pl.smem <= SC.TILE_BYTES or pl.rows == 1
    assert pl.smem <= MAX
    assert SC.route(ci, co, kh, kw, pads, h, w) == (
        'pointwise' if (kh, kw, pads) == (1, 1, ZERO) else 'tile')
    # one work item a thread (two where ks = 2), in whole warps
    items = -(-co // pl.cpt) * pl.rows * -(-ow // pl.px)
    lanes = -(-items // 16) * 32 if pl.ks == 2 else items
    assert lanes <= SC.THREADS or pl.rows == 1
    assert pl.threads == min(SC.THREADS, -(-lanes // 32) * 32)
    # rows: the most that keep one item a thread and TILE_BYTES; one more
    # breaks one of them
    assert 1 <= pl.rows <= min(oh, SC.MAX_ROWS)
    nxt = pl.rows + (2 if pl.px == 8 else 1)
    if nxt <= min(oh, SC.MAX_ROWS):
        more = SC.plan(b, ci, co, h, w, kh, kw, pads, rows=nxt)
        more_items = -(-co // pl.cpt) * nxt * -(-ow // pl.px)
        assert ((-(-more_items // 16) * 32 if pl.ks == 2 else more_items)
                > SC.THREADS or more.smem > SC.TILE_BYTES)
    # the work item: at most MAX_SUMS sums, the most that leave MIN_WARPS
    # warps an SM; two lanes an item where they leave fewer than
    # SPLIT_WARPS
    assert pl.cpt * pl.px <= SC.MAX_SUMS
    assert (pl.cpt, pl.px, pl.ks) == SC.tile_rule(b, ci, co, oh, ow)
    base = SC.tile_item(b, co, oh, ow)
    warps = (b * oh * -(-ow // base[1]) * -(-co // base[0])
             / (32 * SC.SMS))
    assert pl.ks == (2 if ci >= 4 and warps < SC.SPLIT_WARPS else 1)
    assert (pl.cpt, pl.px) == base or pl.ks == 2


def test_nchw_tile_groups_at_the_sites():
    """Exact channel groups at every site: no FMA multiplies padding."""
    for ci, co, s in LEAKY_SITES:
        pl = SC.plan(8, ci, co, s, s, 3, 3, SAME3)
        assert co % pl.cpt == 0 and pl.cpt in (3, 6)
    # blocks of 256 threads, one work item each, at every site
    for b in (8, 64):
        for ci, co, s in LEAKY_SITES:
            assert SC.plan(b, ci, co, s, s, 3, 3, SAME3).threads == 256


@pytest.mark.parametrize('b,ci,co,oh,ow,want', [
    (8, 6, 12, 64, 64, (3, 8, 2)),    # down_2.conv_0, B=8: two lanes
    (64, 6, 12, 64, 64, (6, 4, 1)),   # at B=64: 24 sums, the wider group
    (8, 6, 6, 128, 128, (3, 8, 2)), (8, 12, 6, 128, 128, (3, 8, 2)),
    (8, 3, 6, 128, 128, (6, 4, 1)),   # three channels: no split
    (8, 5, 3, 256, 256, (3, 8, 1)),   # enough warps: no split
    (1, 4, 13, 8, 8, (4, 4, 2)),      # a padded group, few pixels
    (64, 8, 16, 256, 256, (4, 4, 1)),
])
def test_nchw_tile_rule(b, ci, co, oh, ow, want):
    assert SC.tile_rule(b, ci, co, oh, ow) == want


@pytest.mark.parametrize('ci,co,kh,kw,pads,h,w', [
    (6, 12, 3, 3, SAME3, 64, 64),
    (3, 3, 3, 3, SAME3, 4, 8192),     # one 8192-wide row: 101 KB, the tile
    (32, 32, 3, 3, SAME3, 8, 8192),   # 32 channels of it: 3.1 MB, direct
    (32, 1, 1, 1, ZERO, 8192, 8192),  # past the pointwise offsets, direct
    (32, 32, 7, 7, SAME3, 16, 16),    # 200 KB of weights, direct
    (3, 1, 1, 1, ((0, 1), (0, 0)), 256, 256),
])
def test_nchw_route_direct_only_where_the_tile_cannot_fit(ci, co, kh, kw,
                                                          pads, h, w):
    got = SC.route(ci, co, kh, kw, pads, h, w)
    one_row = SC.plan(1, ci, co, h, w, kh, kw, pads, rows=1)
    if (kh, kw, pads) == (1, 1, ZERO) and max(ci, co) * h * w < 2**31:
        assert got == 'pointwise'
    else:
        assert got == ('stencil' if one_row.smem > MAX else 'tile')


def _fake_launch(monkeypatch):
    """Capture stencil_conv's launches on the meta device: (entry, args)."""
    calls = []
    monkeypatch.setattr(_build, 'check_cuda',
                        lambda dtype, **t: torch.device('meta'))
    monkeypatch.setattr(_build, 'stream_of', lambda device: 0)
    monkeypatch.setattr(_build, 'launch',
                        lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize('shape', [s for s in NCHW_SHAPES if s[0] < 64]
                         + [(1, 32, 32, 8, 8192, 3, 3, SAME3)])
def test_nchw_route_and_plan_identical_in_f32_and_bf16(monkeypatch, shape):
    """Both forms launch the same route with the same plan: the tile's
    entries take the same ints in f32 and bf16."""
    calls = _fake_launch(monkeypatch)
    b, ci, co, h, w, kh, kw, pads = shape
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.empty((b, ci, h, w), device='meta', dtype=dtype)
        wk = torch.empty((co, ci, kh, kw), device='meta', dtype=dtype)
        bias = torch.empty((co,), device='meta', dtype=dtype)
        SC.stencil_conv(x, wk, bias, pads, True)
    (f32, a32), (bf, a16) = calls
    assert bf == f32 + '_bf16' and a32 == a16
    kind = SC.route(ci, co, kh, kw, pads, h, w)
    assert f32 == {'pointwise': 'dnnca_pointwise_conv',
                   'tile': 'dnnca_stencil_conv_tile',
                   'stencil': 'dnnca_stencil_conv'}[kind]
    assert len(a32) == len(_build._SIGNATURES[f32])


def _emulate_nchw(x, wk, bias, pads, relu, ks):
    """The tile kernel's indexing in numpy (f64): the weights in group slots
    (zero in the padding), then per block the staged rows [Ci][rows + kh -
    1][xs_w] (zero outside the image, NaN past the staged columns, so a
    read there shows), each work item's window of a kernel row and its sums
    by (c, ky, kx), and its stores (each output written once)."""
    b, ci, h, wd = x.shape
    co, _, kh, kw = wk.shape
    pl = SC.plan(b, ci, co, h, wd, kh, kw, pads, ks=ks)
    (pt, _), (pll, _) = pads
    oh, ow = _out_hw(h, wd, kh, kw, pads)
    cp = -(-pl.cpt // 4) * 4
    groups = -(-co // pl.cpt)
    ws = np.zeros((ci, kh * kw, groups * cp))
    for o in range(co):
        ws[:, :, o // pl.cpt * cp + o % pl.cpt] = wk[o].reshape(ci, -1)
    bs = np.zeros(groups * cp)
    for o in range(co):
        bs[o // pl.cpt * cp + o % pl.cpt] = bias[o]
    out = np.full((b, co, oh, ow), np.nan)
    g, r, col, half = _nchw_items(pl, co, ow)
    nwin = _window(pl, kw)
    c_mid = (ci + 1) // 2 if pl.ks == 2 else ci
    for blk in range(pl.blocks):
        bb, y0 = blk // pl.tiles_y, blk % pl.tiles_y * pl.rows
        xs = np.full((ci, pl.rows + kh - 1, pl.xs_w), np.nan)
        for rr in range(pl.rows + kh - 1):
            for d in range(pl.cols):
                iy, ix = y0 - pt + rr, d - pll
                xs[:, rr, d] = (x[bb, :, iy, ix] if 0 <= iy < h and
                                0 <= ix < wd else 0.0)
        sums = {}
        for gi, ri, ci0, hf in zip(g, r, col, half):
            gy = y0 + ri
            if gy >= oh:
                continue
            acc = (np.zeros((pl.px, pl.cpt)) if hf else
                   np.tile(bs[gi * cp:gi * cp + pl.cpt], (pl.px, 1)))
            for c in (range(c_mid, ci) if hf else range(c_mid)):
                for ky in range(kh):
                    win = xs[c, ri + ky, ci0:ci0 + nwin]
                    assert len(win) == nwin
                    for kx in range(kw):
                        wv = ws[c, ky * kw + kx, gi * cp:gi * cp + pl.cpt]
                        acc += np.outer(win[kx:kx + pl.px], wv)
            key = (gi, ri, ci0)
            sums[key] = sums.get(key, 0) + acc   # the shuffle's add
        for (gi, ri, ci0), acc in sums.items():
            gy = y0 + ri
            if relu:
                acc = np.maximum(acc, 0)
            for o in range(pl.cpt):
                if gi * pl.cpt + o >= co:
                    break
                n = min(pl.px, ow - ci0)
                assert np.isnan(out[bb, gi * pl.cpt + o, gy,
                                    ci0:ci0 + n]).all()
                out[bb, gi * pl.cpt + o, gy, ci0:ci0 + n] = acc[:n, o]
    return out


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads,relu', [
    (2, 5, 3, 9, 16, 3, 3, SAME3, False),    # runs of 8, row pairs
    (1, 6, 12, 7, 12, 3, 3, SAME3, True),    # two groups of 6
    (2, 3, 6, 6, 10, 3, 3, ((0, 2), (1, 0)), False),   # OW % 4 != 0
    (1, 4, 5, 5, 7, 3, 3, ZERO, True),       # VALID, a padded group
    (1, 3, 4, 4, 9, 1, 3, ((0, 0), (1, 1)), False),   # 1 x 3
    (1, 2, 7, 7, 9, 5, 5, ((2, 2), (2, 2)), False),   # 5 x 5, scalar reads
    (2, 3, 2, 5, 6, 2, 2, ((1, 0), (0, 1)), True),
    (1, 3, 1, 4, 5, 1, 1, ((1, 0), (0, 1)), True),    # a padded 1 x 1
    (1, 2, 16, 3, 6, 3, 3, SAME3, False),    # groups of 8
])
@pytest.mark.parametrize('ks', [1, 2])
def test_nchw_tile_emulation_matches_plain(b, ci, co, h, w, kh, kw, pads,
                                           relu, ks):
    rng = np.random.default_rng(ci * 11 + co)
    x = rng.standard_normal((b, ci, h, w))
    wk = rng.standard_normal((co, ci, kh, kw))
    bias = rng.standard_normal(co)
    got = _emulate_nchw(x, wk, bias, pads, relu, ks)
    want = SC.plain(torch.from_numpy(x), torch.from_numpy(wk),
                    torch.from_numpy(bias), pads, relu).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_nchw_tile_plan_is_a_function_of_the_shape(monkeypatch):
    _no_device(monkeypatch)
    shape = (8, 6, 12, 64, 64, 3, 3, SAME3)
    SC.plan.cache_clear()
    first = SC.plan(*shape)
    SC.plan.cache_clear()
    assert SC.plan(*shape) == first
    # down_2.conv_0 at B=8: groups of 3, runs of 8 on row pairs, two lanes
    # an item, four rows a tile, 128 blocks of 256 threads
    assert first == SC.Plan(cpt=3, px=8, ri=2, ks=2, rows=4, tiles_y=16,
                            blocks=128, threads=256, cols=68, xs_w=68,
                            smem=first.smem)


# -- the NCHW backward's one-launch tile ----------------------------------------
# (b, ci, co, h, w, kh, kw, pads): down_2's first conv under bf16.yaml, then
# the gpu tests' shapes: asymmetric pads, 1 x 3, 5 x 5, 32 channels, B=1,
# more and fewer output rows than input rows
BWD_SHAPES = [
    (8, 6, 12, 64, 64, 3, 3, SAME3), (2, 4, 6, 19, 23, 3, 3, ((0, 2), (1, 0))),
    (2, 3, 5, 17, 21, 1, 3, ((0, 0), (1, 1))),
    (2, 5, 7, 19, 23, 5, 5, ((2, 2), (2, 2))),
    (2, 32, 32, 8, 8, 3, 3, SAME3), (1, 6, 12, 64, 64, 3, 3, SAME3),
    (2, 3, 4, 10, 10, 1, 1, ((2, 2), (1, 1))), (2, 3, 4, 12, 13, 3, 3, ZERO),
    (3, 2, 3, 10, 12, 2, 2, ((1, 0), (0, 1))),
    (64, 6, 12, 64, 64, 3, 3, SAME3), (1, 1, 1, 1, 1, 3, 3, SAME3),
]


def _halo(ci, co, h, w, kh, kw, pads, rows):
    '''The kernel's staged ranges: (g_lo, gc_lo, gr, gw) of g, (xr, xw) of
    x.'''
    (pt, pb), (pl, pr) = pads
    oh, ow = _out_hw(h, w, kh, kw, pads)
    g_lo, gc_lo = min(0, pt - kh + 1), min(0, pl - kw + 1)
    return (g_lo, gc_lo, rows + pt - g_lo,
            max(ow - 1, w - 1 + pl) - gc_lo + 1, rows + kh - 1, ow + kw - 1)


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', BWD_SHAPES)
def test_bwd_tile_plan_covers_each_pixel_once(b, ci, co, h, w, kh, kw, pads):
    '''The blocks' tiles (block k takes tiles k * per_block .. ; tile t is
    image t // tiles_y, rows from (t % tiles_y) * rows) cover every input
    row (dx) and every output row (dw) of every image exactly once, every
    block at least one tile but the padding of the last cluster; each tap
    of dx reads a staged g pixel and each of dw a staged x pixel.'''
    pl = SCB.tile_plan(b, ci, co, h, w, kh, kw, pads)
    (pt, _), (pll, _) = pads
    oh, ow = _out_hw(h, w, kh, kw, pads)
    assert pl.tiles_y == -(-max(h, oh) // pl.rows)
    assert pl.tiles == b * pl.tiles_y
    dx_rows = np.zeros((b, h), np.int64)
    dw_rows = np.zeros((b, oh), np.int64)
    for blk in range(pl.blocks):
        t0 = blk * pl.per_block
        t1 = min(pl.tiles, t0 + pl.per_block)
        assert t1 > t0 or blk >= pl.blocks - pl.cluster + 1, \
            'a block without a tile outside the last cluster'
        for t in range(t0, t1):
            bb, r0 = t // pl.tiles_y, t % pl.tiles_y * pl.rows
            dx_rows[bb, r0:min(h, r0 + pl.rows)] += 1
            dw_rows[bb, r0:min(oh, r0 + pl.rows)] += 1
    assert (dx_rows == 1).all() and (dw_rows == 1).all()
    assert pl.blocks <= SCB.MAX_TILE_BLOCKS + pl.cluster - 1
    assert 1 <= pl.cluster <= SCB.CLUSTER and pl.blocks % pl.cluster == 0
    g_lo, gc_lo, gr, gw, xr, xw = _halo(ci, co, h, w, kh, kw, pads, pl.rows)
    ly, ix = np.arange(pl.rows)[:, None], np.arange(w)[None, :]
    for ky in range(kh):
        for kx in range(kw):
            grow = ly + pt - ky - g_lo
            gcol = ix + pll - kx - gc_lo
            assert grow.min() >= 0 and grow.max() < gr
            assert gcol.min() >= 0 and gcol.max() < gw
            # dw: output pixel (ly, ox) reads staged x (ly + ky, ox + kx)
            assert pl.rows - 1 + ky < xr and ow - 1 + kx < xw
    # dw reads staged g at (ly - g_lo, ox - gc_lo)
    assert pl.rows - 1 - g_lo < gr and ow - 1 - gc_lo < gw


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', BWD_SHAPES)
def test_bwd_tile_plan_shared_memory_and_scratch(b, ci, co, h, w, kh, kw,
                                                 pads):
    pl = SCB.tile_plan(b, ci, co, h, w, kh, kw, pads)
    n = co * ci * kh * kw + co
    assert pl.n2 % 2 == 0 and pl.n2 - n in (0, 1)
    # dw's work units: (channel, kernel row, up to KX taps), then the bias
    assert pl.units == ci * kh * -(-kw // SCB.KX) + 1
    dw_threads = SCB.TILE_THREADS - SCB.DX_THREADS
    assert pl.per_pass == min(pl.units, dw_threads)
    assert pl.slices * pl.per_pass <= dw_threads
    cib, cob = (next(c for c in (4, 8, 16, 32) if v <= c) for v in (ci, co))
    g_lo, gc_lo, gr, gw, xr, xw = _halo(ci, co, h, w, kh, kw, pads, pl.rows)
    floats = (kh * kw * cob * cib + gr * gw * cob + ci * xr * xw
              + pl.slices * pl.per_pass * SCB.KX * cob)
    layout = 4 * (-(-floats // 4) * 4) + 8 * n
    clusters = pl.blocks // pl.cluster
    assert pl.smem == max(layout, 16 * -(-clusters // SCB.CHUNK))
    assert SCB.route(b, ci, co, h, w, kh, kw, pads) == 'tile'
    assert pl.smem <= MAX
    # one f64 partial of n2 items a cluster, kept per device and size
    scratch = SCB.scratch(torch.device('cpu'), clusters * pl.n2)
    assert scratch.dtype == torch.float64
    assert scratch.numel() == clusters * pl.n2
    assert SCB.scratch(torch.device('cpu'), clusters * pl.n2) is scratch


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads,want', [
    (8, 6, 12, 64, 64, 3, 3, SAME3, 'tile'),
    (8, 3, 1, 256, 256, 1, 1, ZERO, 'pointwise'),          # the head
    (2, 3, 1, 16, 16, 1, 1, ((0, 1), (0, 0)), 'tile'),     # padded 1 x 1
    (2, 32, 32, 20, 24, 7, 7, ((3, 3), (3, 3)), 'split'),  # 400 KB partial
    (2, 32, 32, 256, 256, 3, 3, SAME3, 'split'),           # wide rows
    (2, 32, 32, 8, 8, 3, 3, SAME3, 'tile'),
    (2, 32, 32, 24, 40, 3, 3, SAME3, 'split'),
    (2, 32, 32, 64, 64, 3, 3, SAME3, 'split'),
])
def test_bwd_route_split_only_where_the_tile_does_not_fit(
        b, ci, co, h, w, kh, kw, pads, want):
    got = SCB.route(b, ci, co, h, w, kh, kw, pads)
    assert got == want
    if got != 'pointwise':
        one_row = SCB.tile_plan(b, ci, co, h, w, kh, kw, pads, rows=1)
        assert (got == 'split') == (one_row.smem > MAX)


def _swizzle(p, cc):
    '''The kernel's chunk order inside a staged g pixel.'''
    return {2: (p >> 2) & 1, 4: (p >> 1) & 3, 8: p & 7}.get(cc, 0)


def _emulate_bwd(x, g, w, pads):
    '''The tile kernel's indexing in numpy (f64): per tile the staged g
    (with dx's halo, as [pixel][CO] swizzled chunks) and x (with dw's
    halo), dx from the staged g, dw and db over the tile's output pixels
    into the block's partial, the blocks' partials added in order within
    each cluster and the clusters' in order.'''
    b, ci, h, wd = x.shape
    co, _, kh, kw = w.shape
    pl = SCB.tile_plan(b, ci, co, h, wd, kh, kw, pads)
    (pt, _), (pll, _) = pads
    oh, ow = _out_hw(h, wd, kh, kw, pads)
    g_lo, gc_lo, gr, gw, xr, xw = _halo(ci, co, h, wd, kh, kw, pads, pl.rows)
    cob = next(c for c in (4, 8, 16, 32) if co <= c)
    gc = cob // 4
    dx = np.full(x.shape, np.nan)
    partials = np.zeros((pl.blocks, pl.n2))
    for blk in range(pl.blocks):
        for t in range(blk * pl.per_block,
                       min(pl.tiles, (blk + 1) * pl.per_block)):
            bb, r0 = t // pl.tiles_y, t % pl.tiles_y * pl.rows
            gs = np.zeros(gr * gw * cob)
            for o in range(cob):
                for p in range(gr * gw):
                    oy, ox = r0 + g_lo + p // gw, gc_lo + p % gw
                    if o < co and 0 <= oy < oh and 0 <= ox < ow:
                        q = (o >> 2) ^ _swizzle(p, gc)
                        gs[4 * (p * gc + q) + (o & 3)] = g[bb, o, oy, ox]
            xs = np.zeros((ci, xr, xw))
            for r in range(xr):
                for col in range(xw):
                    iy, ix = r0 - pt + r, col - pll
                    if 0 <= iy < h and 0 <= ix < wd:
                        xs[:, r, col] = x[bb, :, iy, ix]

            def gvec(p):
                s = _swizzle(p, gc)
                return np.concatenate([gs[4 * (p * gc + (q ^ s)):][:4]
                                       for q in range(gc)])[:co]
            for ly in range(max(0, min(pl.rows, h - r0))):
                for ix in range(wd):
                    acc = np.zeros(ci)
                    for ky in range(kh):
                        for kx in range(kw):
                            p = ((ly + pt - ky - g_lo) * gw
                                 + ix + pll - kx - gc_lo)
                            acc += gvec(p) @ w[:, :, ky, kx]
                    dx[bb, :, r0 + ly, ix] = acc
            n_w = co * ci * kh * kw
            for ly in range(max(0, min(pl.rows, oh - r0))):
                for ox in range(ow):
                    gv = gvec((ly - g_lo) * gw + ox - gc_lo)
                    patch = xs[:, ly:ly + kh, ox:ox + kw]
                    partials[blk, :n_w] += np.einsum(
                        'o,ckl->ockl', gv, patch).reshape(-1)
                    partials[blk, n_w:n_w + co] += gv
    clusters = partials.reshape(-1, pl.cluster, pl.n2).sum(1)
    dwb = clusters.sum(0)
    n_w = co * ci * kh * kw
    return dx, dwb[:n_w].reshape(co, ci, kh, kw), dwb[n_w:n_w + co]


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', [
    (2, 2, 3, 7, 6, 3, 3, SAME3),
    (1, 3, 5, 6, 7, 3, 3, ((0, 2), (1, 0))),
    (2, 1, 6, 5, 6, 1, 3, ((0, 0), (1, 1))),
    (1, 2, 2, 4, 5, 1, 1, ((2, 2), (1, 1))),    # more output rows than input
    (1, 2, 9, 6, 7, 3, 3, ZERO),                # fewer
])
def test_bwd_tile_emulation_matches_plain(b, ci, co, h, w, kh, kw, pads):
    rng = np.random.default_rng(ci * 11 + co)
    oh, ow = _out_hw(h, w, kh, kw, pads)
    x = rng.standard_normal((b, ci, h, w))
    g = rng.standard_normal((b, co, oh, ow))
    wk = rng.standard_normal((co, ci, kh, kw))
    got = _emulate_bwd(x, g, wk, pads)
    want = SCB.plain(*(torch.from_numpy(a) for a in (x, g, wk)), pads)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a, c.numpy(), rtol=1e-10, atol=1e-10)


def test_bwd_tile_plan_is_a_function_of_the_shape(monkeypatch):
    _no_device(monkeypatch)
    shape = (8, 6, 12, 64, 64, 3, 3, SAME3)
    SCB.tile_plan.cache_clear()
    first = SCB.tile_plan(*shape)
    SCB.tile_plan.cache_clear()
    assert SCB.tile_plan(*shape) == first
    # down_2's first conv at B=8: four rows a tile, one tile a block, 64
    # clusters of 2, 19 work units in 20 slices
    assert first == SCB.TilePlan(rows=4, tiles_y=16, tiles=128, per_block=1,
                                 blocks=128, cluster=2, units=19,
                                 per_pass=19, slices=20, n2=660,
                                 smem=first.smem)


def _entries():
    '''{name: [pointer or int, ...]} of every ``extern "C" int`` entry point
    in csrc/*.cu, from its parameter list.'''
    import glob
    import os
    import re
    out = {}
    for path in glob.glob(os.path.join(_build.CSRC_DIR, '*.cu')):
        text = open(path).read()
        for m in re.finditer(r'extern "C" int (dnnca_\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(',') if p.strip()]
            out[m.group(1)] = ['p' if '*' in p else 'i' for p in params]
    return out


def test_ctypes_signatures_match_the_entry_points():
    '''Each entry point's ctypes argtypes list a pointer where its C
    parameter list has one and an int where it has one: ctypes passes an
    argument past the argtypes as a 32-bit int, which cuts a pointer.'''
    entries = _entries()
    assert set(_build._SIGNATURES) <= set(entries)
    # the NCHW forward tile's entries, both forms
    assert {'dnnca_stencil_conv_tile',
            'dnnca_stencil_conv_tile_bf16'} <= set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        want = ['p' if t is _build._P else 'i' for t in argtypes]
        assert entries[name] == want, name


def test_leaky_stack_routes_nine_convs_to_the_stencil_tile(monkeypatch):
    '''unet.yaml + leakyReLU.yaml (every conv alone: a chain fuses relu
    only) sends exactly nine convs to stencil_conv on a non-pointwise route
    at a 256 x 256 forward, the tile at each, and the 1 x 1 head to the
    pointwise route; the other three take the library's conv.'''
    import os
    from dnncancerannotator_torch import models as torch_models
    from dnncancerannotator_torch.utils import config as config_lib
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = config_lib.load_config([
        os.path.join(root, 'configs', 'unet.yaml'),
        os.path.join(root, 'configs', 'additionals', 'leakyReLU.yaml')])
    model, _ = torch_models.build_model(
        config['model'], config['model_options'], in_channels=5,
        generator=torch.Generator().manual_seed(0))
    calls = []
    real = SC.stencil_conv

    def spy(x, w, b, pads, relu=False):
        co, ci, kh, kw = w.shape
        calls.append((ci, co, x.shape[-1], SC.route(
            ci, co, kh, kw, SC._pads(pads), *x.shape[2:]), relu))
        return real(x, w, b, pads, relu)

    monkeypatch.setattr(SC, 'stencil_conv', spy)
    with torch.no_grad():
        model(torch.rand(1, 256, 256, 5), return_logits=True)
    sites = [c for c in calls if c[3] != 'pointwise']
    assert sorted(c[:3] for c in sites) == sorted(LEAKY_SITES)
    assert {c[3] for c in sites} == {'tile'}
    assert [c for c in calls if c[3] == 'pointwise'] == [
        (3, 1, 256, 'pointwise', False)]
    assert not any(c[4] for c in calls)   # the leaky relu is its own op
