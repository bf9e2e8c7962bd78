'''The two stencil tiles' plans and routes, computed on the CPU.

The NHWC stencil conv's tile kernel (csrc/stencil_conv_nhwc.cu:
stencil_nhwc_tile_kernel) trusts ``stencil_conv_nhwc.plan``, and the NCHW
stencil backward's one-launch kernel (csrc/stencil_conv_bwd.cu:
stencil_tile_bwd_kernel) trusts ``stencil_conv_bwd.tile_plan``. These
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
    for name, argtypes in _build._SIGNATURES.items():
        want = ['p' if t is _build._P else 'i' for t in argtypes]
        assert entries[name] == want, name
