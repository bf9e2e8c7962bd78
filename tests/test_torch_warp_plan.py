'''The halo-tile route of the two warp resample kernels, computed on the CPU.

The tile kernel (csrc/warp_tile.cuh), shared by warp_twopass and
warp_crop, stages for each step of each block only the image rows within
+-d of the step's output rows and the columns within +-d of its strip, and
trusts ``warp_twopass.plan`` for its launch and shared-memory layout. These
tests hold that: every tap the plain version takes lies in the staged
region of its block and step (flows past +-d, ragged sizes, d >= H, crop
offsets at both ends); the plan's blocks and steps cover every output
pixel once; its layout holds what the kernel puts there and fits a block's
shared memory on the tile route; the ring holds every row in flight; the
route rule; the plan is a function of the shape alone; and an emulation of
the kernel that gathers only from each step's staged region is bit-equal
to ``plain``.
'''

import numpy as np
import pytest
import torch

from dnncancerannotator_torch.ops.kernels import _build
from dnncancerannotator_torch.ops.kernels import warp_crop as WC
from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

# (B, H, W, C, d): the main path's two shapes, ragged sizes that are not
# multiples of the strip or the step, d >= H, narrow and odd channel counts
SHAPES = [(8, 256, 256, 6, 8), (8, 256, 256, 6, 18), (2, 37, 50, 6, 8),
          (1, 64, 64, 3, 3), (3, 70, 130, 1, 5), (4, 16, 16, 6, 40),
          (2, 9, 200, 7, 2), (1, 130, 20, 3, 18), (2, 24, 64, 6, 0)]


def _steps(pl, h, w):
    '''(x0, x1, ya, yb, y0, y1) of every block and step: its strip's
    columns, its segment's rows and the step's rows, as the kernel computes
    them.'''
    for x0 in range(0, w, pl.tw):
        x1 = min(w, x0 + pl.tw)
        for ya in range(0, h, pl.seg):
            yb = min(h, ya + pl.seg)
            for y0 in range(ya, yb, pl.th):
                yield x0, x1, ya, yb, y0, min(yb, y0 + pl.th)


def _region(d, h, w, x0, x1, y0, y1):
    '''(lo, hi, c_lo, c_hi): the rows and columns a step stages.'''
    return (max(0, y0 - d), min(h - 1, y1 + d), max(0, x0 - d),
            min(w - 1, x1 + d))


def _flows(gen, b, h, w, d, w_fy=None):
    '''Flows past +-d: a random one scaled to 1.5 d, with some values at
    exactly +-d and 0.'''
    scale = 1.5 * max(d, 1)
    fy = torch.from_numpy(gen.standard_normal((b, h, w_fy or w)).astype(
        np.float32) * scale)
    fx = torch.from_numpy(gen.standard_normal((b, h, w)).astype(
        np.float32) * scale)
    fy.view(-1)[::7] = float(d)
    fx.view(-1)[::5] = -float(d)
    fx.view(-1)[::11] = 0.0
    return fy, fx


def _plain_taps(fy_cols, fx, d, h, w):
    '''The plain version's taps: (x_lo, x_hi, [(y_lo, y_hi) at x_lo and at
    x_hi]) of every output pixel [B, H, W]; ``fy_cols(x)`` is fy at frame
    columns x.'''
    gy = torch.arange(h, dtype=torch.float32)[:, None]
    gx = torch.arange(w, dtype=torch.float32)[None, :]
    x_lo, x_hi, _ = WT._taps((gx - fx.clamp(-d, d)).clamp(0.0, w - 1.0), w)
    ys = []
    for xj in (x_lo, x_hi):
        y_lo, y_hi, _ = WT._taps(
            (gy - fy_cols(xj).clamp(-d, d)).clamp(0.0, h - 1.0), h)
        ys.append((y_lo, y_hi))
    return x_lo, x_hi, ys


def _staged_bounds(pl, d, h, w):
    '''[H, W] arrays of each output pixel's step region (lo, hi, c_lo,
    c_hi), and the number of steps that computed it.'''
    lo, hi, c_lo, c_hi, n = (np.zeros((h, w), np.int64) for _ in range(5))
    for x0, x1, _, _, y0, y1 in _steps(pl, h, w):
        r = _region(d, h, w, x0, x1, y0, y1)
        for arr, v in zip((lo, hi, c_lo, c_hi), r):
            arr[y0:y1, x0:x1] = v
        n[y0:y1, x0:x1] += 1
    return lo, hi, c_lo, c_hi, n


def _assert_in_halo(pl, d, h, w, x_lo, x_hi, ys):
    lo, hi, c_lo, c_hi, _ = (torch.from_numpy(a)
                             for a in _staged_bounds(pl, d, h, w))
    for xj in (x_lo, x_hi):
        assert bool(((xj >= c_lo) & (xj <= c_hi)).all())
    for y_lo, y_hi in ys:
        for yj in (y_lo, y_hi):
            assert bool(((yj >= lo) & (yj <= hi)).all())


@pytest.mark.parametrize('b,h,w,c,d', SHAPES)
def test_twopass_taps_lie_in_the_staged_halo(b, h, w, c, d):
    gen = np.random.default_rng(h * 7 + w + d)
    nb = min(b, 2)
    fy, fx = _flows(gen, nb, h, w, d)
    x_lo, x_hi, ys = _plain_taps(
        lambda xj: torch.gather(fy, 2, xj), fx, float(d), h, w)
    _assert_in_halo(WT.plan(b, h, w, c, d), d, h, w, x_lo, x_hi, ys)


@pytest.mark.parametrize('b,h,w,c,d', SHAPES)
@pytest.mark.parametrize('margin', [(0, 0), (12, 12), (5, 31)])
@pytest.mark.parametrize('at', ['zero', 'far'])
def test_crop_taps_lie_in_the_staged_halo(b, h, w, c, d, margin, at):
    '''In the window's frame: fy_ext read at ox + j and the image at
    (oy + r, ox + j) lie within the step's region shifted by the offset,
    at offsets 0 and in - out (and past them: the kernel clamps them).'''
    gen = np.random.default_rng(h + w * 3 + d + margin[0])
    nb = min(b, 2)
    h_in, w_in = h + margin[0], w + margin[1]
    fy_ext, fx = _flows(gen, nb, h, w, d, w_fy=w_in)
    raw = (0, 0) if at == 'zero' else (margin[0] + 3, margin[1] + 3)
    off = torch.tensor([raw] * nb, dtype=torch.int32)
    oy, ox = WC._offsets(off, (h_in, w_in), (h, w))
    x_lo, x_hi, ys = _plain_taps(
        lambda xj: torch.gather(fy_ext, 2, ox + xj), fx, float(d), h, w)
    pl = WC.plan(b, h, w, c, d)
    _assert_in_halo(pl, d, h, w, x_lo, x_hi, ys)
    # the same in the window's frame, against the offset region
    lo, hi, c_lo, c_hi, _ = (torch.from_numpy(a)
                             for a in _staged_bounds(pl, d, h, w))
    for xj in (x_lo, x_hi):
        assert bool(((ox + xj >= ox + c_lo) & (ox + xj <= ox + c_hi)
                     & (ox + xj < w_in)).all())
    for y_lo, y_hi in ys:
        for yj in (y_lo, y_hi):
            assert bool(((oy + yj >= oy + lo) & (oy + yj <= oy + hi)
                         & (oy + yj < h_in)).all())


@pytest.mark.parametrize('b,h,w,c,d', SHAPES)
def test_steps_cover_every_pixel_once(b, h, w, c, d):
    pl = WT.plan(b, h, w, c, d)
    assert pl.grid == (-(-w // pl.tw), -(-h // pl.seg), b)
    assert pl.th * pl.tw >= 1 and pl.seg % pl.th == 0
    _, _, _, _, n = _staged_bounds(pl, d, h, w)
    assert (n == 1).all()
    # the threads of a step take pixels q < rows * tw, dropping x >= W
    for x0, x1, _, _, y0, y1 in _steps(pl, h, w):
        q = np.arange((y1 - y0) * pl.tw)
        assert ((x0 + q % pl.tw) < x1).sum() == (y1 - y0) * (x1 - x0)


@pytest.mark.parametrize('b,h,w,c,d', SHAPES + [
    (8, 256, 256, 64, 8), (1, 256, 256, 6, 100), (1, 256, 256, 6, 18)])
def test_shared_memory_layout(b, h, w, c, d):
    '''Each row holds its segment past a lead of up to 3 floats, every row
    and section starts on 16 bytes, the sum is the launch's shared memory,
    and the tile route's fits a block.'''
    pl = WT.plan(b, h, w, c, d)
    s = min(w, pl.tw + 2 * d + 1)
    assert pl.rs % 4 == 0 and pl.rs >= s * c + 3
    assert pl.fs % 8 == 0 and pl.fs // 2 >= s + 3 and pl.fs >= 2 * s + 3
    assert pl.os % 4 == 0 and pl.os >= pl.tw * c + 3
    assert pl.th * pl.tw == WT.THREADS
    assert pl.rb == min(h, 2 * pl.th + 2 * d + 1)
    assert pl.smem == WT.BARRIER_BYTES + 4 * (
        pl.rb * pl.rs + 2 * pl.th * pl.fs + pl.th * pl.os)
    if WT.route(b, h, w, c, d) == 'tile':
        assert pl.smem <= _build.MAX_SMEM_BYTES == WT.SMEM_CAP
        assert c <= WT.MAX_CHANNELS
        # a thread keeps one column: tw a power of two that divides THREADS
        assert pl.tw & (pl.tw - 1) == 0 and WT.THREADS % pl.tw == 0


@pytest.mark.parametrize('b,h,w,c,d', SHAPES)
def test_ring_holds_the_rows_in_flight(b, h, w, c, d):
    '''While step k is computed the ring holds its rows and those staged
    for step k + 1: rows [lo_k, hi_(k + 1)] map to distinct slots r % rb;
    each step stages the rows past the last one's.'''
    pl = WT.plan(b, h, w, c, d)
    for x0 in range(0, w, pl.tw):
        for ya in range(0, h, pl.seg):
            yb = min(h, ya + pl.seg)
            starts = list(range(ya, yb, pl.th))
            hi = [min(h - 1, min(yb, y0 + pl.th) + d) for y0 in starts]
            for k, y0 in enumerate(starts):
                lo = max(0, y0 - d)
                assert hi[min(k + 1, len(hi) - 1)] - lo + 1 <= pl.rb
                first = lo if k == 0 else min(h - 1, y0 + d) + 1
                assert first == (lo if k == 0 else hi[k - 1] + 1)


@pytest.mark.parametrize('shape,want', [
    ((8, 256, 256, 6, 8), 'tile'),     # the banked and fused d = 8 sites
    ((8, 256, 256, 6, 18), 'tile'),    # the fused d = 18 sites
    ((64, 256, 256, 6, 8), 'tile'),
    ((2, 37, 50, 6, 8), 'tile'),
    ((4, 16, 16, 6, 40), 'tile'),      # d >= H: the whole image a block
    ((8, 256, 256, 64, 8), 'direct'),  # the ring does not fit
    ((8, 64, 64, 9, 8), 'direct'),     # past MAX_CHANNELS
    ((1, 256, 256, 6, 100), 'direct'),
    ((1, 256, 256, 6, 18), 'direct'),  # one image: segments of 8 rows
    ((2, 24, 64, 6, -1), 'direct'),    # no +-d halo
])
def test_route(shape, want):
    assert WT.route(*shape) == want
    pl = WT.plan(*shape)
    fits = pl.smem <= WT.SMEM_CAP and pl.reread <= WT.MAX_REREAD
    assert (want == 'tile') == (fits and shape[-1] >= 0
                                and shape[3] <= WT.MAX_CHANNELS)


def test_plan_is_a_function_of_the_shape():
    '''The rule at the main path's shapes: strips of 128 columns (4 rows
    a step); at d = 8 two blocks an SM, 256 of 16 rows; at d = 18 one an
    SM, 128 of 32 rows. The plan is the rule's unless TUNED names
    another, and the same on every call; a TUNED entry overrides it.'''
    for d, want, per_sm in ((8, (128, 16), 2), (18, (128, 32), 1)):
        assert WT.rule(8, 256, 256, 6, d) == want
        assert WT.resident(WT.layout(8, 256, 256, 6, d, *want)) == per_sm
        pl = WT.plan(8, 256, 256, 6, d)
        key = (8, 256, 256, 6, d)
        assert pl == WT.layout(*key, *WT.TUNED.get(key, want))
        assert WC.plan(*key) is pl and WT.plan(*key) is pl
    key = (8, 256, 256, 6, 8)
    saved = WT.TUNED.get(key)
    WT.TUNED[key] = (32, 16)
    WT.plan.cache_clear()
    try:
        assert WT.plan(*key)[:2] == (32, 16)
    finally:
        WT.TUNED.pop(key)
        if saved is not None:
            WT.TUNED[key] = saved
        WT.plan.cache_clear()


def _emulate(image, fy_ext, fx, off, d, pl, h, w):
    '''The tile kernel in PyTorch: per block and step, each output
    pixel's taps computed as the kernel computes them and gathered from a
    copy of that step's staged rows and columns only (an index outside it
    raises). ``fy_ext`` is [B, H, Win] at column ox + j, as warp_crop
    reads it.'''
    nb, h_in, w_in, c = image.shape
    oy, ox = WC._offsets(off, (h_in, w_in), (h, w))
    out = torch.full((nb, h, w, c), float('nan'))
    fd = float(d)
    for b in range(nb):
        frame = image[b, oy[b, 0, 0]:oy[b, 0, 0] + h,
                      ox[b, 0, 0]:ox[b, 0, 0] + w]
        fy = fy_ext[b, :, ox[b, 0, 0]:ox[b, 0, 0] + w]
        for x0, x1, _, _, y0, y1 in _steps(pl, h, w):
            lo, hi, c_lo, c_hi = _region(d, h, w, x0, x1, y0, y1)
            staged = frame[lo:hi + 1, c_lo:c_hi + 1].clone()
            fys = fy[y0:y1, c_lo:c_hi + 1].clone()
            fxs = fx[b, y0:y1, c_lo:c_hi + 1].clone()
            gy = torch.arange(y0, y1, dtype=torch.float32)[:, None]
            gx = torch.arange(x0, x1, dtype=torch.float32)[None, :]
            x_lo, x_hi, rx = WT._taps(
                (gx - fxs[:, x0 - c_lo:x1 - c_lo].clamp(-fd, fd)).clamp(
                    0.0, w - 1.0), w)
            for t in (x_lo - c_lo, x_hi - c_lo):
                assert int(t.min()) >= 0 and int(t.max()) <= c_hi - c_lo

            def column(xj):
                fyj = torch.gather(fys, 1, xj - c_lo)
                y_lo, y_hi, ry = WT._taps(
                    (gy - fyj.clamp(-fd, fd)).clamp(0.0, h - 1.0), h)
                for t in (y_lo - lo, y_hi - lo):
                    assert int(t.min()) >= 0 and int(t.max()) <= hi - lo
                return WT._blend(staged[y_lo - lo, xj - c_lo],
                                 staged[y_hi - lo, xj - c_lo], ry[..., None])

            out[b, y0:y1, x0:x1] = WT._blend(column(x_lo), column(x_hi),
                                             rx[..., None])
    return out


@pytest.mark.parametrize('b,h,w,c,d', [
    (8, 256, 256, 6, 8), (8, 256, 256, 6, 18), (2, 37, 50, 6, 8),
    (4, 16, 16, 6, 40), (2, 9, 200, 7, 2), (3, 70, 130, 1, 5)])
def test_emulation_matches_plain_twopass(b, h, w, c, d):
    '''Two images of the batch at the batch's plan (the plan of an image's
    blocks does not depend on the others).'''
    gen = np.random.default_rng(b + h + w + c + d)
    nb = min(b, 2)
    image = torch.from_numpy(gen.random((nb, h, w, c)).astype(np.float32))
    fy, fx = _flows(gen, nb, h, w, d)
    flow = torch.stack([fy, fx], -1)
    got = _emulate(image, fy, fx, torch.zeros(nb, 2, dtype=torch.int32), d,
                   WT.plan(b, h, w, c, d), h, w)
    assert torch.equal(got, WT.plain(image, flow, d))


@pytest.mark.parametrize('b,h,w,c,d,margin', [
    (8, 256, 256, 6, 8, 12), (8, 256, 256, 6, 18, 12),
    (3, 30, 31, 3, 3, 0), (2, 44, 37, 6, 8, 13)])
def test_emulation_matches_plain_crop(b, h, w, c, d, margin):
    '''Offsets 0, in - out, and one past it (clamped).'''
    gen = np.random.default_rng(b + h + w + c + d + margin)
    nb = 3 if b >= 3 else b
    h_in, w_in = h + margin, w + margin + 1
    image = torch.from_numpy(gen.random((nb, h_in, w_in, c)).astype(
        np.float32))
    fy_ext, fx = _flows(gen, nb, h, w, d, w_fy=w_in)
    off = torch.tensor([(0, 0), (margin, margin + 1),
                        (margin + 4, 2)][:nb], dtype=torch.int32)
    got = _emulate(image, fy_ext, fx, off, d, WC.plan(b, h, w, c, d), h, w)
    assert torch.equal(got, WC.plain(image, fy_ext, fx, off, d))
