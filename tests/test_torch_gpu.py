'''The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: they skip where no CUDA device is visible and run on a GPU
machine with ``python -m pytest tests/test_torch_gpu.py -m gpu
--noconftest`` (tests/conftest.py imports JAX). The CPU-side parity of the
plain versions with the JAX package is in test_torch_kernels.py,
test_torch_chain_bwd.py, test_torch_conv_bwd.py and test_torch_augment.py;
chip_smoke.py repeats these checks at the full main-path shapes.
'''

import pytest
import torch

from chip_smoke import spiral_mask
from dnncancerannotator_torch.ops import kernels
from dnncancerannotator_torch.ops.kernels import cca as CCA
from dnncancerannotator_torch.ops.kernels import conv_chain as CC
from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
from dnncancerannotator_torch.ops.kernels import pool2x2_nhwc as PN
from dnncancerannotator_torch.ops.kernels import pool2x2_nhwc_bwd as PNB
from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC
from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB
from dnncancerannotator_torch.ops.kernels import tconv2x2_nhwc as TN
from dnncancerannotator_torch.ops.kernels import tconv2x2_nhwc_bwd as TNB
from dnncancerannotator_torch.ops.kernels import warp_crop as WC
from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

pytestmark = pytest.mark.gpu
_TOL = 1e-4  # relative to max|ref|: f32 sums in another order
# weight and bias gradients sum over every pixel of the batch (at most
# 2e-6 * max|ref| measured on an H100 at the training shapes, chip_smoke.py)
_W_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dnncancerannotator_torch import engine
    return engine.resolve_device('cuda')   # also turns TF32 off


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen).cuda()


def _assert_close(got, want, tol=_TOL):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


def _assert_grads(got, want):
    '''(dx or None, weight and bias grads...) against the plain version.'''
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        _assert_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        _assert_close(g, w, _W_TOL)


# the six unet.yaml sites (at B=2), then the edge shapes
_CHAIN_SITES = [(5, 3, 3, 256, 256), (3, 6, 6, 128, 128), (6, 12, 12, 64, 64),
                (24, 12, 12, 64, 64), (12, 6, 6, 128, 128),
                (6, 3, 3, 256, 256)]


@pytest.mark.parametrize('ci,cm,co,h,w,k', [
    *[(*site, 3) for site in _CHAIN_SITES],
    (5, 3, 3, 37, 70, 3),     # ragged tiles on both axes
    (24, 12, 12, 16, 16, 3),
    (32, 32, 32, 9, 33, 3),   # widest the kernel takes: padded groups
    (4, 5, 6, 20, 20, 5),     # runtime tap loop
    (7, 5, 6, 21, 19, 5),
])
def test_conv_chain_kernel(cuda, ci, cm, co, h, w, k):
    gen = torch.Generator().manual_seed(0)
    x = _rand(gen, 2, ci, h, w)
    w1, b1 = _rand(gen, cm, ci, k, k) * 0.3, _rand(gen, cm)
    w2, b2 = _rand(gen, co, cm, k, k) * 0.3, _rand(gen, co)
    before = CC.launches
    c1, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True)
    assert CC.launches == before + 1
    p1, p2 = CC.plain(x, w1, b1, w2, b2)
    _assert_close(c1, p1)
    _assert_close(c2, p2)
    _assert_close(CC.conv_chain(x, w1, b1, w2, b2)[1], p2)   # without c1


@pytest.mark.parametrize('ci,co,h,w', [(6, 3, 5, 7), (12, 12, 32, 32),
                                       (64, 64, 4, 4)])
def test_tconv2x2_kernel(cuda, ci, co, h, w):
    gen = torch.Generator().manual_seed(1)
    x, wk, b = _rand(gen, 2, ci, h, w), _rand(gen, ci, co, 2, 2), \
        _rand(gen, co)
    _assert_close(TC.tconv2x2(x, wk, b), TC.plain(x, wk, b))


@pytest.mark.parametrize('ci,co,k,pads,relu', [
    (3, 1, 1, ((0, 0), (0, 0)), False),
    (5, 7, 3, ((1, 1), (1, 1)), True),
    (4, 6, 3, ((0, 2), (1, 0)), False),
])
def test_stencil_conv_kernel(cuda, ci, co, k, pads, relu):
    gen = torch.Generator().manual_seed(2)
    x, wk, b = _rand(gen, 2, ci, 19, 23), _rand(gen, co, ci, k, k), \
        _rand(gen, co)
    _assert_close(SC.stencil_conv(x, wk, b, pads, relu),
                  SC.plain(x, wk, b, pads, relu))


@pytest.mark.parametrize('ci,cm,co,h,w,k,need_dx', [
    *[(*site, 3, need_dx) for site in _CHAIN_SITES
      for need_dx in (False, True)],
    (5, 3, 3, 37, 70, 3, False),   # down_0's class, ragged tiles
    (5, 3, 3, 37, 70, 3, True),    # down_0 with dx (input sensitivity)
    (24, 12, 12, 16, 16, 3, True),
    (12, 6, 6, 33, 20, 3, True),
    (4, 5, 6, 20, 20, 5, True),    # runtime tap loop: dgrad + wgrad.cu
    (4, 5, 6, 20, 20, 5, False),
    (32, 32, 32, 9, 9, 3, True),   # more wgrad items than threads
    (32, 32, 32, 9, 9, 3, False),
])
def test_conv_chain_bwd_kernel(cuda, ci, cm, co, h, w, k, need_dx):
    gen = torch.Generator().manual_seed(3)
    x = _rand(gen, 2, ci, h, w)
    w1, b1 = _rand(gen, cm, ci, k, k) * 0.3, _rand(gen, cm)
    w2, b2 = _rand(gen, co, cm, k, k) * 0.3, _rand(gen, co)
    c1, c2 = CC.plain(x, w1, b1, w2, b2)
    g = _rand(gen, *c2.shape)
    before = CCB.launches
    got = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx)
    assert CCB.launches == before + 1
    # against the f64 plain version: cuDNN's own f32 weight gradient can
    # lie further from it than the tolerance (3->6->6 @128)
    want = CCB.plain(*(t.double() for t in (x, c1, c2, g, w1, w2)), need_dx)
    _assert_grads(got, tuple(w if w is None else w.float() for w in want))
    # dw and db sum their partials in a fixed order: the same bits again
    again = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2, need_dx)
    for a, b in zip(got[1:], again[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('ci,co,h,w,need_dx', [
    (6, 3, 5, 7, True), (12, 12, 32, 32, True), (12, 6, 9, 40, False),
    (64, 64, 4, 4, True)])
def test_tconv2x2_bwd_kernel(cuda, ci, co, h, w, need_dx):
    gen = torch.Generator().manual_seed(4)
    x, wk = _rand(gen, 2, ci, h, w), _rand(gen, ci, co, 2, 2)
    g = _rand(gen, 2, co, 2 * h, 2 * w)
    _assert_grads(TCB.tconv2x2_bwd(x, g, wk, need_dx),
                  TCB.plain(x, g, wk, need_dx))


@pytest.mark.parametrize('ci,co,k,pads', [
    (3, 1, 1, ((0, 0), (0, 0))),      # the logits head
    (5, 7, 3, ((1, 1), (1, 1))),
    (4, 6, 3, ((0, 2), (1, 0))),
])
def test_stencil_conv_bwd_kernel(cuda, ci, co, k, pads):
    gen = torch.Generator().manual_seed(5)
    x, wk = _rand(gen, 2, ci, 19, 23), _rand(gen, co, ci, k, k)
    oh, ow = SC.check(x, wk, torch.zeros(co), pads)
    g = _rand(gen, 2, co, oh, ow)
    _assert_grads(SCB.stencil_conv_bwd(x, g, wk, pads),
                  SCB.plain(x, g, wk, pads))


@pytest.mark.parametrize('b,h,w,c,d,scale', [
    (2, 37, 50, 6, 8, 4.0),
    (1, 64, 64, 3, 3, 10.0),   # flows well past +-d: the clamp
])
def test_warp_twopass_kernel(cuda, b, h, w, c, d, scale):
    gen = torch.Generator().manual_seed(6)
    img = _rand(gen, b, h, w, c)
    flow = _rand(gen, b, h, w, 2) * scale
    got, want = WT.warp_twopass(img, flow, d), WT.plain(img, flow, d)
    torch.cuda.synchronize()
    # rounded, uncontracted blends: the same floats as the plain version
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize('b,h_in,w_in,h_out,w_out,c,d,scale', [
    (2, 44, 50, 32, 37, 6, 8, 4.0),
    (3, 30, 31, 30, 31, 3, 3, 10.0),   # no margin; flows past +-d
    (4, 76, 76, 64, 64, 1, 18, 25.0),
])
def test_warp_crop_kernel(cuda, b, h_in, w_in, h_out, w_out, c, d, scale):
    gen = torch.Generator().manual_seed(10)
    img = _rand(gen, b, h_in, w_in, c)
    fy = _rand(gen, b, h_out, w_in) * scale
    fx = _rand(gen, b, h_out, w_out) * scale
    off = torch.stack([
        torch.randint(0, h_in - h_out + 1, (b,), generator=gen),
        torch.randint(0, w_in - w_out + 1, (b,), generator=gen)], 1)
    off[0] = 0
    off[-1] = torch.tensor([h_in - h_out, w_in - w_out])
    off = off.int().cuda()
    before = WC.launches
    got = WC.warp_crop(img, fy, fx, off, d)
    assert WC.launches == before + 1
    want = WC.plain(img, fy, fx, off, d)
    torch.cuda.synchronize()
    # rounded, uncontracted blends: the same floats as the plain version
    assert torch.equal(got, want), float((got - want).abs().max())


def test_warp_crop_rejects_bad_inputs(cuda):
    img = torch.zeros(1, 10, 10, 2, device=cuda)
    fy, fx = torch.zeros(1, 8, 10, device=cuda), torch.zeros(1, 8, 8,
                                                           device=cuda)
    off = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match='int32'):
        WC.warp_crop(img, fy, fx, off.long(), 8)
    with pytest.raises(ValueError, match='contiguous'):
        WC.warp_crop(img.transpose(1, 2), fy, fx, off, 8)
    with pytest.raises(TypeError, match='float32'):
        WC.warp_crop(img.double(), fy.double(), fx.double(), off, 8)


@pytest.mark.parametrize('case', ['spiral', 'checkerboard', 'full', 'empty',
                                  'noise', 'odd'])
def test_cca_kernel(cuda, case):
    gen = torch.Generator().manual_seed(7)
    h, w = (77, 333) if case == 'odd' else (128, 128)
    ii, jj = torch.meshgrid(torch.arange(h), torch.arange(w), indexing='ij')
    plane = {
        'spiral': torch.from_numpy(spiral_mask(h, w)),
        'checkerboard': (ii + jj) % 2 == 0,
        'full': torch.ones(h, w, dtype=torch.bool),
        'empty': torch.zeros(h, w, dtype=torch.bool),
    }.get(case)
    masks = (torch.rand(3, h, w, generator=gen) < 0.55) if plane is None \
        else plane.expand(3, h, w)
    masks = masks.contiguous().cuda()
    got = CCA.cca_raw_labels(masks)
    torch.cuda.synchronize()
    # integer labels, the same fixed point whatever order the atomics take
    assert torch.equal(got, CCA.plain(masks))


@pytest.mark.parametrize('b,h,w,c,ties', [
    (2, 16, 16, 128, False), (1, 6, 10, 256, True), (2, 4, 8, 4, True)])
def test_pool2x2_nhwc_kernels(cuda, b, h, w, c, ties):
    gen = torch.Generator().manual_seed(8)
    x = _rand(gen, b, h, w, c)
    if ties:   # relu zeros and a tied plane
        x = x.clamp(min=0)
        x[0, :, :, 0] = 0.5
    g = _rand(gen, b, h // 2, w // 2, c)
    before = (PN.launches, PNB.launches)
    got, dx = PN.pool2x2_nhwc(x), PNB.pool2x2_nhwc_bwd(x, g)
    assert (PN.launches, PNB.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    # maxima and g * {1, 0.5, 0.25}: bit for bit
    assert torch.equal(got, PN.plain(x))
    assert torch.equal(dx, PNB.plain(x, g))


@pytest.mark.parametrize('b,h,w,ci,co,need_dx', [
    (2, 8, 8, 128, 128, True),
    (1, 3, 5, 256, 128, True),    # a ragged last row tile
    (2, 4, 4, 128, 256, False),
    (1, 33, 7, 128, 128, True),   # several wgrad chunks, ragged
    (2, 4, 4, 512, 512, True),    # up_0's widths: the dgrad split by phase
    (3, 7, 9, 128, 384, True),    # ragged M, Co = 3 x 128
])
def test_tconv2x2_nhwc_kernels(cuda, b, h, w, ci, co, need_dx):
    '''The 3xTF32 GEMMs against the plain f32 versions, each held to an f64
    plain version too: the kernel no further from it than 4x the plain f32
    version (the dropped small*small term is ~2^-22 of a product), and the
    same bits from two calls (partials added in a fixed order).'''
    gen = torch.Generator().manual_seed(9)
    x, wk, bias = _rand(gen, b, h, w, ci), _rand(gen, ci, co, 2, 2), \
        _rand(gen, co)
    g = _rand(gen, b, 2 * h, 2 * w, co)
    out = TN.tconv2x2_nhwc(x, wk, bias)
    _assert_close(out, TN.plain(x, wk, bias))
    got = TNB.tconv2x2_nhwc_bwd(x, g, wk, need_dx)
    want = TNB.plain(x, g, wk, need_dx)
    _assert_grads(got, want)
    again = TNB.tconv2x2_nhwc_bwd(x, g, wk, need_dx, wpt=TN.pack(wk))
    for a, c in zip(got, again):
        assert (a is None and c is None) or torch.equal(a, c)
    assert torch.equal(out, TN.tconv2x2_nhwc(x, wk, bias, TN.pack(wk)))
    f64 = [t.double() for t in (x, g, wk, bias)]
    exact = (TN.plain(f64[0], f64[2], f64[3]),) + TNB.plain(
        *f64[:3], need_dx)
    for k, p, e in zip((out,) + got, (TN.plain(x, wk, bias),) + want, exact):
        if e is None:
            continue
        err, plain_err = (float((t.double() - e).abs().max()) for t in (k, p))
        assert err <= 4 * plain_err + 1e-7 * float(e.abs().max()), \
            (err, plain_err)


def test_wrappers_reject_non_contiguous_and_f64(cuda):
    x = torch.zeros(1, 3, 8, 8, device=cuda)
    w, b = torch.zeros(1, 3, 1, 1, device=cuda), torch.zeros(1, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        SC.stencil_conv(x.transpose(2, 3), w, b, ((0, 0), (0, 0)))
    with pytest.raises(TypeError, match='float32'):
        SC.stencil_conv(x.double(), w.double(), b.double(), ((0, 0), (0, 0)))
    kernels.reset_launches()
