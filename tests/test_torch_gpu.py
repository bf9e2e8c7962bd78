'''The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: they skip where no CUDA device is visible and run on a GPU
machine with ``python -m pytest tests/test_torch_gpu.py -m gpu
--noconftest`` (tests/conftest.py imports JAX). The CPU-side parity of the
plain versions with the JAX package is in test_torch_kernels.py,
test_torch_chain_bwd.py, test_torch_conv_bwd.py and test_torch_augment.py;
chip_smoke.py repeats these checks at the full main-path shapes.
'''

import os

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
from dnncancerannotator_torch.ops.kernels import stencil_conv_nhwc as SN
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


# every instance of the input-channel group (1, 2, 3, 4, 6, 8) and widths
# it divides unevenly into, up to the kernel's 64
@pytest.mark.parametrize('ci', [1, 2, 3, 4, 5, 6, 7, 8, 12, 24, 64])
@pytest.mark.parametrize('co', [1, 3, 6, 12, 64])
@pytest.mark.parametrize('need_dx', [False, True])
def test_tconv2x2_bwd_widths_same_bits(cuda, ci, co, need_dx):
    gen = torch.Generator().manual_seed(ci * 100 + co)
    x, wk = _rand(gen, 2, ci, 6, 10), _rand(gen, ci, co, 2, 2)
    g = _rand(gen, 2, co, 12, 20)
    got = TCB.tconv2x2_bwd(x, g, wk, need_dx)
    _assert_grads(got, TCB.plain(x, g, wk, need_dx))
    # the last block adds the partials in block order: the same bits again
    again = TCB.tconv2x2_bwd(x, g, wk, need_dx)
    for a, b in zip(got[1:], again[1:]):
        assert torch.equal(a, b)
    assert int(TCB.ticket(cuda)) == 0


# profiler windows taken, at most, until one holds a record
PROFILE_TRIES = 10


def _window_launches(call):
    '''{name: launches} of one call in a torch.profiler window: every
    record the device ran, the memsets of an allocation included.'''
    cuda_activity = torch.profiler.ProfilerActivity.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[cuda_activity]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


@pytest.mark.parametrize('ci,co,hw', [(12, 12, 32), (12, 6, 64), (6, 3, 128)])
def test_tconv2x2_bwd_one_launch_at_the_sites(cuda, ci, co, hw):
    '''unet.yaml's decoder sites at B=8: one kernel a call by the kernel
    library's own count over 10 calls (chip_smoke.library_launches), and
    nothing beside it, no memset of an allocation either: the profiler sees
    those, but drops a window's records now and then, so an empty window
    is taken again (at most PROFILE_TRIES windows; all empty fails), and
    the first that holds a record must hold the one kernel alone.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(5)
    x, wk = _rand(gen, 8, ci, hw, hw), _rand(gen, ci, co, 2, 2)
    g = _rand(gen, 8, co, 2 * hw, 2 * hw)
    call = lambda: TCB.tconv2x2_bwd(x, g, wk)  # noqa: E731
    call()
    assert library_launches(call) == 1
    for _ in range(PROFILE_TRIES):
        window = _window_launches(call)
        if window:
            break
    else:
        pytest.fail(f'{PROFILE_TRIES} profiler windows recorded nothing')
    assert not [k for k in window if 'memset' in k.lower()], window
    assert sum(window.values()) == 1, window
    _assert_grads(call(), TCB.plain(x, g, wk))


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


# the pointwise route of both stencil kernels (1 x 1, zero pads): the
# head's batches (1, 8 for training, 64 for prediction), planes that are
# and are not whole float4 groups, exact and bucketed channel counts
_PW_SHAPES = [(b, hw, ci, co) for b in (1, 8, 64)
              for hw in ((256, 256), (255, 257), (1, 3))
              for ci in (1, 3, 5, 32) for co in (1, 3, 32)]
_PW_PADS = ((0, 0), (0, 0))


def _pw_inputs(seed, b, hw, ci, co, relu):
    gen = torch.Generator().manual_seed(seed)
    x = _rand(gen, b, ci, *hw)
    wk, bias = _rand(gen, co, ci, 1, 1) * 0.5, _rand(gen, co)
    g = _rand(gen, b, co, *hw)
    if relu:   # the backward of a fused relu sees g masked by the output
        g = g * (SC.plain(x, wk, bias, _PW_PADS, True) > 0)
    return x, wk, bias, g


@pytest.mark.parametrize('b,hw,ci,co', _PW_SHAPES)
@pytest.mark.parametrize('relu', [False, True])
def test_pointwise_conv_kernel(cuda, b, hw, ci, co, relu):
    x, wk, bias, _ = _pw_inputs(7, b, hw, ci, co, relu)
    assert SC.route(ci, co, 1, 1, _PW_PADS, *hw) == 'pointwise'
    before = SC.launches
    _assert_close(SC.stencil_conv(x, wk, bias, _PW_PADS, relu),
                  SC.plain(x, wk, bias, _PW_PADS, relu))
    assert SC.launches == before + 1


@pytest.mark.parametrize('b,hw,ci,co', _PW_SHAPES)
@pytest.mark.parametrize('relu', [False, True])
def test_pointwise_conv_bwd_kernel(cuda, b, hw, ci, co, relu):
    x, wk, _, g = _pw_inputs(8, b, hw, ci, co, relu)
    before = SCB.launches
    got = SCB.stencil_conv_bwd(x, g, wk, _PW_PADS)
    assert SCB.launches == before + 1
    # against the f64 plain version: dw and db sum in f64, the f32 plain
    # version's own error grows with the B x H x W terms of each sum
    want = SCB.plain(x.double(), g.double(), wk.double(), _PW_PADS)
    _assert_grads(got, tuple(t.float() for t in want))
    assert int(TCB.ticket(cuda)) == 0


@pytest.mark.parametrize('b,hw,ci,co', [
    (8, (256, 256), 3, 1),      # the head in training
    (64, (256, 256), 3, 1),     # the head under input sensitivity
    (8, (255, 257), 5, 3),
    (8, (256, 256), 32, 32),
])
def test_pointwise_conv_bwd_same_bits_and_f64(cuda, b, hw, ci, co):
    '''dw and db: the same bits on two calls and without dx, and no
    further from the f64 plain version than F64_RATIO times the f32 plain
    version's error.'''
    from chip_smoke import F64_RATIO
    x, wk, _, g = _pw_inputs(9, b, hw, ci, co, False)
    got = SCB.stencil_conv_bwd(x, g, wk, _PW_PADS)
    again = SCB.stencil_conv_bwd(x, g, wk, _PW_PADS)
    no_dx = SCB.stencil_conv_bwd(x, g, wk, _PW_PADS, need_dx=False)
    assert no_dx[0] is None
    for a, b2, c in zip(got[1:], again[1:], no_dx[1:]):
        assert torch.equal(a, b2) and torch.equal(a, c)
    plain = SCB.plain(x, g, wk, _PW_PADS)
    exact = SCB.plain(x.double(), g.double(), wk.double(), _PW_PADS)
    for k, p, e in zip(got[1:], plain[1:], exact[1:]):
        err, plain_err = (float((t.double() - e).abs().max())
                          for t in (k, p))
        assert err <= F64_RATIO * plain_err, (err, plain_err)


def test_pointwise_conv_bwd_one_launch_at_the_head(cuda):
    '''The head's backward at B=8: one kernel a call, by the kernel
    library's own launch count over 10 calls (chip_smoke.library_launches;
    the profiler drops records now and then), and the profiler's fullest of
    chip_smoke.py's windows sees the pointwise backward kernel alone, the
    memsets of an allocation included.'''
    from chip_smoke import _fullest_split, library_launches
    x, wk, _, g = _pw_inputs(10, 8, (256, 256), 3, 1, False)
    call = lambda: SCB.stencil_conv_bwd(x, g, wk, _PW_PADS)  # noqa: E731
    assert library_launches(call) == 1
    split = _fullest_split(call)
    assert split and all('pointwise_bwd_kernel' in k for k in split), split


def test_pointwise_conv_unaligned_planes(cuda):
    '''Inputs that start off a 16-byte boundary take the scalar form.'''
    gen = torch.Generator().manual_seed(11)
    base = _rand(gen, 2 * 3 * 64 + 1)
    x = base[1:].view(2, 3, 8, 8)
    g = _rand(gen, 2 * 64 + 1)[1:].view(2, 1, 8, 8)
    wk, bias = _rand(gen, 1, 3, 1, 1), _rand(gen, 1)
    _assert_close(SC.stencil_conv(x, wk, bias, _PW_PADS),
                  SC.plain(x, wk, bias, _PW_PADS))
    _assert_grads(SCB.stencil_conv_bwd(x, g, wk, _PW_PADS),
                  SCB.plain(x, g, wk, _PW_PADS))


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


def _at(gen, shift, *shape):
    '''A seeded CUDA tensor whose data starts ``shift`` floats past the
    allocation: 1 and 3 leave it 4-byte aligned (no float2 pairs, odd
    leads), 2 8-byte aligned (pairs, no 16-byte copies at even columns).'''
    n = 1
    for s in shape:
        n *= s
    return _rand(gen, n + shift)[shift:].view(*shape)


def _warp_route(monkeypatch, module, route, shape):
    '''Sends ``shape`` down ``route``: the direct one by a re-read cap of
    0; the tile one must be the rule's own.'''
    if route == 'direct':
        monkeypatch.setattr(WT, 'MAX_REREAD', 0.0)
    assert module.route(*shape) == route


# (B, H, W, C, d, flow scale): the banked step's shape, strips ending at the
# edge and past it, ragged sizes, d >= H, d = 0, C in {1, 3, 6, 7}
_WARP_SHAPES = [(8, 256, 256, 6, 8, 12.0), (2, 64, 64, 6, 8, 12.0),
                (2, 65, 63, 6, 8, 12.0), (1, 37, 50, 6, 8, 4.0),
                (3, 70, 130, 1, 5, 8.0), (2, 9, 200, 7, 2, 3.0),
                (4, 16, 16, 6, 40, 60.0), (3, 130, 24, 3, 10, 15.0),
                (2, 24, 64, 6, 0, 1.0), (2, 33, 129, 3, 3, 10.0)]


@pytest.mark.parametrize('route', ['tile', 'direct'])
@pytest.mark.parametrize('b,h,w,c,d,scale', _WARP_SHAPES)
def test_warp_twopass_routes(cuda, monkeypatch, route, b, h, w, c, d, scale):
    _warp_route(monkeypatch, WT, route, (b, h, w, c, d))
    gen = torch.Generator().manual_seed(h + w + c + d)
    img = _rand(gen, b, h, w, c)
    flow = _rand(gen, b, h, w, 2) * scale
    flow[:, ::3, ::2] = 0.0
    flow[:, 1::5, :, 0] = float(d)
    before = WT.launches
    got = WT.warp_twopass(img, flow, d)
    assert WT.launches == before + 1
    want = WT.plain(img, flow, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize('route', ['tile', 'direct'])
@pytest.mark.parametrize('shift', [1, 2, 3])
@pytest.mark.parametrize('b,h,w,c,d', [(2, 40, 60, 6, 8), (1, 33, 45, 3, 5)])
def test_warp_twopass_unaligned(cuda, monkeypatch, route, shift, b, h, w, c,
                                d):
    '''Image and flow off a 16-byte boundary: the tile stages them with
    4-byte copies where a quad is split and keeps each row's lead.'''
    _warp_route(monkeypatch, WT, route, (b, h, w, c, d))
    gen = torch.Generator().manual_seed(shift)
    img = _at(gen, shift, b, h, w, c)
    flow = _at(gen, 4 - shift, b, h, w, 2) * 10.0
    got = WT.warp_twopass(img, flow, d)
    want = WT.plain(img, flow, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


# (B, h_in, w_in, h_out, w_out, C, d, flow scale): the fused chain's two
# shapes, ragged crops, d >= h_out, C in {1, 3, 6, 7}
_CROP_SHAPES = [(8, 268, 268, 256, 256, 6, 8, 12.0),
                (8, 268, 268, 256, 256, 6, 18, 27.0),
                (2, 44, 50, 32, 37, 6, 8, 4.0), (3, 30, 31, 30, 31, 3, 3, 10.0),
                (4, 76, 76, 64, 64, 1, 12, 18.0),
                (2, 20, 23, 16, 16, 7, 40, 60.0),
                (3, 80, 140, 65, 129, 6, 5, 8.0)]


@pytest.mark.parametrize('route', ['tile', 'direct'])
@pytest.mark.parametrize('b,h_in,w_in,h_out,w_out,c,d,scale', _CROP_SHAPES)
def test_warp_crop_routes(cuda, monkeypatch, route, b, h_in, w_in, h_out,
                          w_out, c, d, scale):
    '''Offsets 0, in - out, past both ends (clamped) and random.'''
    _warp_route(monkeypatch, WC, route, (b, h_out, w_out, c, d))
    gen = torch.Generator().manual_seed(h_in + w_out + d)
    img = _rand(gen, b, h_in, w_in, c)
    fy = _rand(gen, b, h_out, w_in) * scale
    fx = _rand(gen, b, h_out, w_out) * scale
    off = torch.stack([
        torch.randint(0, h_in - h_out + 1, (b,), generator=gen),
        torch.randint(0, w_in - w_out + 1, (b,), generator=gen)], 1)
    off[0] = 0
    off[1] = torch.tensor([h_in - h_out, w_in - w_out])
    if b > 2:
        off[2] = torch.tensor([h_in - h_out + 5, -3])
    off = off.int().cuda()
    before = WC.launches
    got = WC.warp_crop(img, fy, fx, off, d)
    assert WC.launches == before + 1
    want = WC.plain(img, fy, fx, off, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize('route', ['tile', 'direct'])
@pytest.mark.parametrize('shift', [1, 2, 3])
def test_warp_crop_unaligned(cuda, monkeypatch, route, shift):
    b, h_in, w_in, h_out, w_out, c, d = 3, 47, 53, 40, 41, 6, 8
    _warp_route(monkeypatch, WC, route, (b, h_out, w_out, c, d))
    gen = torch.Generator().manual_seed(shift)
    img = _at(gen, shift, b, h_in, w_in, c)
    fy = _at(gen, 4 - shift, b, h_out, w_in) * 12.0
    fx = _at(gen, shift, b, h_out, w_out) * 12.0
    off = torch.tensor([[0, 0], [h_in - h_out, w_in - w_out], [3, 7]],
                       dtype=torch.int32, device=cuda)
    got = WC.warp_crop(img, fy, fx, off, d)
    want = WC.plain(img, fy, fx, off, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


def _one_tile_kernel(call):
    '''One kernel a call by the kernel library's own launch count over 10
    calls (chip_smoke.library_launches), and the profiler's fullest window
    (which counts every launch, the memsets of an allocation included, but
    drops records now and then: one window of this file read 0.4 launches
    a call on an H100) sees the tile kernel alone.'''
    from chip_smoke import _fullest_split, library_launches
    assert library_launches(call) == 1
    split = _fullest_split(call)
    assert split and all('warp_tile_kernel' in key for key in split), split


def test_warp_one_launch_at_the_main_shapes(cuda):
    '''One kernel a call on the tile route at the banked step's and the
    fused chain's shapes (``_one_tile_kernel``); the wrapper's launch
    counter moves by one a call.'''
    gen = torch.Generator().manual_seed(3)
    img = _rand(gen, 8, 256, 256, 6)
    flow = _rand(gen, 8, 256, 256, 2) * 12.0
    assert WT.route(8, 256, 256, 6, 8) == 'tile'
    before = WT.launches
    _one_tile_kernel(lambda: WT.warp_twopass(img, flow, 8))
    assert WT.launches > before
    img = _rand(gen, 8, 268, 268, 6)
    fy, fx = _rand(gen, 8, 256, 268), _rand(gen, 8, 256, 256)
    off = torch.full((8, 2), 6, dtype=torch.int32, device=cuda)
    for d in (8, 18):
        assert WC.route(8, 256, 256, 6, d) == 'tile'
        _one_tile_kernel(lambda: WC.warp_crop(img, fy, fx, off, d))


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


@pytest.mark.parametrize('n,h,w', [
    (2000, 128, 128),   # a chunk of the evaluate path's region metrics
    (3, 256, 256),      # few large planes: the global route
    (140, 256, 256),    # many: the shared route's largest plane
    (140, 1, 65536), (140, 65536, 1), (2, 181, 181),
    (5, 77, 333),       # unaligned planes: byte loads, scalar stores
    (2, 257, 256), (2, 384, 384)])   # over the cap: the global route
def test_cca_kernel_routes(cuda, n, h, w):
    gen = torch.Generator().manual_seed(n + h + w)
    masks = (torch.rand(n, h, w, generator=gen) < 0.55).cuda()
    want = 'shared' if h * w <= 32768 or (h * w <= 65536 and n >= 132) \
        else 'global'
    assert CCA.route(n, h, w) == want
    got = CCA.cca_raw_labels(masks)
    torch.cuda.synchronize()
    assert torch.equal(got, CCA.plain(masks))


@pytest.mark.parametrize('h,w', [(256, 256), (192, 300)])
def test_cca_kernel_shared_route_hard_planes(cuda, h, w):
    '''A spiral (one component, pointer chains across the whole plane)
    and a mask whose planes start off 16-byte boundaries.'''
    spiral = torch.from_numpy(spiral_mask(h, w)).cuda()[None].contiguous()
    assert torch.equal(CCA.cca_raw_labels(spiral), CCA.plain(spiral))
    gen = torch.Generator().manual_seed(h)
    flat = torch.rand(3 * h * w + 1, generator=gen) < 0.6
    shifted = flat.cuda()[1:].view(3, h, w)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert torch.equal(CCA.cca_raw_labels(shifted), CCA.plain(shifted))


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
    g = torch.zeros(1, 1, 8, 8, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        SCB.stencil_conv_bwd(x.transpose(2, 3), g, w, ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match='contiguous'):
        SCB.stencil_conv_bwd(x, g.transpose(2, 3), w, ((0, 0), (0, 0)))
    kernels.reset_launches()



# -- the NHWC stencil conv (MulmoUNet) ----------------------------------------
@pytest.mark.parametrize('b,h,w,ci,co,k,pads,relu,stride', [
    (8, 256, 256, 1, 16, 3, ((1, 1), (1, 1)), True, 5),   # an encoder's conv_0
    (8, 256, 256, 16, 1, 1, ((0, 0), (0, 0)), False, 16),  # the head
    (64, 256, 256, 1, 16, 3, ((1, 1), (1, 1)), True, 5),
    (64, 256, 256, 16, 1, 1, ((0, 0), (0, 0)), False, 16),
    (2, 37, 70, 1, 16, 3, ((1, 1), (1, 1)), True, 1),     # ragged
    (2, 33, 20, 4, 8, 3, ((0, 0), (0, 0)), False, 4),     # VALID, float4 in
    (2, 16, 16, 4, 8, 3, ((1, 1), (1, 1)), True, 6),      # scalar in
    (2, 17, 19, 3, 5, 2, ((0, 1), (0, 1)), True, 3),      # odd pads
    (3, 20, 20, 32, 32, 1, ((0, 0), (0, 0)), False, 32),  # widest
    (2, 9, 9, 2, 3, 5, ((2, 2), (2, 2)), False, 2),
])
def test_stencil_conv_nhwc_kernel(cuda, b, h, w, ci, co, k, pads, relu,
                                  stride):
    '''Against the plain version, one launch a call; x a channel slice of
    a wider tensor where ``stride`` > ci.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(ci * 31 + co)
    x = _rand(gen, b, h, w, stride)[..., stride - ci:]
    wk, bias = _rand(gen, co, ci, k, k), _rand(gen, co)
    got = SN.stencil_conv_nhwc(x, wk, bias, pads, relu)
    assert got.is_contiguous() and got.shape == (
        b, h + sum(pads[0]) - k + 1, w + sum(pads[1]) - k + 1, co)
    _assert_close(got, SN.plain(x, wk, bias, pads, relu))
    before = SN.launches
    assert library_launches(
        lambda: SN.stencil_conv_nhwc(x, wk, bias, pads, relu)) == 1
    assert SN.launches == before + 10


def test_stencil_conv_nhwc_autograd(cuda):
    '''The autograd Function at an encoder site: the forward kernel and
    the library conv backward on the relu-masked cotangent against
    autograd of the plain version, dx into the channel slice.'''
    from dnncancerannotator_torch.ops import functions
    gen = torch.Generator().manual_seed(5)
    base = _rand(gen, 8, 64, 64, 5)
    wk, bias = _rand(gen, 16, 1, 3, 3), _rand(gen, 16)
    g = _rand(gen, 8, 64, 64, 16)
    grads = []
    for fn in (functions.stencil_conv_nhwc, SN.plain):
        x = base.clone().requires_grad_()
        w_, b_ = wk.clone().requires_grad_(), bias.clone().requires_grad_()
        (fn(x[..., 2:3], w_, b_, ((1, 1), (1, 1)), True) * g).sum().backward()
        grads.append((x.grad, w_.grad, b_.grad))
    for got, want in zip(*grads):
        _assert_close(got, want, _W_TOL)


def test_stencil_conv_nhwc_rejects_bad_inputs(cuda):
    gen = torch.Generator().manual_seed(6)
    wk, bias = _rand(gen, 16, 1, 3, 3), _rand(gen, 16)
    x = _rand(gen, 2, 8, 8, 5)
    with pytest.raises(ValueError):   # pixels not evenly spaced
        SN.stencil_conv_nhwc(x.transpose(1, 2)[..., :1], wk, bias,
                             ((1, 1), (1, 1)))
    with pytest.raises((TypeError, ValueError)):
        SN.stencil_conv_nhwc(x[..., :1].double(), wk, bias, ((1, 1), (1, 1)))


# -- the bf16 forms ---------------------------------------------------------------
# Each bf16 form computes in f32 from the exact upcast values in its f32
# form's order and rounds what it returns to bf16 (the chain's c1 and c2f
# stay f32), so it is bit-equal to the f32 form on the upcast inputs,
# rounded; one wrapper launch a call, with the f32 form's kernel count.
BF16 = torch.bfloat16


def _rand16(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(BF16).cuda()


def _bits(got, want):
    '''got and want hold the same bits (and dtype).'''
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    view = torch.int16 if got.dtype == BF16 else torch.int32
    assert torch.equal(got.contiguous().view(view),
                       want.contiguous().view(view))


def _one_call(mod, call, count='launches'):
    '''call() through the library, its kernel count, after one wrapper
    launch (of the form whose ``count`` it is).'''
    from chip_smoke import library_launches
    before = getattr(mod, count)
    kernels = library_launches(call, calls=1)
    assert getattr(mod, count) == before + 1
    return kernels


def _f32(*tensors):
    return tuple(None if t is None else t.float() for t in tensors)


# unet.yaml's bf16 chains (down_0, down_1, up_1, up_2) at B=2, then K = 5,
# ragged and odd widths, and 32 channels (wgrad.cu's five-launch backward)
_BF16_CHAINS = [(5, 3, 3, 256, 256, 3), (3, 6, 6, 128, 128, 3),
                (12, 6, 6, 128, 128, 3), (6, 3, 3, 256, 256, 3),
                (5, 3, 3, 37, 71, 3), (4, 5, 6, 20, 20, 5),
                (32, 32, 32, 9, 33, 3)]


@pytest.mark.parametrize('ci,cm,co,h,w,k', _BF16_CHAINS)
def test_conv_chain_bf16_form(cuda, ci, cm, co, h, w, k):
    gen = torch.Generator().manual_seed(20)
    x = _rand16(gen, 2, ci, h, w)
    w1, b1 = _rand16(gen, cm, ci, k, k, scale=0.3), _rand16(gen, cm)
    w2, b2 = _rand16(gen, co, cm, k, k, scale=0.3), _rand16(gen, co)
    args = (x, w1, b1, w2, b2)
    got = CC.conv_chain(*args, need_c1=True, need_c2f=True)
    c1, c2 = CC.conv_chain(*_f32(*args), need_c1=True)
    _bits(got[0], c1)
    _bits(got[1], c2.to(BF16))
    _bits(got[2], c2)
    _bits(CC.conv_chain(*args)[1], c2.to(BF16))
    assert _one_call(CC, lambda: CC.conv_chain(*args),
                     'launches_bf16') == _one_call(
        CC, lambda: CC.conv_chain(*_f32(*args)))


@pytest.mark.parametrize('ci,cm,co,h,w,k', _BF16_CHAINS)
@pytest.mark.parametrize('need_dx', [False, True])
def test_conv_chain_bwd_bf16_form(cuda, ci, cm, co, h, w, k, need_dx):
    gen = torch.Generator().manual_seed(21)
    x = _rand16(gen, 2, ci, h, w)
    w1, b1 = _rand16(gen, cm, ci, k, k, scale=0.3), _rand16(gen, cm)
    w2, b2 = _rand16(gen, co, cm, k, k, scale=0.3), _rand16(gen, co)
    c1, _, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True,
                              need_c2f=True)
    g = _rand16(gen, 2, co, h, w)
    args = (x, c1, c2, g, w1, w2)
    got = CCB.conv_chain_bwd(*args, need_dx=need_dx)
    want = CCB.conv_chain_bwd(*_f32(*args), need_dx=need_dx)
    assert (got[0] is None) == (not need_dx)
    for a, b in zip(got, want):
        if b is not None:
            _bits(a, b.to(BF16))
    assert _one_call(CCB, lambda: CCB.conv_chain_bwd(
        *args, need_dx=need_dx), 'launches_bf16') == _one_call(
            CCB, lambda: CCB.conv_chain_bwd(*_f32(*args), need_dx=need_dx))


# unet.yaml's bf16 stencil sites (down_2.conv_0 6 -> 12 at 64 x 64, the
# head 3 -> 1), then the scalar pointwise route and odd pads
_BF16_STENCILS = [(8, 6, 12, 64, 64, 3, ((1, 1), (1, 1)), True),
                  (8, 3, 1, 256, 256, 1, ((0, 0), (0, 0)), False),
                  (2, 3, 1, 19, 23, 1, ((0, 0), (0, 0)), True),
                  (2, 4, 6, 19, 23, 3, ((0, 2), (1, 0)), False)]


@pytest.mark.parametrize('b,ci,co,h,w,k,pads,relu', _BF16_STENCILS)
def test_stencil_conv_bf16_form(cuda, b, ci, co, h, w, k, pads, relu):
    gen = torch.Generator().manual_seed(22)
    x, wk = _rand16(gen, b, ci, h, w), _rand16(gen, co, ci, k, k)
    bias = _rand16(gen, co)
    got = SC.stencil_conv(x, wk, bias, pads, relu)
    _bits(got, SC.stencil_conv(*_f32(x, wk, bias), pads, relu).to(BF16))
    assert _one_call(SC, lambda: SC.stencil_conv(x, wk, bias, pads, relu),
                     'launches_bf16') == 1


@pytest.mark.parametrize('b,ci,co,h,w,k,pads,relu', _BF16_STENCILS)
@pytest.mark.parametrize('need_dx', [False, True])
def test_stencil_conv_bwd_bf16_form(cuda, b, ci, co, h, w, k, pads, relu,
                                    need_dx):
    gen = torch.Generator().manual_seed(23)
    x, wk = _rand16(gen, b, ci, h, w), _rand16(gen, co, ci, k, k)
    oh, ow = h + sum(pads[0]) - k + 1, w + sum(pads[1]) - k + 1
    g = _rand16(gen, b, co, oh, ow)
    got = SCB.stencil_conv_bwd(x, g, wk, pads, need_dx)
    want = SCB.stencil_conv_bwd(*_f32(x, g, wk), pads, need_dx)
    assert (got[0] is None) == (not need_dx)
    for a, c in zip(got, want):
        if c is not None:
            _bits(a, c.to(BF16))
    assert _one_call(SCB, lambda: SCB.stencil_conv_bwd(
        x, g, wk, pads, need_dx), 'launches_bf16') == _one_call(
            SCB, lambda: SCB.stencil_conv_bwd(*_f32(x, g, wk), pads, need_dx))


@pytest.mark.parametrize('b,h,w,ci,co,k,pads,relu,stride', [
    (8, 256, 256, 1, 16, 3, ((1, 1), (1, 1)), True, 5),   # an encoder's conv_0
    (8, 256, 256, 16, 1, 1, ((0, 0), (0, 0)), False, 16),  # the head
    (2, 33, 20, 4, 8, 3, ((0, 0), (0, 0)), False, 4),     # four-value reads
    (2, 17, 19, 3, 5, 2, ((0, 1), (0, 1)), True, 3),      # odd pads
])
def test_stencil_conv_nhwc_bf16_form(cuda, b, h, w, ci, co, k, pads, relu,
                                     stride):
    gen = torch.Generator().manual_seed(24)
    x = _rand16(gen, b, h, w, stride)[..., stride - ci:]
    wk, bias = _rand16(gen, co, ci, k, k), _rand16(gen, co)
    got = SN.stencil_conv_nhwc(x, wk, bias, pads, relu)
    want = SN.stencil_conv_nhwc(x.float(), *_f32(wk, bias), pads, relu)
    _bits(got, want.to(BF16))
    assert _one_call(SN, lambda: SN.stencil_conv_nhwc(
        x, wk, bias, pads, relu), 'launches_bf16') == 1


def test_bf16_reaching_an_f32_only_kernel_raises(cuda):
    '''A kernel with no bf16 form refuses bf16 rather than upcasting.'''
    gen = torch.Generator().manual_seed(25)
    x = _rand16(gen, 2, 8, 8, 128)
    with pytest.raises(TypeError, match='float32'):
        PN.pool2x2_nhwc(x)
    with pytest.raises(TypeError, match='float32'):
        TC.tconv2x2(_rand16(gen, 2, 6, 4, 4), _rand16(gen, 6, 3, 2, 2),
                    _rand16(gen, 3))


# -- the stencil tiles: the NHWC forward's tile route, the NCHW backward's
# one-launch tile form ----------------------------------------------------------
_SAME3 = ((1, 1), (1, 1))
_ZERO = ((0, 0), (0, 0))
# b, h, w, ci, co, k, pads, relu, stride: H and W not multiples of the
# tile's rows or of P, pixel strides 5 and Ci, Ci % 4 == 0 and not, Co 1, 3,
# 16 and 32, VALID, B=1
_NHWC_TILES = [
    (1, 37, 70, 1, 16, 3, _SAME3, True, 5),     # an encoder's conv, ragged
    (2, 19, 33, 1, 16, 3, _SAME3, True, 1),     # xs = Ci, OW % P != 0
    (2, 21, 22, 4, 3, 3, _SAME3, False, 4),     # Ci % 4 == 0, Co 3
    (2, 21, 22, 3, 32, 3, _SAME3, True, 3),     # Ci % 4 != 0, Co 32
    (2, 17, 24, 1, 1, 3, _ZERO, False, 5),      # VALID, Co 1
    (2, 16, 18, 8, 16, 3, _ZERO, True, 8),      # VALID, eight channels
    (2, 20, 20, 32, 1, 1, _ZERO, False, 32),    # the 1 x 1 form, Ci 32
    (3, 13, 250, 16, 1, 1, _ZERO, False, 20),   # a head, strided pixels
    (2, 15, 15, 16, 1, 1, _ZERO, False, 18),    # the 1 x 1 form, scalar reads
    (2, 9, 9, 2, 3, 5, ((2, 2), (2, 2)), False, 2),
    (2, 11, 13, 1, 8, 3, ((0, 2), (2, 0)), True, 1),   # odd pads, P = 4
]


def _nhwc_inputs(gen, b, h, w, ci, co, k, stride, rand=_rand):
    x = rand(gen, b, h, w, stride)[..., stride - ci:]
    return x, rand(gen, co, ci, k, k), rand(gen, co)


@pytest.mark.parametrize('b,h,w,ci,co,k,pads,relu,stride', _NHWC_TILES)
def test_stencil_conv_nhwc_tile(cuda, b, h, w, ci, co, k, pads, relu,
                                stride):
    '''The tile route against the plain version, one launch a call by the
    library's count.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(ci * 37 + co + k)
    x, wk, bias = _nhwc_inputs(gen, b, h, w, ci, co, k, stride)
    assert SN.route(b, h, w, ci, co, k, k, pads, 4) == 'tile'
    got = SN.stencil_conv_nhwc(x, wk, bias, pads, relu)
    assert got.is_contiguous()
    _assert_close(got, SN.plain(x, wk, bias, pads, relu))
    assert library_launches(
        lambda: SN.stencil_conv_nhwc(x, wk, bias, pads, relu)) == 1


@pytest.mark.parametrize('b,h,w,ci,co,k,pads,relu,stride', _NHWC_TILES)
def test_stencil_conv_nhwc_tile_bf16_form(cuda, b, h, w, ci, co, k, pads,
                                          relu, stride):
    gen = torch.Generator().manual_seed(ci * 41 + co + k)
    x, wk, bias = _nhwc_inputs(gen, b, h, w, ci, co, k, stride, _rand16)
    assert SN.route(b, h, w, ci, co, k, k, pads, 2) == 'tile'
    got = SN.stencil_conv_nhwc(x, wk, bias, pads, relu)
    want = SN.stencil_conv_nhwc(x.float(), *_f32(wk, bias), pads, relu)
    _bits(got, want.to(BF16))
    assert _one_call(SN, lambda: SN.stencil_conv_nhwc(
        x, wk, bias, pads, relu), 'launches_bf16') == 1


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
def test_stencil_conv_nhwc_direct_route(cuda, dtype):
    '''A shape whose one output row does not fit a block's shared memory
    keeps the direct kernel: against the plain version, one launch.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(26)
    rand = _rand if dtype == torch.float32 else _rand16
    x, wk, bias = _nhwc_inputs(gen, 1, 4, 8192, 1, 32, 3, 1, rand)
    esize = x.element_size()
    assert SN.route(1, 4, 8192, 1, 32, 3, 3, _SAME3, esize) == 'direct'
    got = SN.stencil_conv_nhwc(x, wk, bias, _SAME3, True)
    _assert_close(got.float(), SN.plain(x, wk, bias, _SAME3, True).float(),
                  _TOL if dtype == torch.float32 else 1e-2)
    assert library_launches(
        lambda: SN.stencil_conv_nhwc(x, wk, bias, _SAME3, True)) == 1


# b, ci, co, h, w, kh, kw, pads: down_2's first conv under bf16.yaml, then
# asymmetric pads, 1 x 3, 5 x 5, Ci = Co = 32, B=1, a padded 1 x 1 (more
# output rows than input rows), VALID (fewer)
_STENCIL_BWD_TILES = [
    (8, 6, 12, 64, 64, 3, 3, _SAME3),
    (2, 4, 6, 19, 23, 3, 3, ((0, 2), (1, 0))),
    (2, 3, 5, 17, 21, 1, 3, ((0, 0), (1, 1))),
    (2, 5, 7, 19, 23, 5, 5, ((2, 2), (2, 2))),
    (2, 32, 32, 8, 8, 3, 3, _SAME3),
    (1, 6, 12, 64, 64, 3, 3, _SAME3),
    (2, 3, 4, 10, 10, 1, 1, ((2, 2), (1, 1))),
    (2, 3, 4, 12, 13, 3, 3, _ZERO),
    (3, 2, 3, 10, 12, 2, 2, ((1, 0), (0, 1))),
]


def _bwd_inputs(gen, b, ci, co, h, w, kh, kw, pads, rand=_rand):
    x, wk = rand(gen, b, ci, h, w), rand(gen, co, ci, kh, kw)
    oh, ow = h + sum(pads[0]) - kh + 1, w + sum(pads[1]) - kw + 1
    return x, rand(gen, b, co, oh, ow), wk


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', _STENCIL_BWD_TILES)
@pytest.mark.parametrize('need_dx', [True, False])
def test_stencil_conv_bwd_tile(cuda, b, ci, co, h, w, kh, kw, pads, need_dx):
    '''The stencil route's one-launch form against the f64 plain version
    (its dw and db sum in f64), one launch a call by the library's count,
    dw and db the same bits on two calls and with or without dx, and the
    ticket back at 0.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(ci * 13 + co + kh)
    x, g, wk = _bwd_inputs(gen, b, ci, co, h, w, kh, kw, pads)
    assert SCB.route(b, ci, co, h, w, kh, kw, pads) == 'tile'
    got = SCB.stencil_conv_bwd(x, g, wk, pads, need_dx)
    assert (got[0] is None) == (not need_dx)
    want = SCB.plain(x.double(), g.double(), wk.double(), pads, need_dx)
    _assert_grads(got, tuple(None if t is None else t.float() for t in want))
    again = SCB.stencil_conv_bwd(x, g, wk, pads, not need_dx)
    for a, c in zip(got[1:], again[1:]):
        assert torch.equal(a, c)
    assert library_launches(
        lambda: SCB.stencil_conv_bwd(x, g, wk, pads, need_dx)) == 1
    assert int(TCB.ticket(cuda)) == 0


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', _STENCIL_BWD_TILES)
@pytest.mark.parametrize('need_dx', [True, False])
def test_stencil_conv_bwd_tile_bf16_form(cuda, b, ci, co, h, w, kh, kw, pads,
                                         need_dx):
    gen = torch.Generator().manual_seed(ci * 17 + co + kh)
    x, g, wk = _bwd_inputs(gen, b, ci, co, h, w, kh, kw, pads, _rand16)
    got = SCB.stencil_conv_bwd(x, g, wk, pads, need_dx)
    want = SCB.stencil_conv_bwd(*_f32(x, g, wk), pads, need_dx)
    for a, c in zip(got, want):
        if c is not None:
            _bits(a, c.to(BF16))
    assert _one_call(SCB, lambda: SCB.stencil_conv_bwd(
        x, g, wk, pads, need_dx), 'launches_bf16') == 1


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
def test_stencil_conv_bwd_split_route(cuda, dtype):
    '''A shape whose f64 partial does not fit a block's shared memory (7 x
    7, 32 -> 32) keeps the three-launch split form.'''
    from chip_smoke import library_launches
    pads = ((3, 3), (3, 3))
    gen = torch.Generator().manual_seed(27)
    rand = _rand if dtype == torch.float32 else _rand16
    x, g, wk = _bwd_inputs(gen, 2, 32, 32, 20, 24, 7, 7, pads, rand)
    assert SCB.route(2, 32, 32, 20, 24, 7, 7, pads) == 'split'
    got = SCB.stencil_conv_bwd(x, g, wk, pads)
    if dtype == torch.float32:
        _assert_grads(got, SCB.plain(x, g, wk, pads))
    else:
        for a, c in zip(got, SCB.stencil_conv_bwd(*_f32(x, g, wk), pads)):
            _bits(a, c.to(BF16))
    assert library_launches(
        lambda: SCB.stencil_conv_bwd(x, g, wk, pads)) == 3


# NCHW forward tile ------------------------------------------------------------
# b, ci, co, h, w, kh, kw, pads: unet.yaml + leakyReLU.yaml's nine stencil
# sites (down_2.conv_0 also unet.yaml + bf16.yaml's) at B=8, then odd H and
# W, asymmetric pads, VALID, 1 x 3, 5 x 5, 2 x 2, a padded 1 x 1, 32
# channels, a padded group (Co 16, 5), B=1
_NCHW_TILES = [(8, ci, co, s, s, 3, 3, _SAME3) for ci, co, s in (
    (5, 3, 256), (3, 3, 256), (3, 6, 128), (6, 6, 128), (6, 12, 64),
    (12, 6, 128), (6, 3, 256))] + [
    (1, 3, 3, 37, 53, 3, 3, _SAME3), (2, 4, 6, 19, 23, 3, 3, ((0, 2), (1, 0))),
    (2, 3, 4, 12, 13, 3, 3, _ZERO), (2, 3, 5, 17, 21, 1, 3, ((0, 0), (1, 1))),
    (2, 5, 7, 19, 23, 5, 5, ((2, 2), (2, 2))),
    (3, 2, 3, 10, 12, 2, 2, ((1, 0), (0, 1))),
    (2, 3, 4, 10, 10, 1, 1, ((2, 2), (1, 1))),
    (2, 32, 32, 8, 8, 3, 3, _SAME3), (1, 6, 12, 64, 64, 3, 3, _SAME3),
    (2, 3, 16, 9, 30, 3, 3, _SAME3), (1, 4, 5, 33, 17, 3, 3, _SAME3),
    (2, 3, 5, 10, 18, 3, 3, _SAME3), (1, 3, 6, 11, 20, 3, 3, _SAME3),
    (64, 5, 3, 256, 256, 3, 3, _SAME3),   # predict's batch, 2048 tiles
]


def _nchw_inputs(gen, b, ci, co, h, w, kh, kw, rand=_rand):
    return rand(gen, b, ci, h, w), rand(gen, co, ci, kh, kw), rand(gen, co)


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', _NCHW_TILES)
@pytest.mark.parametrize('relu', [False, True])
def test_stencil_conv_tile(cuda, b, ci, co, h, w, kh, kw, pads, relu):
    '''The tile route against the plain version, one launch a call by the
    library's count.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(ci * 31 + co + kh)
    x, wk, bias = _nchw_inputs(gen, b, ci, co, h, w, kh, kw)
    assert SC.route(ci, co, kh, kw, pads, h, w) == 'tile'
    got = SC.stencil_conv(x, wk, bias, pads, relu)
    _assert_close(got, SC.plain(x, wk, bias, pads, relu))
    assert library_launches(
        lambda: SC.stencil_conv(x, wk, bias, pads, relu)) == 1


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', _NCHW_TILES)
def test_stencil_conv_tile_bf16_form(cuda, b, ci, co, h, w, kh, kw, pads):
    gen = torch.Generator().manual_seed(ci * 29 + co + kh)
    x, wk, bias = _nchw_inputs(gen, b, ci, co, h, w, kh, kw, _rand16)
    got = SC.stencil_conv(x, wk, bias, pads, True)
    _bits(got, SC.stencil_conv(*_f32(x, wk, bias), pads, True).to(BF16))
    assert _one_call(SC, lambda: SC.stencil_conv(x, wk, bias, pads, True),
                     'launches_bf16') == 1


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
def test_stencil_conv_direct_route(cuda, dtype):
    '''A shape whose one staged row does not fit a block's shared memory
    (32 channels 8192 wide) keeps the direct kernel: against the plain
    version (bf16: bit-equal to its f32 form), one launch.'''
    from chip_smoke import library_launches
    gen = torch.Generator().manual_seed(28)
    rand = _rand if dtype == torch.float32 else _rand16
    x, wk, bias = _nchw_inputs(gen, 1, 32, 32, 8, 8192, 3, 3, rand)
    assert SC.route(32, 32, 3, 3, _SAME3, 8, 8192) == 'stencil'
    got = SC.stencil_conv(x, wk, bias, _SAME3, True)
    if dtype == torch.float32:
        _assert_close(got, SC.plain(x, wk, bias, _SAME3, True))
    else:
        _bits(got, SC.stencil_conv(*_f32(x, wk, bias), _SAME3,
                                   True).to(BF16))
    assert library_launches(
        lambda: SC.stencil_conv(x, wk, bias, _SAME3, True)) == 1


@pytest.mark.parametrize('b,ci,co,h,w,kh,kw,pads', [
    (8, 6, 12, 64, 64, 3, 3, _SAME3), (2, 4, 6, 19, 23, 3, 3,
                                       ((0, 2), (1, 0)))])
@pytest.mark.parametrize('relu', [False, True])
def test_stencil_conv_fn_grads_through_the_tile(cuda, b, ci, co, h, w, kh,
                                                kw, pads, relu):
    '''StencilConvFn (the tile forward, the stencil backward) against
    autograd of the plain version: the output and every gradient.'''
    from dnncancerannotator_torch.ops import functions
    gen = torch.Generator().manual_seed(ci * 19 + co)
    x, wk, bias = _nchw_inputs(gen, b, ci, co, h, w, kh, kw)
    oh, ow = h + sum(pads[0]) - kh + 1, w + sum(pads[1]) - kw + 1
    g = _rand(gen, b, co, oh, ow)
    assert SC.route(ci, co, kh, kw, pads, h, w) == 'tile'
    grads = []
    for fn in (functions.stencil_conv, SC.plain):
        leaves = [t.clone().requires_grad_() for t in (x, wk, bias)]
        out = fn(*leaves, pads, relu)
        (out * g).sum().backward()
        grads.append((out.detach(),) + tuple(t.grad for t in leaves))
    got, want = grads
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])
    for a, c in zip(got[2:], want[2:]):
        _assert_close(a, c, _W_TOL)


@pytest.mark.parametrize('cpt,px', SC.TILES)
@pytest.mark.parametrize('rows', [1, 3, 4])
@pytest.mark.parametrize('k,pads', [(3, ((0, 2), (1, 0))),
                                    (5, ((2, 2), (2, 2)))])
@pytest.mark.parametrize('ks', [1, 2])
def test_stencil_conv_tile_every_work_item(cuda, monkeypatch, cpt, px, rows,
                                           k, pads, ks):
    '''Each (CPT, PX) the kernel is built for, at row counts with and without
    the lanes' row pairs, with one and two lanes an item, against the plain
    version (f32) and its f32 form (bf16), one launch a call.'''
    from chip_smoke import library_launches
    import functools
    co = 12 if cpt in SC.EXACT_CPT else 13
    monkeypatch.setattr(SC, 'plan', functools.partial(
        SC.plan, rows=rows, px=px, cpt=cpt, ks=ks))
    gen = torch.Generator().manual_seed(cpt * 7 + px + rows + k + ks)
    x, wk, bias = _nchw_inputs(gen, 2, 5, co, 19, 23, k, k)
    got = SC.stencil_conv(x, wk, bias, pads, True)
    _assert_close(got, SC.plain(x, wk, bias, pads, True))
    assert library_launches(
        lambda: SC.stencil_conv(x, wk, bias, pads, True)) == 1
    x16, w16, b16 = (t.to(BF16) for t in (x, wk, bias))
    _bits(SC.stencil_conv(x16, w16, b16, pads, True),
          SC.stencil_conv(*_f32(x16, w16, b16), pads, True).to(BF16))



@pytest.mark.parametrize('spec', [
    'adamax', 'nadam', 'rmsprop',
    {'class_name': 'RMSprop', 'config': {'momentum': 0.5, 'centered': True}},
    'adagrad', 'adadelta', {'class_name': 'Lamb', 'config': {
        'weight_decay': 0.01}}, {'class_name': 'Lion', 'config': {
            'weight_decay': 0.1}}])
def test_optimizer_step_on_the_card(cuda, spec):
    '''Two steps of each optimizer the port writes or takes from torch
    beside Adam and SGD, on CUDA tensors against the same optimizer on CPU
    copies (f32 to 1e-6 relative, 1e-7 absolute); the state stays on the
    card.'''
    from dnncancerannotator_torch.train import optimizers
    gen = torch.Generator().manual_seed(11)
    shapes = [(3, 5, 3, 3), (3,), (5, 2, 2, 2)]
    p0 = [torch.randn(*s, generator=gen) for s in shapes]
    grads = [[0.5 + torch.rand(*s, generator=gen) for s in shapes]
             for _ in range(2)]
    runs = {}
    for device in ('cpu', cuda):
        params = [torch.nn.Parameter(p.clone().to(device)) for p in p0]
        opt, schedule = optimizers.solve_optimizer(spec, params)
        for step, g in enumerate(grads):
            for group in opt.param_groups:
                group['lr'] = schedule(step)
            for p, x in zip(params, g):
                p.grad = x.to(device)
            opt.step()
        runs[str(device)] = [p.detach().cpu() for p in params]
        if device != 'cpu':
            for state in opt.state.values():
                for key, value in state.items():
                    if key != 'step':
                        assert value.device == cuda, key
    for got, want in zip(runs[str(cuda)], runs['cpu']):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


# -- the host input path: pinned copies on a side stream --------------------------
def test_prefetcher_pinned_copies_equal_the_host(cuda):
    '''200 batches through the prefetcher's pinned buffers and side stream,
    each read on the consumer's stream without a host sync in between (a
    digest a batch, read at the end) and dropped at once, so a buffer
    refilled or a device block handed back too early shows as a wrong
    digest; every 20th also compared whole. The stream is closed
    mid-way: the producer ends.'''
    from dnncancerannotator_torch import engine
    import threading
    import numpy as np

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (8, 268, 268, 6), np.uint8)
    weights = torch.arange(1, 7, device=cuda, dtype=torch.int64)

    def stream():
        for i in range(400):
            yield base ^ np.uint8(i % 251)

    batches = engine._Prefetcher(stream(), cuda)
    digests, want = [], []
    try:
        for i in range(200):
            item, tensor = next(batches)
            assert tensor.is_cuda and tensor.dtype == torch.uint8
            digests.append((tensor.to(torch.int64) * weights).sum())
            want.append(int((item.astype(np.int64) * np.arange(1, 7)).sum()))
            if i % 20 == 0:
                assert torch.equal(tensor.cpu(), torch.from_numpy(item))
            del tensor
    finally:
        batches.close()
    assert torch.stack(digests).tolist() == want
    assert not [t for t in threading.enumerate()
                if t.name == engine._Prefetcher.THREAD_NAME and t.is_alive()]


# -- the serving artifact: library ops only ---------------------------------------
@pytest.mark.parametrize('options,deploy', [
    (dict(n_filters_first=3, n_downsample=3), {}),
    (dict(n_filters_first=64, n_downsample=2, bn=True),
     dict(pallas_pool=True, pallas_tconv=True)),
])
def test_exported_program_on_the_card(cuda, tmp_path, options, deploy):
    '''A seeded run exported on the CPU (runs/export.py), moved to the
    card: every tensor of the program there, the maps equal to the CPU
    program's to 1e-5 at two batches, and no kernel of the library
    launched.'''
    import numpy as np
    import yaml
    from chip_smoke import library_launches
    from dnncancerannotator_torch import engine
    from dnncancerannotator_torch.runs import export

    config = dict(model='UNetAnnotator', model_options=dict(
        rate=2, kernel_size=3, conv_stride=1, padding='same', **options),
        deploy_options=deploy, data_options=dict(eval=dict(
            output_size=[64, 64])))
    eng = engine.Engine(config, device='cpu')
    eng.build((2, 64, 64, 5))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, value in eng.model.state_dict().items():
            if name.endswith(('bias', 'mean')):
                value.copy_(torch.randn(value.shape, generator=gen) * 0.1)
    save = str(tmp_path / 'run')
    os.makedirs(save)
    with open(os.path.join(save, 'options.yaml'), 'w') as f:
        yaml.safe_dump(dict(config=config), f)
    eng.save_ckpt(os.path.join(save, 'checkpoints'), 1)
    eng.finalize_checkpoints()
    path = export.export_model(save, str(tmp_path / 'art'))

    from torch.export.passes import move_to_device_pass
    program = move_to_device_pass(torch.export.load(path), cuda)
    assert all(t.device == cuda for t in program.state_dict.values())
    on_card = export.load_exported(path, device='cuda')
    on_host = export.load_exported(path, device='cpu')
    rng = np.random.default_rng(1)
    for b in (1, 8):
        x = rng.integers(0, 256, (b, 64, 64, 5), np.uint8)
        kernels.reset_launches()
        launched = library_launches(lambda: on_card(x), calls=2)
        assert not any(kernels.launch_counts().values())
        assert launched == 0
        got = on_card(x)
        assert got.device == cuda and got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), on_host(x), rtol=0, atol=1e-5)


# -- data parallelism: two ranks on the one card -----------------------------------------
def _dp_config(**train):
    from dnncancerannotator_torch.utils import config as config_lib
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = config_lib.load_config([os.path.join(repo, 'configs', name) for
                                     name in ('unet.yaml',
                                              'additionals/deploy_options.yaml',
                                              'additionals/data_options.yaml')])
    config['data_options']['train'].update(output_size=[32, 32], **train)
    config['deploy_options'].update(warp_bank_size=8, enable_multigpu=True)
    return config


def _test_module(name):
    '''A module of tests/ by its path: on a machine whose packages hold a
    ``tests`` package of their own, ``tests.<name>`` would not be ours.'''
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dp_records(root):
    from dnncancerannotator_torch.data.records import generate_tfrecords
    util_synth = _test_module('util_synth')
    tree = util_synth.make_exam_tree(os.path.join(root, 'tree'), size=64)
    paths = []
    for category in ('cancer', 'healthy'):
        paths.append(os.path.join(root, f'{category}.tfrecords'))
        generate_tfrecords(tree, paths[-1], category=category,
                           output_size=(64, 64))
    return paths


@pytest.mark.parametrize('batch', [8, 7])
def test_two_ranks_on_one_card_match_one_rank(cuda, tmp_path, batch):
    '''Two ranks on the one card, in a gloo group (NCCL refuses two ranks on
    one card): the unet.yaml step through the kernels at B = 8 (4 a rank)
    and B = 7 (3 and 4), three Adam steps. Every rank's parameters the same
    bits, the losses within 1e-5 relative and every parameter within 1e-6
    of one rank on the card (tests/test_torch_train.py's limits), and each
    rank's launches of the seven kernels of the step above 0.'''
    import numpy as np
    from dnncancerannotator_torch import convert, engine
    from dnncancerannotator_torch.data import pipeline
    dp = _test_module('util_torch_dp')

    records = _dp_records(str(tmp_path))
    config = _dp_config(batch_size=batch)
    out = str(tmp_path / 'dp')
    dp.wait(dp.ranks(2, [dict(kind='train', config=config, records=records,
                              max_steps=3, device='cuda', out=out)],
                     str(tmp_path), 'dp'), str(tmp_path), 'dp')
    eng = engine.Engine(config, device='cuda')
    res = eng.train(pipeline.train_ds(records,
                                      **config['data_options']['train']),
                    max_steps=3, save_freq=1 << 30)
    want = convert.flax_from_torch_state(eng.model.state_dict())
    got = [dict(np.load(f'{out}.rank{rank}.npz')) for rank in (0, 1)]
    for key, value in got[0].items():
        np.testing.assert_array_equal(got[1][key], value, err_msg=key)
    np.testing.assert_allclose(got[0]['losses'], res.history['loss'],
                               rtol=1e-5)
    for key, value in want.items():
        np.testing.assert_allclose(got[0][key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
    for rank in (0, 1):
        for name in ('conv_chain', 'conv_chain_bwd', 'tconv2x2',
                     'tconv2x2_bwd', 'stencil_conv', 'stencil_conv_bwd',
                     'warp_twopass'):
            assert got[rank][f'launches/{name}'] > 0, (rank, name)


@pytest.mark.parametrize('batch', [4, 3])
def test_spatial_partition_on_one_card_matches_one_rank(cuda, tmp_path,
                                                        batch):
    '''Two ranks on the one card (gloo) splitting the image rows
    (``spatial_partition: 2``): the unet.yaml step through the kernels on
    each rank's slab of a 32 x 32 batch (16 rows a rank) at B = 4 and 3,
    three Adam steps. Every rank's parameters the same bits, the losses within
    1e-5 relative and every parameter within 1e-6 of one rank on the card,
    and each rank's launches of the seven kernels of the step above 0.'''
    import numpy as np
    from dnncancerannotator_torch import convert, engine
    from dnncancerannotator_torch.data import pipeline
    dp = _test_module('util_torch_dp')

    records = _dp_records(str(tmp_path))
    config = _dp_config(batch_size=batch)
    one = engine.Engine(config, device='cuda')
    config['deploy_options']['spatial_partition'] = 2
    out = str(tmp_path / 'spatial')
    dp.wait(dp.ranks(2, [dict(kind='train', config=config, records=records,
                              max_steps=3, device='cuda', out=out)],
                     str(tmp_path), 'spatial'), str(tmp_path), 'spatial')
    res = one.train(pipeline.train_ds(records,
                                      **config['data_options']['train']),
                    max_steps=3, save_freq=1 << 30)
    want = convert.flax_from_torch_state(one.model.state_dict())
    got = [dict(np.load(f'{out}.rank{rank}.npz')) for rank in (0, 1)]
    for key, value in got[0].items():
        if not key.startswith('launches/'):
            np.testing.assert_array_equal(got[1][key], value, err_msg=key)
    np.testing.assert_allclose(got[0]['losses'], res.history['loss'],
                               rtol=1e-5)
    for key, value in want.items():
        np.testing.assert_allclose(got[0][key], value, rtol=0, atol=1e-6,
                                   err_msg=key)
    for rank in (0, 1):
        for name in ('conv_chain', 'conv_chain_bwd', 'tconv2x2',
                     'tconv2x2_bwd', 'stencil_conv', 'stencil_conv_bwd',
                     'warp_twopass'):
            assert got[rank][f'launches/{name}'] > 0, (rank, name)


@pytest.mark.parametrize('seed', [0, 1])
def test_corner_response_on_the_card(cuda, seed):
    '''The extractor's corner correlation on the card: int32, bit-equal to
    the CPU path and to scipy's convolution on a seeded 1080 x 1600
    collage.'''
    import numpy as np
    from scipy import signal
    from chip_smoke import screenshot
    from dnncancerannotator_torch.runs import extract as ex

    img, boxes, _ = screenshot(seed, annotate=True, ruler=True)
    binary = (ex._gray(img) >= 100).astype(np.uint8)
    filt = ex.get_orthogonal_detector(25)
    for f in (filt, np.flip(filt)):
        card = ex.corner_response(binary, f, cuda)
        assert card.is_cuda and card.dtype == torch.int32
        card = card.cpu().numpy()
        np.testing.assert_array_equal(
            card, ex.corner_response(binary, f, 'cpu').numpy())
        np.testing.assert_array_equal(
            card, signal.convolve2d(binary.astype(np.float32), np.flip(f),
                                    'valid'))
    assert [tuple(map(int, b)) for b in ex.detect_internals(
        img, device=cuda)] == boxes


@pytest.mark.parametrize('name', ['unet', 'bn'])
def test_orbax_fixture_loads_onto_the_card(cuda, name):
    '''A committed JAX package checkpoint (tests/fixtures_torch/orbax/, an
    Orbax OCDBT store) loads into an Engine on the card: every parameter,
    BatchNorm statistic and optimizer moment equals the fixture's
    expected.npz, to the bit.'''
    import numpy as np
    from dnncancerannotator_torch import convert, engine
    from dnncancerannotator_torch.train import optimizers
    from dnncancerannotator_torch.utils import config as config_lib

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures_torch', 'orbax')
    run = os.path.join(root, name)
    config = config_lib.load_config(
        os.path.join(run, 'options.yaml'))['config']
    eng = engine.Engine(config, device=cuda)
    eng.build((1, 64, 64, 5))
    eng.optimizer, eng.schedule = optimizers.solve_optimizer(
        config['deploy_options'].get('optimizer', 'adam'),
        eng.model.parameters(), eng.schedule)
    ckpts = eng.get_ckpts(os.path.join(run, 'checkpoints'))
    eng.load(ckpts[max(ckpts)])
    with np.load(os.path.join(root, f'{name}.expected.npz')) as npz:
        expected = {k: npz[k] for k in npz.files}
    model = {k: v for k, v in expected.items()
             if k.split('/')[0] in ('params', 'batch_stats')}
    want = convert.torch_state_from_flax(model)
    got = eng.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].device.type == 'cuda'
        assert torch.equal(got[key].float().cpu(), value), key
    names = {p: n for n, p in eng.model.named_parameters()}
    state_names = optimizers.state_names(eng.optimizer)
    moments = 0
    for param, state in eng.optimizer.state.items():
        for key, optax_name in state_names.items():
            flat = convert.flax_from_torch_state(
                {names[param]: state[key].cpu()})
            for path, value in flat.items():
                want_value = expected[f'{optax_name}/{path}']
                assert state[key].device.type == 'cuda'
                assert value.tobytes() == want_value.tobytes(), path
                moments += 1
        assert float(state['step']) == float(expected['count'])
    assert moments == 2 * len(eng.optimizer.state)


# -- the model geometries (unet.yaml at rate 3 on 243 x 243 crops, at
# VALID on 256 x 256): the kernels at the shapes those paths give them
# (chip_smoke.py phase 21 runs the paths themselves)
_RATE3_CHAINS = [(5, 3, 3, 243), (3, 9, 9, 81), (9, 27, 27, 27),
                 (18, 9, 9, 81), (6, 3, 3, 243)]


@pytest.mark.parametrize('ci,cm,co,hw', _RATE3_CHAINS)
def test_conv_chain_kernels_at_rate3(cuda, ci, cm, co, hw):
    '''The five fused chains at rate 3 (B=8, planes of 243, 81 and 27:
    multiples of neither 16 nor 128), forward with c1 and backward, one
    launch a call each; the backward against the f64 plain version and
    its dw and db the same bits on two calls.'''
    gen = torch.Generator().manual_seed(ci * hw)
    x = _rand(gen, 8, ci, hw, hw)
    w1, b1 = _rand(gen, cm, ci, 3, 3) * 0.3, _rand(gen, cm)
    w2, b2 = _rand(gen, co, cm, 3, 3) * 0.3, _rand(gen, co)
    before = CC.launches
    c1, c2 = CC.conv_chain(x, w1, b1, w2, b2, need_c1=True)
    assert CC.launches == before + 1
    p1, p2 = CC.plain(x, w1, b1, w2, b2)
    _assert_close(c1, p1)
    _assert_close(c2, p2)
    g = _rand(gen, *c2.shape)
    before = CCB.launches
    got = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2)
    assert CCB.launches == before + 1
    want = CCB.plain(*(t.double() for t in (x, c1, c2, g, w1, w2)))
    _assert_grads(got, tuple(w.float() for w in want))
    again = CCB.conv_chain_bwd(x, c1, c2, g, w1, w2)
    for a, b in zip(got[1:], again[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('route', ['tile', 'direct'])
def test_warp_twopass_at_rate3(cuda, monkeypatch, route):
    '''The banked warp at the rate-3 crop, [8, 243, 243, 6] at d = 8, on
    both routes: exactly its plain version, one launch.'''
    shape = (8, 243, 243, 6, 8)
    _warp_route(monkeypatch, WT, route, shape)
    gen = torch.Generator().manual_seed(243)
    img = _rand(gen, *shape[:4])
    flow = _rand(gen, 8, 243, 243, 2) * 12.0
    before = WT.launches
    got = WT.warp_twopass(img, flow, 8)
    assert WT.launches == before + 1
    want = WT.plain(img, flow, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize('n,hw', [(2000, 121), (20, 121), (100, 243),
                                  (6400, 121)])
def test_cca_kernel_at_rate3(cuda, n, hw):
    '''The CCA on the planes evaluate gives it at a 243 crop (the region
    metrics' half-size 121 x 121 planes a chunk, the Visualizer's whole
    ones, on the global route below 132 of them): exactly its plain
    version, on the route's rule.'''
    gen = torch.Generator().manual_seed(n + hw)
    masks = (torch.rand(n, hw, hw, generator=gen) < 0.55).cuda()
    want = 'shared' if hw * hw <= 32768 or (hw * hw <= 65536 and n >= 132) \
        else 'global'
    assert CCA.route(n, hw, hw) == want
    got = CCA.cca_raw_labels(masks)
    torch.cuda.synchronize()
    assert torch.equal(got, CCA.plain(masks))


# the 3x3 stencil sites of unet.yaml at VALID (B=8, 256 x 256 in): zero
# pads, relu, each conv's input plane
_VALID_SITES = [(5, 3, 256), (3, 3, 254), (3, 6, 126), (6, 6, 124),
                (6, 12, 61), (12, 6, 104), (6, 6, 102), (6, 3, 200),
                (3, 3, 198)]


@pytest.mark.parametrize('ci,co,hw', _VALID_SITES)
def test_stencil_conv_zero_pads_at_valid_sites(cuda, ci, co, hw):
    '''The stencil conv forward and backward with zero pads at full width:
    against their plain versions, one launch a forward, the backward's
    launches by its route.'''
    gen = torch.Generator().manual_seed(ci * co + hw)
    x = torch.rand(8, ci, hw, hw, generator=gen).cuda()
    wk, b = _rand(gen, co, ci, 3, 3) * 0.3, _rand(gen, co)
    before = SC.launches
    got = SC.stencil_conv(x, wk, b, _ZERO, True)
    assert SC.launches == before + 1
    assert got.shape == (8, co, hw - 2, hw - 2)
    _assert_close(got, SC.plain(x, wk, b, _ZERO, True))
    g = torch.where(got > 0, _rand(gen, *got.shape), torch.zeros_like(got))
    _assert_grads(SCB.stencil_conv_bwd(x, g, wk, _ZERO),
                  SCB.plain(x, g, wk, _ZERO))


@pytest.mark.parametrize('name', ['unet', 'bn'])
def test_orbax_write_from_the_card(cuda, name, tmp_path):
    '''The fixture's run loaded onto the card, then saved in the background
    with ``save_ckpt`` while the card keeps working: the checkpoint commits
    in the JAX engine's Orbax layout and reads back to the state on the
    card at the save, to the bit.'''
    import numpy as np
    from dnncancerannotator_torch import convert, engine
    from dnncancerannotator_torch.train import optimizers
    from dnncancerannotator_torch.utils import config as config_lib

    run = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures_torch', 'orbax', name)
    config = config_lib.load_config(
        os.path.join(run, 'options.yaml'))['config']
    eng = engine.Engine(config, device=cuda)
    eng.build((1, 64, 64, 5))
    eng.optimizer, eng.schedule = optimizers.solve_optimizer(
        config['deploy_options'].get('optimizer', 'adam'),
        eng.model.parameters(), eng.schedule)
    ckpts = eng.get_ckpts(os.path.join(run, 'checkpoints'))
    step = max(ckpts)
    eng.load(ckpts[step])
    want = convert.flax_from_torch_state(eng.model.state_dict())
    want.update(eng._opt_state_flat(step))
    path = eng.save_ckpt(str(tmp_path), step)
    with torch.no_grad():   # the state on the card moves on meanwhile
        for p in eng.model.parameters():
            p.add_(1.0)
    eng.finalize_checkpoints()
    assert {'_METADATA', '_CHECKPOINT_METADATA', 'manifest.ocdbt'} <= set(
        os.listdir(path))
    got = engine.read_ckpt(path)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.asarray(got[key]).tobytes() == value.tobytes(), key
