'''The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: they skip where no CUDA device is visible and run on a GPU
machine with ``python -m pytest tests/test_torch_gpu.py -m gpu``. The
CPU-side parity of the plain versions with the JAX package is in
test_torch_kernels.py; chip_smoke.py repeats these checks at the full
main-path shapes.
'''

import pytest
import torch

from dnncancerannotator_torch.ops import kernels
from dnncancerannotator_torch.ops.kernels import conv_chain as CC
from dnncancerannotator_torch.ops.kernels import stencil_conv as SC
from dnncancerannotator_torch.ops.kernels import tconv2x2 as TC

pytestmark = pytest.mark.gpu
_TOL = 1e-4  # relative to max|ref|: f32 sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from dnncancerannotator_torch import engine
    return engine.resolve_device('cuda')   # also turns TF32 off


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen).cuda()


def _assert_close(got, want):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= _TOL * float(want.abs().max()), err


@pytest.mark.parametrize('ci,cm,co,h,w,k', [
    (5, 3, 3, 37, 70, 3),     # ragged tiles on both axes
    (24, 12, 12, 16, 16, 3),
    (32, 32, 32, 9, 33, 3),   # widest the kernel takes: smaller tiles
    (4, 5, 6, 20, 20, 5),
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


def test_wrappers_reject_non_contiguous_and_f64(cuda):
    x = torch.zeros(1, 3, 8, 8, device=cuda)
    w, b = torch.zeros(1, 3, 1, 1, device=cuda), torch.zeros(1, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        SC.stencil_conv(x.transpose(2, 3), w, b, ((0, 0), (0, 0)))
    with pytest.raises(TypeError, match='float32'):
        SC.stencil_conv(x.double(), w.double(), b.double(), ((0, 0), (0, 0)))
    kernels.reset_launches()
