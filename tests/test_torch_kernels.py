'''Port kernels on the CPU: each plain PyTorch version against the Pallas
kernel it replaces, run in interpret mode as the JAX package's tests run it.

Inputs are made once with seeded numpy and handed to both packages. The
tolerance is 2e-5 * max|ref| (f32, sums in another order). The wrappers
take the plain version for CPU tensors, so no kernel launch may be counted.
'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu.models import fastconv as jax_fastconv
from dnncancerannotator_tpu.ops.pallas import conv_kernel, flatchain, flattconv
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
from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

_REL_TOL = 2e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= _REL_TOL * scale, (err, scale)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _chain_inputs(b, ci, cm, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, h, w)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, ci, cm)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(cm) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, cm, cm)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(cm) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _port_chain(x, w1, b1, w2, b2):
    return CC.conv_chain(torch.from_numpy(x), _oihw(w1), torch.from_numpy(b1),
                         _oihw(w2), torch.from_numpy(b2), need_c1=True)


def test_conv_chain_matches_pallas_stencil_chain():
    '''down_0's class (5 -> 3 -> 3) through conv_chain_pallas.'''
    x, w1, b1, w2, b2 = _chain_inputs(2, 5, 3, 16, 16, seed=0)
    c1_ref, c2_ref = conv_kernel.conv_chain_pallas(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), pads=((1, 1), (1, 1)), interpret=True)
    c1, c2 = _port_chain(x, w1, b1, w2, b2)
    _close(c1, c1_ref)
    _close(c2, c2_ref)


@pytest.mark.parametrize('im2col,ci,cm', [
    ('1', 6, 12),    # down_2's class, im2col strategy
    ('1', 24, 12),   # up_0's class (the [up, skip] concat input)
    ('0', 12, 6),    # up_1's class, nine-dot strategy
])
def test_conv_chain_matches_flat_chain(monkeypatch, im2col, ci, cm):
    monkeypatch.setenv('DNNCA_FLATCHAIN_IM2COL', im2col)
    x, w1, b1, w2, b2 = _chain_inputs(2, ci, cm, 8, 8, seed=1)
    want = flatchain.conv_chain_flat_nchw(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), True)
    _, c2 = _port_chain(x, w1, b1, w2, b2)
    _close(c2, want)


def _flax_to_torch_tconv(w_hwio):
    # lax.conv_transpose applies the HWIO kernel flipped (convert.py)
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio[::-1, ::-1].transpose(2, 3, 0, 1)))


def _tconv_inputs(b, ci, co, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, h, w)).astype(np.float32)
    wk = (rng.standard_normal((2, 2, ci, co)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, wk, bias


def test_tconv2x2_matches_flat_tconv():
    '''up_2's class: W = 128, the shape the Pallas tconv kernel takes.'''
    x, wk, bias = _tconv_inputs(2, 6, 3, 2, 128, seed=2)
    want = flattconv.conv_transpose2x2_flat_nchw(
        jnp.asarray(x), jnp.asarray(wk), jnp.asarray(bias), True)
    got = TC.tconv2x2(torch.from_numpy(x), _flax_to_torch_tconv(wk),
                      torch.from_numpy(bias))
    _close(got, want)


def test_tconv2x2_matches_einsum_tconv():
    '''up_0's class: W = 32, where the JAX package runs the plain einsum.'''
    x, wk, bias = _tconv_inputs(2, 12, 12, 4, 32, seed=3)
    want = jax_fastconv.stencil_conv_transpose2d(
        jnp.asarray(x), jnp.asarray(wk), 2, 'NCHW') \
        + jnp.asarray(bias).reshape(1, -1, 1, 1)
    got = TC.tconv2x2(torch.from_numpy(x), _flax_to_torch_tconv(wk),
                      torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize('k,ci,co,pads,relu', [
    (1, 3, 1, ((0, 0), (0, 0)), False),   # the logits head
    (3, 3, 3, ((1, 1), (1, 1)), True),
])
def test_stencil_conv_matches_pallas(k, ci, co, pads, relu):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, ci, 16, 16)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    want = conv_kernel.stencil_conv2d_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), pads=pads,
        relu=relu, nchw=True, interpret=True)
    got = SC.stencil_conv(torch.from_numpy(x), _oihw(w),
                          torch.from_numpy(bias), pads, relu)
    _close(got, want)


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launches()
    x, w1, b1, w2, b2 = _chain_inputs(1, 3, 6, 8, 8, seed=5)
    _port_chain(x, w1, b1, w2, b2)
    xt, wk, bias = _tconv_inputs(1, 6, 3, 4, 4, seed=5)
    TC.tconv2x2(torch.from_numpy(xt), _flax_to_torch_tconv(wk),
                torch.from_numpy(bias))
    SC.stencil_conv(torch.from_numpy(xt), torch.ones(1, 6, 1, 1),
                    torch.zeros(1), ((0, 0), (0, 0)))
    x = torch.rand(1, 3, 8, 8)
    c1, c2 = CC.plain(x, torch.rand(6, 3, 3, 3), torch.rand(6),
                      torch.rand(4, 6, 3, 3), torch.rand(4))
    CCB.conv_chain_bwd(x, c1, c2, torch.rand_like(c2),
                       torch.rand(6, 3, 3, 3), torch.rand(4, 6, 3, 3))
    TCB.tconv2x2_bwd(x, torch.rand(1, 2, 16, 16), torch.rand(3, 2, 2, 2))
    SCB.stencil_conv_bwd(x, torch.rand(1, 1, 8, 8), torch.rand(1, 3, 1, 1),
                         ((0, 0), (0, 0)))
    WT.warp_twopass(torch.rand(1, 8, 8, 6), torch.rand(1, 8, 8, 2))
    CCA.cca_raw_labels(torch.rand(2, 8, 8) > 0.5)
    xn = torch.rand(1, 4, 4, 128)
    PNB.pool2x2_nhwc_bwd(xn, PN.pool2x2_nhwc(xn))
    wn = torch.rand(128, 128, 2, 2)
    TNB.tconv2x2_nhwc_bwd(xn, TN.tconv2x2_nhwc(xn, wn, torch.rand(128)), wn)
    assert kernels.launch_counts() == {
        'conv_chain': 0, 'conv_chain_bwd': 0, 'tconv2x2': 0,
        'tconv2x2_bwd': 0, 'stencil_conv': 0, 'stencil_conv_bwd': 0,
        'warp_twopass': 0, 'cca': 0, 'pool2x2_nhwc': 0,
        'pool2x2_nhwc_bwd': 0, 'tconv2x2_nhwc': 0, 'tconv2x2_nhwc_bwd': 0}


def test_wrappers_raise_outside_their_bounds():
    x = torch.zeros(1, 33, 8, 8)
    with pytest.raises(ValueError, match='at most 32'):
        CC.conv_chain(x, torch.zeros(4, 33, 3, 3), torch.zeros(4),
                      torch.zeros(4, 4, 3, 3), torch.zeros(4))
    with pytest.raises(ValueError, match='odd K'):
        CC.conv_chain(torch.zeros(1, 3, 8, 8), torch.zeros(4, 3, 2, 2),
                      torch.zeros(4), torch.zeros(4, 4, 2, 2), torch.zeros(4))
    with pytest.raises(ValueError, match='do not chain'):
        CC.conv_chain(torch.zeros(1, 3, 8, 8), torch.zeros(4, 3, 3, 3),
                      torch.zeros(4), torch.zeros(4, 5, 3, 3), torch.zeros(4))
    with pytest.raises(ValueError, match='at most 64'):
        TC.tconv2x2(torch.zeros(1, 65, 4, 4), torch.zeros(65, 2, 2, 2),
                    torch.zeros(2))
    with pytest.raises(ValueError, match='at most 32'):
        SC.stencil_conv(torch.zeros(1, 40, 4, 4), torch.zeros(1, 40, 1, 1),
                        torch.zeros(1), ((0, 0), (0, 0)))


def test_non_cpu_non_cuda_tensors_raise():
    '''Only CPU tensors take the plain version; anything that is not a CUDA
    tensor after that raises instead of running a fallback.'''
    meta = dict(device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        CC.conv_chain(torch.empty(1, 3, 8, 8, **meta),
                      torch.empty(3, 3, 3, 3, **meta),
                      torch.empty(3, **meta),
                      torch.empty(3, 3, 3, 3, **meta),
                      torch.empty(3, **meta))
    with pytest.raises(ValueError, match='CUDA tensor'):
        TC.tconv2x2(torch.empty(1, 3, 4, 4, **meta),
                    torch.empty(3, 3, 2, 2, **meta), torch.empty(3, **meta))
    with pytest.raises(ValueError, match='CUDA tensor'):
        SC.stencil_conv(torch.empty(1, 3, 4, 4, **meta),
                        torch.empty(1, 3, 1, 1, **meta),
                        torch.empty(1, **meta), ((0, 0), (0, 0)))
    x, c = torch.empty(1, 3, 8, 8, **meta), torch.empty(1, 3, 8, 8, **meta)
    with pytest.raises(ValueError, match='CUDA tensor'):
        CCB.conv_chain_bwd(x, c, c, c, torch.empty(3, 3, 3, 3, **meta),
                           torch.empty(3, 3, 3, 3, **meta))
    with pytest.raises(ValueError, match='CUDA tensor'):
        TCB.tconv2x2_bwd(x, torch.empty(1, 2, 16, 16, **meta),
                         torch.empty(3, 2, 2, 2, **meta))
    with pytest.raises(ValueError, match='CUDA tensor'):
        SCB.stencil_conv_bwd(x, torch.empty(1, 1, 8, 8, **meta),
                             torch.empty(1, 3, 1, 1, **meta),
                             ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match='CUDA tensor'):
        WT.warp_twopass(torch.empty(1, 8, 8, 6, **meta),
                        torch.empty(1, 8, 8, 2, **meta))
