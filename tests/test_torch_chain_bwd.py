'''The conv chain's plain backward on the CPU against both Pallas chain
backwards it replaces: conv_chain_bwd_pallas (with and without dx) and
flatchain's im2col and nine-dot backwards.

Inputs are made with seeded numpy and handed to both packages; the Pallas
kernels run in interpret mode, as the JAX package's tests run them. The
port's gradients hold within 5e-6 * max|ref| (f32 sums of up to a few
thousand terms, taken in another order; <= 5e-7 measured).
'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu.ops.pallas import conv_kernel, flatchain
from dnncancerannotator_torch.ops.kernels import conv_chain as CC
from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB

_REL_TOL = 5e-6


def _close(got, want, tol=_REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oihw(w_hwio):
    return _t(w_hwio.transpose(3, 2, 0, 1))


def _hwio(w_oihw):
    return np.asarray(w_oihw).transpose(2, 3, 1, 0)


# -- conv chain backward -------------------------------------------------------------
def _chain_case(b, ci, cm, co, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, ci, h, w)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, ci, cm)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(cm) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, cm, co)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(co) * 0.1).astype(np.float32)
    c1, c2 = CC.conv_chain(_t(x), _oihw(w1), _t(b1), _oihw(w2), _t(b2),
                           need_c1=True)
    g = rng.standard_normal(c2.shape).astype(np.float32)
    return x, w1, w2, c1.numpy(), c2.numpy(), g


def _port_chain_bwd(x, w1, w2, c1, c2, g, need_dx):
    return CCB.conv_chain_bwd(_t(x), _t(c1), _t(c2), _t(g), _oihw(w1),
                              _oihw(w2), need_dx=need_dx)


def _assert_chain_grads(got, want, need_dx):
    dx, dw1, db1, dw2, db2 = got
    assert (dx is None) == (not need_dx)
    if need_dx:
        _close(dx, want[0])
    _close(_hwio(dw1), want[1])
    _close(db1, want[2])
    _close(_hwio(dw2), want[3])
    _close(db2, want[4])


@pytest.mark.parametrize('need_dx', [True, False])
def test_chain_bwd_matches_pallas_stencil_chain(need_dx):
    '''down_0's class (5 -> 3 -> 3), with and without dx.'''
    x, w1, w2, c1, c2, g = _chain_case(2, 5, 3, 3, 8, 8, seed=0)
    want = conv_kernel.conv_chain_bwd_pallas(
        *map(jnp.asarray, (x, c1, c2, g, w1, w2)), pads=((1, 1), (1, 1)),
        interpret=True, need_dx=need_dx)
    got = _port_chain_bwd(x, w1, w2, c1, c2, g, need_dx)
    _assert_chain_grads(got, want, need_dx)


@pytest.mark.parametrize('im2col,ci,cm', [
    (True, 6, 12),    # down_2's class
    (True, 24, 12),   # up_0's class
    (False, 12, 6),   # up_1's class, nine-dot strategy
    (True, 12, 6),
])
def test_chain_bwd_matches_flat_chain(im2col, ci, cm):
    x, w1, w2, c1, c2, g = _chain_case(2, ci, cm, cm, 8, 8, seed=1)
    b, _, h, w = x.shape
    flat = [jnp.asarray(a.reshape(b, a.shape[1], h * w)) for a in (x, c1, c2,
                                                                  g)]
    if im2col:
        cmp_ = -(-cm // 8) * 8
        flat[1] = jnp.pad(flat[1], ((0, 0), (0, cmp_ - cm), (0, 0)))
        want = flatchain._bwd_call_im2col(
            flat[0], flat[1], flat[2], flat[3], jnp.asarray(w1),
            jnp.asarray(w2), w, True)
    else:
        want = flatchain._bwd_call(
            flat[0], flat[1], flat[2], flat[3], jnp.asarray(w1),
            jnp.asarray(w2), w, True)
    want = (np.asarray(want[0]).reshape(x.shape), *want[1:])
    _assert_chain_grads(_port_chain_bwd(x, w1, w2, c1, c2, g, True), want,
                        True)


