'''The plain backwards of the transposed conv and the stencil conv on the
CPU against the Pallas backwards they replace (flattconv._bwd_call,
stencil_conv2d_bwd_pallas).

Inputs are made with seeded numpy and handed to both packages; the Pallas
kernels run in interpret mode, as the JAX package's tests run them. The
port's gradients hold within 5e-6 * max|ref| (f32 sums of up to a few
thousand terms, taken in another order; <= 5e-7 measured).
'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu.ops.pallas import conv_kernel, flattconv
from dnncancerannotator_torch.ops.kernels import stencil_conv_bwd as SCB
from dnncancerannotator_torch.ops.kernels import tconv2x2_bwd as TCB

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


# -- transposed conv backward ----------------------------------------------------------
@pytest.mark.parametrize('b,ci,h,w,co', [
    (2, 6, 8, 128, 3),    # up_2's class
    (2, 12, 8, 64, 6),
    (2, 24, 8, 32, 12),
])
def test_tconv_bwd_matches_flat_tconv(b, ci, h, w, co):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, ci, h, w)).astype(np.float32)
    wk = (rng.standard_normal((2, 2, ci, co)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, co, 2 * h, 2 * w)).astype(np.float32)
    dx_ref, dw_ref, db_ref = flattconv._bwd_call(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(wk), True)
    # the port's weight is the flax kernel flipped (convert.py); so is dw
    w_port = _t(wk[::-1, ::-1].transpose(2, 3, 0, 1))
    dx, dw, db = TCB.tconv2x2_bwd(_t(x), _t(g), w_port)
    _close(dx, dx_ref)
    _close(dw, np.asarray(dw_ref)[::-1, ::-1].transpose(2, 3, 0, 1))
    _close(db, db_ref)


# -- stencil conv backward ------------------------------------------------------------
@pytest.mark.parametrize('k,ci,co,pads', [
    (1, 3, 1, ((0, 0), (0, 0))),   # the logits head
    (3, 3, 3, ((1, 1), (1, 1))),
    (3, 4, 2, ((0, 2), (1, 0))),
])
def test_stencil_bwd_matches_pallas(k, ci, co, pads):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, ci, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) * 0.3).astype(np.float32)
    oh = 8 + pads[0][0] + pads[0][1] - k + 1
    ow = 8 + pads[1][0] + pads[1][1] - k + 1
    g = rng.standard_normal((2, co, oh, ow)).astype(np.float32)
    want = conv_kernel.stencil_conv2d_bwd_pallas(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(w), pads=pads, nchw=True,
        interpret=True)
    dx, dw, db = SCB.stencil_conv_bwd(_t(x), _t(g), _oihw(w), pads)
    _close(dx, want[0])
    _close(_hwio(dw), want[1])
    _close(db, want[2])


