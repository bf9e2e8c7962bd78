'''The port's gradients on the CPU: the max-pool gradient at ties, and
every parameter gradient of the UNetAnnotator against ``jax.grad`` of the
JAX model on converted weights (the kernels' backwards one by one are in
test_torch_chain_bwd.py and test_torch_conv_bwd.py).

Inputs are made with seeded numpy and handed to both packages. Tolerances:
the pool's gradient exactly; the model's parameter gradients within
2e-5 * max|ref| per tensor (f32 sums of up to a few thousand terms per
layer, taken in another order, through 13 layers; 2.2e-6 measured).
'''

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_tpu.ops import pooling as jax_pooling
from dnncancerannotator_torch import convert
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.ops import kernels, pooling
from dnncancerannotator_torch.ops.kernels import conv_chain_bwd as CCB
from tests.test_torch_unet import UNET_OPTIONS, _jax_params, flat_params

_MODEL_TOL = 2e-5


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- max pool at ties ---------------------------------------------------------------
def _pool_grads(x):
    xt = torch.from_numpy(x).requires_grad_()
    pooling.max_pool2d(xt, 2).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_pooling.max_pool2d(
        v, 2, data_format='NCHW')))(jnp.asarray(x))
    return xt.grad.numpy(), np.asarray(want)


def test_max_pool_grad_splits_ties_as_jax():
    x = np.array([[1, 1], [1, 0]], np.float32).reshape(1, 1, 2, 2)
    got, want = _pool_grads(x)
    np.testing.assert_array_equal(want.reshape(-1), [0.25, 0.5, 0.25, 0.0])
    np.testing.assert_array_equal(got, want)


def test_max_pool_grad_with_planted_ties_equals_jax():
    rng = np.random.default_rng(0)
    # three levels: most windows hold ties; odd sizes drop a row and a column
    x = rng.integers(0, 3, (2, 3, 9, 7)).astype(np.float32)
    got, want = _pool_grads(x)
    np.testing.assert_array_equal(got, want)
    assert pooling.max_pool2d(torch.from_numpy(x), 2).shape == (2, 3, 4, 3)


# -- the model ---------------------------------------------------------------------
def test_unet_param_grads_match_jax():
    '''Every parameter gradient of unet.yaml's UNetAnnotator (B=2, 32 x 32)
    for the loss sum(logits * G), against jax.grad on the same weights.'''
    rng = np.random.default_rng(4)
    x = rng.random((2, 32, 32, 5), dtype=np.float32)
    gmap = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    model, _ = jax_models.build_model('UNetAnnotator', UNET_OPTIONS)
    params = model.init(jax.random.PRNGKey(4), jnp.asarray(x[:1]))['params']
    flat = flat_params(params)
    for key in flat:
        if key.endswith('/bias'):
            flat[key] = (rng.standard_normal(flat[key].shape) * 0.1
                         ).astype(np.float32)

    def loss(p):
        logits = model.apply({'params': p}, jnp.asarray(x),
                             return_logits=True)
        return jnp.sum(logits * jnp.asarray(gmap))

    want = convert.torch_state_from_flax(
        flat_params(jax.jit(jax.grad(loss))(_jax_params(flat))))
    port, _ = torch_models.build_model('UNetAnnotator', UNET_OPTIONS,
                                       in_channels=5)
    port.load_state_dict(convert.torch_state_from_flax(
        flat, expected=port.state_dict()))
    kernels.reset_launches()
    (port(_t(x), return_logits=True) * _t(gmap)).sum().backward()
    got = {name: p.grad for name, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], _MODEL_TOL)
    # CPU tensors take the plain versions: no kernel was launched
    assert set(kernels.launch_counts().values()) == {0}


def test_first_chain_skips_its_data_gradient(monkeypatch):
    '''The input batch needs no gradient, so only down_0's chain backward
    runs without dx (need_dx=False in the JAX package).'''
    calls = []
    real = CCB.conv_chain_bwd

    def spy(x, c1, c2, g, w1, w2, need_dx=True):
        calls.append((tuple(x.shape), need_dx))
        return real(x, c1, c2, g, w1, w2, need_dx)

    monkeypatch.setattr(CCB, 'conv_chain_bwd', spy)
    port, _ = torch_models.build_model(
        'UNetAnnotator', UNET_OPTIONS, in_channels=5,
        generator=torch.Generator().manual_seed(0))
    port(torch.rand(1, 16, 16, 5), return_logits=True).sum().backward()
    assert sorted(calls) == sorted([
        ((1, 5, 16, 16), False), ((1, 3, 8, 8), True), ((1, 6, 4, 4), True),
        ((1, 24, 4, 4), True), ((1, 12, 8, 8), True), ((1, 6, 16, 16), True)])


def test_predict_saves_nothing_for_backward():
    '''Without grad recording the chain kernel runs alone: no c1 kept.'''
    port, _ = torch_models.build_model('UNetAnnotator', UNET_OPTIONS,
                                       in_channels=5)
    with torch.no_grad():
        out = port(torch.rand(1, 16, 16, 5), return_logits=True)
    assert out.grad_fn is None
