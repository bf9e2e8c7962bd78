'''The port's UNetAnnotator against the JAX model, and the weight converter.

The model is unet.yaml's (3 first filters, 3 levels, SAME, no BN) at B=2,
256 x 256, so every site class of the prediction path is hit, including
the W=128 tconv. The JAX side runs ``apply(..., return_logits=True)``
through its XLA route (the plain reference of its Pallas kernels on the
CPU); the port runs the plain versions of its kernels on converted params.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_torch import convert
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.models import blocks

UNET_OPTIONS = dict(n_filters_first=3, n_downsample=3, rate=2, kernel_size=3,
                    conv_stride=1, bn=False, padding='same')


def flat_params(params):
    '''Flax params tree -> {'params/...': np.ndarray}.'''
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = '/'.join(['params'] + [str(k.key) for k in path])
        flat[key] = np.asarray(leaf)
    return flat


@pytest.fixture(scope='module')
def unet_case():
    rng = np.random.default_rng(0)
    x = rng.random((2, 256, 256, 5), dtype=np.float32)
    model, _ = jax_models.build_model('UNetAnnotator', UNET_OPTIONS)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))['params']
    flat = flat_params(params)
    # non-zero biases, so a misplaced bias shows
    for key in flat:
        if key.endswith('/bias'):
            flat[key] = (rng.standard_normal(flat[key].shape) * 0.1
                         ).astype(np.float32)
    return model, x, flat


def _jax_params(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split('/')[1:]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def test_unet_logits_match_jax(unet_case):
    model, x, flat = unet_case
    want = np.asarray(model.apply({'params': _jax_params(flat)},
                                  jnp.asarray(x), return_logits=True))
    port, _ = torch_models.build_model('UNetAnnotator', UNET_OPTIONS,
                                       in_channels=5)
    port.load_state_dict(convert.torch_state_from_flax(
        flat, expected=port.state_dict()))
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_logits=True).numpy()
    assert got.shape == want.shape == (2, 256, 256, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('overrides,size', [
    (dict(padding='valid'), 140),    # VALID convs and the skip center-crop
    (dict(activation={'class_name': 'LeakyReLU',
                      'config': {'alpha': 0.3}}), 64),  # per-conv path
])
def test_unet_variants_match_jax(overrides, size):
    options = dict(UNET_OPTIONS, **overrides)
    rng = np.random.default_rng(1)
    x = rng.random((1, size, size, 5), dtype=np.float32)
    model, _ = jax_models.build_model('UNetAnnotator', options)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(x))['params']
    want = np.asarray(model.apply({'params': params}, jnp.asarray(x),
                                  return_logits=True))
    port, _ = torch_models.build_model('UNetAnnotator', options,
                                       in_channels=5)
    assert not any(m.fused for m in port.modules()
                   if isinstance(m, blocks.ConvChain))
    port.load_state_dict(convert.torch_state_from_flax(
        flat_params(params), expected=port.state_dict()))
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_logits=True).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_unet_routes_every_chain_through_conv_chain():
    '''All six ConvChain sites of unet.yaml fuse into the chain kernel.'''
    port, _ = torch_models.build_model('UNetAnnotator', UNET_OPTIONS,
                                       in_channels=5)
    chains = [m for m in port.modules() if isinstance(m, blocks.ConvChain)]
    assert len(chains) == 6
    assert all(c.fused for c in chains)


def test_converter_round_trip(unet_case):
    _, _, flat = unet_case
    back = convert.flax_from_torch_state(convert.torch_state_from_flax(flat))
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


@pytest.mark.parametrize('edit', ['missing', 'extra', 'foreign'])
def test_converter_rejects_mismatched_keys(unet_case, edit):
    _, _, flat = unet_case
    flat = dict(flat)
    port, _ = torch_models.build_model('UNetAnnotator', UNET_OPTIONS,
                                       in_channels=5)
    if edit == 'missing':
        del flat['params/last_conv/bias']
    elif edit == 'extra':
        flat['params/unet/encoder/down_9/convchain/conv_0/bias'] = \
            np.zeros(3, np.float32)
    else:
        flat['batch_stats/unet/mean'] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        convert.torch_state_from_flax(flat, expected=port.state_dict())


def test_unported_models_raise():
    '''What the port once refused now runs: bf16 compute builds in each of
    the three models, and a strided conv (stride 2, SAME, 3 -> 4 channels:
    the JAX package's small einsum form) equals the JAX Conv2DFast on the
    same weights, in NHWC and NCHW, in f32 (within 1e-5 of its scale) and
    in bf16 (within a bf16 ulp of it: one rounding on each side after f32
    sums in other orders).'''
    from dnncancerannotator_tpu.models import fastconv as jax_fastconv
    for name, options in (('UNetAnnotator', UNET_OPTIONS),
                          ('MulmoUNetAnnotator', UNET_OPTIONS),
                          ('MultiResUnet', {})):
        torch_models.build_model(name, dict(options, dtype='bfloat16'),
                                 in_channels=5)
    rng = np.random.default_rng(4)
    kernel = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    x = rng.random((2, 9, 8, 3), dtype=np.float32)
    for dtype in (None, 'bfloat16'):
        for fmt in ('NHWC', 'NCHW'):
            arr = x if fmt == 'NHWC' else x.transpose(0, 3, 1, 2)
            want = np.asarray(jax_fastconv.Conv2DFast(
                features=4, kernel_size=(3, 3), strides=(2, 2),
                activation='relu', data_format=fmt,
                dtype=jnp.bfloat16 if dtype else None).apply(
                    {'params': {'kernel': kernel, 'bias': bias}},
                    jnp.asarray(arr)).astype(jnp.float32))
            conv = blocks.fastconv.Conv2DFast(3, 4, (3, 3), strides=(2, 2),
                                              activation='relu',
                                              data_format=fmt, dtype=dtype)
            conv.load_state_dict({'weight': torch.from_numpy(
                kernel.transpose(3, 2, 0, 1).copy()),
                'bias': torch.from_numpy(bias)})
            with torch.no_grad():
                got = conv(torch.from_numpy(arr.copy())).float().numpy()
            assert got.shape == want.shape == (
                (2, 5, 4, 4) if fmt == 'NHWC' else (2, 4, 5, 4))
            tol = 2.0 ** -8 if dtype else 1e-5
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=tol * np.abs(want).max(),
                                       err_msg=f'{fmt} {dtype}')
