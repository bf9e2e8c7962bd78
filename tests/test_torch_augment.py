'''The port's augmentation chain and warp on the CPU against the JAX package.

JAX's random streams cannot be replayed in torch, so the parity tests draw
with JAX (its own key threading in build_augment_fn) and feed those draws to
the port's apply functions; the port's samplers get distribution tests.

Tolerances: the two-pass resample within 1e-6 absolute of the Pallas kernel
in interpret mode (the same f32 operations; values in [0, 1]); the bank's
coarse flows within 0.05 px of JAX's for the same control points at the
production density (100 points on 256 px) and 0.005 px at a sparser one:
both packages solve the ill-conditioned thin-plate system in f32 with
different LU code, and each lands up to ~0.04-0.09 px from an f64 solve at
100 points (measured on these seeds, where the two disagree by up to 0.02
px at 256 px); images through the chain within 2e-5 absolute (means and
upsampling matmuls summed in another order).
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu.data import augment as jax_augment
from dnncancerannotator_tpu.ops import warp as jax_warp
from dnncancerannotator_tpu.ops.pallas import warp_kernel
from dnncancerannotator_torch.data import augment
from dnncancerannotator_torch.ops import warp
from dnncancerannotator_torch.ops.kernels import warp_twopass as WT

SLICE_TYPES = ('TRA', 'ADC', 'DWI', 'DCEE', 'DCEL', 'label')
CHAIN = {'random_crop': None, 'random_flip': None, 'random_contrast': None,
         'random_warp': None}


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(b, size, seed):
    rng = np.random.default_rng(seed)
    images = rng.random((b, size, size, 6), dtype=np.float32)
    images[..., 5] = (images[..., 5] > 0.7).astype(np.float32)   # the label
    return images


@pytest.mark.parametrize('d,scale', [(8, 4.0), (3, 10.0)])
def test_twopass_resample_matches_pallas(d, scale):
    '''The flows exceed +-d at scale 10, so the clamp is exercised.'''
    rng = np.random.default_rng(0)
    image = rng.random((2, 24, 40, 6), dtype=np.float32)
    flow = (rng.standard_normal((2, 24, 40, 2)) * scale).astype(np.float32)
    want = warp_kernel.dense_image_warp_twopass_pallas(
        jnp.asarray(image), jnp.asarray(flow), max_displacement=d,
        interpret=True)
    got = WT.warp_twopass(_t(image), _t(flow), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _jax_points(n, n_points, size, seed):
    src, dst = jax_augment._warp_points(jax.random.PRNGKey(seed), n, n_points,
                                        size, 2.0, 5)
    return np.asarray(src), np.asarray(dst)


@pytest.mark.parametrize('size,n_points,tol', [(256, 100, 0.05),
                                               (64, 30, 0.005)])
def test_coarse_flow_matches_jax(size, n_points, tol):
    src, dst = _jax_points(3, n_points, size, seed=1)
    want = jax_warp.coarse_twopass_flow(
        jnp.asarray(src), jnp.asarray(dst), (size, size), max_displacement=8,
        flow_grid_stride=4)
    got = warp.coarse_twopass_flow(_t(src), _t(dst), (size, size),
                                   max_displacement=8, flow_grid_stride=4)
    assert got.shape == want.shape == (3, size // 4 + 1, size // 4 + 1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def test_warp_with_coarse_flow_matches_jax():
    src, dst = _jax_points(2, 30, 48, seed=2)
    coarse = jax_warp.coarse_twopass_flow(
        jnp.asarray(src), jnp.asarray(dst), (48, 48), max_displacement=8)
    image = _images(2, 48, seed=2)
    want = jax_warp.warp_with_coarse_flow(jnp.asarray(image), coarse,
                                          max_displacement=8)
    got = warp.warp_with_coarse_flow(_t(image), _t(coarse),
                                     max_displacement=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def _jax_draws(methods, b, key, n_bank):
    '''The draws of the JAX package's build_augment_fn for this key: one
    split per method, per-image splits for flip and contrast, three for the
    banked warp.'''
    keys = jax.random.split(key, len(methods))
    draws = []
    for (name, o), k in zip(methods, keys):
        if name == 'random_crop':
            noise = jax.random.normal(k, [b, 2]) * o.get('stddev', 4)
            draws.append(_t(jnp.clip(noise.astype(jnp.int32), -6, 6)).long())
        elif name == 'random_flip':
            draws.append(_t(jax.vmap(jax.random.bernoulli)(
                jax.random.split(k, b))))
        elif name == 'random_contrast':
            draws.append(_t(jax.vmap(lambda kk: jax.random.uniform(
                kk, (), minval=0.8, maxval=1.2))(jax.random.split(k, b))))
        else:
            k_idx, k_ud, k_lr = jax.random.split(k, 3)
            draws.append((
                _t(jax.random.randint(k_idx, [b], 0, n_bank)).long(),
                _t(jax.random.bernoulli(k_ud, shape=(b,))),
                _t(jax.random.bernoulli(k_lr, shape=(b,)))))
    return draws


@pytest.mark.parametrize('n_ops', [1, 2, 3, 4])
def test_chain_with_jax_draws_matches_build_augment_fn(n_ops):
    '''crop -> flip -> contrast -> banked warp (prefixes of it) on 44 x 44
    windows cropped to 32 x 32, the label channel riding along.'''
    options = dict(list(CHAIN.items())[:n_ops])
    methods = jax_augment.parse_augment_options(options, SLICE_TYPES,
                                                (32, 32))
    bank = jax_augment.build_warp_bank(jax.random.PRNGKey(3), 6, (32, 32),
                                       n_points=20)
    images = _images(4, 44, seed=3)
    key = jax.random.PRNGKey(4)
    want = jax_augment.build_augment_fn(methods, warp_bank=bank)(
        jnp.asarray(images), key)
    port_methods = augment.parse_augment_options(options, SLICE_TYPES,
                                                 (32, 32))
    assert port_methods == methods
    port_bank = dict(bank, flows=_t(bank['flows']))
    got = augment.apply_chain(port_methods, _t(images),
                              _jax_draws(methods, 4, key, 6), port_bank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_contrast_leaves_the_label_alone():
    images = _t(_images(2, 16, seed=5))
    out = augment.apply_contrast(images, torch.tensor([0.8, 1.2]),
                                 target_channels=range(5))
    assert torch.equal(out[..., 5], images[..., 5])
    assert not torch.equal(out[..., :5], images[..., :5])


def test_samplers_distributions():
    gen = torch.Generator().manual_seed(0)
    n = 40000
    diff = augment.draw_crop(gen, n // 2).reshape(-1).double()
    assert diff.min() == -6 and diff.max() == 6
    assert abs(diff.mean()) < 0.05
    # trunc(N(0, 4)) == 0 iff |z| < 1/4: P = 0.1974
    assert abs((diff == 0).double().mean() - 0.1974) < 0.01
    assert abs(augment.draw_flip(gen, n).double().mean() - 0.5) < 0.01
    f = augment.draw_contrast(gen, n).double()
    assert 0.8 <= f.min() and f.max() < 1.2 and abs(f.mean() - 1.0) < 0.003
    idx, ud, lr = augment.draw_banked_warp(gen, n, 8)
    counts = torch.bincount(idx, minlength=8).double() / n
    assert (counts - 1 / 8).abs().max() < 0.01
    assert abs(ud.double().mean() - 0.5) < 0.01
    assert abs(lr.double().mean() - 0.5) < 0.01
    src, dst = augment._warp_points(gen, 100, 100, 256, 2.0, 5)
    assert 0 <= src.min() and src.max() < 256
    d = (dst - src).double()
    assert d.abs().max() <= 5 + 1e-4 and abs(d.std() - 2.0) < 0.05


def test_warp_bank():
    gen = torch.Generator().manual_seed(1)
    bank = augment.build_warp_bank(gen, 5, (32, 32), n_points=20, chunk=2)
    assert bank['flows'].shape == (5, 9, 9, 2)
    assert bank['max_displacement'] == 8 and bank['stride'] == 4
    assert bank['out_size'] == (32, 32)
    assert bank['flows'].abs().max() <= 8
    gen.manual_seed(1)
    src, dst = augment._warp_points(gen, 5, 20, 32, 2.0, 5)
    torch.testing.assert_close(
        bank['flows'], warp.coarse_twopass_flow(src, dst, (32, 32)),
        rtol=0, atol=0)


def test_unported_chains_raise():
    methods = augment.parse_augment_options(CHAIN, SLICE_TYPES, (32, 32))
    with pytest.raises(NotImplementedError, match='per-step'):
        augment.build_augment_fn(methods, warp_bank=None)
    methods = augment.parse_augment_options(
        {'random_intrachannelwarp': None}, SLICE_TYPES, (32, 32))
    with pytest.raises(NotImplementedError, match='random_intrachannelwarp'):
        augment.build_augment_fn(methods)
    with pytest.raises(NotImplementedError, match='RGB'):
        augment.parse_augment_options({'random_hue': None}, SLICE_TYPES)
