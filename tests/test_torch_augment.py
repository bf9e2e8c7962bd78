'''The port's augmentation chain and warp on the CPU against the JAX package.

JAX's random streams cannot be replayed in torch, so the parity tests draw
with JAX (its own key threading in build_augment_fn) and feed those draws to
the port's apply functions; the port's samplers get distribution tests.

Tolerances: the two-pass resample within 1e-6 absolute of the Pallas kernel
in interpret mode (the same f32 operations; values in [0, 1]); the bank's
coarse flows of each package within 0.05 px of an f64 solve of the same
control points at the production density (100 points on 256 px) and 0.005
px at a sparser one (test_coarse_flow_matches_jax says why); images
through the chain within 2e-5 absolute (means and upsampling matmuls
summed in another order).
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

# the per-step and intra-channel warps on smooth images: both packages solve
# the spline in f32 with different LU code, so their flows differ a little
# (test_coarse_flow_matches_jax), and a sample moves by that times the
# image's gradient: 3.0e-6 measured for random_warp's options, 1.0e-4 for
# the intra-channel options (stddev 5, max_diff 100: larger, unclamped
# flows); each bound is about 10x that
WARP_ATOL = 3e-5
INTRA_ATOL = 1e-3
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


def _smooth_images(b, size, c, seed):
    '''Gaussian blobs in [0, 1] (tests/test_augment_fused.py's batch).'''
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    images = np.zeros((b, size, size, c), np.float32)
    for i in range(b):
        for _ in range(4):
            cy, cx = rng.uniform(10, size - 10, 2)
            images[i, ..., rng.integers(0, c)] += np.exp(
                -(((yy - cy) ** 2 + (xx - cx) ** 2) / 60.0)
            ).astype(np.float32)
    return np.clip(images, 0, 1)


def _jax_points(n, n_points, size, seed):
    src, dst = jax_augment._warp_points(jax.random.PRNGKey(seed), n, n_points,
                                        size, 2.0, 5)
    return np.asarray(src), np.asarray(dst)


def _f64_coarse_flow(src, dst, size, max_displacement, stride):
    '''The coarse two-pass flows of ``coarse_twopass_flow`` solved and
    evaluated in f64 with numpy: the thin-plate spline through the
    destination points (scaled by 1 / size), clamped to +-d, fy re-evaluated
    at the target column x + fx.'''
    def phi(r2):
        return 0.5 * r2 * np.log(np.maximum(r2, 1e-10))

    def design(q, p):
        return phi(((q[:, None] - p[None]) ** 2).sum(-1)), np.concatenate(
            [np.ones((len(q), 1)), q], 1)

    scale = 1.0 / size
    n_coarse = -(-(size - 1) // stride) + 1
    gy, gx = np.meshgrid(np.arange(n_coarse) * stride,
                         np.arange(n_coarse) * stride, indexing='ij')
    flows = []
    for s, d in zip(src.astype(np.float64), dst.astype(np.float64)):
        p = d * scale
        a, bm = design(p, p)
        lhs = np.block([[a, bm], [bm.T, np.zeros((3, 3))]])
        sol = np.linalg.solve(lhs, np.concatenate([d - s, np.zeros((3, 2))]))

        def spline(q, p=p, sol=sol):
            phi_q, aff = design(q * scale, p)
            return phi_q @ sol[:len(p)] + aff @ sol[len(p):]

        fl = np.clip(spline(np.stack([gy.ravel(), gx.ravel()], -1)),
                     -max_displacement, max_displacement)
        fx = fl[:, 1].reshape(gy.shape)
        fy = spline(np.stack([gy.ravel(), (gx + fx).ravel()], -1))[:, 0]
        flows.append(np.stack([fy.reshape(gy.shape), fx], -1))
    return np.stack(flows)


@pytest.mark.parametrize('size,n_points,tol', [(256, 100, 0.05),
                                               (64, 30, 0.005)])
def test_coarse_flow_matches_jax(size, n_points, tol):
    '''Both packages solve the ill-conditioned thin-plate system in f32,
    each with its own LU (MKL's through torch.linalg.solve, the LAPACK call
    of XLA:CPU), so each lands some way from the exact solve. On these
    seeds each is within 0.0022-0.0088 px of the f64 solve at 256 px and the
    two within 0.0035-0.009 px of each other, the same at 1 to 6 torch
    threads, at any alignment of the solve's buffers and with the JAX
    compile cache off. Earlier hosts measured each side up to 0.04-0.09 px
    from f64 and the two 0.02 px apart, and one full run saw them more than
    0.05 apart: the f32 solve's error depends on the host's LAPACK code
    path, not on the port, so the gap between two f32 solves was no sound
    check. Each side is held to the f64 solve of the same points instead,
    which both meet with a margin of 5x or more.'''
    src, dst = _jax_points(3, n_points, size, seed=1)
    want = np.asarray(jax_warp.coarse_twopass_flow(
        jnp.asarray(src), jnp.asarray(dst), (size, size), max_displacement=8,
        flow_grid_stride=4))
    got = warp.coarse_twopass_flow(_t(src), _t(dst), (size, size),
                                   max_displacement=8, flow_grid_stride=4)
    assert got.shape == want.shape == (3, size // 4 + 1, size // 4 + 1, 2)
    exact = _f64_coarse_flow(src, dst, size, 8, 4)
    errs = {'port - f64': float(np.abs(got.numpy() - exact).max()),
            'jax - f64': float(np.abs(want - exact).max()),
            'port - jax': float(np.abs(got.numpy() - want).max())}
    print('coarse flow max|diff| px', errs)
    assert errs['port - f64'] <= tol and errs['jax - f64'] <= tol, errs


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
    with pytest.raises(NotImplementedError, match='RGB'):
        augment.parse_augment_options({'random_hue': None}, SLICE_TYPES)


@pytest.mark.parametrize('method,stride', [('two_pass', 4), ('two_pass', 1),
                                           ('exact', 1)])
def test_sparse_image_warp_matches_jax(method, stride):
    '''The per-step warp, both methods, on the same points and images
    (the flow clamped, as random_warp asks).'''
    src, dst = _jax_points(2, 20, 48, seed=6)
    image = _smooth_images(2, 48, 6, seed=6)
    kwargs = dict(method=method, max_displacement=8, clamp_flow=True,
                  flow_grid_stride=stride)
    want = jax_warp.sparse_image_warp(jnp.asarray(image), jnp.asarray(src),
                                      jnp.asarray(dst), **kwargs)
    got = warp.sparse_image_warp(_t(image), _t(src), _t(dst), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WARP_ATOL)


def test_dense_image_warp_matches_jax():
    '''map_coordinates' bilinear gather with edge clamping, at a flow that
    reaches past every edge.'''
    rng = np.random.default_rng(8)
    image = _images(2, 24, seed=8)
    flow = (rng.standard_normal((2, 24, 24, 2)) * 9).astype(np.float32)
    want = jax_warp.dense_image_warp(jnp.asarray(image), jnp.asarray(flow))
    got = warp.dense_image_warp(_t(image), _t(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_intrachannelwarp_matches_jax():
    '''random_intrachannelwarp with JAX's per-group draws: the label
    paired with channel 0, every other channel alone.'''
    images = _smooth_images(2, 40, 6, seed=6)
    key = jax.random.PRNGKey(6)
    opts = dict(n_points=20, max_diff=100, stddev=5.0)
    want = jax_augment.random_intrachannelwarp_batch(jnp.asarray(images), key,
                                                     **opts)
    groups = augment._channel_groups(6, ((0, -1),))
    assert groups == [[0, 5], [1], [2], [3], [4]]
    draws = [tuple(map(_t, jax_augment._warp_points(k, 2, 20, 40, 5.0, 100)))
             for k in jax.random.split(key, len(groups))]
    got = augment.apply_intrachannelwarp(_t(images), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=INTRA_ATOL)


def test_bank_serves_only_random_warp():
    '''With a bank of the crop size random_warp draws bank fields, and
    random_intrachannelwarp after it still draws its own points per
    group.'''
    methods = augment.parse_augment_options(
        {'random_crop': None, 'random_warp': None,
         'random_intrachannelwarp': {'n_points': 10}}, SLICE_TYPES, (32, 32))
    gen = torch.Generator().manual_seed(4)
    bank = augment.build_warp_bank(gen, 4, (32, 32), n_points=10)
    images = _t(_images(2, 44, seed=9))
    draws = augment.draw_chain(methods, images.shape, gen, bank)
    assert [d.shape for d in draws[1]] == [(2,)] * 3        # index, mirrors
    assert len(draws[2]) == 5 and all(
        s.shape == d.shape == (2, 10, 2) for s, d in draws[2])
    want = augment.apply_intrachannelwarp(augment.apply_banked_warp(
        augment.apply_crop(images, draws[0], (32, 32)), bank, draws[1]),
        draws[2])
    assert torch.equal(augment.apply_chain(methods, images, draws, bank),
                       want)


def test_per_step_warp_draws():
    '''The per-step warp draws its points over the image width at its
    place in the chain (the crop's, not the window's).'''
    methods = augment.parse_augment_options(
        {'random_crop': None, 'random_warp': {'n_points': 50},
         'random_intrachannelwarp': {'paired': [[1, 2]], 'n_points': 7}},
        SLICE_TYPES, (32, 32))
    gen = torch.Generator().manual_seed(2)
    _, (src, dst), groups = augment.draw_chain(methods, (400, 44, 44, 6), gen)
    assert src.shape == (400, 50, 2)
    assert 0 <= src.min() and src.max() < 32
    assert abs(src.double().mean() - 16) < 0.1
    assert abs(src.double().std() - 32 / 12 ** 0.5) < 0.05
    d = (dst - src).double()
    assert d.abs().max() <= 5 + 1e-4 and abs(d.std() - 2.0) < 0.05
    assert abs(d.mean()) < 0.04      # 4 standard errors
    # groups [1, 2], then 0, 3, 4, 5 alone
    assert len(groups) == 5 and groups[0][0].shape == (400, 7, 2)
