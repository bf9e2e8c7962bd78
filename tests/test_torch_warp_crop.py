'''The crop-fused warp and the fused augmentation chain of the port on the
CPU against the JAX package, and the routing between the fused, banked and
per-step chains.

Tolerances: the plain crop resample within 1e-6 absolute of the Pallas
kernel in interpret mode (the same f32 operations; values in [0, 1]). The
whole fused chain with JAX's draws within FUSED_ATOL: the two packages
solve the thin-plate system in f32 with different LU code, so their flows
differ a little (tests/test_torch_augment.py), which moves a sample of
these smooth images by up to 3.7e-5 (measured on these seeds, 12 control
points on 64 px); the bound is about 10x that.
'''

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu.data import augment as jax_augment
from dnncancerannotator_tpu.ops import gates as jax_gates
from dnncancerannotator_tpu.ops.pallas import warp_kernel
from dnncancerannotator_torch import engine
from dnncancerannotator_torch.data import augment, pipeline
from dnncancerannotator_torch.ops import gates
from dnncancerannotator_torch.ops.kernels import warp_crop as WC
from dnncancerannotator_torch.ops.kernels import warp_twopass as WT
from dnncancerannotator_torch.runs.__main__ import main
from tests import util_synth
from tests.test_torch_augment import _smooth_images
from tests.test_torch_train import CONFIGS, _overlay

FUSED_ATOL = 4e-4
SLICE_TYPES = ('TRA', 'ADC', 'label')


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('scale', [4.0, 14.0])
def test_crop_resample_matches_pallas(scale):
    '''[4, 76, 76, 3] windows cropped to 64 x 64 at d = 8, at offsets 0,
    in - out and mirrored ones (w_in - w_out - ox); at scale 14 the flows
    run well past +-d, so the clamp is exercised.'''
    rng = np.random.default_rng(0)
    image = rng.random((4, 76, 76, 3), dtype=np.float32)
    fy = (rng.standard_normal((4, 64, 76)) * scale).astype(np.float32)
    fx = (rng.standard_normal((4, 64, 64)) * scale).astype(np.float32)
    off = np.array([[0, 0], [12, 12], [5, 12 - 3], [12, 0]], np.int32)
    want = warp_kernel.dense_image_warp_crop_pallas(
        jnp.asarray(image), jnp.asarray(fy), jnp.asarray(fx),
        jnp.asarray(off), out_size=(64, 64), max_displacement=8,
        interpret=True)
    got = WC.warp_crop(_t(image), _t(fy), _t(fx), _t(off), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_crop_resample_is_crop_then_twopass():
    '''At every offset the fused resample equals cropping and then the
    two-pass resample with fy taken at the source columns.'''
    rng = np.random.default_rng(1)
    image = _t(rng.random((3, 20, 23, 2), dtype=np.float32))
    fy = _t(rng.standard_normal((3, 16, 23)).astype(np.float32) * 3)
    fx = _t(rng.standard_normal((3, 16, 17)).astype(np.float32) * 3)
    off = torch.tensor([[0, 6], [4, 0], [2, 3]], dtype=torch.int32)
    got = WC.warp_crop(image, fy, fx, off, 2)
    for i, (oy, ox) in enumerate(off.tolist()):
        crop = image[i:i + 1, oy:oy + 16, ox:ox + 17]
        flow = torch.stack([fy[i:i + 1, :, ox:ox + 17], fx[i:i + 1]], -1)
        assert torch.equal(got[i:i + 1], WT.plain(crop, flow, 2))
    with pytest.raises(ValueError, match='fit'):
        WC.warp_crop(image, fy, fx[:, :, :1].expand(3, 16, 30), off, 2)


def _methods(stride, **crop):
    return augment.parse_augment_options(
        {'random_crop': crop or None, 'random_flip': None,
         'random_contrast': None,
         'random_warp': {'flow_grid_stride': stride, 'n_points': 12}},
        SLICE_TYPES, (64, 64))


@pytest.mark.parametrize('stride,seed', [(1, 3), (4, 0)])
def test_fused_chain_matches_jax(monkeypatch, stride, seed):
    '''The JAX package's fused chain (the Pallas kernel in interpret mode)
    and the port's on the same windows with JAX's draws; both seeds give
    batches with flipped and unflipped images.'''
    methods = _methods(stride)
    assert methods == jax_augment.parse_augment_options(
        dict(zip(('random_crop', 'random_flip', 'random_contrast',
                  'random_warp'), (o for _, o in methods))), SLICE_TYPES,
        (64, 64))
    images = _smooth_images(6, 76, 3, seed)
    key = jax.random.PRNGKey(seed)
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')
    with jax_gates.active(jax_gates.KernelGates(fused_aug=True)):
        want = jax_augment.build_augment_fn(methods)(jnp.asarray(images), key)
    off, flips, factors, src, dst = (np.asarray(x) for x in
                                     jax_augment._chain_draws(
                                         images.shape, key, methods))
    assert flips.any() and not flips.all()
    draws = [_t(off - 6).long(), _t(flips), _t(factors), (_t(src), _t(dst))]
    got = augment.apply_fused_chain(methods, _t(images), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FUSED_ATOL)


class _Calls:
    '''Counts the CPU calls of the resamples' plain versions.'''

    def __init__(self, monkeypatch):
        self.n = {'warp_crop': 0, 'warp_twopass': 0}
        for mod, name in ((WC, 'warp_crop'), (WT, 'warp_twopass')):
            def counted(*args, _plain=mod.plain, _name=name):
                self.n[_name] += 1
                return _plain(*args)
            monkeypatch.setattr(mod, 'plain', counted)


def _route(methods, bank, fused_gate):
    images = torch.rand(4, 76, 76, 3, generator=torch.Generator()
                        .manual_seed(0))
    fn = augment.build_augment_fn(methods, warp_bank=bank)
    with gates.active(gates.KernelGates(fused_aug=fused_gate)):
        return fn(images, torch.Generator().manual_seed(1))


@pytest.mark.parametrize('fused_gate,with_bank,want', [
    (False, False, 'warp_twopass'),   # the composed per-step chain
    (False, True, 'warp_twopass'),    # the banked chain
    (True, True, 'warp_crop'),        # fused, even with a bank
])
def test_routing(monkeypatch, fused_gate, with_bank, want):
    monkeypatch.delenv('DNNCA_FUSEDAUG', raising=False)
    calls = _Calls(monkeypatch)
    bank = augment.build_warp_bank(torch.Generator().manual_seed(2), 4,
                                   (64, 64), n_points=12) if with_bank \
        else None
    out = _route(_methods(4), bank, fused_gate)
    assert out.shape == (4, 64, 64, 3)
    assert calls.n == {'warp_crop': 0, 'warp_twopass': 0, want: 1}


def test_same_draws_for_both_routes(monkeypatch):
    '''The fused route and the composed per-step route take one draw list,
    and at stride 1 they realize the same warp.'''
    monkeypatch.delenv('DNNCA_FUSEDAUG', raising=False)
    methods = _methods(1)
    images = _t(_smooth_images(4, 76, 3, 3))
    composed = _route(methods, None, False)
    fused = _route(methods, None, True)
    np.testing.assert_allclose(fused.numpy(), composed.numpy(), rtol=0,
                               atol=1e-5)
    draws = augment.draw_chain(methods, images.shape,
                               torch.Generator().manual_seed(5))
    np.testing.assert_allclose(
        augment.apply_fused_chain(methods, images, draws).numpy(),
        augment.apply_chain(methods, images, draws).numpy(), rtol=0,
        atol=1e-5)


def test_chain_without_flip_stays_composed(monkeypatch):
    methods = augment.parse_augment_options(
        {'random_crop': None, 'random_warp': {'flow_grid_stride': 1}},
        SLICE_TYPES, (64, 64))
    assert not augment.fused_chain_eligible(methods)
    calls = _Calls(monkeypatch)
    monkeypatch.setenv('DNNCA_FUSEDAUG', '1')
    assert _route(methods, None, True).shape == (4, 64, 64, 3)
    assert calls.n == {'warp_crop': 0, 'warp_twopass': 1}


@pytest.mark.parametrize('fused_gate', [True, False])
def test_engine_solves_no_bank_for_the_fused_chain(monkeypatch, fused_gate):
    monkeypatch.delenv('DNNCA_FUSEDAUG', raising=False)
    config = {'model': 'UNetAnnotator', 'model_options': {},
              'deploy_options': {'fused_aug': fused_gate,
                                 'warp_bank_size': 4}}
    eng = engine.Engine(config, device='cpu')
    ds = pipeline.TrainDataset(
        'unused.tfrecords', batch_size=2, buffer_size=1,
        slice_types=SLICE_TYPES, output_size=(32, 32),
        augment_options={'random_crop': None, 'random_flip': None,
                         'random_contrast': None,
                         'random_warp': {'n_points': 12}})
    assert (eng._warp_bank(ds) is None) == fused_gate
    assert len(eng._bank_cache) == int(not fused_gate)


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_fused_aug')
    return list(util_synth.make_tfrecords(str(tmp), size=64))


@pytest.mark.parametrize('deploy,want', [
    ({'deploy_options.fused_aug': True}, 'warp_crop'),
    ({'deploy_options.warp_bank': False}, 'warp_twopass'),
])
def test_train_cli_fused_and_per_step(monkeypatch, records, tmp_path, deploy,
                                      want):
    '''The train CLI with the fused chain, and with the per-step solve:
    finite losses and one resample a step through the route's kernel.'''
    monkeypatch.delenv('DNNCA_FUSEDAUG', raising=False)
    calls = _Calls(monkeypatch)
    overlay = tmp_path / 'route.json'
    overlay.write_text(json.dumps(deploy))
    res = main(argv=['train', '--config', *CONFIGS, _overlay(tmp_path),
                     str(overlay), '--save_path', str(tmp_path / 'run'),
                     '--data_path', *records, '--save_freq', '3',
                     '--max_steps', '3', '--device', 'cpu'])
    assert res.epoch == [1, 2, 3]
    assert np.isfinite(res.history['loss']).all()
    assert calls.n == {'warp_crop': 0, 'warp_twopass': 0, want: 3}
    assert os.path.isdir(tmp_path / 'run' / 'checkpoints' / 'ckpt-3')
