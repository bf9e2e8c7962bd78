'''The port's connected components on the CPU (the plain fixed point the
CCA kernel is held against on the card) against the JAX package's
``connected_components`` (vmapped XLA), its Pallas kernel
``cca_raw_labels_pallas`` in interpret mode, and ``scipy.ndimage.label``
with the 4-connected cross. Every comparison is exact: labels are integers.
'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from chip_smoke import spiral_mask
from dnncancerannotator_tpu.ops import cca as jax_cca
from dnncancerannotator_tpu.ops.pallas.cca_kernel import cca_raw_labels_pallas
from dnncancerannotator_tpu.parallel import mesh as mesh_lib
from dnncancerannotator_torch.ops import cca
from dnncancerannotator_torch.ops import kernels
from dnncancerannotator_torch.ops.kernels import cca as cca_kernel

FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])


def _planes(name, h, w):
    '''[2, h, w] bool masks of one kind (two planes, so the batch offsets
    are exercised).'''
    rng = np.random.default_rng(h * 1000 + w)
    ii, jj = np.mgrid[:h, :w]
    one = {
        'spiral': spiral_mask(h, w),
        'checkerboard': (ii + jj) % 2 == 0,
        'full': np.ones((h, w), bool),
        'empty': np.zeros((h, w), bool),
        'single_pixel': (ii == h // 2) & (jj == w - 1),
        'noise': rng.random((h, w)) < 0.6,
    }[name]
    return np.stack([one, rng.random((h, w)) < 0.55])


CASES = ['spiral', 'checkerboard', 'full', 'empty', 'single_pixel', 'noise']


@pytest.mark.parametrize('name', CASES)
@pytest.mark.parametrize('h,w', [(48, 48), (23, 70)])
def test_plain_matches_jax_and_scipy(name, h, w):
    masks = _planes(name, h, w)
    labels, counts = cca.connected_components_batch(torch.from_numpy(masks))
    want, want_counts = jax_cca.connected_components_batch(
        jnp.asarray(masks))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    for i in range(len(masks)):
        ref, n = ndimage.label(masks[i], structure=FOUR)
        assert counts[i] == n
        np.testing.assert_array_equal(labels[i].numpy(), ref)


@pytest.mark.parametrize('name', CASES)
def test_raw_labels_match_pallas_interpret(name, monkeypatch):
    '''Raw labels on tile-aligned planes, where the Pallas kernel sees the
    plane unpadded.'''
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')
    masks = _planes(name, 8, 128)
    with mesh_lib.pallas_single_device():
        want = cca_raw_labels_pallas(jnp.asarray(masks),
                                     interpret=mesh_lib.pallas_interpret())
    got = cca_kernel.cca_raw_labels(torch.from_numpy(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('name', ['spiral', 'checkerboard', 'noise'])
def test_compact_labels_match_pallas_on_unaligned_planes(name, monkeypatch):
    '''Unaligned planes: the JAX package pads them for its Pallas kernel,
    whose raw index then uses the padded width, so the compact labels are
    compared.'''
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')
    masks = _planes(name, 20, 70)
    with mesh_lib.pallas_single_device():
        assert jax_cca._pallas_cca_ok(masks.shape)
        want, want_counts = jax_cca.connected_components_batch(
            jnp.asarray(masks))
    labels, counts = cca.connected_components_batch(torch.from_numpy(masks))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


def test_raw_labels_are_component_minima():
    masks = _planes('noise', 37, 53)
    raw = cca_kernel.cca_raw_labels(torch.from_numpy(masks)).numpy()
    hw = 37 * 53
    for i in range(len(masks)):
        ref, n = ndimage.label(masks[i], structure=FOUR)
        flat = np.arange(hw).reshape(37, 53)
        want = np.full((37, 53), hw)
        for region in range(1, n + 1):
            inside = ref == region
            want[inside] = flat[inside].min()
        np.testing.assert_array_equal(raw[i], want)


def test_single_plane_entry_point():
    mask = torch.from_numpy(spiral_mask(15, 21))
    labels, count = cca.connected_components(mask)
    assert int(count) == 1 and labels.shape == (15, 21)
    assert labels.dtype == torch.int32 and count.dtype == torch.int32


def test_cpu_tensors_launch_no_kernel_and_other_devices_raise():
    kernels.reset_launches()
    cca.connected_components_batch(torch.from_numpy(_planes('noise', 9, 9)))
    assert cca_kernel.launches == 0
    with pytest.raises(ValueError, match='CUDA or CPU'):
        cca_kernel.cca_raw_labels(torch.empty(1, 4, 4, dtype=torch.bool,
                                              device='meta'))
    with pytest.raises(TypeError, match='bool or uint8'):
        cca_kernel.cca_raw_labels(torch.zeros(1, 4, 4))
    with pytest.raises(ValueError, match=r'\[N, H, W\]'):
        cca_kernel.cca_raw_labels(torch.zeros(4, 4, dtype=torch.bool))


# the kernel's route (ops/kernels/cca.py: route): planes of 32-bit labels
# always take the shared route, planes of 16-bit labels from MIN_PLANES at
# a time, larger planes never
@pytest.mark.parametrize('n,h,w,want', [
    (1, 128, 128, 'shared'), (2000, 128, 128, 'shared'),
    (1, 181, 181, 'shared'),                 # 32761 pixels: 32-bit labels
    (1, 128, 256, 'shared'), (1, 1, 32768, 'shared'),   # at the 32-bit cap
    (1, 1, 32769, 'global'), (131, 256, 256, 'global'),
    (132, 256, 256, 'shared'), (500, 256, 256, 'shared'),
    (132, 1, 65536, 'shared'), (132, 65536, 1, 'shared'),   # at the cap
    (132, 1, 65537, 'global'), (132, 257, 256, 'global'),
    (2, 384, 384, 'global')])
def test_route_rule_at_below_and_above_the_caps(n, h, w, want):
    assert cca_kernel.route(n, h, w) == want
    if want == 'shared':
        assert h * w <= cca_kernel.PLANE_MAX
        assert cca_kernel.shared_bytes(h, w) <= 232448   # the H100's limit


def test_shared_memory_of_a_plane():
    '''Two bitmasks in whole 16-byte rows and the labels rounded up to 16
    bytes (csrc/cca.cu: shared_bytes).'''
    assert cca_kernel.label_bytes(128, 128) == 4
    assert cca_kernel.shared_bytes(128, 128) == 2 * 2048 + 65536
    assert cca_kernel.label_bytes(256, 256) == 2
    assert cca_kernel.shared_bytes(256, 256) == 2 * 8192 + 131072
    assert cca_kernel.label_bytes(1, 32769) == 2
    assert cca_kernel.shared_bytes(77, 333) == 2 * 16 * -(-25641 // 128) + \
        16 * -(-4 * 25641 // 16)


def _minima(mask):
    '''Raw labels of one plane from scipy: each component's minimum flat
    index, H * W off the mask.'''
    ref, n = ndimage.label(mask, structure=FOUR)
    hw = mask.size
    flat = np.arange(hw)
    mins = np.full(n + 1, hw)
    np.minimum.at(mins, ref.reshape(-1), flat)
    out = mins[ref.reshape(-1)]
    out[~mask.reshape(-1)] = hw
    return out.reshape(mask.shape)


@pytest.mark.parametrize('h,w', [(181, 181), (128, 256), (1, 32769),
                                 (255, 257), (256, 256), (65536, 1),
                                 (1, 65537)])
def test_plain_at_the_caps_matches_scipy(h, w):
    '''The plain version the kernel is held to, on planes at and beside the
    routes' caps (32768 and 65536 pixels), a noise plane and a spiral.'''
    rng = np.random.default_rng(h + w)
    masks = np.stack([rng.random((h, w)) < 0.6, spiral_mask(h, w)])
    raw = cca_kernel.plain(torch.from_numpy(masks)).numpy()
    for i in range(len(masks)):
        np.testing.assert_array_equal(raw[i], _minima(masks[i]))
