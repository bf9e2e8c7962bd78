'''The port's unet_big slice on the CPU against the JAX package: the NHWC
max pool and transposed conv (plain versions of the CUDA kernels pool2x2_nhwc
and tconv2x2_nhwc, forward and backward) against the Pallas kernels in
interpret mode, the routing and the kernel gates, BatchNormFast, a narrow
BatchNorm UNet (logits, batch_stats, every parameter gradient) and the
engine's handling of batch_stats.

Inputs are made with seeded numpy and handed to both packages. Tolerances:
the pool bit for bit (forward and backward: maxima and g * {1, 0.5, 0.25});
the transposed conv with test_tconv_kernel.py's (rtol 2e-5, atol 2e-4
forward, 5e-4 for the gradients); BatchNorm and the narrow UNet as stated
at each test, about 10x the errors measured here.
'''

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnncancerannotator_tpu import models as jax_models
from dnncancerannotator_tpu.models import fastbn as jax_fastbn
from dnncancerannotator_tpu.ops import pooling as jax_pooling
from dnncancerannotator_tpu.ops.pallas import pool_kernel as PK
from dnncancerannotator_tpu.ops.pallas import tconv_kernel as TK
from dnncancerannotator_torch import convert, engine
from dnncancerannotator_torch import models as torch_models
from dnncancerannotator_torch.data import pipeline
from dnncancerannotator_torch.models import fastbn
from dnncancerannotator_torch.ops import functions, gates, pooling
from dnncancerannotator_torch.ops.kernels import pool2x2_nhwc as PN
from dnncancerannotator_torch.ops.kernels import pool2x2_nhwc_bwd as PNB
from dnncancerannotator_torch.ops.kernels import tconv2x2_nhwc as TN
from dnncancerannotator_torch.ops.kernels import tconv2x2_nhwc_bwd as TNB
from dnncancerannotator_torch.runs.__main__ import main
from dnncancerannotator_torch.utils import config as config_lib
from tests import util_synth
from tests.test_torch_unet import _jax_params, flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the overlays follow deploy_options.yaml, whose deploy_options dict replaces
# the one stacked before it (test_overlays_follow_deploy_options)
CONFIGS = [os.path.join(REPO, 'configs', c) for c in (
    'unet_big.yaml', 'additionals/data_options.yaml',
    'additionals/deploy_options.yaml', 'additionals/f32.yaml',
    'additionals/pallas_decoder.yaml')]
# unet_big at 2 levels: down_1 (128 ch) and up_0 (128 -> 128) take the
# kernels, down_0 (64 ch) and up_1 (128 -> 64) the plain routes
NARROW = dict(n_filters_first=64, n_downsample=2, rate=2, kernel_size=3,
              conv_stride=1, bn=True, padding='same')
GATES_ON = gates.KernelGates(pallas_pool=True, pallas_tconv=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def pallas_on(monkeypatch):
    '''The JAX package's pool and tconv gates on, its Pallas kernels in
    interpret mode on the CPU.'''
    monkeypatch.setenv('DNNCA_PPOOL', '1')
    monkeypatch.setenv('DNNCA_PTCONV', '1')
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')


# -- the pool ---------------------------------------------------------------------
def _pool_case(name):
    rng = np.random.RandomState(0)
    shape = {'random': (2, 16, 16, 128), 'wide': (1, 8, 32, 256),
             'relu ties': (2, 8, 8, 128), 'constant': (1, 4, 6, 128)}[name]
    x = rng.randn(*shape).astype(np.float32)
    if name == 'relu ties':
        x = np.maximum(x, 0.0)
    elif name == 'constant':
        x[:] = 0.5
    g = rng.randn(shape[0], shape[1] // 2, shape[2] // 2,
                  shape[3]).astype(np.float32)
    return x, g


@pytest.mark.parametrize('name', ['random', 'wide', 'relu ties', 'constant'])
def test_pool_matches_pallas_and_jax_grad_exactly(name):
    x, g = _pool_case(name)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    np.testing.assert_array_equal(PN.pool2x2_nhwc(_t(x)).numpy(),
                                  np.asarray(PK.max_pool2x2_nhwc(xj, True)))
    want = jax.grad(lambda v: jnp.vdot(PK.max_pool2x2_nhwc(v, True), gj))(xj)
    tree = jax.grad(lambda v: jnp.vdot(jax_pooling.max_pool2d(v, 2), gj))(xj)
    got = PNB.pool2x2_nhwc_bwd(_t(x), _t(g)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(tree))
    # through the autograd Function
    xt = _t(x).requires_grad_()
    (functions.pool2x2_nhwc(xt) * _t(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), got)
    if name == 'constant':   # every window tied on both levels
        np.testing.assert_array_equal(
            got, np.repeat(np.repeat(g, 2, 1), 2, 2) * 0.25)


# -- the transposed conv --------------------------------------------------------------
@pytest.mark.parametrize('shape', [(2, 8, 8, 128, 128), (1, 4, 4, 256, 128),
                                   (2, 8, 16, 128, 256)])
def test_tconv_matches_pallas(shape):
    b, h, w, ci, co = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, h, w, ci).astype(np.float32)
    k = (rng.randn(2, 2, ci, co) * 0.1).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    g = rng.randn(b, 2 * h, 2 * w, co).astype(np.float32)
    wt = _t(k[::-1, ::-1].transpose(2, 3, 0, 1))   # convert.py's tconv flip
    xj, kj, bj = jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)

    want = TK.conv_transpose2x2_nhwc(xj, kj, bj, True)
    got = TN.tconv2x2_nhwc(_t(x), wt, _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-4)
    dxj, dkj, dbj = jax.grad(
        lambda x_, k_, b_: jnp.vdot(TK.conv_transpose2x2_nhwc(
            x_, k_, b_, True), jnp.asarray(g)), argnums=(0, 1, 2))(xj, kj, bj)
    dx, dw, db = TNB.tconv2x2_nhwc_bwd(_t(x), _t(g), wt)
    dw_hwio = dw.numpy().transpose(2, 3, 0, 1)[::-1, ::-1]
    for name, a, ref in (('dx', dx.numpy(), dxj), ('dw', dw_hwio, dkj),
                         ('db', db.numpy(), dbj)):
        np.testing.assert_allclose(a, np.asarray(ref), rtol=2e-5, atol=5e-4,
                                   err_msg=name)
    assert TNB.tconv2x2_nhwc_bwd(_t(x), _t(g), wt, need_dx=False)[0] is None


# the unet_big decoder sites at the training batch (B=8, 256 x 256 crops):
# x [B, H, W, Ci] and Co at up_0, up_1 and up_2
BIG_TCONV_SITES = [(8, 16, 16, 512, 512), (8, 32, 32, 512, 256),
                   (8, 64, 64, 256, 128)]


@pytest.mark.parametrize('shape', BIG_TCONV_SITES + [
    (1, 33, 7, 128, 128), (2, 4, 4, 512, 512), (1, 3, 5, 256, 128)])
def test_tconv_bwd_plan_covers_every_slice_once(shape):
    '''The backward's split plan: the dgrad splits cut the four phases into
    equal whole parts, the wgrad chunks are whole K slices that cover the
    input pixels once, at least 132 dgrad blocks at the unet_big sites and
    no more wgrad blocks than one wave where the tiles allow it.'''
    b, h, w, ci, co = shape
    pixels = b * h * w
    dsplits, chunk, wsplits = TNB.plan(b, h, w, ci, co, sms=132)
    assert dsplits in (1, 2, 4)
    dgrad_blocks = (ci // 128) * -(-pixels // 128) * dsplits
    if shape in BIG_TCONV_SITES:
        assert dgrad_blocks >= 132
    assert chunk % TNB.BK == 0
    covered = np.zeros(pixels, int)
    for z in range(wsplits):
        lo, hi = z * chunk, min((z + 1) * chunk, pixels)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    wgrad_tiles = (ci // 128) * (4 * co // 128)
    assert wgrad_tiles * wsplits <= max(132, wgrad_tiles)


def _gemm_views(x, g, w, bias, wpt, sms=132):
    '''The products of csrc/tconv_gemm.cuh as the kernels cut them, in plain
    torch: the forward [M, Ci] x wpt^T with the phases scattered, the dgrad
    as per-phase splits of K added in order, the wgrad per pixel chunk with
    db's column sums, both added in order.'''
    b, h, wd, ci = x.shape
    co = w.shape[1]
    m = b * h * wd
    xm = x.reshape(m, ci)
    # g's rows of one phase p = 2 * dy + dx, [M, Co]
    gp = g.reshape(b, h, 2, wd, 2, co).permute(2, 4, 0, 1, 3, 5).reshape(
        4, m, co)
    out = (xm @ wpt.T).reshape(b, h, wd, 2, 2, co).permute(
        0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * wd, co) + bias
    dsplits, chunk, wsplits = TNB.plan(b, h, wd, ci, co, sms)
    per = 4 // dsplits
    dx = sum(sum(gp[p] @ wpt[p * co:(p + 1) * co]
                 for p in range(z * per, (z + 1) * per))
             for z in range(dsplits))
    gcat = gp.permute(1, 0, 2).reshape(m, 4 * co)   # [M, p * Co + co]
    dwp = torch.zeros(ci, 4 * co, dtype=x.dtype)
    dbp = torch.zeros(4 * co, dtype=x.dtype)
    for z in range(wsplits):
        rows = slice(z * chunk, (z + 1) * chunk)
        dwp = dwp + xm[rows].T @ gcat[rows]
        dbp = dbp + gcat[rows].sum(0)
    dw = dwp.reshape(ci, 2, 2, co).permute(0, 3, 1, 2)
    return out, dx.reshape(x.shape), dw, dbp.reshape(4, co).sum(0)


@pytest.mark.parametrize('shape', [(2, 4, 4, 512, 512), (1, 33, 7, 128, 128),
                                   (2, 3, 5, 128, 256)])
def test_tconv_packed_weight_gemms_equal_plain(shape):
    '''The one packed weight read as the forward's B and as the dgrad's B,
    and the kernels' splits of both reductions, give the plain einsums (in
    f64, so only a wrong layout or a missed slice could differ).'''
    b, h, w, ci, co = shape
    rng = np.random.default_rng(11)
    x, wk, bias = (torch.from_numpy(rng.standard_normal(s))
                   for s in ((b, h, w, ci), (ci, co, 2, 2), (co,)))
    g = torch.from_numpy(rng.standard_normal((b, 2 * h, 2 * w, co)))
    wpt = TN.pack(wk)
    assert wpt.shape == (4 * co, ci) and wpt.is_contiguous()
    out, dx, dw, db = _gemm_views(x, g, wk, bias, wpt)
    want = (TN.plain(x, wk, bias),) + TNB.plain(x, g, wk)
    for got, ref in zip((out, dx, dw, db), want):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-10)


# -- routing and gates -------------------------------------------------------------
POOL_SHAPES = [((2, 16, 16, 128), 2, 'NHWC', 'f32'),
               ((2, 16, 16, 64), 2, 'NHWC', 'f32'),
               ((2, 16, 16, 128), 3, 'NHWC', 'f32'),
               ((2, 16, 16, 128), 2, 'NCHW', 'f32'),
               ((2, 15, 16, 128), 2, 'NHWC', 'f32'),
               ((2, 16, 16, 128), 2, 'NHWC', 'bf16')]
TCONV_SHAPES = [((2, 8, 8, 128), (2, 2), (2, 2), 128, 'NHWC', 'f32'),
                ((2, 8, 8, 96), (2, 2), (2, 2), 128, 'NHWC', 'f32'),
                ((2, 8, 8, 128), (3, 3), (2, 2), 128, 'NHWC', 'f32'),
                ((2, 8, 8, 128), (2, 2), (2, 2), 128, 'NHWC', 'bf16'),
                ((2, 8, 8, 128), (2, 2), (2, 2), 128, 'NCHW', 'f32'),
                ((2, 8, 8, 128), (2, 2), (2, 2), 96, 'NHWC', 'f32')]
_DT = {'f32': (jnp.float32, torch.float32),
       'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('gate_on', [True, False])
def test_routing_equals_the_jax_eligibility(monkeypatch, gate_on):
    monkeypatch.setenv('DNNCA_PALLAS_INTERPRET', '1')
    for var in ('DNNCA_PPOOL', 'DNNCA_PTCONV'):
        if gate_on:
            monkeypatch.setenv(var, '1')
        else:
            monkeypatch.delenv(var, raising=False)
    for shape, rate, fmt, dt in POOL_SHAPES:
        want = PK.pool_pallas_ok(shape, rate, fmt, _DT[dt][0])
        assert PN.eligible(shape, rate, fmt, _DT[dt][1]) == want, shape
    for shape, ks, st, co, fmt, dt in TCONV_SHAPES:
        want = TK.tconv_pallas_ok(shape, ks, st, co, fmt, _DT[dt][0])
        assert TN.eligible(shape, ks, st, co, fmt, _DT[dt][1]) == want, shape
    assert PN.eligible(*POOL_SHAPES[0][:3], torch.float32) == gate_on


def test_gates_scope_env_and_defaults(monkeypatch):
    for var in ('DNNCA_PPOOL', 'DNNCA_PTCONV', 'DNNCA_WARPBANK'):
        monkeypatch.delenv(var, raising=False)
    assert not gates.enabled('pallas_pool') and gates.enabled('warp_bank')
    deploy = {'pallas_pool': True, 'warp_bank': False, 'optimizer': 'adam'}
    gset = gates.KernelGates.from_deploy_options(deploy)
    assert 'pallas_pool' in deploy   # read, not popped
    with gates.active(gset):
        assert gates.enabled('pallas_pool') and not gates.enabled('warp_bank')
        assert not gates.enabled('pallas_tconv')   # None: the default
        monkeypatch.setenv('DNNCA_PPOOL', '0')     # the env beats the scope
        assert not gates.enabled('pallas_pool')
        monkeypatch.setenv('DNNCA_PPOOL', '')      # empty: not read
        assert gates.enabled('pallas_pool')
    assert not gates.enabled('pallas_pool')


def test_overlays_follow_deploy_options():
    '''deploy_options.yaml sets the whole deploy_options dict, in both
    packages: stacked after f32.yaml and pallas_decoder.yaml it drops their
    keys (and unet_big.yaml's own precision), so the gates are on only with
    the overlays after it.'''
    from dnncancerannotator_tpu.utils import config as jax_config
    late = [CONFIGS[0], CONFIGS[3], CONFIGS[4], CONFIGS[2], CONFIGS[1]]
    for stack, on in ((CONFIGS, True), (late, False)):
        config = config_lib.load_config(stack)
        assert config == jax_config.load_config(stack)
        deploy = config['deploy_options']
        assert deploy.get('pallas_pool', False) == on
        assert deploy.get('pallas_tconv', False) == on
        assert deploy.get('precision') == ('float32' if on else None)


def _narrow_config(**deploy):
    config = config_lib.load_config(CONFIGS)
    config['model_options'].update(n_downsample=2)
    config['deploy_options'].update(deploy)
    return config


def test_two_engines_route_by_their_own_gates(monkeypatch):
    for var in ('DNNCA_PPOOL', 'DNNCA_PTCONV'):
        monkeypatch.delenv(var, raising=False)
    calls = []
    for mod, name in ((PN, 'pool2x2_nhwc'), (TN, 'tconv2x2_nhwc')):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    on = engine.Engine(_narrow_config(), device='cpu')
    off = engine.Engine(_narrow_config(pallas_pool=False, pallas_tconv=False),
                        device='cpu')
    raw = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 6), np.uint8)
    counts = []
    for eng in (on, off, on):
        eng.build((2, 16, 16, 5))
        calls.clear()
        eng._make_eval_step(util_synth.SLICE_TYPES)(raw)
        counts.append(sorted(calls))
    assert counts[0] == counts[2] == ['pool2x2_nhwc', 'tconv2x2_nhwc']
    assert counts[1] == []


# -- BatchNorm --------------------------------------------------------------------
def test_batchnorm_matches_flax():
    '''Outputs in train and eval mode, the running-stat update and the
    gradients for x, scale and bias at [2, 8, 8, 16]; within 1e-5 * max|ref|
    (f32 reductions over 128 values in another order; 1e-6 measured).'''
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 8, 8, 16)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    variables = {
        'params': {'scale': rng.uniform(0.5, 1.5, 16).astype(np.float32),
                   'bias': rng.standard_normal(16).astype(np.float32)},
        'batch_stats': {'mean': rng.standard_normal(16).astype(np.float32),
                        'var': rng.uniform(0.5, 2, 16).astype(np.float32)}}
    jbn = jax_fastbn.BatchNormFast(use_running_average=None, momentum=0.99,
                                   epsilon=1e-3)
    bn = fastbn.BatchNormFast(16)
    state = convert.torch_state_from_flax(
        {f'{col}/bn/{k}': v for col, leaves in variables.items()
         for k, v in leaves.items()})
    bn.load_state_dict({k[len('bn.'):]: v for k, v in state.items()})

    def close(got, want):
        want = np.asarray(want)
        assert float(np.abs(got - want).max()) <= 1e-5 * max(
            float(np.abs(want).max()), 1e-6)

    def train_out(params, x_):
        return jbn.apply({'params': params,
                          'batch_stats': variables['batch_stats']}, x_,
                         use_running_average=False, mutable=['batch_stats'])

    y, new_stats = train_out(variables['params'], jnp.asarray(x))
    dparams, dx = jax.grad(
        lambda p, x_: jnp.vdot(train_out(p, x_)[0], jnp.asarray(g)),
        argnums=(0, 1))(variables['params'], jnp.asarray(x))
    xt = _t(x).requires_grad_()
    bn.train()
    yt = bn(xt)
    (yt * _t(g)).sum().backward()
    close(yt.detach().numpy(), y)
    close(bn.mean.numpy(), new_stats['batch_stats']['mean'])
    close(bn.var.numpy(), new_stats['batch_stats']['var'])
    close(xt.grad.numpy(), dx)
    close(bn.scale.grad.numpy(), dparams['scale'])
    close(bn.bias.grad.numpy(), dparams['bias'])
    bn.eval()
    stats = {k: np.asarray(v) for k, v in new_stats['batch_stats'].items()}
    want = jbn.apply({'params': variables['params'], 'batch_stats': stats},
                     jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        before = bn.mean.clone()
        close(bn(_t(x)).numpy(), want)
        assert torch.equal(bn.mean, before)   # eval mode moves nothing


# -- the narrow BN UNet -----------------------------------------------------------------
def _narrow_case():
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 32, 5), dtype=np.float32)
    gmap = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    model, _ = jax_models.build_model('UNetAnnotator', NARROW)
    variables = model.init(jax.random.PRNGKey(5), jnp.asarray(x[:1]))
    flat = flat_params(variables['params'])
    for key in flat:   # non-trivial BN parameters and biases
        if key.endswith(('/bias', '/scale')):
            base = 1.0 if key.endswith('/scale') else 0.0
            flat[key] = (base + rng.standard_normal(flat[key].shape) * 0.1
                         ).astype(np.float32)
    stats = {}
    for key, v in flat_params(variables['batch_stats']).items():
        key = 'batch_stats' + key[len('params'):]
        stats[key] = (rng.uniform(0.5, 1.5, v.shape) if key.endswith('/var')
                      else rng.standard_normal(v.shape) * 0.1
                      ).astype(np.float32)
    return model, x, gmap, flat, stats


def _jax_tree(stats):
    return _jax_params({'params' + k[len('batch_stats'):]: v
                        for k, v in stats.items()})


def test_narrow_bn_unet_matches_jax(pallas_on):
    '''Logits in train and eval mode, the mutated batch_stats and every
    parameter gradient of sum(logits * G) in train mode, against the JAX
    model with its pool and tconv kernels (interpret mode) on the same
    weights. Relative to max|ref|: the train-mode logits within 1e-4 (8.7e-6
    measured: the batch variance E[x^2] - mean^2 of twelve BatchNorms in f32;
    against a float64 run of the port the JAX logits are off by 4.6e-5, the
    port's by 1.8e-5), the eval-mode logits within 2e-5 (1.5e-6 measured),
    batch_stats within 1e-5, each gradient within 1e-4 (1.1e-5 measured).'''
    model, x, gmap, flat, stats = _narrow_case()
    xj = jnp.asarray(x)

    def logits_train(p):
        out, upd = model.apply({'params': p, 'batch_stats': _jax_tree(stats)},
                               xj, training=True, return_logits=True,
                               mutable=['batch_stats'])
        return jnp.vdot(out, jnp.asarray(gmap)), (out, upd['batch_stats'])

    grads, (want_train, new_stats) = jax.jit(
        jax.grad(logits_train, has_aux=True))(_jax_params(flat))
    want_eval = model.apply({'params': _jax_params(flat),
                             'batch_stats': _jax_tree(stats)}, xj,
                            return_logits=True)

    port, _ = torch_models.build_model('UNetAnnotator', NARROW, in_channels=5)
    assert port.data_format == 'NHWC'
    port.load_state_dict(convert.torch_state_from_flax(
        {**flat, **stats}, expected=port.state_dict()))
    with gates.active(GATES_ON):
        port.eval()
        with torch.no_grad():
            got_eval = port(_t(x), return_logits=True)
        port.train()
        got_train = port(_t(x), return_logits=True)
        (got_train * _t(gmap)).sum().backward()
    for got_l, want_l, tol in ((got_train.detach(), want_train, 1e-4),
                               (got_eval, want_eval, 2e-5)):
        want_l = np.asarray(want_l)
        err = np.abs(got_l.numpy() - want_l).max()
        assert err <= tol * np.abs(want_l).max(), err
    state = convert.flax_from_torch_state(port.state_dict())
    want_stats = flat_params(new_stats)
    for key, value in want_stats.items():
        key = 'batch_stats' + key[len('params'):]
        assert np.abs(state[key] - value).max() <= 1e-5 * np.abs(value).max()
    want_grads = convert.torch_state_from_flax(flat_params(grads))
    got = {name: p.grad for name, p in port.named_parameters()}
    assert sorted(got) == sorted(want_grads)
    for name, want in want_grads.items():
        # a tconv bias feeds its BatchNorm directly, so its exact gradient
        # is 0 and both sides hold rounding noise: a bias is held on the
        # scale of its layer's weight gradient
        layer = name.rsplit('.', 1)[0]
        scale = max(float(want.abs().max()),
                    float(want_grads.get(layer + '.weight', want).abs().max()))
        assert float((got[name] - want).abs().max()) <= 1e-4 * scale, name


def test_bn_converter_round_trip():
    _, _, _, flat, stats = _narrow_case()
    both = {**flat, **stats}
    back = convert.flax_from_torch_state(convert.torch_state_from_flax(both))
    assert sorted(back) == sorted(both)
    for key in both:
        np.testing.assert_array_equal(back[key], both[key])
    with pytest.raises(KeyError):
        convert.torch_state_from_flax({'batch_stats/unet/bn_0/scale':
                                       np.ones(3, np.float32)})


# -- the engine -----------------------------------------------------------------------
@pytest.fixture(scope='module')
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_unet_big')
    return list(util_synth.make_tfrecords(str(tmp), size=64, n_slices=2))


def _overlay(tmp_path):
    path = tmp_path / 'narrow.json'
    path.write_text(json.dumps({
        'model_options.n_downsample': 2,
        'data_options.train.output_size': [32, 32],
        'data_options.train.batch_size': 2,
        'data_options.eval.output_size': [32, 32],
        'data_options.eval.batch_size': 4,
        'deploy_options.warp_bank_size': 8,
        'deploy_options.steps_per_call': 2,
    }))
    return str(path)


def _stats(flat):
    return {k: v for k, v in flat.items() if k.startswith('batch_stats/')}


def test_train_cli_keeps_batch_stats(records, tmp_path):
    '''A narrow unet_big train run with --validate: batch_stats move, are
    checkpointed and resumed (2 + 2 steps equal 4 in one call), and
    validation leaves them unchanged.'''
    overlay = _overlay(tmp_path)

    def run(save, max_steps, validate=False):
        argv = ['train', '--config', *CONFIGS, overlay, '--save_path', save,
                '--data_path', *records, '--save_freq', '2', '--seed', '1',
                '--device', 'cpu', '--max_steps', str(max_steps)]
        if validate:
            argv += ['--validate', '--val_data_path', *records]
        return main(argv=argv)

    def ckpt(save, step):
        return engine.read_ckpt(os.path.join(
            save, 'checkpoints', f'ckpt-{step}'), opt_state=False)

    a, b = str(tmp_path / 'a'), str(tmp_path / 'b')
    res = run(a, 4, validate=True)
    assert res.epoch == [1, 2, 3, 4] and np.isfinite(res.history['loss']).all()
    assert len(res.history['val_loss']) == 2
    run(b, 2)
    run(b, 4)   # resumes at step 2
    first, unbroken, resumed = ckpt(b, 2), ckpt(a, 4), ckpt(b, 4)
    # mean and var of 12 BNs: bn_0, bn_1 in 4 chains, 2 pool_bn, 2 tconv_bn
    assert len(_stats(first)) == 24
    for key, value in _stats(first).items():
        init = 1.0 if key.endswith('/var') else 0.0
        assert not np.allclose(value, init), key   # they moved
    assert sorted(unbroken) == sorted(resumed)
    for key in unbroken:
        np.testing.assert_array_equal(unbroken[key], resumed[key], key)

    # validation runs in eval mode: it moves no statistic, and the model is
    # back in training mode after it
    config = config_lib.load_config([*CONFIGS, overlay])
    eng = engine.Engine(config, device='cpu')
    ds = pipeline.train_ds(records, **config['data_options']['train'])
    eng._setup_training(ds)
    eng.load(os.path.join(b, 'checkpoints', 'ckpt-4'))
    val = pipeline.eval_ds(records, **config['data_options']['eval'])
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    eng.model.train()
    eng._eval_dataset(eng._make_eval_step(val.slice_types), val, [])
    assert eng.model.training
    for key, value in eng.model.state_dict().items():
        assert torch.equal(value, before[key]), key
