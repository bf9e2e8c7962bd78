'''The JAX package's values for tests/test_torch_bf16.py, computed in a
process of their own.

XLA lets a fusion keep f32 where the program rounds to bf16 between two
ops (``--xla_allow_excess_precision``, on by default), so the JAX
package's bf16 results depend on what XLA fuses: a bias gradient summed in
f32 and never rounded, a BatchNorm's output kept in f32 into the next add.
The port rounds wherever the JAX modules cast (eager PyTorch fuses
nothing), so its reference is the JAX program with that flag off, which a
process that has already started XLA cannot set. Without excess precision
XLA's CPU runtime has no bf16 x bf16 -> f32 dot, so the einsums of the JAX
fastconv module (its small convs and transposed convs) take their bf16
operands upcast to f32: exact, since a product of two bf16 values is an
f32 value and the sum is f32 as asked.

The bf16 run takes the JAX package's Pallas routes, as on the TPU (the
routing gates read interpret mode as on), with each Pallas kernel replaced
by its function in plain f32 XLA (``PALLAS_F32``): the kernels upcast
their bf16 inputs, compute in f32 and return f32, and their callers round
(fastconv.py:182, :213, :548, :568-569). The kernels themselves in
interpret mode take minutes a model on the CPU; test_torch_bf16.py holds
the port's plain versions against them one call at a time. This module
runs as

    XLA_FLAGS=--xla_allow_excess_precision=false \\
        python -m tests.util_bf16_ref OUT_DIR CASE...

and writes OUT_DIR/CASE.npz for each case of CASES: the inputs (x, the
cotangent map G, the weights and statistics ``model_case`` makes), the
JAX model's values in bf16 (``bf16/<key>``: train- and eval-mode logits,
every parameter gradient of sum(logits * G), the updated batch_stats, and
the input sensitivity where the case takes it), the same in float64 on the
f32 model (``f64/<key>``: x64, the XLA routes, float32 casts read as
float64), and the f32 model's train-mode logits (``f32/train``). Keys are
``tests/test_torch_mulmo._run_port``'s.
'''

import os
import sys

BN = dict(n_filters_first=8, n_downsample=2, rate=2, kernel_size=3,
          conv_stride=1, bn=True, padding='same')
# unet.yaml's model: 3 first filters, 3 levels, no BN (NCHW, the chains)
UNET = dict(n_filters_first=3, n_downsample=3, rate=2, kernel_size=3,
            conv_stride=1, bn=False, padding='same')
MULMO = dict(BN, n_filters_first=4)
# name -> (model, options, input shape, seed, input sensitivity). The JAX
# models take their XLA routes: in interpret mode the Pallas chain alone
# takes minutes a forward on the CPU (the kernels' bf16 semantics are
# checked one kernel at a time in test_torch_bf16.py instead).
CASES = {
    'bn': ('UNetAnnotator', BN, (2, 32, 32, 3), 5, True),
    'bn_f32_head': ('UNetAnnotator', dict(BN, f32_head=True), (2, 32, 32, 3),
                    5, False),
    'bn_f32_level0': ('UNetAnnotator', dict(BN, f32_level0=True),
                      (2, 32, 32, 3), 5, False),
    'unet': ('UNetAnnotator', UNET, (2, 32, 32, 5), 6, True),
    'mulmo': ('MulmoUNetAnnotator', MULMO, (2, 32, 32, 2), 7, False),
    'mru': ('MultiResUnet', dict(base_filters=4), (2, 32, 32, 3), 8, False),
}
# tests/test_torch_geometry.py's: unet.yaml's model at rate 3, 2 levels
GEOMETRY_CASES = {
    'unet_rate3': ('UNetAnnotator', dict(UNET, rate=3, n_downsample=2),
                   (2, 27, 27, 5), 9, False),
}


def model_case(name, options, shape, seed):
    '''``tests/test_torch_mulmo.model_case`` for models with or without
    BatchNorm.'''
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dnncancerannotator_tpu import models as jax_models
    from tests.test_torch_unet import flat_params

    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    gmap = rng.standard_normal(shape[:3] + (1,)).astype(np.float32)
    model, _ = jax_models.build_model(name, options)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.asarray(x[:1]))
    flat = flat_params(variables['params'])
    for key in flat:
        if key.endswith(('/bias', '/scale')):
            base = 1.0 if key.endswith('/scale') else 0.0
            flat[key] = (base + rng.standard_normal(flat[key].shape) * 0.1
                         ).astype(np.float32)
    stats = {}
    for key, v in flat_params(variables.get('batch_stats', {})).items():
        key = 'batch_stats' + key[len('params'):]
        stats[key] = (rng.uniform(0.5, 1.5, v.shape) if key.endswith('/var')
                      else rng.standard_normal(v.shape) * 0.1
                      ).astype(np.float32)
    return model, x, gmap, flat, stats


def _conv_f32(x, w, pads, nchw):
    import jax.numpy as jnp
    from jax import lax
    layout = 'NCHW' if nchw else 'NHWC'
    return lax.conv_general_dilated(
        x.astype(jnp.float32), w.astype(jnp.float32), (1, 1), pads,
        dimension_numbers=(layout, 'HWIO', layout),
        precision=lax.Precision.HIGHEST)


def _bias(b, nchw):
    import jax.numpy as jnp
    b = b.astype(jnp.float32)
    return b.reshape(1, -1, 1, 1) if nchw else b


def _stencil(x, w, bias=None, pads=((1, 1), (1, 1)), relu=False,
             nchw=False, interpret=False):
    import jax.numpy as jnp
    out = _conv_f32(x, w, pads, nchw) + _bias(bias, nchw)
    return jnp.maximum(out, 0.0) if relu else out


def _stencil_bwd(x, g, w, pads=((1, 1), (1, 1)), nchw=False,
                 interpret=False):
    import jax
    import jax.numpy as jnp
    gf = g.astype(jnp.float32)
    _, vjp = jax.vjp(lambda x_, w_: _conv_f32(x_, w_, pads, nchw),
                     x.astype(jnp.float32), w.astype(jnp.float32))
    dx, dw = vjp(gf)
    return dx, dw, gf.sum((0, 2, 3) if nchw else (0, 1, 2))


def _chain(x, w1, b1, w2, b2, pads=((1, 1), (1, 1)), interpret=False):
    c1 = _stencil(x, w1, b1, pads, True, True)
    return c1, _stencil(c1, w2, b2, pads, True, True)


def _chain_bwd(x, c1, c2, g, w1, w2, pads=((1, 1), (1, 1)),
               interpret=False, need_dx=True):
    import jax.numpy as jnp
    g2 = jnp.where(c2 > 0, g.astype(jnp.float32), 0.0)
    dc1, dw2, db2 = _stencil_bwd(c1, g2, w2, pads, True)
    dc1 = jnp.where(c1 > 0, dc1, 0.0)
    dx, dw1, db1 = _stencil_bwd(x, dc1, w1, pads, True)
    if not need_dx:
        dx = jnp.zeros(x.shape, jnp.float32)
    return dx, dw1, db1, dw2, db2


# conv_kernel's Pallas entries -> their functions in plain f32 XLA
PALLAS_F32 = {'stencil_conv2d_pallas': _stencil,
              'stencil_conv2d_bwd_pallas': _stencil_bwd,
              'conv_chain_pallas': _chain,
              'conv_chain_bwd_pallas': _chain_bwd}


class _F32DotNumpy:
    '''jax.numpy whose einsum upcasts bf16 operands to f32 where the
    caller asks for an f32 result (module docstring).'''

    def __getattr__(self, name):
        import jax.numpy as jnp
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *operands, preferred_element_type=None, **kwargs):
        import jax.numpy as jnp
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                        else o for o in operands]
        return jnp.einsum(spec, *operands,
                          preferred_element_type=preferred_element_type,
                          **kwargs)


def _values(model, x, gmap, flat, stats, sens):
    '''``tests/test_torch_mulmo._jax_values`` for models with or without
    BatchNorm.'''
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tests import test_torch_mulmo as tm
    from tests.test_torch_unet import flat_params

    xj = jnp.asarray(x)
    params = tm._jax_params(flat)
    variables = {'params': params}
    if stats:
        variables['batch_stats'] = tm._jax_tree(stats)

    def logits_train(p):
        out, upd = model.apply({**variables, 'params': p}, xj, training=True,
                               return_logits=True, mutable=['batch_stats'])
        return jnp.vdot(out, jnp.asarray(gmap)), (
            out, upd.get('batch_stats', {}))

    grads, (train, new_stats) = jax.jit(
        jax.grad(logits_train, has_aux=True))(params)
    want = {'train': train, 'eval': jax.jit(
        lambda v: model.apply(v, xj, return_logits=True))(variables)}
    if sens:
        dprobs = jax.jit(jax.grad(
            lambda x_: jnp.sum(model.apply(variables, x_))))(xj)
        summed = np.abs(np.asarray(dprobs)).sum((1, 2))
        want['sens'] = summed / summed.sum(1, keepdims=True)
    want = {k: np.asarray(np.array(v), np.float64 if np.asarray(v).dtype
                          == np.float64 else np.float32)
            for k, v in want.items()}
    for key, value in tm._port_state(flat_params(grads)).items():
        want['params/' + key] = value.numpy()
    if new_stats:
        for key, value in flat_params(new_stats).items():
            want['batch_stats/' + key[len('params/'):].replace('/', '.')] = \
                np.array(value)
    return want


def _values_f64(model, x, gmap, flat, stats, sens):
    '''``tests/test_torch_mulmo._jax_values_f64`` over ``_values``.'''
    import jax
    import numpy as np
    import pytest

    from dnncancerannotator_tpu.ops import gates as jax_gates
    from tests import test_torch_mulmo as tm

    def f64(tree):
        return {k: np.asarray(v, np.float64) for k, v in tree.items()}

    with pytest.MonkeyPatch.context() as mp, jax_gates.pure_xla(), \
            jax.enable_x64(True):
        for module in tm._F32_CASTS:
            mp.setattr(module, 'jnp', tm._F64Numpy())
        return _values(model, x.astype(np.float64), gmap.astype(np.float64),
                       f64(flat), f64(stats), sens)


def compute(case):
    '''{key: numpy array} of one case (module docstring).'''
    import jax.numpy as jnp
    import numpy as np

    from dnncancerannotator_tpu import models as jax_models
    from tests import test_torch_mulmo as tm

    name, options, shape, seed, sens = {**CASES, **GEOMETRY_CASES}[case]
    model, x, gmap, flat, stats = model_case(name, options, shape, seed)
    model16, _ = jax_models.build_model(name, options, dtype=jnp.bfloat16)
    out = {'in/x': x, 'in/gmap': gmap}
    out.update({'param/' + k: v for k, v in {**flat, **stats}.items()})
    import pytest
    from dnncancerannotator_tpu.models import fastconv as jax_fastconv
    from dnncancerannotator_tpu.ops.pallas import conv_kernel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fastconv, 'jnp', _F32DotNumpy())
        for name_, fn in PALLAS_F32.items():
            mp.setattr(conv_kernel, name_, fn)
        mp.setenv('DNNCA_PALLAS_INTERPRET', '1')
        want16 = _values(model16, x, gmap, flat, stats, sens)
    want64 = _values_f64(model, x, gmap, flat, stats, sens)
    variables = {'params': tm._jax_params(flat)}
    if stats:
        variables['batch_stats'] = tm._jax_tree(stats)
    logits32, _ = model.apply(variables, jnp.asarray(x), training=True,
                              return_logits=True, mutable=['batch_stats'])
    out.update({'bf16/' + k: v for k, v in want16.items()})
    out.update({'f64/' + k: v for k, v in want64.items()})
    out['f32/train'] = np.asarray(logits32)
    return out


def main(argv):
    import jax
    import numpy as np

    jax.config.update('jax_default_matmul_precision', 'highest')
    out_dir, cases = argv[0], argv[1:]
    for case in cases:
        np.savez(os.path.join(out_dir, case + '.npz'), **compute(case))


if __name__ == '__main__':
    main(sys.argv[1:])
