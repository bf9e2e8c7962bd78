'''Non-overlapping max pooling (counterpart of
dnncancerannotator_tpu.ops.pooling.max_pool2d).

The pool is the JAX package's pairwise tree: ``rate`` strided slices along
H combined with ``torch.maximum``, then the same along W. ``torch.maximum``
splits its gradient 50/50 at an exact tie, as ``jnp.maximum`` does, so a
window's cotangent splits at ties exactly as in the JAX package (a fully
tied 2x2 window gives 1/4 each). A reduction such as ``amax`` would split
it evenly among all tied values instead.

Where the JAX package routes to its Pallas pool (the ``pallas_pool`` gate,
NHWC f32, rate 2, C % 128 == 0), the pool runs the port's pool2x2_nhwc
kernel forward and backward (ops/functions.py), which computes the same
values and the same gradient. Everything else is plain tensor ops, as the
JAX package leaves it to XLA.
'''

import torch

from . import functions
from .kernels import pool2x2_nhwc as pool_mod


def max_pool2d(x, rate, data_format='NCHW'):
    '''Max pool of [B, C, H, W] (or [B, H, W, C] with data_format='NHWC')
    by ``rate`` with window == stride; trailing rows/cols beyond a window
    multiple are dropped (VALID) and get zero gradient.'''
    rate = int(rate)
    if pool_mod.eligible(x.shape, rate, data_format, x.dtype):
        return functions.pool2x2_nhwc(x.contiguous())
    ay, ax = (2, 3) if data_format == 'NCHW' else (1, 2)

    def sl(t, axis, start, stop=None, step=1):
        index = [slice(None)] * t.dim()
        index[axis] = slice(start, stop, step)
        return t[tuple(index)]

    oh, ow = x.shape[ay] // rate, x.shape[ax] // rate
    x = sl(sl(x, ay, 0, oh * rate), ax, 0, ow * rate)
    m = sl(x, ay, 0, None, rate)
    for i in range(1, rate):
        m = torch.maximum(m, sl(x, ay, i, None, rate))
    out = sl(m, ax, 0, None, rate)
    for i in range(1, rate):
        out = torch.maximum(out, sl(m, ax, i, None, rate))
    return out
