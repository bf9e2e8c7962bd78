'''Non-overlapping max pooling (counterpart of
dnncancerannotator_tpu.ops.pooling.max_pool2d). Plain tensor ops, as the
JAX package leaves the pool to XLA.

The pool is the JAX package's pairwise tree: ``rate`` strided slices along
H combined with ``torch.maximum``, then the same along W. ``torch.maximum``
splits its gradient 50/50 at an exact tie, as ``jnp.maximum`` does, so a
window's cotangent splits at ties exactly as in the JAX package (a fully
tied 2x2 window gives 1/4 each). A reduction such as ``amax`` would split
it evenly among all tied values instead.
'''

import torch


def max_pool2d(x, rate, data_format='NCHW'):
    '''Max pool of [B, C, H, W] (or [B, H, W, C] with data_format='NHWC')
    by ``rate`` with window == stride; trailing rows/cols beyond a window
    multiple are dropped (VALID) and get zero gradient.'''
    rate = int(rate)
    if data_format == 'NHWC':
        return max_pool2d(x.permute(0, 3, 1, 2), rate).permute(0, 2, 3, 1)
    oh, ow = x.shape[2] // rate, x.shape[3] // rate
    x = x[:, :, :oh * rate, :ow * rate]
    m = x[:, :, 0::rate]
    for i in range(1, rate):
        m = torch.maximum(m, x[:, :, i::rate])
    out = m[:, :, :, 0::rate]
    for i in range(1, rate):
        out = torch.maximum(out, m[:, :, :, i::rate])
    return out
