'''Non-overlapping max pooling, forward (counterpart of
dnncancerannotator_tpu.ops.pooling.max_pool2d). Plain tensor ops, as the
JAX package leaves the pool to XLA.'''


def max_pool2d(x, rate, data_format='NCHW'):
    '''Max pool of [B, C, H, W] (or [B, H, W, C] with data_format='NHWC')
    by ``rate`` with window == stride; trailing rows/cols beyond a window
    multiple are dropped (VALID).'''
    rate = int(rate)
    if data_format == 'NHWC':
        return max_pool2d(x.permute(0, 3, 1, 2), rate).permute(0, 2, 3, 1)
    b, c, h, w = x.shape
    oh, ow = h // rate, w // rate
    x = x[:, :, :oh * rate, :ow * rate]
    return x.reshape(b, c, oh, rate, ow, rate).amax(dim=(3, 5))
