'''BatchNorm over the last (channel) axis with the analytic backward
(counterpart of dnncancerannotator_tpu.models.fastbn).

``BatchNormFast`` keeps the JAX module's names, statistics and update rule:

- parameters ``scale`` (ones) and ``bias`` (zeros), buffers ``mean``
  (zeros) and ``var`` (ones), as flax names ``params/.../{scale,bias}`` and
  ``batch_stats/.../{mean,var}`` (convert.py carries them across); with
  ``use_scale=False`` (MultiResUnet's ``ConvBN`` and ``head_bn``) there is
  no ``scale`` parameter, as the flax tree has no ``scale`` leaf, and the
  apply multiplies by ``rsqrt(var + eps)`` alone;
- in training mode: f32 batch statistics over every axis but the last, the
  mean and the biased variance ``E[x^2] - mean^2``; the running statistics
  move as ``momentum * running + (1 - momentum) * batch`` with momentum
  0.99 (Keras' convention; ``nn.BatchNorm2d`` uses the complement and an
  unbiased variance, so it is not used here). Nothing updates them but a
  forward in training mode;
- in eval mode: the running statistics;
- the apply ``x * mul + shift`` with ``mul = rsqrt(var + eps) * scale`` and
  ``shift = bias - mean * mul``, eps 1e-3 inside the rsqrt;
- in training mode the closed-form BN backward of ``_bn_train_bwd``
  (fastbn.py:68-87) as a ``torch.autograd.Function``: the batch statistics'
  dependence on x is differentiated analytically, not by autograd through
  the reductions; without a scale it has no dgamma output;
- with a ``dtype`` (bfloat16 compute) x is cast to it first; the
  statistics, the apply and the backward run in f32 from the rounded
  values, the output and dx are rounded back to x's dtype, and dscale and
  dbias stay f32 (fastbn.py:40-48, :68-88). Under f32 the casts are
  no-ops;
- inside a data-parallel step (parallel/mesh.py) the statistics are the
  global batch's, as GSPMD computes them over the JAX package's sharded
  batch: each rank's mean and ``E[x^2]``, weighted by its share of the
  pixels (its batch rows, and under ``spatial_partition`` its image rows
  of the [B, H, W, C] input), are summed over every rank in f32 (one
  all_reduce), so the running
  statistics move alike on every rank; the backward sums ``sum(g)`` and
  ``sum(g * xhat)`` over the ranks for dx (one all_reduce), while dscale
  and dbias stay the rank's own, summed with every other gradient. At one
  rank the shares are 1 and the sums the rank's own: the one-device
  arithmetic. ``nn.SyncBatchNorm`` is not used: its variance convention
  differs and it needs ``all_gather``, which gloo lacks on CUDA tensors.
'''

import torch
from torch import nn

from ..parallel import mesh as mesh_lib


def wide(x):
    '''x in f32, or as it is when it is wider (the f64 check runs).'''
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _apply(x, scale, bias, mean, var, eps):
    '''The normalize in f32, rounded to x's dtype.'''
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale
    shift = bias - mean * mul
    return (wide(x) * mul + shift).to(x.dtype)


class _BNTrainFn(torch.autograd.Function):
    '''Normalize with the batch statistics (given, not differentiated) and
    the analytic gradient for x, scale and bias.'''

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, eps):
        ctx.eps = eps
        # the backward may run on another thread: it keeps the step's shard
        ctx.shard = mesh_lib.current()
        ctx.save_for_backward(x, scale, mean, var)
        return _apply(x, scale, bias, mean, var, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, var = ctx.saved_tensors
        red = tuple(range(x.dim() - 1))
        count = x.numel() // x.shape[-1]
        r = torch.rsqrt(var + ctx.eps)
        gf = wide(g)
        xhat = (wide(x) - mean) * r
        dbeta = gf.sum(red)
        dgamma = (gf * xhat).sum(red)
        sum_beta, sum_gamma = dbeta, dgamma
        if ctx.shard is not None:
            # dx reads the global batch's sums and count; dscale and dbias
            # stay this rank's, summed over ranks with the other gradients
            sums = ctx.shard.group.all_reduce_sum(torch.cat([dbeta, dgamma]))
            sum_beta, sum_gamma = sums.split(dbeta.shape[0])
            count = (count // x.shape[0] * ctx.shard.total
                     // x.shape[1] * ctx.shard.plane(x.shape[1]))
        gscale = r if scale is None else r * scale
        dx = gscale * (gf - sum_beta / count - xhat * (sum_gamma / count))
        return (dx.to(x.dtype), None if scale is None else dgamma, dbeta,
                None, None, None)


class BatchNormFast(nn.Module):
    '''BatchNorm of [..., C] tensors; ``train()`` / ``eval()`` select
    batch or running statistics; ``dtype`` (None: x's own) the dtype x is
    cast to and the output has.'''

    def __init__(self, features, momentum=0.99, epsilon=1e-3,
                 use_scale=True, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = (nn.Parameter(torch.ones(features)) if use_scale
                      else None)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if not self.training:
            return _apply(x, self.scale, self.bias, self.mean, self.var,
                          self.epsilon)
        red = tuple(range(x.dim() - 1))
        with torch.no_grad():
            xf = wide(x)
            mean = xf.mean(red)
            mean_sq = (xf * xf).mean(red)
            shard = mesh_lib.current()
            if shard is not None:
                share = x.shape[0] / shard.total   # 1.0 at one rank
                if shard.spatial:   # its image rows' share of the plane's
                    share = share * x.shape[1] / shard.plane(x.shape[1])
                moments = shard.group.all_reduce_sum(
                    torch.cat([mean * share, mean_sq * share]))
                mean, mean_sq = moments.split(mean.shape[0])
            var = mean_sq - mean * mean
            self.mean.copy_(self.momentum * self.mean
                            + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var
                           + (1 - self.momentum) * var)
        return _BNTrainFn.apply(x, self.scale, self.bias, mean, var,
                                self.epsilon)
