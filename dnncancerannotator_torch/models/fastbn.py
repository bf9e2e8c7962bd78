'''BatchNorm over the last (channel) axis with the analytic backward
(counterpart of dnncancerannotator_tpu.models.fastbn).

``BatchNormFast`` keeps the JAX module's names, statistics and update rule:

- parameters ``scale`` (ones) and ``bias`` (zeros), buffers ``mean``
  (zeros) and ``var`` (ones), as flax names ``params/.../{scale,bias}`` and
  ``batch_stats/.../{mean,var}`` (convert.py carries them across);
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
  the reductions.
'''

import torch
from torch import nn


def _apply(x, scale, bias, mean, var, eps):
    mul = torch.rsqrt(var + eps) * scale
    shift = bias - mean * mul
    return x * mul + shift


class _BNTrainFn(torch.autograd.Function):
    '''Normalize with the batch statistics (given, not differentiated) and
    the analytic gradient for x, scale and bias.'''

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, mean, var)
        return _apply(x, scale, bias, mean, var, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, var = ctx.saved_tensors
        red = tuple(range(x.dim() - 1))
        count = x.numel() // x.shape[-1]
        r = torch.rsqrt(var + ctx.eps)
        xhat = (x - mean) * r
        dbeta = g.sum(red)
        dgamma = (g * xhat).sum(red)
        dx = (r * scale) * (g - dbeta / count - xhat * (dgamma / count))
        return dx, dgamma, dbeta, None, None, None


class BatchNormFast(nn.Module):
    '''BatchNorm of [..., C] f32 tensors; ``train()`` / ``eval()`` select
    batch or running statistics.'''

    def __init__(self, features, momentum=0.99, epsilon=1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        if not self.training:
            return _apply(x, self.scale, self.bias, self.mean, self.var,
                          self.epsilon)
        red = tuple(range(x.dim() - 1))
        with torch.no_grad():
            mean = x.mean(red)
            var = (x * x).mean(red) - mean * mean
            self.mean.copy_(self.momentum * self.mean
                            + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var
                           + (1 - self.momentum) * var)
        return _BNTrainFn.apply(x, self.scale, self.bias, mean, var,
                                self.epsilon)
