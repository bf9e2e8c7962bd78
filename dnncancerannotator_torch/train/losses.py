'''Segmentation loss (counterpart of dnncancerannotator_tpu.train.losses).

``weighted_crossentropy``: pixel-wise binary cross-entropy from logits with
the positive-class weight mask ``label * (weight - 1) + 1``. When ``weight``
is unset it is ``1 / positive_rate`` of the whole batch (1 when the batch has
no positive pixel), then ``weight_mul * w + weight_add``. Returns the
per-sample loss [B] (mean over pixels); callers take the batch mean.

Label smoothing (a Gaussian blur of the mask) is not ported yet.
'''

import torch


def sigmoid_bce_from_logits(labels, logits):
    '''Numerically stable elementwise sigmoid cross-entropy,
    max(z, 0) - z * y + log(1 + exp(-|z|)), with the JAX package's
    gradients at a logit of exactly 0 (a pixel whose head input is all zero
    and whose bias is 0, common at initialisation): ``jnp.maximum`` splits
    50/50 there, as ``torch.maximum`` does, and ``jnp.abs`` has slope 1,
    as the ``where`` below has. The gradient there is then -y, as in the
    JAX package (the exact derivative would be 0.5 - y); ``clamp(min=0)``
    and ``abs`` would give 1 - y.'''
    abs_z = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_z)))


def positive_rate(labels):
    '''Fraction of positive pixels over the whole label tensor.'''
    return labels.sum() / labels.numel()


def weighted_crossentropy(labels, logits, weight=None, weight_add=0.0,
                          weight_mul=1.0):
    '''Per-sample weighted BCE of labels [B, H, W] and logits [B, H, W]
    (or [B, H, W, 1]).'''
    if logits.dim() == labels.dim() + 1:
        logits = logits.squeeze(-1)
    # at least f32 (bf16 logits are upcast; f64 stays f64)
    dtype = torch.promote_types(logits.dtype, torch.float32)
    labels = labels.to(dtype)
    logits = logits.to(dtype)
    if weight is None:
        rate = positive_rate(labels)
        weight = torch.where(rate > 0, 1.0 / rate.clamp(min=1e-12),
                             torch.ones_like(rate))
    weight = weight_mul * weight + weight_add
    weight_mask = labels * (weight - 1.0) + 1.0
    bce = sigmoid_bce_from_logits(labels, logits)
    return (bce * weight_mask).mean(dim=(1, 2))


class WeightedCrossentropy:
    '''Configured loss: ``per_sample(labels, logits) -> [B]`` and
    ``__call__(labels, logits) -> scalar``.'''

    def __init__(self, weight=None, weight_add=0.0, weight_mul=1.0,
                 label_smoothing=False, label_smoothing_filter_size=6,
                 label_smoothing_sigma=3):
        del label_smoothing_filter_size, label_smoothing_sigma
        if label_smoothing:
            raise NotImplementedError(
                'label_smoothing is not ported yet: it needs the Gaussian '
                'filter of ops/filters.py (ROADMAP.md queue 1)')
        self.weight = weight
        self.weight_add = weight_add
        self.weight_mul = weight_mul

    def per_sample(self, labels, logits):
        return weighted_crossentropy(
            labels, logits, weight=self.weight, weight_add=self.weight_add,
            weight_mul=self.weight_mul)

    def __call__(self, labels, logits):
        return self.per_sample(labels, logits).mean()


_LOSSES = {
    'WeightedCrossentropy': WeightedCrossentropy,
    'weighted_crossentropy': WeightedCrossentropy,
}


def solve_loss(spec):
    '''Resolve a loss spec: {'class_name': ..., 'config': {...}}, a
    registered name, or a callable.'''
    if isinstance(spec, str):
        return _LOSSES[spec]()
    if isinstance(spec, dict) and 'class_name' in spec:
        return _LOSSES[spec['class_name']](**(spec.get('config') or {}))
    if callable(spec):
        return spec
    raise ValueError(f'Cannot resolve loss spec: {spec!r}')
