'''Segmentation loss (counterpart of dnncancerannotator_tpu.train.losses).

``weighted_crossentropy``: pixel-wise binary cross-entropy from logits with
the positive-class weight mask ``label * (weight - 1) + 1``. When ``weight``
is unset it is ``1 / positive_rate`` of the whole batch (1 when the batch has
no positive pixel), then ``weight_mul * w + weight_add``. Returns the
per-sample loss [B] (mean over pixels); callers take the batch mean.
Logits smaller than the labels are taken where they broadcast against
them, as the JAX loss takes them (a strided model's 1 x 1 output), and
raise ValueError naming both shapes where they do not (a VALID model's
output): the labels are never cropped or padded to fit.

Label smoothing blurs the label mask with a Gaussian
(``ops/filters.py``) before the loss, wherever ``per_sample`` runs: the
train step and the validation loss. With ``deploy_options.debug_asserts``
the train step checks the labels, the positive rate and the weight
(``utils/checks.py``).

Inside a data-parallel step (parallel/mesh.py) "the whole batch" is the
global batch: the positive pixels of every rank's real rows are summed over
the ranks before the rate is taken, so a rank whose rows hold no positive
pixel gets the global weight, as one device running the whole batch (and
the JAX package's sharded step) gives it; in evaluation the padded rows
do not count (JAX train/losses.py: ``n_valid``). Under
``spatial_partition`` a rank holds some image rows of its batch rows; the
rate counts the whole planes' pixels, and the engine blurs the labels
(``prepare``) before it takes a rank's rows.
'''

import torch

from ..ops.filters import gaussian_filter2d
from ..parallel import mesh as mesh_lib
from ..utils import checks


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
    '''Fraction of positive pixels over the whole label tensor; inside a
    data-parallel step, over the real rows of every rank's (of whole
    planes: under ``spatial_partition`` a rank holds [B, h, W] of them).'''
    shard = mesh_lib.current()
    if shard is None:
        return labels.sum() / labels.numel()
    positive = shard.group.all_reduce_sum(labels[:shard.valid].sum())
    h = labels.shape[1]
    return positive / (shard.total * (labels[0].numel() // h
                                      * shard.plane(h)))


def weighted_crossentropy(labels, logits, weight=None, weight_add=0.0,
                          weight_mul=1.0, check_labels=True):
    '''Per-sample weighted BCE of labels [B, H, W] and logits [B, H, W]
    (or [B, H, W, 1]); ``check_labels=False`` leaves the labels' range
    check to the caller.'''
    if logits.dim() == labels.dim() + 1:
        logits = logits.squeeze(-1)
    try:
        torch.broadcast_shapes(labels.shape, logits.shape)
    except RuntimeError:
        # where the JAX loss's broadcast fails (a VALID model's smaller
        # output, a strided one's past 1 x 1): the labels are not cropped
        raise ValueError(f'the logits {tuple(logits.shape)} do not match '
                         f'the labels {tuple(labels.shape)}') from None
    # at least f32 (bf16 logits are upcast; f64 stays f64)
    dtype = torch.promote_types(logits.dtype, torch.float32)
    labels = labels.to(dtype)
    logits = logits.to(dtype)
    if check_labels:
        checks.check_range(labels, 0.0, 1.0, 'labels')
    if weight is None:
        rate = positive_rate(labels)
        checks.check_range(rate, 0.0, 1.0, 'positive_rate')
        weight = torch.where(rate > 0, 1.0 / rate.clamp(min=1e-12),
                             torch.ones_like(rate))
    weight = weight_mul * weight + weight_add
    checks.check_non_negative(weight, 'loss weight', device=labels.device)
    weight_mask = labels * (weight - 1.0) + 1.0
    bce = sigmoid_bce_from_logits(labels, logits)
    return (bce * weight_mask).mean(dim=(1, 2))


class WeightedCrossentropy:
    '''Configured loss: ``per_sample(labels, logits) -> [B]`` and
    ``__call__(labels, logits) -> scalar``.'''

    def __init__(self, weight=None, weight_add=0.0, weight_mul=1.0,
                 label_smoothing=False, label_smoothing_filter_size=6,
                 label_smoothing_sigma=3):
        self.weight = weight
        self.weight_add = weight_add
        self.weight_mul = weight_mul
        self.label_smoothing = label_smoothing
        self.label_smoothing_filter_size = label_smoothing_filter_size
        self.label_smoothing_sigma = label_smoothing_sigma

    def prepare(self, labels):
        '''The labels [B, H, W] the loss reads: under label smoothing
        checked and blurred (reflect padding: whole planes only), else as
        they are.'''
        if not self.label_smoothing:
            return labels
        # the labels' check reads them before the blur: the blur of a
        # region of ones is 1 + an ulp, which the JAX package's check,
        # after it, rejects
        checks.check_range(labels, 0.0, 1.0, 'labels')
        return gaussian_filter2d(
            labels[..., None], filter_shape=self.label_smoothing_filter_size,
            sigma=self.label_smoothing_sigma)[..., 0]

    def per_sample(self, labels, logits, prepared=False):
        '''The per-sample loss [B]; ``prepared``: ``labels`` came through
        ``prepare`` already (the engine prepares whole planes and then
        takes a rank's image rows under ``spatial_partition``).'''
        if not prepared:
            labels = self.prepare(labels)
        return weighted_crossentropy(
            labels, logits, weight=self.weight, weight_add=self.weight_add,
            weight_mul=self.weight_mul,
            check_labels=not self.label_smoothing)

    def __call__(self, labels, logits, prepared=False):
        return self.per_sample(labels, logits, prepared).mean()


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
