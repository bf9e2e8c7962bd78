'''Connected-components labelling with 4-connectivity (counterpart of
dnncancerannotator_tpu.ops.cca).

Each connected region of a boolean mask gets a distinct id 1..n, numbered in
the order of its first pixel in row-major order; 0 is background. The raw
labels (every mask pixel holding its component's minimum flat index) come
from ``kernels.cca.cca_raw_labels``: the CUDA kernel for CUDA tensors, the
plain PyTorch fixed point for CPU tensors. The compaction to 1..n is a
cumulative sum of the roots and a gather, as in the JAX package.
'''

import torch

from .kernels import cca as cca_kernel


def _compact_from_raw(raw, masks):
    '''Raw min-index labels [N, H, W] -> (labels 1..n [N, H, W] int32,
    counts [N] int32): a pixel is a root iff its label is its own index.'''
    n, h, w = masks.shape
    hw = h * w
    flat = raw.reshape(n, hw).long()
    mask = masks.reshape(n, hw)
    is_root = (flat == torch.arange(hw, device=raw.device)) & mask
    ranks = torch.cumsum(is_root, 1, dtype=torch.int32)
    compact = torch.where(mask, ranks.gather(1, flat.clamp(max=hw - 1)), 0)
    return compact.reshape(n, h, w), ranks[:, -1]


def connected_components_batch(masks):
    '''Label the 4-connected regions of each of N masks ([N, H, W] bool);
    returns (labels [N, H, W] int32, counts [N] int32).'''
    masks = masks.bool().contiguous()
    return _compact_from_raw(cca_kernel.cca_raw_labels(masks), masks)


def connected_components(mask):
    '''Label the 4-connected regions of one [H, W] bool mask; returns
    (labels [H, W] int32, count: int32 scalar tensor).'''
    labels, counts = connected_components_batch(mask[None])
    return labels[0], counts[0]
