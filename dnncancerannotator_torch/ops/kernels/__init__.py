'''Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the wrapper (which launches the kernel for CUDA tensors
and counts its launches in ``launches``, and those of its bf16 form, where
it has one, in ``launches_bf16``), the plain PyTorch version of the
same function (run for CPU tensors and used as the reference on the card),
and the shape bounds the kernel takes.
'''

from . import (cca, conv_chain, conv_chain_bwd, pool2x2_nhwc,
               pool2x2_nhwc_bwd, stencil_conv, stencil_conv_bwd,
               stencil_conv_nhwc, tconv2x2, tconv2x2_bwd, tconv2x2_nhwc,
               tconv2x2_nhwc_bwd, warp_crop, warp_twopass)

KERNELS = (conv_chain, conv_chain_bwd, tconv2x2, tconv2x2_bwd, stencil_conv,
           stencil_conv_bwd, warp_twopass, cca, pool2x2_nhwc,
           pool2x2_nhwc_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd, warp_crop,
           stencil_conv_nhwc)


# the kernels with a bf16 form (``launches_bf16``)
BF16_KERNELS = (conv_chain, conv_chain_bwd, stencil_conv, stencil_conv_bwd,
                stencil_conv_nhwc)


def reset_launches():
    for mod in KERNELS:
        mod.launches = 0
    for mod in BF16_KERNELS:
        mod.launches_bf16 = 0
    stencil_conv.launches_tile = stencil_conv.launches_tile_bf16 = 0


def launch_counts():
    '''{kernel: launches}, the bf16 forms as ``<kernel>_bf16``; and of
    stencil_conv's, those of its tile route as ``stencil_conv_tile`` (and
    ``stencil_conv_tile_bf16``).'''
    counts = {mod.__name__.rsplit('.', 1)[-1]: mod.launches
              for mod in KERNELS}
    counts.update({mod.__name__.rsplit('.', 1)[-1] + '_bf16':
                   mod.launches_bf16 for mod in BF16_KERNELS})
    counts.update(stencil_conv_tile=stencil_conv.launches_tile,
                  stencil_conv_tile_bf16=stencil_conv.launches_tile_bf16)
    return counts
