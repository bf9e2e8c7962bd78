'''Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the wrapper (which launches the kernel for CUDA tensors
and counts its launches in ``launches``), the plain PyTorch version of the
same function (run for CPU tensors and used as the reference on the card),
and the shape bounds the kernel takes.
'''

from . import (cca, conv_chain, conv_chain_bwd, pool2x2_nhwc,
               pool2x2_nhwc_bwd, stencil_conv, stencil_conv_bwd, tconv2x2,
               tconv2x2_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd, warp_twopass)

KERNELS = (conv_chain, conv_chain_bwd, tconv2x2, tconv2x2_bwd, stencil_conv,
           stencil_conv_bwd, warp_twopass, cca, pool2x2_nhwc,
           pool2x2_nhwc_bwd, tconv2x2_nhwc, tconv2x2_nhwc_bwd)


def reset_launches():
    for mod in KERNELS:
        mod.launches = 0


def launch_counts():
    return {mod.__name__.rsplit('.', 1)[-1]: mod.launches for mod in KERNELS}
