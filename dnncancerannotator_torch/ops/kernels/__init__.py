'''Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the wrapper (which launches the kernel for CUDA tensors
and counts its launches in ``launches``), the plain PyTorch version of the
same function (run for CPU tensors and used as the reference on the card),
and the shape bounds the kernel takes.
'''

from . import conv_chain, stencil_conv, tconv2x2

KERNELS = (conv_chain, tconv2x2, stencil_conv)


def reset_launches():
    for mod in KERNELS:
        mod.launches = 0


def launch_counts():
    return {mod.__name__.rsplit('.', 1)[-1]: mod.launches for mod in KERNELS}
