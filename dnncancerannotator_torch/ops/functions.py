'''The port's kernels as differentiable functions: each forward kernel with
its backward kernel in a ``torch.autograd.Function`` (the counterparts of
the JAX package's ``custom_vjp`` wrappers around its Pallas kernels).

Each public function below runs the forward kernel alone, with nothing
saved, when no gradient is being recorded (prediction), and the Function
otherwise. The backward asks for the data gradient only when autograd needs
it (``ctx.needs_input_grad[0]``): the model's input batch never requires
grad, so its first conv chain skips its dx, which is need_dx=False in the
JAX package (fastconv.py:540-569, engine.py:512-520).
'''

import torch

from .kernels import conv_chain as chain_mod
from .kernels import conv_chain_bwd as chain_bwd_mod
from .kernels import pool2x2_nhwc as pool_mod
from .kernels import pool2x2_nhwc_bwd as pool_bwd_mod
from .kernels import stencil_conv as stencil_mod
from .kernels import stencil_conv_bwd as stencil_bwd_mod
from .kernels import tconv2x2 as tconv_mod
from .kernels import tconv2x2_bwd as tconv_bwd_mod
from .kernels import tconv2x2_nhwc as tconv_nhwc_mod
from .kernels import tconv2x2_nhwc_bwd as tconv_nhwc_bwd_mod


def _recording(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class ConvChainFn(torch.autograd.Function):
    '''c2 = relu(conv(relu(conv(x, w1) + b1), w2) + b2); the forward keeps
    c1 and c2 for the relu masks of the backward.'''

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        c1, c2 = chain_mod.conv_chain(x, w1, b1, w2, b2, need_c1=True)
        ctx.save_for_backward(x, c1, c2, w1, w2)
        return c2

    @staticmethod
    def backward(ctx, g):
        x, c1, c2, w1, w2 = ctx.saved_tensors
        return chain_bwd_mod.conv_chain_bwd(
            x, c1, c2, g.contiguous(), w1, w2,
            need_dx=ctx.needs_input_grad[0])


class TConv2x2Fn(torch.autograd.Function):
    '''ConvTranspose(kernel=2, stride=2) + bias, w [Ci, Co, 2, 2].'''

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return tconv_mod.tconv2x2(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return tconv_bwd_mod.tconv2x2_bwd(x, g.contiguous(), w,
                                          need_dx=ctx.needs_input_grad[0])


class Pool2x2NHWCFn(torch.autograd.Function):
    '''2x2 / stride-2 max pool, NHWC, with the JAX tie rule backward.'''

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pool_mod.pool2x2_nhwc(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pool_bwd_mod.pool2x2_nhwc_bwd(x, g.contiguous())


class TConv2x2NHWCFn(torch.autograd.Function):
    '''ConvTranspose(kernel=2, stride=2) + bias, NHWC, w [Ci, Co, 2, 2]. On
    the card the weight is packed once a step, in the forward, and the
    backward's dgrad reads the same packed copy.'''

    @staticmethod
    def forward(ctx, x, w, b):
        wpt = tconv_nhwc_mod.pack(w) if x.is_cuda else None
        ctx.save_for_backward(x, w, wpt)
        return tconv_nhwc_mod.tconv2x2_nhwc(x, w, b, wpt)

    @staticmethod
    def backward(ctx, g):
        x, w, wpt = ctx.saved_tensors
        return tconv_nhwc_bwd_mod.tconv2x2_nhwc_bwd(
            x, g.contiguous(), w, need_dx=ctx.needs_input_grad[0], wpt=wpt)


class StencilConvFn(torch.autograd.Function):
    '''Stride-1 conv with explicit pads, bias and an optional fused relu;
    with the relu, the backward masks g by the saved output first.'''

    @staticmethod
    def forward(ctx, x, w, b, pads, relu):
        out = stencil_mod.stencil_conv(x, w, b, pads, relu)
        ctx.pads, ctx.relu = pads, relu
        ctx.save_for_backward(x, w, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if ctx.relu:
            g = g * (out > 0)
        dx, dw, db = stencil_bwd_mod.stencil_conv_bwd(
            x, g.contiguous(), w, ctx.pads, need_dx=ctx.needs_input_grad[0])
        return dx, dw, db, None, None


def conv_chain(x, w1, b1, w2, b2):
    if _recording(x, w1, b1, w2, b2):
        return ConvChainFn.apply(x, w1, b1, w2, b2)
    return chain_mod.conv_chain(x, w1, b1, w2, b2)[1]


def tconv2x2(x, w, b):
    if _recording(x, w, b):
        return TConv2x2Fn.apply(x, w, b)
    return tconv_mod.tconv2x2(x, w, b)


def stencil_conv(x, w, b, pads, relu=False):
    if _recording(x, w, b):
        return StencilConvFn.apply(x, w, b, pads, relu)
    return stencil_mod.stencil_conv(x, w, b, pads, relu)


def pool2x2_nhwc(x):
    if _recording(x):
        return Pool2x2NHWCFn.apply(x)
    return pool_mod.pool2x2_nhwc(x)


def tconv2x2_nhwc(x, w, b):
    if _recording(x, w, b):
        return TConv2x2NHWCFn.apply(x, w, b)
    return tconv_nhwc_mod.tconv2x2_nhwc(x, w, b)
