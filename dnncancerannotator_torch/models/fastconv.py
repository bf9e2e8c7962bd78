'''Convolution modules and the chain routing (counterpart of
dnncancerannotator_tpu.models.fastconv).

Where the JAX package routes a convolution to a Pallas kernel, the port
runs one of its CUDA kernels (ops/kernels) on the card, or its plain
PyTorch version on the CPU, forward and backward (the autograd Functions of
ops/functions.py):

- ``Conv2DFast``: NCHW stride-1 convs with at most 32 channels and kh *
  kw * Ci * Co <= 1024 -> stencil_conv; NHWC stride-1 convs with at most 32 channels, a string
  padding and kh * kw * Ci * Co <= 1024 -> stencil_conv_nhwc (the JAX
  package's ``small`` convs that reach ``stencil_conv2d_pallas`` with
  ``nchw=False``: MulmoUNet's first conv of each encoder and its head);
- ``ConvTranspose2DFast``: kernel == stride == 2 -> tconv2x2 (NCHW, at most
  64 channels), or tconv2x2_nhwc (NHWC where its gate and eligibility hold,
  ops/kernels/tconv2x2_nhwc.py);
- ``chain_ok``: which ConvChain cells run whole through conv_chain.

Inside ``gates.library_only()`` none of these routes is taken: every conv
and transposed conv is the library call below.

Under ``deploy_options.spatial_partition`` (parallel/mesh.py) a SAME conv
with a kernel taller than one row runs, on whichever route, on its rank's
slab: its rows plus (kh - 1) // 2 rows of the rank above and kh - 1 - (kh
- 1) // 2 of the rank below, exchanged, and keeps its own rows; a 1x1 conv
and a transposed conv (2x2, stride 2, on whole blocks) stay on the rank's
rows.

Wider convs and transposed convs are plain ``F.conv2d`` /
``F.conv_transpose2d``, as the JAX package leaves them to XLA
(``lax.conv_general_dilated``, ``lax.conv_transpose``); an NHWC tensor goes
in as its ``channels_last`` NCHW view, with no copy. Strided convs belong to
a model the port does not run yet and raise NotImplementedError.

``Conv2DFast`` also takes a tuple of NHWC parts, the conv of their channel
concat, computed as the split-kernel sum conv(a, k[:, :ca]) + conv(b,
k[:, ca:]) without the concat, then bias, then relu (fastconv.py:343-389).

Parameters use PyTorch layouts: ``weight`` [Co, Ci, kh, kw] for convs and
[Ci, Co, kh, kw] for transposed convs; convert.py carries flax checkpoints
across.

Compute dtype (``dtype``; None takes the input's, as flax's ``self.dtype or
x.dtype``): the parameters stay f32, and a module casts its input, weight
and bias to the dtype where the JAX module does (fastconv.py:360-362,
:284, :388, :452-456). Under bfloat16 a library conv or transposed conv
returns bf16 and its bias is added in bf16 after the rounding; the kernels
take their bf16 forms (f32 accumulation, the output rounded once), and the
kernel gates read the dtype as the JAX gates do: the NHWC and NCHW
transposed-conv kernels are f32 only, the stencil conv takes any dtype,
and a chain runs whole in bf16 only where the JAX stencil chain takes it
(``chain_ok``).
'''

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import functions, gates
from ..ops.kernels import conv_chain_bwd as conv_chain_bwd_mod
from ..ops.kernels import stencil_conv as stencil_mod
from ..ops.kernels import stencil_conv_nhwc as stencil_nhwc_mod
from ..ops.kernels import tconv2x2 as tconv_mod
from ..ops.kernels import tconv2x2_nhwc as tconv_nhwc_mod
from ..parallel import mesh

_NOT_PORTED = ('not ported yet (ROADMAP.md queue 1 item 4: strided convs and '
               'the valid-padding centre crop)')
# the JAX stencil chain's unroll bound (conv_kernel.chain_supported): K * K
# * Ci * Cm and K * K * Cm * Co terms at most
CHAIN_TERMS = 1024
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'bf16': torch.bfloat16}


def resolve_dtype(dtype):
    '''The torch dtype of a compute dtype option (a torch dtype, its name,
    or None for the input's own).'''
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f'dtype must be float32 or bfloat16, got {dtype!r}')
    return _DTYPES[str(dtype)]


def same_or_valid_pads(kh, kw, padding):
    '''((top, bottom), (left, right)) pads of a stride-1 conv with SAME or
    VALID padding (SAME puts the odd pixel at the bottom/right, as XLA
    does).'''
    mode = padding.upper()
    if mode == 'VALID':
        return ((0, 0), (0, 0))
    if mode != 'SAME':
        raise ValueError(f'padding must be SAME or VALID, got {padding!r}')
    return (((kh - 1) // 2, kh - 1 - (kh - 1) // 2),
            ((kw - 1) // 2, kw - 1 - (kw - 1) // 2))


def _glorot_uniform_(weight, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


def _nchw(x):
    '''The NCHW view of an NHWC tensor (channels_last, no copy).'''
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def plain_tconv(x, w, b):
    '''2x2 / stride-2 F.conv_transpose2d of an NCHW (view) tensor plus its
    bias: fused in f32 (and f64), and in bf16 added after the output's
    rounding, in bf16, as the JAX modules add it.'''
    if x.dtype == torch.bfloat16:
        return F.conv_transpose2d(x, w, stride=2) + b.reshape(1, -1, 1, 1)
    return F.conv_transpose2d(x, w, b, stride=2)


def _plain_conv(x, w, pads):
    '''F.conv2d of an NCHW (view) tensor with explicit pads, no bias.'''
    (pt, pb), (pl, pr) = pads
    if (pt, pl) == (pb, pr):
        return F.conv2d(x, w, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w)


class Conv2DFast(nn.Module):
    '''Conv2D with optional fused relu: at small channel counts the
    stencil_conv kernel (NCHW) or the stencil_conv_nhwc kernel (NHWC, where
    ``stencil_conv_nhwc.eligible``), plain F.conv2d otherwise.
    ``activation='relu'`` applies the relu after the bias; callers that
    pass it must not apply it again. In NHWC the input may be a tuple of
    parts (see the module docstring); a tuple that routes to the kernel is
    concatenated first, as the JAX package does.'''

    def __init__(self, in_channels, features, kernel_size, strides=(1, 1),
                 padding='SAME', activation=None, data_format='NCHW',
                 dtype=None, generator=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        if activation not in (None, 'relu'):
            raise ValueError(f'Conv2DFast fuses only relu, got {activation}')
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.relu = activation == 'relu'
        self.data_format = data_format
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        co, ci, kh, kw = self.weight.shape
        if self.strides != (1, 1):
            raise NotImplementedError(
                f'Conv2DFast stride {self.strides}: ' + _NOT_PORTED)
        pads = same_or_valid_pads(kh, kw, self.padding)
        if kh > 1 and self.padding.upper() != 'SAME':
            mesh.check_whole(f'a {self.padding} {kh}x{kw} conv')
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        dtype = self.dtype or parts[0].dtype
        parts = tuple(part.to(dtype) for part in parts)
        # under spatial_partition: on this rank's slab of the SAME pads
        return mesh.on_slab(lambda *slabs: self._conv(slabs, pads),
                            parts, *pads[0],
                            1 if self.data_format == 'NHWC' else 2)

    def _conv(self, parts, pads):
        co, ci, kh, kw = self.weight.shape
        nhwc = self.data_format == 'NHWC'
        w, b = self.weight.to(parts[0].dtype), self.bias.to(parts[0].dtype)
        kernel = not gates.forced_off()
        if kernel and not nhwc and stencil_mod.eligible(ci, co, kh, kw):
            return functions.stencil_conv(parts[0], w, b, pads, self.relu)
        if kernel and nhwc and stencil_nhwc_mod.eligible(ci, co, kh, kw,
                                                         self.padding):
            x = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
            return functions.stencil_conv_nhwc(x, w, b, pads, self.relu)
        out, off = None, 0
        for part in parts:
            c = part.shape[-1] if nhwc else part.shape[1]
            y = _plain_conv(_nchw(part) if nhwc else part,
                            w[:, off:off + c], pads)
            out = y if out is None else out + y
            off += c
        out = out + b.reshape(1, -1, 1, 1)
        if self.relu:
            out = F.relu(out)
        return _nhwc(out) if nhwc else out


class ConvTranspose2DFast(nn.Module):
    '''ConvTranspose for the kernel == stride == 2 upsampling case (SAME and
    VALID agree when kernel == stride), NCHW or NHWC.'''

    def __init__(self, in_channels, features, kernel_size, strides,
                 data_format='NCHW', dtype=None, generator=None):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        kh, kw = kernel_size
        if (kh, kw) != (2, 2) or tuple(strides) != (2, 2):
            raise NotImplementedError(
                f'ConvTranspose2DFast kernel {kernel_size} stride {strides}: '
                + _NOT_PORTED)
        self.data_format = data_format
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        _glorot_uniform_(self.weight, kh * kw * in_channels,
                         kh * kw * features, generator)

    def forward(self, x):
        ci, co = self.weight.shape[:2]
        dtype = self.dtype or x.dtype
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if self.data_format == 'NHWC':
            # the gate reads the module's dtype, as tconv_pallas_ok does
            if tconv_nhwc_mod.eligible(x.shape, (2, 2), (2, 2), co, 'NHWC',
                                       dtype):
                return functions.tconv2x2_nhwc(x.contiguous(), w, b)
            return _nhwc(plain_tconv(_nchw(x), w, b))
        # f32 only, as tconv_flat_ok (f64 stands for f32 in the checks)
        if tconv_mod.supported(ci, co) and dtype != torch.bfloat16 \
                and not gates.forced_off():
            return functions.tconv2x2(x, w, b)
        return plain_tconv(x, w, b)


def chain_ok(ci, filters, kernel_size, padding, dtype=None):
    '''Whether a relu ConvChain cell (two stride-1 convs, no BN) runs as one
    conv_chain kernel: SAME padding with an odd kernel (size-preserving,
    symmetric pads) and channels within the bounds of the chain kernel and
    its backward. In f32 this one test covers both JAX chain kernels (the
    scalar stencil chain and the "flatland" chain), which the port folds
    into one kernel. The flat chain is f32 only (flatchain.py:475), so in
    bf16 a chain also needs the stencil chain's unroll bound, K * K * Ci *
    Cm and K * K * Cm * Co at most CHAIN_TERMS (conv_kernel.py:319-330; its
    VMEM bound is a TPU limit and is not kept); the others run conv by
    conv, each rounded to bf16.'''
    k = int(kernel_size)
    if (resolve_dtype(dtype) == torch.bfloat16
            and k * k * filters * max(ci, filters) > CHAIN_TERMS):
        return False
    return (isinstance(padding, str) and padding.upper() == 'SAME'
            and conv_chain_bwd_mod.supported(ci, filters, filters, k))
