'''Crop-fused two-pass bilinear resample of an NHWC window, f32.

The CUDA kernel (csrc/warp_crop.cu) replaces
warp_kernel.dense_image_warp_crop_pallas of the JAX package: the window
``image`` [B, h_in, w_in, C] is cropped at per-image integer offsets
``crop_offset`` [B, 2] (oy, ox) to h_out x w_out and resampled by the
two-pass warp (ops/kernels/warp_twopass.py) in one pass, so the crop is
never written. The flows:

- ``fx`` [B, h_out, w_out] is the horizontal flow in the crop frame;
- ``fy_ext`` [B, h_out, w_in] is the vertical flow in the window's column
  frame: the vertical pass of crop column j reads ``fy_ext[b, y, ox + j]``
  (ops/warp.py:cropped_twopass_flows makes both).

Both are clamped to +-d = max_displacement first; the tap positions are
clipped to the crop and the hi tap at its last row or column is clamped
into it, as the composed crop-then-warp path does. Offsets are clamped into
[0, in - out], so no read leaves the window. ``plain`` is a gather
formulation of the same arithmetic (the TPU kernel's shift-selects each
pick exactly one shift).

The CUDA kernel takes the two routes of warp_twopass on the crop's shape
(``warp_twopass.route``; ``plan`` lays the halo tile out in the crop frame,
the window's size and the offsets changing only where rows are read from),
one launch a call either way.

``warp_crop`` launches the kernel for CUDA tensors and runs ``plain`` for
CPU tensors; it raises on any other input.
'''

import torch

from . import _build
from .warp_twopass import _blend, _taps, plan, plan_args, route  # noqa: F401

launches = 0  # kernel launches in this process


def _offsets(crop_offset, in_size, out_size):
    '''([B, 1, 1] oy, [B, 1, 1] ox) clamped into [0, in - out].'''
    off = crop_offset.long()
    oy = off[:, 0].clamp(0, in_size[0] - out_size[0])
    ox = off[:, 1].clamp(0, in_size[1] - out_size[1])
    return oy[:, None, None], ox[:, None, None]


def plain(image, fy_ext, fx, crop_offset, max_displacement=8):
    '''Plain PyTorch version: -> [B, h_out, w_out, C].'''
    b, h_in, w_in, c = image.shape
    _, h_out, w_out = fx.shape
    d = float(int(max_displacement))
    oy, ox = _offsets(crop_offset, (h_in, w_in), (h_out, w_out))
    gy = torch.arange(h_out, device=image.device, dtype=image.dtype)[:, None]
    gx = torch.arange(w_out, device=image.device, dtype=image.dtype)[None, :]
    x0, x1, rx = _taps((gx - fx.clamp(-d, d)).clamp(0.0, w_out - 1.0), w_out)
    flat = image.reshape(b, h_in * w_in, c)

    def column(xj):
        '''The vertical pass at crop columns xj [B, h_out, w_out].'''
        col = ox + xj
        fy = torch.gather(fy_ext, 2, col).clamp(-d, d)
        y0, y1, ry = _taps((gy - fy).clamp(0.0, h_out - 1.0), h_out)

        def tap(yj):
            idx = ((oy + yj) * w_in + col).reshape(b, -1, 1).expand(-1, -1, c)
            return torch.gather(flat, 1, idx).reshape(b, h_out, w_out, c)

        return _blend(tap(y0), tap(y1), ry[..., None])

    return _blend(column(x0), column(x1), rx[..., None])


def check(image, fy_ext, fx, crop_offset):
    '''(h_out, w_out) of valid arguments; raises otherwise.'''
    if image.dim() != 4 or image.numel() == 0:
        raise ValueError(f'image must be a non-empty [B, H, W, C] tensor, '
                         f'got {tuple(image.shape)}')
    b, h_in, w_in, _ = image.shape
    if fx.dim() != 3 or fx.shape[0] != b:
        raise ValueError(f'fx must be [B, h_out, w_out] with B = {b}, got '
                         f'{tuple(fx.shape)}')
    h_out, w_out = fx.shape[1:]
    if not (0 < h_out <= h_in and 0 < w_out <= w_in):
        raise ValueError(f'the crop {h_out} x {w_out} must fit the window '
                         f'{h_in} x {w_in}')
    if tuple(fy_ext.shape) != (b, h_out, w_in):
        raise ValueError(f'fy_ext must be [B, h_out, w_in] = '
                         f'{(b, h_out, w_in)}, got {tuple(fy_ext.shape)}')
    if tuple(crop_offset.shape) != (b, 2):
        raise ValueError(f'crop_offset must be [B, 2], got '
                         f'{tuple(crop_offset.shape)}')
    return h_out, w_out


def warp_crop(image, fy_ext, fx, crop_offset, max_displacement=8):
    global launches
    h_out, w_out = check(image, fy_ext, fx, crop_offset)
    if image.device.type == 'cpu':
        return plain(image, fy_ext, fx, crop_offset, max_displacement)
    device = _build.check_cuda_f32(image=image, fy_ext=fy_ext, fx=fx)
    if crop_offset.device != device or crop_offset.dtype != torch.int32 \
            or not crop_offset.is_contiguous():
        raise TypeError(f'crop_offset must be a contiguous int32 tensor on '
                        f'{device}, got {crop_offset.dtype} on '
                        f'{crop_offset.device}')
    b, h_in, w_in, c = image.shape
    d = int(max_displacement)
    out = torch.empty((b, h_out, w_out, c), dtype=image.dtype, device=device)
    _build.launch('dnnca_warp_crop', image.data_ptr(), fy_ext.data_ptr(),
                  fx.data_ptr(), crop_offset.data_ptr(), out.data_ptr(), b,
                  h_in, w_in, h_out, w_out, c, d,
                  *plan_args(b, h_out, w_out, c, d), device.index,
                  _build.stream_of(device))
    launches += 1
    return out
