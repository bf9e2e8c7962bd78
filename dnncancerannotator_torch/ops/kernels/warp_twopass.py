'''Two-pass bilinear resample of an NHWC batch at a dense flow, NHWC f32.

The CUDA kernel (csrc/warp_twopass.cu) replaces
warp_kernel.dense_image_warp_twopass_pallas of the JAX package; ``plain`` is
a port of that package's ops.warp.dense_image_warp_twopass, written with
gathers instead of shift-selects (the same function: each select there picks
exactly one shift):

- the flow is clamped to +-d = max_displacement first;
- the vertical pass samples rows floor(qy) and floor(qy) + 1, qy =
  clip(y - fy, 0, H - 1), with edge replication, blended as
  lo * (1 - r) + hi * r;
- the horizontal pass does the same along x on the vertically resampled
  image, so that image is taken at the source columns, with fy read there.

``warp_twopass`` launches the kernel for CUDA tensors and runs ``plain`` for
CPU tensors; it raises on any other input.
'''

import torch

from . import _build

launches = 0  # kernel launches in this process


def _taps(q, n):
    '''(lo, hi, r) of positions q already clipped to [0, n - 1].'''
    q0 = torch.floor(q)
    lo = q0.long()
    return lo, (lo + 1).clamp(max=n - 1), q - q0


def _blend(lo, hi, r):
    return lo * (1.0 - r) + hi * r


def plain(image, flow, max_displacement=8):
    '''Plain PyTorch version: image [B, H, W, C], flow [B, H, W, 2] (dy, dx)
    -> [B, H, W, C].'''
    b, h, w, c = image.shape
    d = float(int(max_displacement))
    flow = flow.clamp(-d, d)
    gy = torch.arange(h, device=image.device, dtype=image.dtype)[:, None]
    gx = torch.arange(w, device=image.device, dtype=image.dtype)[None, :]
    y0, y1, ry = _taps((gy - flow[..., 0]).clamp(0.0, h - 1.0), h)
    mid = _blend(
        torch.gather(image, 1, y0[..., None].expand(b, h, w, c)),
        torch.gather(image, 1, y1[..., None].expand(b, h, w, c)),
        ry[..., None])
    x0, x1, rx = _taps((gx - flow[..., 1]).clamp(0.0, w - 1.0), w)
    return _blend(
        torch.gather(mid, 2, x0[..., None].expand(b, h, w, c)),
        torch.gather(mid, 2, x1[..., None].expand(b, h, w, c)),
        rx[..., None])


def check(image, flow):
    if image.dim() != 4 or image.numel() == 0:
        raise ValueError(f'image must be a non-empty [B, H, W, C] tensor, '
                         f'got {tuple(image.shape)}')
    if tuple(flow.shape) != (*image.shape[:3], 2):
        raise ValueError(f'flow must be [B, H, W, 2] = '
                         f'{(*image.shape[:3], 2)}, got {tuple(flow.shape)}')


def warp_twopass(image, flow, max_displacement=8):
    global launches
    check(image, flow)
    if image.device.type == 'cpu':
        return plain(image, flow, max_displacement)
    device = _build.check_cuda_f32(image=image, flow=flow)
    b, h, w, c = image.shape
    out = torch.empty_like(image)
    _build.launch('dnnca_warp_twopass', image.data_ptr(), flow.data_ptr(),
                  out.data_ptr(), b, h, w, c, int(max_displacement),
                  device.index, _build.stream_of(device))
    launches += 1
    return out
