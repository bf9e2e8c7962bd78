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

The CUDA kernel has two routes (``route``), one launch a call either way:

- ``tile`` (csrc/warp_tile.cuh, shared with warp_crop): a block walks down
  a strip of output columns a step of rows at a time, one pixel a thread,
  with the step's halo of the image (every row and column within +-d of its
  outputs: the flow is clamped to +-d) in a ring in shared memory, the next
  step's rows in flight by bulk copies (the Tensor Memory Accelerator), and
  the output written back by bulk stores. ``plan`` lays it out from the
  shape alone (B, H, W, C, d).
- ``direct``: one thread an output pixel, its taps read from device memory,
  for shapes whose halo tile does not fit shared memory or would stage more
  than MAX_REREAD times the image.

``warp_twopass`` launches the kernel for CUDA tensors and runs ``plain`` for
CPU tensors; it raises on any other input.
'''

import collections
import functools

import torch

from . import _build
from .tconv2x2_bwd import SMS, cdiv, pad4

launches = 0  # kernel launches in this process

# the tile kernel (csrc/warp_tile.cuh)
THREADS = 512          # kThreads: a block, one pixel a thread a step
MAX_STRIP = 128        # widest strip of output columns (tw)
MAX_CHANNELS = 8       # the C instances of launch_tile
BARRIER_BYTES = 16     # the two steps' mbarriers
SM_SMEM = 233472       # shared memory of an SM; 1 KB of it reserved a block
SM_THREADS = 2048      # resident threads of an SM
SMEM_CAP = _build.MAX_SMEM_BYTES
# The direct kernel reads 4 taps an output value, which its L1 partly
# serves; a tile that stages more than this many times the image moves
# more from L2 than that.
MAX_REREAD = 4.0
# (B, H, W, C, d) -> (tw, seg), where tools/profile_torch_sites.py
# --sweep-warp measured the rule's plan more than 3% slower
TUNED = {}

Plan = collections.namedtuple(
    'Plan', 'tw seg th rb rs fs os smem grid reread')


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


def layout(b, h, w, c, d, tw, seg):
    '''The tile kernel's plan for strips of ``tw`` columns and ``seg`` rows
    of an H x W frame (th = THREADS / tw rows a step), as the kernel lays
    out its shared memory: the mbarriers, then
    in floats the ring of rb = min(H, 2 th + 2d + 1) rows, each of S =
    min(W, tw + 2d + 1) halo pixels and a lead of up to 3 floats (rs); the
    flow rows of two steps, two segments of S floats and a lead each
    (fs); th output rows of tw pixels and a lead (os). ``reread`` is the
    image floats staged over the grid (each block's halo columns by its
    rows, [ya - d, yb + d] clipped) over H * W * C.'''
    th = THREADS // tw
    s = min(w, tw + 2 * d + 1)
    rb = min(h, 2 * th + 2 * d + 1)
    rs, fs, os_ = pad4(s * c + 3), 2 * pad4(s + 3), pad4(tw * c + 3)
    smem = BARRIER_BYTES + 4 * (rb * rs + 2 * th * fs + th * os_)
    cols = sum(min(w - 1, min(w, x0 + tw) + d) - max(0, x0 - d) + 1
               for x0 in range(0, w, tw))
    rows = sum(min(h - 1, min(h, y0 + seg) + d) - max(0, y0 - d) + 1
               for y0 in range(0, h, seg))
    return Plan(tw, seg, th, rb, rs, fs, os_, smem,
                (cdiv(w, tw), cdiv(h, seg), b), cols * rows / (h * w))


def resident(pl):
    '''Blocks of the plan an SM holds at once.'''
    return min(SM_SMEM // (pl.smem + 1024), SM_THREADS // THREADS)


def rule(b, h, w, c, d):
    '''(tw, seg): strips MAX_STRIP columns wide (W rounded up to a power
    of two if narrower, so that tw divides THREADS), and the shortest
    segment, a multiple of th rows, whose grid fits one wave of resident
    blocks, so that each SM walks one region of the batch as tall as that
    allows; the whole height if no segment fits.'''
    tw = min(MAX_STRIP, 1 << max(w - 1, 1).bit_length())
    th = THREADS // tw
    full = cdiv(h, th) * th
    for seg in range(th, full, th):
        pl = layout(b, h, w, c, d, tw, seg)
        if b * pl.grid[0] * pl.grid[1] <= SMS * resident(pl):
            return tw, seg
    return tw, full


@functools.lru_cache(maxsize=None)
def plan(b, h, w, c, d):
    '''The tile kernel's plan for [B, H, W, C] at +-d: ``rule``'s strips
    unless TUNED names others. A function of the shape alone.'''
    return layout(b, h, w, c, d, *(TUNED.get((b, h, w, c, d))
                                   or rule(b, h, w, c, d)))


def route(b, h, w, c, d):
    '''``tile`` where the plan's shared memory fits a block and it stages at
    most MAX_REREAD times the image, else ``direct`` (and past
    MAX_CHANNELS, or for d < 0, where the halo is not [-d, d]).'''
    pl = plan(b, h, w, c, d)
    ok = (d >= 0 and c <= MAX_CHANNELS and pl.smem <= SMEM_CAP
          and pl.reread <= MAX_REREAD)
    return 'tile' if ok else 'direct'


def plan_args(b, h, w, c, d):
    '''(tile, tw, seg, th, rb, rs, fs, os, smem) for the entry points.'''
    pl = plan(b, h, w, c, d)
    return (int(route(b, h, w, c, d) == 'tile'), pl.tw, pl.seg, pl.th, pl.rb,
            pl.rs, pl.fs, pl.os, pl.smem)


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
    d = int(max_displacement)
    out = torch.empty_like(image)
    _build.launch('dnnca_warp_twopass', image.data_ptr(), flow.data_ptr(),
                  out.data_ptr(), b, h, w, c, d, *plan_args(b, h, w, c, d),
                  device.index, _build.stream_of(device))
    launches += 1
    return out
