'''Backward of ConvTranspose(kernel=2, stride=2) plus bias
(ops/kernels/tconv2x2.py), NCHW f32.

The CUDA kernel (csrc/tconv2x2_bwd.cu) replaces flattconv's backward kernel
(``_bwd_call``) of the JAX package and also serves the upsamples that
package leaves to XLA. From the forward's input x, the cotangent g of its
output and the weight in PyTorch's unflipped [Ci, Co, 2, 2] layout it
returns (dx or None, dw, db); dw is the gradient with respect to that
layout.

One launch a call: each block stages one tile of x and the matching tile
of g and computes dx there and its partial dw and db; the blocks of each
cluster (``cluster_size``) add their partials through distributed shared
memory, and the last cluster to finish adds the clusters' partials in
order (a ticket counter, one a device, that the kernel leaves at 0).
``plan`` sizes the launch in pure Python: the tile, the input-channel
group CPT (a divisor of Ci: no padding), the blocks (whole clusters) and
the shared memory; the kernel trusts it.

``tconv2x2_bwd`` launches the kernel for CUDA tensors and runs ``plain``
(``F.conv2d`` of g with stride 2 for dx, an einsum over the four phases for
dw) for CPU tensors; it raises on any other input.
'''

import collections
import functools

import torch
import torch.nn.functional as F

from . import _build
from . import tconv2x2 as fwd

launches = 0  # kernel launches in this process

THREADS = 512                   # csrc/tconv2x2_bwd.cu: kThreads
DW_THREADS = 256                # threads on the weight gradient (kDwThreads)
CPT_CHOICES = (8, 6, 4, 3, 2, 1)  # its instances, widest first
# the finish: cluster partials a unit adds (kChunk), units a batch
# (kFinUnits)
CHUNK, FIN_UNITS = 16, 1024
MAX_CLUSTERS = CHUNK * FIN_UNITS
SMS = 132                       # streaming multiprocessors of an H100 SXM
TILE_HEIGHTS = (1, 2, 4, 8, 16, 32)
# the widest tile row: whole rows up to this width (contiguous copies)
MAX_TILE_W = 128
# dynamic shared memory a block may take, less room for the static flag
SMEM_CAP = _build.MAX_SMEM_BYTES - 1024
# (B, Ci, Co, H, W, need_dx) -> tile_h where a sweep on the card
# (tools/profile_torch_sites.py --sweep) measured the rule slower:
# unet.yaml's up_0 at B=8, 64 blocks of 4 rows, 0.0114 ms on the device
# against the rule's 2 rows, 0.0133 (NVIDIA H100 80GB HBM3, 700 W)
TUNED = {(8, 12, 12, 32, 32, True): 4}

Plan = collections.namedtuple('Plan',
                              'tile_h tile_w cpt blocks cluster smem')


def cdiv(a, b):
    return -(-a // b)


def pad4(n):
    return cdiv(n, 4) * 4


def cpt(ci):
    '''The kernel's input-channel group: the widest instance dividing Ci.'''
    return next(c for c in CPT_CHOICES if ci % c == 0)


def smem_bytes(ci, co, tile_h, tile_w, clusters, need_dx):
    '''The weight (for dx), the x and g tiles, the f64 shares of the
    weight-gradient items (one a DW_THREADS thread) and the block's partial
    (dw in f32, db in f64); in the block that adds the clusters' partials,
    their chunk sums (32 bytes a unit, a batch at most FIN_UNITS) over the
    tiles.'''
    p = tile_h * tile_w
    n_w = 4 * ci * co
    tiles = 4 * ((n_w if need_dx else 0) + pad4(ci * p) + 4 * co * p)
    work = (tiles + 8 * DW_THREADS * (4 * cpt(ci) + 1)
            + 4 * pad4(n_w) + 8 * co)
    units = (ci * co + co) * cdiv(clusters, CHUNK)
    return max(work, 32 * min(units, FIN_UNITS))


def cluster_size(tiles):
    '''Blocks a cluster: 4, or 2 past half an SM's worth of tiles each
    (one block an SM: at 128 blocks clusters of 4 took a second wave on the
    H100, clusters of 2 did not).'''
    return 4 if tiles <= SMS // 2 else 2


def geometry(b, ci, co, h, w, need_dx, tile_h, tile_w):
    '''The plan of one tile size: a block a tile, padded to whole
    clusters.'''
    tiles = b * cdiv(h, tile_h) * cdiv(w, tile_w)
    cluster = cluster_size(tiles)
    blocks = cdiv(tiles, cluster) * cluster
    return Plan(tile_h, tile_w, cpt(ci), blocks, cluster,
                smem_bytes(ci, co, tile_h, tile_w, blocks // cluster,
                           need_dx))


def _tile_w(ci, co, w, need_dx):
    '''Whole rows up to MAX_TILE_W, else the widest power of two that
    fits one row of the tile in shared memory.'''
    tile_w = w if w <= MAX_TILE_W else MAX_TILE_W
    while tile_w > 1 and geometry(1, ci, co, 1, tile_w, need_dx, 1,
                                  tile_w).smem > SMEM_CAP:
        tile_w = max(1, tile_w // 2)
    return tile_w


def _fits(pl):
    return pl.smem <= SMEM_CAP and pl.blocks // pl.cluster <= MAX_CLUSTERS


@functools.lru_cache(maxsize=None)
def rule(b, ci, co, h, w, need_dx):
    '''The shortest tile that leaves at most one block an SM (every SM
    fed, the fewest partials for the last cluster to add) among those that
    fit; where every tile leaves more, the tallest that fits.'''
    tile_w = _tile_w(ci, co, w, need_dx)
    fits = [pl for pl in (geometry(b, ci, co, h, w, need_dx, th, tile_w)
                          for th in TILE_HEIGHTS if th <= max(1, h))
            if _fits(pl)]
    if not fits:
        raise ValueError(f'tconv2x2_bwd: no launch fits B={b}, Ci={ci}, '
                         f'Co={co}, {h} x {w}')
    few = [pl for pl in fits if pl.blocks <= SMS]
    return few[0] if few else fits[-1]


def plan(b, ci, co, h, w, need_dx):
    tile_h = TUNED.get((b, ci, co, h, w, need_dx))
    if tile_h is None:
        return rule(b, ci, co, h, w, need_dx)
    return geometry(b, ci, co, h, w, need_dx, tile_h,
                    _tile_w(ci, co, w, need_dx))


def scratch_floats(pl, ci, co):
    '''f32 words of the wrapper's scratch for plan ``pl``: the clusters'
    dw partials [clusters][4 Ci Co] in f32 (rows of whole float4s), then
    their db partials [clusters][Co] in f64.'''
    clusters = pl.blocks // pl.cluster
    return clusters * 4 * ci * co + 2 * clusters * co


_tickets = {}  # device index -> the kernel's ticket counter (one int32)


def ticket(device):
    '''The ticket counter of ``device``: zeroed once, left at 0 by every
    launch. Calls on one device run in stream order, so they never hold
    it at once.'''
    if device.index not in _tickets:
        _tickets[device.index] = torch.zeros(1, dtype=torch.int32,
                                             device=device)
    return _tickets[device.index]


def plain(x, g, w, need_dx=True):
    '''Plain PyTorch version: returns (dx or None, dw, db).'''
    b, ci, h, wd = x.shape
    co = w.shape[1]
    dx = F.conv2d(g, w, stride=2) if need_dx else None
    dw = torch.einsum('bihw,bohpwq->iopq', x, g.reshape(b, co, h, 2, wd, 2))
    return dx, dw, g.sum((0, 2, 3))


def tconv2x2_bwd(x, g, w, need_dx=True):
    '''Returns (dx or None, dw, db).'''
    global launches
    fwd.check(x, w, torch.empty(w.shape[1], device='meta'))
    b, ci, h, wd = x.shape
    co = w.shape[1]
    if tuple(g.shape) != (b, co, 2 * h, 2 * wd):
        raise ValueError(f'g must be [B, Co, 2H, 2W] = '
                         f'{(b, co, 2 * h, 2 * wd)}, got {tuple(g.shape)}')
    if x.device.type == 'cpu':
        return plain(x, g, w, need_dx)
    device = _build.check_cuda_f32(x=x, g=g, w=w)
    if w.data_ptr() % 16:
        raise ValueError('tconv2x2_bwd reads w as float4: it must be 16-byte '
                         'aligned')
    n_w = ci * co * 4
    pl = plan(b, ci, co, h, wd, need_dx)
    dx = torch.empty_like(x) if need_dx else None
    dwb = torch.empty(n_w + co, device=device, dtype=torch.float32)
    scratch = torch.empty(scratch_floats(pl, ci, co), device=device,
                          dtype=torch.float32)
    _build.launch('dnnca_tconv2x2_bwd', x.data_ptr(), g.data_ptr(),
                  w.data_ptr(), dx.data_ptr() if dx is not None else None,
                  dwb.data_ptr(), scratch.data_ptr(),
                  scratch.data_ptr() + 4 * pl.blocks // pl.cluster * n_w,
                  ticket(device).data_ptr(), b, ci, co, h, wd, pl.tile_h,
                  pl.tile_w, pl.cpt, pl.blocks, pl.cluster, pl.smem,
                  device.index, _build.stream_of(device))
    launches += 1
    return dx, dwb[:n_w].view(ci, co, 2, 2), dwb[n_w:]
