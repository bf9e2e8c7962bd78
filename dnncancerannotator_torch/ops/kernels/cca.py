'''Raw 4-connected component labels of a batch of masks: [N, H, W] bool ->
[N, H, W] int32, each mask pixel holding the minimum row-major flat index
``r * W + c`` of its component and every background pixel ``H * W``.

The CUDA kernel (csrc/cca.cu) replaces cca_kernel.cca_raw_labels_pallas of
the JAX package (on the unpadded plane); ``plain`` is the same fixed point
written with PyTorch ops over the mask pixels only (in row-major order, so
a pixel's position in that list orders like its flat index):

- every maximal run of mask pixels along a row, and along a column, gets an
  id; each pixel's label is the position of a pixel of its component,
  first its own;
- a sweep takes the minimum label over each row run, then over each column
  run (``scatter_reduce`` by run id), so a label crosses a whole straight
  run in one sweep; a pointer jump (label <- label of the pixel it names)
  follows, which is valid because every label names a pixel of the same
  component that comes no later;
- sweeps repeat until nothing changes; the labels are then constant on each
  component and name its first pixel.

``cca_raw_labels`` launches the kernel for CUDA tensors and runs ``plain``
for CPU tensors; it raises on any other input. The compaction to 1..n is
ops/cca.py.

The kernel has two routes, both hand-written and both held against
``plain``; ``route`` picks one by plane size and count. The shared route
runs one block a plane with the forest in shared memory (``shared_bytes``):
every plane of at most ``LABEL32_MAX`` pixels (32-bit labels, 68 KB at
128 x 128: the evaluate path's planes after metrics.yaml's and the
Visualizer's resize by 0.5), and planes of at most ``PLANE_MAX`` pixels
(16-bit labels, 144 KB at 256 x 256: the Visualizer at a ratio of 1) when a
call has at least ``MIN_PLANES`` of them. The global route, three launches
with the forest in device memory, takes the rest: larger planes, and a few
large ones, which it spreads over the whole card (on an H100 one 256 x 256
plane took 0.0092-0.1577 ms on the shared route and 0.0055-0.1041 ms on
the global one; 132 of them 0.0488 and 0.1380 ms: tools/
profile_torch_sites.py --sweep).
'''

import torch

from . import _build

launches = 0  # kernel launches in this process

# the shared route's largest plane: its labels are 16-bit indices; up to
# LABEL32_MAX pixels they are 32-bit, whose atomic min is native
PLANE_MAX = 1 << 16
LABEL32_MAX = 1 << 15
# the fewest planes of over LABEL32_MAX pixels the shared route takes: one
# block works a plane on one SM, and a few large planes finish sooner
# spread over the card by the global route
MIN_PLANES = 132   # the H100's SMs


def route(n, h, w):
    '''The kernel's route for [n, h, w] masks: 'shared' (one block a
    plane, the forest in shared memory) for planes of 32-bit labels, and
    for planes of 16-bit labels (an index fits 16 bits) at least
    MIN_PLANES at a time; else 'global' (three launches over device
    memory).'''
    hw = h * w
    if hw <= LABEL32_MAX or (hw <= PLANE_MAX and n >= MIN_PLANES):
        return 'shared'
    return 'global'


def label_bytes(h, w):
    '''Bytes of one label in the shared route's shared memory.'''
    return 4 if h * w <= LABEL32_MAX else 2


def shared_bytes(h, w):
    '''Shared memory of one block of the shared route (csrc/cca.cu:
    shared_bytes): two bitmasks (the mask, the run starts) in whole 16-byte
    rows and the labels rounded up to 16 bytes.'''
    hw = h * w
    return 2 * 16 * -(-hw // 128) + 16 * -(-label_bytes(h, w) * hw // 16)


def _run_ids(starts):
    '''Run id of each pixel of a list in which every run is contiguous,
    given where runs start.'''
    return torch.cumsum(starts, 0) - 1


def _run_min(labels, ids):
    '''Minimum of ``labels`` over each run, spread back over the run.'''
    mins = torch.full((int(ids.max()) + 1,), labels.numel(), dtype=labels.dtype,
                      device=labels.device)
    mins.scatter_reduce_(0, ids, labels, 'amin')
    return mins[ids]


def plain(masks):
    '''Plain PyTorch version: masks [N, H, W] (bool or uint8) -> raw labels
    [N, H, W] int32.'''
    masks = masks.bool()
    n, h, w = masks.shape
    hw = h * w
    flat = masks.reshape(-1)
    out = torch.full((n * hw,), hw, dtype=torch.int32, device=masks.device)
    pix = flat.nonzero().squeeze(1)          # row-major flat indices
    if not pix.numel():
        return out.reshape(n, h, w)
    local = pix % hw
    row_ids = _run_ids((local % w == 0) | ~flat[(pix - 1).clamp(min=0)])
    # the same pixels in column-major order, for the column runs
    cols = masks.transpose(1, 2).reshape(-1).nonzero().squeeze(1)
    plane, rest = cols // hw, cols % hw
    col_pix = plane * hw + (rest % h) * w + rest // h
    col_order = torch.searchsorted(pix, col_pix)
    col_starts = (rest % h == 0) | ~flat[(col_pix - w).clamp(min=0)]
    col_ids = torch.empty_like(col_order)
    col_ids[col_order] = _run_ids(col_starts)
    labels = torch.arange(pix.numel(), device=masks.device)
    while True:
        new = _run_min(_run_min(labels, row_ids), col_ids)
        new = new[new]
        if torch.equal(new, labels):
            out[pix] = local[labels].to(torch.int32)
            return out.reshape(n, h, w)
        labels = new


def check(masks):
    if masks.dim() != 3 or masks.numel() == 0:
        raise ValueError(f'masks must be a non-empty [N, H, W] tensor, '
                         f'got {tuple(masks.shape)}')
    if masks.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f'masks must be bool or uint8, got {masks.dtype}')
    if masks.shape[1] * masks.shape[2] >= 2 ** 31 - 1:
        raise ValueError(f'a {masks.shape[1]} x {masks.shape[2]} plane '
                         'overflows int32 indices')


def cca_raw_labels(masks):
    global launches
    check(masks)
    if masks.device.type == 'cpu':
        return plain(masks)
    if not masks.is_cuda:
        raise ValueError(f'masks must be a CUDA or CPU tensor, got '
                         f'{masks.device}')
    if not masks.is_contiguous():
        raise ValueError('masks must be contiguous')
    n, h, w = masks.shape
    out = torch.empty((n, h, w), device=masks.device, dtype=torch.int32)
    _build.launch('dnnca_cca', masks.data_ptr(), out.data_ptr(), n, h, w,
                  int(route(n, h, w) == 'shared'), label_bytes(h, w),
                  masks.device.index,
                  _build.stream_of(masks.device))
    launches += 1
    return out
