'''Host-memory tuning for the input pipeline's large buffers (counterpart
of dnncancerannotator_tpu.utils.hostmem).

A streaming input path that allocates a fresh multi-MB buffer for every
decoded exam can be bound by page-fault service rather than by the copies.
Two remedies, both acting on this process's own memory only:

- ``madvise(MADV_HUGEPAGE)`` on buffers of 4 MiB or more before first
  touch (``hugepage_empty``): 2 MiB transparent-hugepage faults replace 512
  base-page faults;
- ``mallopt(M_MMAP_THRESHOLD / M_TRIM_THRESHOLD, big)`` (``tune_malloc``):
  glibc keeps large freed buffers in its arena instead of handing them back
  to the kernel and faulting them in again on the next allocation.

Both are best-effort: on a non-glibc libc or a refused madvise the helpers
do nothing. ``DNNCA_NO_MALLOC_TUNE=1`` turns ``tune_malloc`` off.
'''

import ctypes
import os

import numpy as np

_MADV_HUGEPAGE = 14
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_PAGE = 4096

_libc = None
_malloc_tuned = False


def _lib():
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL(None, use_errno=True)
        except Exception:
            _libc = False
    return _libc or None


def tune_malloc(threshold=256 << 20):
    '''Raise glibc's mmap/trim thresholds so large pipeline buffers are
    recycled in-arena instead of munmapped and re-faulted. Idempotent.'''
    global _malloc_tuned
    if _malloc_tuned or os.environ.get('DNNCA_NO_MALLOC_TUNE') == '1':
        return
    _malloc_tuned = True
    lib = _lib()
    if lib is None or not hasattr(lib, 'mallopt'):
        return
    try:
        lib.mallopt(_M_MMAP_THRESHOLD, int(threshold))
        lib.mallopt(_M_TRIM_THRESHOLD, int(threshold))
    except Exception:
        pass


def madvise_hugepage(arr):
    '''Mark a numpy array's pages for transparent hugepages (best-effort;
    call BEFORE first touch — faults then map 2 MiB pages directly).'''
    lib = _lib()
    if lib is None or not hasattr(lib, 'madvise'):
        return False
    addr = arr.ctypes.data
    start = (addr + _PAGE - 1) // _PAGE * _PAGE
    end = (addr + arr.nbytes) // _PAGE * _PAGE
    if end <= start:
        return False
    try:
        return lib.madvise(ctypes.c_void_p(start),
                           ctypes.c_size_t(end - start),
                           _MADV_HUGEPAGE) == 0
    except Exception:
        return False


def hugepage_empty(shape, dtype=np.uint8):
    '''np.empty whose pages fault as hugepages when the buffer is large
    enough to matter (>= 4 MiB).'''
    arr = np.empty(shape, dtype)
    if arr.nbytes >= 4 << 20:
        madvise_hugepage(arr)
    return arr
