'''Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file compiles to an object, all of them at once in
parallel ``nvcc`` processes, and the objects link into one shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <obj>/<name>.o csrc/<name>.cu   # each file
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/torch_kernels/<lib>.so <obj>/*.o

The library goes under ``build/torch_kernels/`` beside the package and is
named by a hash of the sources and flags, so it is built at first use and
again whenever a source changes. ``nvcc``'s register and shared-memory
report (``-Xptxas -v``) is kept in ``nvcc.log`` next to it. Nothing here
runs at import: the CPU tests import every module and have no nvcc.
'''

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_kernels')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas', '-v')
# dynamic shared memory one block may use on sm_90 (csrc/common.cuh)
MAX_SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every entry point: without them ctypes passes each pointer as
# a 32-bit int and cuts it
_SIGNATURES = {
    # x, w1, b1, w2, b2, c1, c2, B, Ci, Cm, Co, H, W, K, cpt, tile_h,
    # tile_w, c1_w, c1_s, xs_w, threads, smem, device, stream
    'dnnca_conv_chain': [_P] * 7 + [_I] * 16 + [_P],
    # x, w, bias, out, B, Ci, Co, H, W, device, stream
    'dnnca_tconv2x2': [_P] * 4 + [_I] * 6 + [_P],
    # x, w, bias, out, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW, relu,
    # device, stream
    'dnnca_stencil_conv': [_P] * 4 + [_I] * 13 + [_P],
    # x, c1, c2, g, w1, w2, dx, out, scratch, B, Ci, Cm, Co, H, W, K, cpt,
    # tile_h, tile_w, c1_w, c1_s, gs_w, slices, threads, blocks, fused, smem,
    # wgrad_blocks, device, stream
    'dnnca_conv_chain_bwd': [_P] * 9 + [_I] * 20 + [_P],
    # x, g, w, dx, dwb, partial, B, Ci, Co, H, W, wgrad_blocks, device,
    # stream
    'dnnca_tconv2x2_bwd': [_P] * 6 + [_I] * 7 + [_P],
    # x, g, w, dx, dwb, partial, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW,
    # wgrad_blocks, device, stream
    'dnnca_stencil_conv_bwd': [_P] * 6 + [_I] * 13 + [_P],
    # img, flow, out, B, H, W, C, max_displacement, device, stream
    'dnnca_warp_twopass': [_P] * 3 + [_I] * 6 + [_P],
    # img, fy_ext, fx, off, out, B, Hin, Win, Hout, Wout, C,
    # max_displacement, device, stream
    'dnnca_warp_crop': [_P] * 5 + [_I] * 8 + [_P],
    # masks, labels, N, H, W, device, stream
    'dnnca_cca': [_P] * 2 + [_I] * 4 + [_P],
    # x, out, B, H, W, C, device, stream
    'dnnca_pool2x2_nhwc': [_P] * 2 + [_I] * 5 + [_P],
    # x, g, dx, B, H, W, C, device, stream
    'dnnca_pool2x2_nhwc_bwd': [_P] * 3 + [_I] * 5 + [_P],
    # x, wpt, bias, out, B, H, W, Ci, Co, device, stream
    'dnnca_tconv2x2_nhwc': [_P] * 4 + [_I] * 6 + [_P],
    # x, g, wpt, dx, dw, db, w_partial, db_partial, dx_partial, B, H, W, Ci,
    # Co, dgrad_splits, wgrad_chunk, wgrad_splits, device, stream
    'dnnca_tconv2x2_nhwc_bwd': [_P] * 9 + [_I] * 9 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')) +
                  glob.glob(os.path.join(CSRC_DIR, '*.cuh')))


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin); '
                           'the CUDA kernels cannot be built')
    return path


def library_path():
    '''Path of the shared library for the current sources and flags.'''
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(os.path.basename(src).encode())
        with open(src, 'rb') as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f'libdnnca_torch_kernels-{digest.hexdigest()[:16]}.so')


def build():
    '''Compile the library unless a build of these sources exists; returns
    its path.'''
    global build_seconds
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        cu = [s for s in _sources() if s.endswith('.cu')]
        objs = [os.path.join(obj_dir, os.path.basename(s)[:-3] + '.o')
                for s in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', '-o', obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = os.path.join(obj_dir, 'lib.so')
        link = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', tmp, *objs],
                              capture_output=True, text=True, check=False)
        with open(os.path.join(BUILD_DIR, 'nvcc.log'), 'w') as fh:
            fh.write(''.join(logs) + link.stdout + link.stderr)
        for src, proc, log in zip(cu, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {os.path.basename(src)} '
                                   f'({proc.returncode}):\n{log[-4000:]}')
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({link.returncode}):\n'
                               f'{link.stderr[-4000:]}')
        os.replace(tmp, target)
    build_seconds = time.perf_counter() - start
    return target


def library():
    '''The loaded kernel library (built on first use).'''
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dnnca_error_string.argtypes = [ctypes.c_int]
            lib.dnnca_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name, *args):
    '''Call entry point ``name`` and raise if the launch was refused.'''
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.dnnca_error_string(code).decode()
        raise RuntimeError(f'{name} failed: CUDA error {code} ({msg})')


def check_cuda_f32(**tensors):
    '''Raise unless every tensor is a contiguous float32 tensor on one
    CUDA device; returns that device.'''
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(
                f'{name} must be a CUDA tensor on {device}, got {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return device


def stream_of(device):
    '''Raw handle of PyTorch's current stream on ``device``.'''
    return torch.cuda.current_stream(device).cuda_stream
