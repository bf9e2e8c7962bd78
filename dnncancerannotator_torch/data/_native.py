'''Build the port's C++ host library with g++ and bind it with ctypes.

The sources are ``csrc/host/tfrecord_io.cc`` (CRC32C, slicing-by-8),
``csrc/host/exam_decoder.cc`` (the one-pass exam decode and channel gather)
and ``csrc/host/zstd_decode.cc`` (the Zstandard decoder that the reader of
the JAX package's Orbax checkpoints, ckpt/, runs on every OCDBT file and
zarr chunk). They compile into one shared library at first use:

    g++ -O3 -shared -fPIC -std=c++17 -Wall -o build/torch_host/<lib>.so \\
        csrc/host/tfrecord_io.cc csrc/host/exam_decoder.cc \\
        csrc/host/zstd_decode.cc

The library goes under ``build/torch_host/`` beside the package and is named
by a hash of the sources and flags, so a changed source builds anew. A build
or load that fails raises with g++'s message: nothing falls back to the
Python codec quietly (that codec stays as the plain version the tests hold
the library against, and as the path of the records ``exam_decode``
declines). ``ctypes.CDLL`` releases the GIL during each call, so decode
threads run in parallel. Nothing here runs at import.
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC_DIR = os.path.join(_PKG_DIR, 'csrc', 'host')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'torch_host')
SOURCES = ('tfrecord_io.cc', 'exam_decoder.cc', 'zstd_decode.cc')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-Wall')

_I64 = ctypes.c_int64
_P64 = ctypes.POINTER(ctypes.c_int64)
# argtypes and restype of each entry point
_SIGNATURES = {
    'crc32c': ([ctypes.c_void_p, ctypes.c_size_t], ctypes.c_uint32),
    'exam_decode': ([
        ctypes.c_char_p, _I64,          # record, length
        _P64, _I64,                     # channel indices, their count
        _I64, _I64,                     # crop h, w (-1: whole)
        ctypes.c_void_p, _I64,          # out, its capacity
        _P64,                           # shape[4]
        _P64,                           # ids[2]
        ctypes.c_char_p, _I64,          # path
        ctypes.c_char_p, _I64,          # category
        ctypes.c_char_p, _I64,          # comma-joined slice types
    ], _I64),
    'zstd_decompress': ([
        ctypes.c_void_p, _I64,          # frames, their length
        ctypes.c_void_p, _I64,          # out (NULL: count only), its size
        ctypes.c_char_p, _I64,          # error message, its capacity
    ], _I64),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process


def _cxx():
    path = shutil.which(os.environ.get('CXX', 'g++'))
    if path is None:
        raise RuntimeError('g++ not found on PATH; the host library '
                           f'({", ".join(SOURCES)}) cannot be built')
    return path


def library_path():
    '''Path of the shared library for the current sources and flags.'''
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        with open(os.path.join(HOST_SRC_DIR, name), 'rb') as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f'libdnnca_torch_host-{digest.hexdigest()[:16]}.so')


def build():
    '''Compile the library unless a build of these sources exists; returns
    its path. Several processes may build at once: each writes its own
    temporary file and renames it into place.'''
    global build_seconds
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_cxx(), *CXX_FLAGS, '-o', tmp,
             *(os.path.join(HOST_SRC_DIR, name) for name in SOURCES)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f'g++ failed building the host library '
                f'({proc.returncode}):\n{(proc.stdout + proc.stderr)[-4000:]}')
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - start
    return target


def library():
    '''The loaded host library (built on first use).'''
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib
