"""zstd decoding through the system's ``libzstd.so.1`` (ctypes).

The JAX package's orbax checkpoints compress their B-tree nodes and array
chunks with zstd (``train/ocdbt.py``, ``train/checkpoint.py:read_orbax``).
This module binds the four functions of the library's stable API that
reading them needs. It is host code, like ``native/``; there is no second
decoder: without the library, ``decompress`` raises ``OSError`` naming
where it looked.

Frames written by zarr's zstd compressor may not declare their content
size (``frame_content_size`` returns None), so ``decompress`` takes the
size from the caller, who knows it from the array's shape and dtype.
"""
import ctypes
import ctypes.util

import numpy as np

SONAME = 'libzstd.so.1'
# ZSTD_getFrameContentSize's two error values (zstd.h)
_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2
_TOO_SMALL = 'Destination buffer is too small'
_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        found = ctypes.util.find_library('zstd')
        tried = []
        for name in (found, SONAME):
            if not name:
                continue
            tried.append(name)
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_versionNumber.restype = ctypes.c_uint
            lib.ZSTD_versionNumber.argtypes = []
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_size_t]
            lib.path = name
            _LIB = lib
            break
        else:
            raise OSError(
                "zstd decoding needs the system's libzstd.so.1, which was "
                f"not found: ctypes.util.find_library('zstd') gave {found!r}"
                f' and loading {tried} failed')
    return _LIB


def library():
    """(the library's name as loaded, its version 'x.y.z')."""
    lib = _load()
    v = lib.ZSTD_versionNumber()
    return lib.path, f'{v // 10000}.{v // 100 % 100}.{v % 100}'


def _source(buf):
    src = np.frombuffer(buf, np.uint8)
    return src, src.ctypes.data, src.nbytes


def frame_content_size(buf):
    """The decoded size the frame at the start of ``buf`` declares, or
    None when it declares none."""
    _, ptr, n = _source(buf)
    size = _load().ZSTD_getFrameContentSize(ptr, n)
    if size == _CONTENTSIZE_UNKNOWN:
        return None
    if size == _CONTENTSIZE_ERROR:
        raise ValueError('not a zstd frame')
    return size


def _decode(buf, capacity):
    """(uint8 array of ``capacity`` bytes, bytes decoded or None when they
    do not fit)."""
    lib = _load()
    src, ptr, n = _source(buf)
    out = np.empty(capacity, np.uint8)
    got = lib.ZSTD_decompress(out.ctypes.data, capacity, ptr, n)
    if lib.ZSTD_isError(got):
        name = lib.ZSTD_getErrorName(got).decode()
        if name == _TOO_SMALL:
            return out, None
        raise ValueError(f'zstd: {name} ({n} bytes into {capacity})')
    return out, got


def decompress(buf, out_size):
    """Decode the zstd frame(s) in ``buf`` (any buffer: bytes, memoryview,
    a numpy array or memmap) into a new uint8 array of exactly
    ``out_size`` bytes. Raises ValueError when the data is not zstd, does
    not fit, or decodes to another size."""
    out, got = _decode(buf, out_size)
    if got != out_size:
        raise ValueError(f'zstd: {len(memoryview(buf))} bytes decode to '
                         f'{"more than " if got is None else ""}'
                         f'{out_size if got is None else got}, expected '
                         f'{out_size}')
    return out


def decompress_upto(buf, max_size):
    """Decode ``buf`` whose decoded size is not known, only bounded by
    ``max_size``: the declared size when the frame has one, else a
    buffer doubled from 8x the input until it fits. Returns the uint8
    array of the decoded bytes."""
    size = frame_content_size(buf)
    if size is not None:
        if size > max_size:
            raise ValueError(f'zstd: a frame of {size} bytes exceeds the '
                             f'limit of {max_size}')
        return decompress(buf, size)
    capacity = min(max_size, max(1 << 16, 8 * len(memoryview(buf))))
    while True:
        out, got = _decode(buf, capacity)
        if got is not None:
            return out[:got]
        if capacity >= max_size:
            raise ValueError(f'zstd: the data decodes to more than the '
                             f'limit of {max_size} bytes')
        capacity = min(max_size, 2 * capacity)
