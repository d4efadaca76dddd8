"""Multi-page grayscale TIFF IO in plain numpy.

Counterpart of ``axtrack_tpu/data/tiffio.py``, which goes through PIL. This
module reads and writes the subset the pipeline needs without any imaging
library: classic (non-Big) TIFF, uncompressed, strip-organised pages of
8/16/32-bit unsigned, signed or float samples, either byte order. That is
what ``write_tiff`` of both packages produces. A compressed or tiled file
raises a ValueError that says so.

Integer data is normalised to float32 in [0, 1] exactly as
``skimage.util.img_as_float32`` does (``img_as_float32`` below).
"""
import struct

import numpy as np

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8}
_TYPE_CODES = {1: 'B', 2: 'c', 3: 'H', 4: 'I', 6: 'b', 7: 'B', 8: 'h',
               9: 'i', 11: 'f', 12: 'd', 16: 'Q'}


def img_as_float32(arr):
    """skimage.util.img_as_float32 semantics for the dtypes we encounter."""
    if arr.dtype == np.uint8:
        return (arr / np.float32(255.0)).astype(np.float32)
    if arr.dtype == np.uint16:
        return (arr / np.float32(65535.0)).astype(np.float32)
    if arr.dtype in (np.int16, np.int32):
        info = np.iinfo(arr.dtype)
        return (arr / np.float32(info.max)).astype(np.float32)
    return arr.astype(np.float32)


def _read_ifd(buf, offset, bo):
    n = struct.unpack_from(bo + 'H', buf, offset)[0]
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(
            bo + 'HHI4s', buf, offset + 2 + 12 * i)
        size = _TYPE_SIZES.get(typ)
        if size is None or typ not in _TYPE_CODES:
            continue                      # a tag type the reader never needs
        nbytes = size * count
        if nbytes <= 4:
            data = raw[:nbytes]
        else:
            ptr = struct.unpack(bo + 'I', raw)[0]
            data = bytes(buf[ptr:ptr + nbytes])
        tags[tag] = struct.unpack(bo + _TYPE_CODES[typ] * count, data)
    nxt = struct.unpack_from(bo + 'I', buf, offset + 2 + 12 * n)[0]
    return tags, nxt


def _page(buf, tags, bo):
    width, height = tags[256][0], tags[257][0]
    compression = tags.get(259, (1,))[0]
    if compression != 1:
        raise ValueError(f'compressed TIFF (Compression={compression}) is not '
                         'supported; write the movie uncompressed')
    if 273 not in tags:
        raise ValueError('tiled TIFF is not supported; write it in strips')
    if tags.get(284, (1,))[0] != 1:
        raise ValueError('planar-separate TIFF is not supported')
    bits = tags.get(258, (1,))[0]
    spp = tags.get(277, (1,))[0]
    fmt = tags.get(339, (1,))[0]
    kind = {1: 'u', 2: 'i', 3: 'f'}.get(fmt)
    if kind is None or bits not in (8, 16, 32) or (kind == 'f' and bits != 32):
        raise ValueError(f'unsupported TIFF sample type (bits={bits}, '
                         f'format={fmt})')
    dtype = np.dtype(f'{kind}{bits // 8}').newbyteorder(
        '<' if bo == '<' else '>')
    offsets, counts = tags[273], tags[279]
    if len(offsets) == 1:
        raw = buf[offsets[0]:offsets[0] + counts[0]]
    else:
        raw = np.concatenate([buf[o:o + c] for o, c in zip(offsets, counts)])
    n = width * height * spp
    page = np.frombuffer(raw, dtype=dtype, count=n).reshape(height, width, spp)
    return page[..., 0].astype(dtype.newbyteorder('='), copy=False)


def read_tiff_raw(path):
    """Read a multi-page grayscale TIFF in its NATIVE dtype [T, H, W].

    Multi-sample (RGB) pages keep their first channel, as the PIL reader
    of ``axtrack_tpu`` does."""
    buf = np.memmap(path, dtype=np.uint8, mode='r')
    head = bytes(buf[:4])
    if head[:2] == b'II':
        bo = '<'
    elif head[:2] == b'MM':
        bo = '>'
    else:
        raise ValueError(f'{path} is not a TIFF file')
    magic = struct.unpack(bo + 'H', head[2:4])[0]
    if magic != 42:
        raise ValueError(f'{path}: only classic TIFF is supported '
                         f'(magic {magic})')
    offset = struct.unpack_from(bo + 'I', buf, 4)[0]
    frames = []
    while offset:
        tags, offset = _read_ifd(buf, offset, bo)
        frames.append(_page(buf, tags, bo))
    return np.stack(frames, 0)


def read_tiff(path):
    """Read a multi-page grayscale TIFF into float32 [T, H, W] in [0, 1]."""
    return img_as_float32(read_tiff_raw(path))


def write_tiff(path, stack):
    """Write [T, H, W] as an uncompressed multi-page little-endian TIFF.

    float inputs in [0, 1] are stored as uint16 (typical microscopy depth);
    integer inputs are stored as-is.
    """
    stack = np.asarray(stack)
    if stack.ndim == 2:
        stack = stack[None]
    if np.issubdtype(stack.dtype, np.floating):
        stack = np.clip(stack, 0.0, 1.0)
        stack = (stack * 65535.0 + 0.5).astype(np.uint16)
    stack = np.ascontiguousarray(stack, stack.dtype.newbyteorder('<'))
    kind = {'u': 1, 'i': 2, 'f': 3}[stack.dtype.kind]
    bits = stack.dtype.itemsize * 8
    T, H, W = stack.shape
    nbytes = H * W * stack.dtype.itemsize
    n_entries = 11
    ifd_size = 2 + 12 * n_entries + 4
    with open(path, 'wb') as f:
        f.write(b'II' + struct.pack('<HI', 42, 8))
        pos = 8
        for t in range(T):
            data_off = pos + ifd_size
            nxt = data_off + nbytes if t + 1 < T else 0
            entries = [(256, 4, W), (257, 4, H), (258, 3, bits), (259, 3, 1),
                       (262, 3, 1), (273, 4, data_off), (277, 3, 1),
                       (278, 4, H), (279, 4, nbytes), (284, 3, 1),
                       (339, 3, kind)]
            ifd = struct.pack('<H', n_entries)
            for tag, typ, val in entries:
                fmt = '<HHIH2x' if typ == 3 else '<HHII'
                ifd += struct.pack(fmt, tag, typ, 1, val)
            f.write(ifd + struct.pack('<I', nxt))
            f.write(stack[t].tobytes())
            pos = data_off + nbytes
