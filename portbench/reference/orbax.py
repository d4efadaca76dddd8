"""A frozen copy of the port's orbax checkpoint reader, for the plain
reference: ``read_orbax(path)`` gives the tree an orbax restore gives
(nested dicts, lists, numpy arrays), read with numpy and the system's
``libzstd.so.1`` through ctypes. It is three modules of the port
(``utils/zstd.py``, ``train/ocdbt.py`` and the zarr half of
``train/checkpoint.py``) copied whole into one file, so that the
reference reads the trained weights without importing the program.
"""
import ctypes
import ctypes.util
import itertools
import json
import math
import os
import struct

import numpy as np


# ---------------------------------------------------------------- zstd
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


# --------------------------------------------------------------- OCDBT
MANIFEST_MAGIC = 0x0cdb3a2a
NODE_MAGIC = 0x0cdb20de
# a reference whose offset and length are all ones names no node: the
# empty tree of the store's first version
_NULL = 2 ** 64 - 1
# a manifest holds the config and at most 2**arity inline versions: KBs
MAX_MANIFEST_BYTES = 1 << 24


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of a bytes-like object."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in bytes(data):
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Sequential decoding of a body; every read checks the bounds."""

    def __init__(self, buf, what):
        self.buf = memoryview(buf).cast('B')
        self.pos = 0
        self.what = what

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError(f'{self.what}: truncated at byte {self.pos}')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self):
        return self.take(1)[0]

    def u64le(self):
        return struct.unpack('<Q', self.take(8))[0]

    def varint(self):
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f'{self.what}: a varint longer than 64 '
                                 f'bits at byte {self.pos}')

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.buf):
            raise ValueError(f'{self.what}: {len(self.buf) - self.pos} bytes '
                             'left over after the body')


def _prefixed(r, n, extra=0):
    """n prefix-compressed byte strings: prefix lengths of entries 1..n-1,
    suffix lengths, ``extra`` more columns of n varints each, then the
    suffixes' bytes. Returns (strings, the extra columns)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    cols = [r.varints(n) for _ in range(extra)]
    out, prev = [], b''
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f'{r.what}: a prefix of {p} bytes on a string '
                             f'of {len(prev)}')
        prev = prev[:p] + bytes(r.take(s))
        out.append(prev)
    return out, cols


def _data_files(r):
    """The data file table: paths (str) relative to the store's root."""
    paths, (base,) = _prefixed(r, r.varint(), extra=1)
    for p, b in zip(paths, base):
        if b > len(p):
            raise ValueError(f'{r.what}: a base path of {b} bytes on a '
                             f'path of {len(p)}')
    return [p.decode() for p in paths]


def _unframe(buf, magic, what, max_decoded):
    """The decoded body of a framed manifest or node, checked; at most
    ``max_decoded`` bytes."""
    buf = memoryview(buf).cast('B')
    if len(buf) < 4 + 8 + 2 + 4:
        raise ValueError(f'{what}: {len(buf)} bytes is too short')
    got_magic, length = struct.unpack('>I', buf[:4])[0], struct.unpack(
        '<Q', buf[4:12])[0]
    if got_magic != magic:
        raise ValueError(f'{what}: magic {got_magic:#010x}, expected '
                         f'{magic:#010x}')
    if length != len(buf):
        raise ValueError(f'{what}: the header says {length} bytes, there '
                         f'are {len(buf)}')
    want = struct.unpack('<I', buf[-4:])[0]
    if crc32c(buf[:-4]) != want:
        raise ValueError(f'{what}: crc32c mismatch')
    r = _Reader(buf[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f'{what}: format version {version}')
    method = r.varint()
    body = buf[r.pos:-4]
    if method == 1:
        body = memoryview(decompress_upto(body, max_decoded))
    elif method != 0:
        raise ValueError(f'{what}: unknown compression method {method}')
    if len(body) > max_decoded:
        raise ValueError(f'{what}: {len(body)} decoded bytes, above the '
                         f'limit of {max_decoded}')
    return body


class OcdbtStore:
    """The latest version of the OCDBT store in directory ``root``.

    ``list()`` gives its keys (bytes, sorted); ``read(key)`` a key's value
    as a read-only buffer: the bytes of an inline value, or an
    ``np.memmap`` of the indirect value's range of its data file (a
    single mapping; the data file is never read whole)."""

    def __init__(self, root):
        self.root = os.fspath(root)
        with open(os.path.join(self.root, 'manifest.ocdbt'), 'rb') as f:
            raw = f.read()
        r = _Reader(_unframe(raw, MANIFEST_MAGIC, 'manifest.ocdbt',
                             MAX_MANIFEST_BYTES), 'manifest.ocdbt')
        uuid = bytes(r.take(16)).hex()
        kind = r.varint()
        self.config = {'uuid': uuid, 'manifest_kind': kind,
                       'max_inline_value_bytes': r.varint(),
                       'max_decoded_node_bytes': r.varint(),
                       'version_tree_arity_log2': r.u8()}
        method = r.varint()
        if method == 0:
            self.config['compression'] = None
        elif method == 1:
            self.config['compression'] = {
                'id': 'zstd', 'level': struct.unpack('<i', r.take(4))[0]}
        else:
            raise ValueError(f'manifest.ocdbt: unknown compression method '
                             f'{method} in the config')
        if kind != 0:
            raise ValueError(f'manifest.ocdbt: manifest kind {kind} (numbered '
                             'manifests) is not read')
        files = _data_files(r)
        n = r.varint()
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        ref = list(zip(r.varints(n), r.varints(n), r.varints(n)))
        stats = list(zip(r.varints(n), r.varints(n), r.varints(n)))
        commit = [r.u64le() for _ in range(n)]
        n_nodes = r.varint()
        if n_nodes:
            raise ValueError(f'manifest.ocdbt: {n_nodes} version tree '
                             'node(s) beyond the inline version list are '
                             'not read')
        r.end()
        if not n:
            raise ValueError('manifest.ocdbt: no version')
        self.versions = [
            {'generation': g, 'root_height': h, 'root': self._ref(files, *x),
             'num_keys': s[0], 'num_tree_bytes': s[1],
             'num_indirect_value_bytes': s[2], 'commit_time': c}
            for g, h, x, s, c in zip(gen, height, ref, stats, commit)]
        self._entries = None

    def _ref(self, files, file_id, offset, length):
        if offset == _NULL and length == _NULL:
            return None
        if file_id >= len(files):
            raise ValueError(f'data file id {file_id} of a table of '
                             f'{len(files)}')
        return os.path.join(self.root, files[file_id]), offset, length

    def _node_bytes(self, ref):
        path, offset, length = ref
        with open(path, 'rb') as f:
            f.seek(offset)
            buf = f.read(length)
        if len(buf) != length:
            raise ValueError(f'{path}: {length} bytes at {offset} run past '
                             'its end')
        return buf

    def _walk(self, ref, height, prefix, out):
        what = f'B-tree node {os.path.relpath(ref[0], self.root)}@{ref[1]}'
        r = _Reader(_unframe(self._node_bytes(ref), NODE_MAGIC, what,
                             self.config['max_decoded_node_bytes']), what)
        got = r.u8()
        if got != height:
            raise ValueError(f'{what}: height {got}, expected {height}')
        files = _data_files(r)
        n = r.varint()
        keys, cols = _prefixed(r, n, extra=0 if height == 0 else 1)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f'{what}: unknown value kinds '
                                 f'{sorted(set(kinds) - {0, 1})}')
            m = sum(kinds)
            ids, offsets = r.varints(m), r.varints(m)
            indirect = iter(zip(ids, offsets))
            for key, length, kind in zip(keys, lengths, kinds):
                if kind:
                    file_id, offset = next(indirect)
                    out[prefix + key] = self._ref(files, file_id, offset,
                                                  length)
                else:
                    out[prefix + key] = bytes(r.take(length))
        else:
            common = cols[0]
            children = list(zip(r.varints(n), r.varints(n), r.varints(n)))
            r.varints(3 * n)                      # the subtrees' statistics
            for key, c, child in zip(keys, common, children):
                if c > len(key):
                    raise ValueError(f'{what}: a subtree prefix of {c} '
                                     f'bytes on a key of {len(key)}')
                self._walk(self._ref(files, *child), height - 1,
                           prefix + key[:c], out)
        r.end()

    def _index(self):
        if self._entries is None:
            latest = max(self.versions, key=lambda v: v['generation'])
            out = {}
            if latest['root'] is not None:
                self._walk(latest['root'], latest['root_height'], b'', out)
            self._entries = out
        return self._entries

    def list(self):
        """The keys of the latest version, sorted (bytes)."""
        return sorted(self._index())

    def read(self, key):
        """The value of ``key`` (str or bytes); KeyError when absent."""
        if isinstance(key, str):
            key = key.encode()
        value = self._index()[key]
        if isinstance(value, bytes):
            return value
        path, offset, length = value
        if not length:
            return b''
        if offset + length > os.path.getsize(path):
            raise ValueError(f'{path}: a value of {length} bytes at '
                             f'{offset} runs past its end')
        return np.memmap(path, np.uint8, 'r', offset, (length,))


# ---------------------------------------------------------------- zarr
_SEQUENCE, _DICT = 1, 2
_EMPTY = {'None': lambda: None, 'Dict': dict, 'List': list}
_ARRAYS = ('np.ndarray', 'jax.Array', 'scalar')


def read_orbax(path):
    """The tree an orbax ``PyTreeCheckpointer().restore(path)`` gives (the
    counterpart of the JAX package's ``_restore``), read with numpy and
    the system's libzstd: nested dicts, lists for sequences, numpy arrays
    of the stored dtype and shape, Python scalars for scalar leaves, and
    None, {} or [] for empty ones. Reads checkpoints written with OCDBT
    and zarr v2 (orbax's default); anything else raises ValueError."""
    path = str(path)
    with open(os.path.join(path, '_METADATA')) as f:
        meta = json.load(f)
    if not meta.get('use_ocdbt') or meta.get('use_zarr3'):
        raise ValueError(f'{path}: only OCDBT with zarr v2 is read, this '
                         f'checkpoint has use_ocdbt={meta.get("use_ocdbt")}, '
                         f'use_zarr3={meta.get("use_zarr3")}')
    store = OcdbtStore(path)
    root = {}
    for entry in meta['tree_metadata'].values():
        keys = entry['key_metadata']
        value = entry['value_metadata']['value_type']
        if value in _EMPTY:
            leaf = _EMPTY[value]()
        elif value in _ARRAYS:
            leaf = read_zarr(store, '.'.join(str(k['key']) for k in keys))
            if value == 'scalar':
                leaf = leaf.item()
        else:
            raise ValueError(f'{path}: leaf value type {value!r} is not read')
        node = root
        for k, nxt in zip(keys, keys[1:] + [None]):
            if k['key_type'] not in (_SEQUENCE, _DICT):
                raise ValueError(f'{path}: key type {k["key_type"]} is not '
                                 'read')
            key = int(k['key']) if k['key_type'] == _SEQUENCE else k['key']
            if nxt is None:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})
    return _sequences(root)


def _sequences(root):
    """The dicts whose keys are sequence indices, as lists."""
    def walk(node):
        if not isinstance(node, dict) or not node:
            return node
        out = {k: walk(v) for k, v in node.items()}
        if all(isinstance(k, int) for k in out):
            if sorted(out) != list(range(len(out))):
                raise ValueError(f'sequence indices {sorted(out)} are not '
                                 '0..n-1')
            return [out[i] for i in range(len(out))]
        return out
    return walk(root)


def read_zarr(store, name):
    """The zarr v2 array ``name`` of an OCDBT store: its ``.zarray``, then
    each chunk of its grid, zstd-compressed or raw. A missing chunk is
    the fill value; with none (null) it raises."""
    meta = json.loads(bytes(store.read(f'{name}/.zarray')))
    for key, want in (('zarr_format', 2), ('order', 'C'), ('filters', None)):
        if meta.get(key) != want:
            raise ValueError(f'{name}: {key} {meta.get(key)!r} is not read '
                             f'(only {want!r})')
    comp = meta.get('compressor')
    if comp is not None and comp.get('id') != 'zstd':
        raise ValueError(f'{name}: compressor {comp.get("id")!r} is not '
                         'read (only zstd or none)')
    try:
        dtype = np.dtype(meta['dtype'])
    except TypeError:
        raise ValueError(f'{name}: dtype {meta["dtype"]!r} is not read')
    if dtype.hasobject or dtype.fields:
        raise ValueError(f'{name}: dtype {meta["dtype"]!r} is not read')
    shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    if len(chunks) != len(shape) or min(chunks, default=1) < 1:
        raise ValueError(f'{name}: chunks {chunks} for shape {shape}')
    sep = meta.get('dimension_separator', '.')
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    n_bytes = math.prod(chunks) * dtype.itemsize

    def chunk(idx):
        key = f'{name}/{sep.join(map(str, idx)) if shape else "0"}'
        try:
            buf = store.read(key)
        except KeyError:
            if meta.get('fill_value') is None:
                raise ValueError(f'{name}: chunk {key} is missing and the '
                                 'array has no fill value')
            return None
        raw = (decompress(buf, n_bytes) if comp is not None
               else np.frombuffer(buf, np.uint8))
        if raw.nbytes != n_bytes:
            raise ValueError(f'{name}: chunk {key} holds {raw.nbytes} bytes, '
                             f'expected {n_bytes}')
        return raw.view(dtype).reshape(chunks)

    if tuple(chunks) == shape:
        out = chunk((0,) * len(shape))
        if out is not None:
            return out if comp is not None else out.copy()
    out = np.empty(shape, dtype)
    for idx in itertools.product(*map(range, grid)):
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        got = chunk(idx)
        if got is None:
            out[dst] = _fill(meta['fill_value'], dtype)
        else:
            out[dst] = got[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def _fill(value, dtype):
    """A zarr v2 fill value (JSON numbers, or 'NaN' / 'Infinity' /
    '-Infinity' for floats)."""
    named = {'NaN': np.nan, 'Infinity': np.inf, '-Infinity': -np.inf}
    return np.asarray(named.get(value, value), dtype)
