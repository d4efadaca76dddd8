"""A read-only OCDBT key-value store: the on-disk layout under the JAX
package's orbax checkpoints, read without tensorstore.

Follows tensorstore's published "OCDBT format" (``kvstore/ocdbt``). The
store is a directory with a ``manifest.ocdbt`` and data files (``d/...``,
and in orbax's merged multi-process layout ``ocdbt.process_N/d/...``, all
named relative to the store's directory). The manifest and every B-tree
node are framed alike:

    magic u32be (manifest 0x0cdb3a2a, B-tree node 0x0cdb20de)
    length u64le (of the whole encoding), version varint (0)
    compression varint (0 none, 1 zstd), the body, crc32c u32le (of all
    that precedes it)

The manifest's body: the config (uuid[16], manifest kind varint (0: one
manifest file), max inline value bytes, max decoded node bytes (varints),
version tree arity log2 u8, compression varint and, for zstd, its level
i32le), a data file table, then the inline versions in columns
(generation varint, root height u8, root node reference: data file id,
offset and length varints, the root's statistics: keys, tree bytes,
indirect value bytes varints, commit time u64le) and the count of version
tree nodes. The latest version's root is the tree read here.

A data file table: the count, then the paths prefix-compressed against
the previous path (prefix lengths of paths 1.., suffix lengths, base path
lengths) and the suffixes' bytes. A B-tree node's body: its height u8, a
data file table, the entry count, the keys prefix-compressed the same way
(an interior node adds, per entry, the length of the prefix its subtree's
keys share, which the child's keys omit), then a leaf's value lengths and
kinds (0 inline, 1 indirect), the indirect values' data file ids and
offsets, and the inline values' bytes; an interior node's child references
(data file id, offset, length) and statistics (keys, tree bytes, indirect
value bytes).

Whatever the reader does not decode raises ``ValueError`` naming it: a
numbered manifest, version tree nodes beyond the inline list, an unknown
compression, magic or version, a bad crc32c, a truncated or over-long
encoding, a node of the wrong height.
"""
import os
import struct

import numpy as np

from ..utils import zstd

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
        body = memoryview(zstd.decompress_upto(body, max_decoded))
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
