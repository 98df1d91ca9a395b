"""A read-only reader of OCDBT, the key-value store in which orbax (through
tensorstore) writes the arrays of a ``.orbax`` checkpoint, written from the
format's public description (tensorstore's "OCDBT" kvstore documentation).

A store is a directory.  ``manifest.ocdbt`` holds the configuration and the
version tree; each version names the root of a B+tree whose nodes, and the
values too large to stay inline in a leaf, lie in data files under
``d/`` (a multi-process save: under ``ocdbt.process_<i>/d/`` as well,
named from the root's leaves).  Every manifest and node file is

    magic (uint32, big-endian)     0x0cdb3a2a manifest, 0x0cdb20de node
    length (uint64, little-endian) of the whole file
    version (varint)               0
    compression (varint)           0 none, 1 zstd (the body one frame)
    body
    crc32c (uint32, little-endian) of every byte before it

and lists of records are stored column by column.  The reader checks each
file's magic, length, version, compression and checksum, and raises a
``ValueError`` naming the file where one is wrong.  It reads the newest
version, which is always among the manifest's inline versions; the
out-of-line version-tree nodes hold older ones and are not followed.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

from vqatpu_torch.train import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_FORMAT_VERSION = 0
_COMPRESSIONS = {0: "none", 1: "zstd"}
_MANIFEST_SINGLE = 0
_NO_FILE = 2**64 - 1  # the data-file id of an empty tree
_HEADER = 4 + 8  # magic, length


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's files end with."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads varints, bytes and columns from a decoded body."""

    def __init__(self, data: bytes, where: str, pos: int = 0,
                 end: Optional[int] = None):
        self.data, self.where, self.pos = data, where, pos
        self.end = len(data) if end is None else end

    def _need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise ValueError(f"{self.where}: truncated")

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def bytes(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return bytes(self.data[self.pos - n:self.pos])

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.where}: varint over 64 bits")

    def column(self, n: int, read=None) -> list:
        return [(read or self.varint)() for _ in range(n)]

    def done(self) -> None:
        if self.pos != self.end:
            raise ValueError(f"{self.where}: {self.end - self.pos} bytes "
                             "after the last field")


def decode_file(data: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or node file, checked and decompressed."""
    if len(data) < _HEADER + 2 + 4:
        raise ValueError(f"{where}: truncated ({len(data)} bytes)")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise ValueError(f"{where}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise ValueError(f"{where}: {len(data)} bytes, the header says "
                         f"{length}")
    crc = int.from_bytes(data[-4:], "little")
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"{where}: CRC-32C mismatch")
    head = _Cursor(data, where, _HEADER, len(data) - 4)
    version = head.varint()
    if version != _FORMAT_VERSION:
        raise ValueError(f"{where}: format version {version}, only "
                         f"{_FORMAT_VERSION} is read")
    compression = head.varint()
    if compression not in _COMPRESSIONS:
        raise ValueError(f"{where}: compression {compression}, only none "
                         "and zstd are read")
    body = data[head.pos:-4]
    if _COMPRESSIONS[compression] == "zstd":
        try:
            body = zstd.decompress(body).tobytes()
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from e
    return body


def _key_lengths(r: _Cursor, n: int) -> tuple:
    """The columns of ``n`` prefix-compressed keys: the bytes each shares
    with the key before it, and the bytes it adds."""
    shared = [0] + r.column(n - 1) if n else []
    return shared, r.column(n)


def _key_bytes(r: _Cursor, shared: list, suffix: list) -> list:
    keys, prev = [], b""
    for s, n in zip(shared, suffix):
        if s > len(prev):
            raise ValueError(f"{r.where}: bad key prefix")
        prev = prev[:s] + r.bytes(n)
        keys.append(prev)
    return keys


def _data_file_table(r: _Cursor) -> list:
    """The data files a manifest or node refers to: paths relative to the
    store's directory, prefix-compressed as keys are, each a base path
    (its length a column of its own) and a path relative to it."""
    n = r.varint()
    shared, suffix = _key_lengths(r, n)
    base = r.column(n)
    paths = []
    for raw, b in zip(_key_bytes(r, shared, suffix), base):
        path = raw.decode()
        if b > len(raw) or path.startswith("/") or ".." in path.split("/"):
            raise ValueError(f"{r.where}: data file {path!r} outside the "
                             "store")
        paths.append(path)
    return paths


def _file_id(r: _Cursor, table: list) -> int:
    fid = r.varint()
    if fid >= len(table):
        raise ValueError(f"{r.where}: data file {fid} of {len(table)}")
    return fid


class OcdbtStore:
    """The newest version of the OCDBT store in the directory ``root``:
    :meth:`keys` and :meth:`get` (the value's bytes, or None)."""

    def __init__(self, root: str):
        self.root = root
        self._values: Dict[str, Tuple] = {}
        self._read_manifest(os.path.join(root, "manifest.ocdbt"))

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{path}: truncated (bytes {offset}-"
                             f"{offset + length} referenced, "
                             f"{offset + len(data)} present)")
        return data

    def _read_manifest(self, path: str) -> None:
        with open(path, "rb") as f:
            r = _Cursor(decode_file(f.read(), MANIFEST_MAGIC, path), path)
        r.bytes(16)  # the store's uuid
        kind = r.varint()
        if kind != _MANIFEST_SINGLE:
            raise ValueError(f"{path}: manifest kind {kind}; only a single "
                             "manifest (orbax's) is read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:  # zstd, then its level (int32)
            r.bytes(4)
        table = _data_file_table(r)
        # the inline versions: generation, root height, root node (file,
        # offset, length), statistics (keys, tree bytes, indirect value
        # bytes), commit time (uint64)
        n = r.varint()
        generation = r.column(n)
        height = r.column(n, r.byte)
        fid = r.column(n)
        offset, length = r.column(n), r.column(n)
        r.column(3 * n)
        r.column(n, lambda: r.bytes(8))
        # the out-of-line version-tree nodes, older generations: generation,
        # node (file, offset, length), generations, commit time, height
        m = r.varint()
        r.column(m)
        r.column(m, lambda: _file_id(r, table))
        r.column(2 * m)
        r.column(m)
        r.column(m, lambda: r.bytes(8))
        r.column(m, r.byte)
        r.done()
        if not n:
            if m:
                raise ValueError(f"{path}: no inline version")
            return
        newest = max(range(n), key=generation.__getitem__)
        if fid[newest] == _NO_FILE:
            return  # an empty tree
        if fid[newest] >= len(table):
            raise ValueError(f"{path}: data file {fid[newest]} of "
                             f"{len(table)}")
        self._walk(table[fid[newest]], offset[newest], length[newest],
                   height[newest], b"")

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        where = f"{os.path.join(self.root, rel)} @{offset}"
        r = _Cursor(decode_file(self._read(rel, offset, length), NODE_MAGIC,
                                where), where)
        got = r.byte()
        if got != height:
            raise ValueError(f"{where}: a node of height {got}, {height} "
                             "expected")
        table = _data_file_table(r)
        n = r.varint()
        shared, suffix = _key_lengths(r, n)
        if height == 0:
            keys = _key_bytes(r, shared, suffix)
            size = r.column(n)
            kind = r.column(n)
            if any(k not in (0, 1) for k in kind):
                raise ValueError(f"{where}: value kind not inline (0) or "
                                 "indirect (1)")
            indirect = [i for i in range(n) if kind[i] == 1]
            fids = r.column(len(indirect), lambda: _file_id(r, table))
            offsets = r.column(len(indirect))
            at = dict(zip(indirect, zip(fids, offsets)))
            for i, key in enumerate(keys):
                name = (prefix + key).decode()
                if kind[i] == 0:
                    self._values[name] = ("inline", r.bytes(size[i]))
                else:
                    f, off = at[i]
                    self._values[name] = (table[f], off, size[i])
            r.done()
            return
        common = r.column(n)
        keys = _key_bytes(r, shared, suffix)
        fids = r.column(n, lambda: _file_id(r, table))
        offsets, lengths = r.column(n), r.column(n)
        r.column(3 * n)  # the subtrees' statistics
        r.done()
        for i, key in enumerate(keys):
            if common[i] > len(key):
                raise ValueError(f"{where}: bad subtree prefix")
            self._walk(table[fids[i]], offsets[i], lengths[i], height - 1,
                       prefix + key[:common[i]])

    def keys(self) -> Iterator[str]:
        return iter(sorted(self._values))

    def get(self, key: str) -> Optional[bytes]:
        ref = self._values.get(key)
        if ref is None:
            return None
        if ref[0] == "inline":
            return ref[1]
        return self._read(*ref)
