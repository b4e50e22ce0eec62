"""A read-only OCDBT key-value store (tensorstore's "OCDBT on-disk format").

Orbax writes a checkpoint's arrays through tensorstore into an OCDBT store:
a manifest (``manifest.ocdbt``) names the newest version of a b-tree whose
leaves hold the keys (zarr's ``<array>/.zarray`` and chunk keys) and their
values, inline or by reference into data files (``d/<name>``). Under Orbax a
step's root manifest refers into ``ocdbt.process_<n>/d/``; every path in the
store is relative to the directory of the manifest, so a store reads the same
wherever it lies.

The layout read here, as tensorstore writes it:

- every manifest and b-tree node: magic (uint32 big-endian; ``0x0cdb3a2a``
  for a manifest, ``0x0cdb20de`` for a b-tree node), its length in bytes
  (uint64 LE), a format version (varint 0) and a compression format (varint:
  0 raw, 1 zstd), the body, and the CRC-32C of all that (uint32 LE);
- a manifest body: the config (a 16-byte uuid, the manifest kind, the
  largest inline value, the largest decoded node, the version tree's arity as
  a log2 byte, the compression method and, for zstd, its level as int32 LE),
  a data file table, then the newest versions column by column (generation,
  root height, root file, offset and length, three statistics, commit time)
  and the references to older version-tree nodes, which are not read;
- a data file table: the count, then each path's length shared with the
  previous path, its suffix's length and its base path's length, then the
  suffixes; a file's path is its base path and its relative path joined;
- a b-tree node body: its height (a byte), a data file table and the entry
  count, then the entries column by column, each key stored as the length
  it shares with the previous key and its suffix. A leaf's entries give each
  value's length and kind (0 inline, 1 by reference), the references' file
  and offset, then the inline values. An interior node's entries give each
  child's common key prefix length, its file, offset and length and three
  statistics; a child's keys are stored without the parent's prefix and the
  child's common prefix.

Integers are LEB128 varints. A checksum that does not match, a reference
outside its file or a body that ends early raises :class:`CorruptOcdbt` (an
``IOError``); a format version, compression or manifest kind not listed here
raises :class:`UnsupportedOcdbt` (a ``NotImplementedError``).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Tuple, Union

from tcs_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_INVALID = (1 << 64) - 1
_MANIFEST_CAP = 1 << 26  # a manifest frame without its content size


class CorruptOcdbt(IOError):
    """A damaged or truncated OCDBT store."""


class UnsupportedOcdbt(NotImplementedError):
    """An OCDBT layout this reader does not read."""


class _Ref(NamedTuple):
    file: str      # relative to the store's directory
    offset: int
    length: int


class _Reader:
    """Sequential reads from a node or manifest body."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise CorruptOcdbt(f"{self.where}: {what} at byte {self.pos}")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("body ends inside a varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            self.fail(f"body ends before {n} more bytes")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _prefixed(r: _Reader, n: int, prefix_lengths: List[int], suffix_lengths: List[int]
              ) -> List[bytes]:
    """``n`` byte strings stored as (length shared with the previous one,
    suffix); ``prefix_lengths`` has ``n - 1`` entries."""
    out, prev = [], b""
    for i in range(n):
        shared = prefix_lengths[i - 1] if i else 0
        if shared > len(prev):
            r.fail("prefix longer than the previous key")
        prev = prev[:shared] + r.take(suffix_lengths[i])
        out.append(prev)
    return out


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    if n == 0:
        return []
    shared = r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths = _prefixed(r, n, shared, suffix)
    for p, b in zip(paths, base):
        if b > len(p):
            r.fail("base path longer than its path")
    return [p.decode() for p in paths]


def _file_ref(r: _Reader, table: List[str], file_ids, offsets, lengths) -> List[_Ref]:
    out = []
    for f, o, n in zip(file_ids, offsets, lengths):
        if f >= len(table):
            r.fail(f"data file {f} not in a table of {len(table)}")
        out.append(_Ref(table[f], o, n))
    return out


def _unwrap(blob: bytes, magic: int, where: str, cap: int) -> bytes:
    """The body of a manifest or node after its header and checksum are
    checked, decompressed."""
    if len(blob) < 4 + 8 + 2 + 4:
        raise CorruptOcdbt(f"{where}: {len(blob)} bytes, shorter than any header")
    got_magic, length = struct.unpack_from(">I", blob)[0], struct.unpack_from("<Q", blob, 4)[0]
    if got_magic != magic:
        raise CorruptOcdbt(f"{where}: magic {got_magic:08x}, not {magic:08x}")
    if length != len(blob):
        raise CorruptOcdbt(f"{where}: header gives {length} bytes, the file holds {len(blob)}")
    crc = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if zstd.crc32c(blob[:-4]) != crc:
        raise CorruptOcdbt(f"{where}: CRC-32C mismatch")
    r = _Reader(blob[:-4], where)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise UnsupportedOcdbt(f"{where}: OCDBT format version {version}")
    body = blob[r.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise UnsupportedOcdbt(f"{where}: OCDBT compression format {compression}")
    size = zstd.content_size(body)
    try:
        return zstd.decompress(body, cap if size is None else size)
    except zstd.CorruptZstd as e:
        raise CorruptOcdbt(f"{where}: {e}") from e


class OcdbtStore:
    """The newest version of the OCDBT store whose manifest is
    ``directory/manifest.ocdbt``: its sorted keys and their values."""

    def __init__(self, directory: Union[str, os.PathLike]):
        self.directory = os.fspath(directory)
        path = os.path.join(self.directory, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = _unwrap(f.read(), MANIFEST_MAGIC, path, _MANIFEST_CAP)
        r = _Reader(body, path)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise UnsupportedOcdbt(f"{path}: manifest kind {kind} (numbered manifests)")
        r.varint()  # the largest inline value
        self.max_decoded_node_bytes = r.varint()
        r.byte()  # the version tree's arity
        method = r.varint()
        if method == 1:
            r.take(4)  # zstd level
        elif method != 0:
            raise UnsupportedOcdbt(f"{path}: OCDBT compression method {method}")
        table = _data_file_table(r)
        n = r.varint()
        generations = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        roots = _file_ref(r, table, r.varints(n), r.varints(n), r.varints(n))
        r.varints(3 * n)  # statistics
        r.take(8 * n)     # commit times
        self._values: Dict[bytes, Union[bytes, _Ref]] = {}
        self.height = 0  # of the newest version's b-tree
        if n:
            newest = max(range(n), key=generations.__getitem__)
            root = roots[newest]
            self.height = heights[newest]
            if root.length != _INVALID:  # an empty tree has no root node
                self._walk(root, self.height, b"")
        self._keys = sorted(self._values)

    def _node(self, ref: _Ref) -> Tuple[int, _Reader, List[str]]:
        where = f"{os.path.join(self.directory, ref.file)}@{ref.offset}+{ref.length}"
        blob = self._read(ref, where)
        r = _Reader(_unwrap(blob, BTREE_MAGIC, where, self.max_decoded_node_bytes), where)
        height = r.byte()
        return height, r, _data_file_table(r)

    def _read(self, ref: _Ref, where: str) -> bytes:
        path = os.path.join(self.directory, ref.file)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise CorruptOcdbt(f"{where}: reference runs past the end of its file")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        got, r, table = self._node(ref)
        if got != height:
            r.fail(f"node of height {got} where its parent expects {height}")
        n = r.varint()
        shared = r.varints(n - 1) if n else []
        suffix = r.varints(n)
        if height == 0:
            keys = _prefixed(r, n, shared, suffix)
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k > 1 for k in kinds):
                r.fail(f"value kind {max(kinds)}")
            indirect = [i for i in range(n) if kinds[i] == 1]
            refs = _file_ref(r, table, r.varints(len(indirect)), r.varints(len(indirect)),
                             [lengths[i] for i in indirect])
            for i, ref_i in zip(indirect, refs):
                self._values[prefix + keys[i]] = ref_i
            for i in range(n):
                if kinds[i] == 0:
                    self._values[prefix + keys[i]] = r.take(lengths[i])
            if r.pos != len(r.data):
                r.fail("bytes after the leaf's values")
            return
        common = r.varints(n)
        keys = _prefixed(r, n, shared, suffix)
        children = _file_ref(r, table, r.varints(n), r.varints(n), r.varints(n))
        r.varints(3 * n)  # statistics
        for key, c, child in zip(keys, common, children):
            if c > len(key):
                r.fail("child prefix longer than its key")
            self._walk(child, height - 1, prefix + key[:c])

    def keys(self) -> List[str]:
        """Every key, sorted."""
        return [k.decode() for k in self._keys]

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` if the store lacks it."""
        value = self._values[key.encode()]
        if isinstance(value, _Ref):
            return self._read(value, f"{os.path.join(self.directory, value.file)}"
                                     f"@{value.offset} ({key})")
        return value
