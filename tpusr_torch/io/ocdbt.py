"""A read-only OCDBT key-value store: the container of tpusr's orbax
checkpoints.

orbax (through tensorstore) writes a checkpoint's arrays as zarr keys in
one OCDBT database ("optionally-cooperative distributed B+tree") under the
checkpoint directory. This module reads that database without tensorstore:

* files (manifest, B-tree node, version-tree node) start with a big-endian
  magic number, the file's length (u64 LE), a format version and a
  compression flag (0 none, 1 zstd over the body) and end with the CRC-32C
  of everything before it;
* the manifest holds the config (uuid, manifest kind, inline-value and node
  limits, version-tree arity, compression), the newest versions inline and
  references to version-tree nodes (the 'single' manifest kind, which
  orbax writes; tensorstore's 'numbered' kind raises);
* a version points at a B-tree root; interior nodes hold prefix-compressed
  keys, each child's common key prefix and its (file, offset, length); leaf
  nodes hold keys and values, inline or as (file, offset, length) in a data
  file;
* file references are (base path, relative path) pairs from a per-node
  table, relative to the node's own base path, so a root manifest that
  merges ``ocdbt.process_N/`` reaches into those directories' ``d/`` files.

Columns of integers are LEB128 varints. ``OcdbtStore(path).get(key)`` and
``.list(prefix)`` are all the checkpoint reader needs; anything the reader
does not know raises FormatError with the field and its byte offset.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from tpusr_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_MISSING = (1 << 64) - 1  # offset and length of an empty tree's root


class FormatError(ValueError):
    """Bytes the reader does not understand: names the field and offset."""


class _Bytes:
    """A cursor over one decoded body, for error messages: ``what`` and the
    offset of the field being read."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what
        self.start = 0  # where the field read last began

    def fail(self, field: str, why: str):
        raise FormatError(f"{self.what}: {field} at byte {self.start}: {why}")

    def varint(self, field: str) -> int:
        value = shift = 0
        start = self.start = self.pos
        while True:
            if self.pos >= len(self.data):
                self.pos = start
                self.fail(field, "varint runs past the end")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.pos = start
                self.fail(field, "varint longer than 10 bytes")

    def varints(self, n: int, field: str) -> list[int]:
        return [self.varint(field) for _ in range(n)]

    def take(self, n: int, field: str) -> bytes:
        self.start = self.pos
        if self.pos + n > len(self.data):
            self.fail(field, f"{n} bytes run past the end ({len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self, field: str) -> int:
        return self.take(1, field)[0]

    def u64(self, field: str) -> int:
        return int.from_bytes(self.take(8, field), "little")

    def end(self):
        self.start = self.pos
        if self.pos != len(self.data):
            self.fail("end", f"{len(self.data) - self.pos} bytes left over")


@dataclasses.dataclass(frozen=True)
class Location:
    path: str  # below the store's root
    offset: int
    length: int
    base: str = ""  # the file's base path: its nodes' tables are under it


@dataclasses.dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Location | None  # None: the empty tree
    num_keys: int
    commit_time: int


def _decode_file(data: bytes, magic: int, what: str) -> bytes:
    """Header, CRC-32C and optional zstd of one OCDBT file; the body."""
    if len(data) < 18:
        raise FormatError(f"{what}: {len(data)} bytes, too short for a "
                          f"header and checksum")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise FormatError(f"{what}: magic at byte 0: 0x{got:08x}, expected "
                          f"0x{magic:08x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise FormatError(f"{what}: length at byte 4: {length}, the file "
                          f"holds {len(data)}")
    crc = int.from_bytes(data[-4:], "little")
    want = zstd.crc32c(np.frombuffer(data, np.uint8)[:-4])
    if crc != want:
        raise FormatError(f"{what}: checksum at byte {len(data) - 4}: "
                          f"0x{crc:08x}, the bytes give 0x{want:08x}")
    head = _Bytes(data[:-4], what)
    head.pos = head.start = 12
    version = head.varint("format version")
    if version != 0:
        head.fail("format version", f"{version} (only 0 is known)")
    compression = head.varint("compression format")
    body = data[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body).tobytes()
    elif compression != 0:
        head.fail("compression format", f"{compression} (0 or 1 known)")
    return body


def _file_table(r: _Bytes, base: str) -> list[tuple[str, str]]:
    """A node's data-file table: each file's (base path, path) below the
    store root, under the node's own base path ``base``."""
    n = r.varint("data file count")
    prefix = [0] + r.varints(max(n - 1, 0), "data file path prefix length")
    suffix = r.varints(n, "data file path suffix length")
    base_len = r.varints(n, "data file base path length")
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file path prefix length",
                   f"{prefix[i]} longer than the previous path")
        full = prev[:prefix[i]] + r.take(suffix[i], "data file path")
        if base_len[i] > len(full):
            r.fail("data file base path length",
                   f"{base_len[i]} longer than the path {full!r}")
        paths.append((base + full[:base_len[i]].decode(),
                      base + full.decode()))
        prev = full
    return paths


def _locations(r: _Bytes, n: int, files: list[tuple[str, str]],
               field: str):
    ids = r.varints(n, f"{field} data file id")
    offsets = r.varints(n, f"{field} offset")
    lengths = r.varints(n, f"{field} length")
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if i >= len(files):
            r.fail(f"{field} data file id", f"{i} not in a table of "
                                            f"{len(files)}")
        out.append(None if (o, ln) == (_MISSING, _MISSING)
                   else Location(files[i][1], o, ln, files[i][0]))
    return out


def _keys(r: _Bytes, n: int, interior: bool):
    """Prefix-compressed keys (and, in interior nodes, each child's
    common-prefix length)."""
    prefix = [0] + r.varints(max(n - 1, 0), "key prefix length")
    suffix = r.varints(n, "key suffix length")
    common = r.varints(n, "subtree common prefix length") if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix length", f"{prefix[i]} longer than the "
                                        f"previous key")
        prev = prev[:prefix[i]] + r.take(suffix[i], "key")
        keys.append(prev)
    return keys, common


def _version_entries(r: _Bytes, files: list[tuple[str, str]]
                     ) -> list[Version]:
    n = r.varint("version count")
    gens = r.varints(n, "generation number")
    heights = list(r.take(n, "root height"))
    roots = _locations(r, n, files, "root")
    num_keys = r.varints(n, "num_keys")
    r.varints(n, "num_tree_bytes")
    r.varints(n, "num_indirect_value_bytes")
    times = [r.u64("commit time") for _ in range(n)]
    return [Version(*v) for v in zip(gens, heights, roots, num_keys, times)]


def _version_refs(r: _Bytes, files: list[tuple[str, str]],
                  with_height: bool):
    """References to version-tree nodes: (height, location, generation)."""
    n = r.varint("version node count")
    gens = r.varints(n, "version node generation number")
    locs = _locations(r, n, files, "version node")
    r.varints(n, "version node num_generations")
    for _ in range(n):
        r.u64("version node commit time")
    heights = list(r.take(n, "version node height")) if with_height \
        else [None] * n
    return list(zip(heights, locs, gens))


class OcdbtStore:
    """The newest version of the OCDBT database under ``path``."""

    def __init__(self, path: str):
        self.root = os.path.abspath(path)
        manifest = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"{self.root}: no OCDBT manifest.ocdbt")
        r = self._manifest(manifest)
        files = _file_table(r, "")
        self.versions = _version_entries(r, files)
        self.version_nodes = _version_refs(r, files, with_height=True)
        r.end()
        if not self.versions:
            raise FormatError(f"{manifest}: no version")
        self.version = max(self.versions, key=lambda v: v.generation)
        self._index: dict[bytes, bytes | Location] | None = None

    def _manifest(self, path: str) -> _Bytes:
        with open(path, "rb") as f:
            r = _Bytes(_decode_file(f.read(), MANIFEST_MAGIC, path), path)
        r.take(16, "uuid")
        kind = r.varint("manifest kind")
        if kind != 0:
            r.fail("manifest kind", f"{kind} (only 0, 'single', is read)")
        r.varint("max_inline_value_bytes")
        r.varint("max_decoded_node_bytes")
        r.byte("version_tree_arity_log2")
        method = r.varint("compression method")
        if method == 1:
            r.take(4, "zstd level")
        elif method != 0:
            r.fail("compression method", f"{method} (0 none, 1 zstd known)")
        return r

    def _read(self, loc: Location) -> bytes:
        with open(os.path.join(self.root, loc.path), "rb") as f:
            f.seek(loc.offset)
            data = f.read(loc.length)
        if len(data) != loc.length:
            raise FormatError(f"{loc.path}: {loc.length} bytes at "
                              f"{loc.offset} run past the file's end")
        return data

    def _node(self, loc: Location, height: int, prefix: bytes, out: dict):
        what = f"{loc.path}@{loc.offset}"
        r = _Bytes(_decode_file(self._read(loc), BTREE_MAGIC, what), what)
        got = r.byte("height")
        if got != height:
            r.fail("height", f"{got}, its parent says {height}")
        files = _file_table(r, loc.base)
        n = r.varint("entry count")
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            children = _locations(r, n, files, "child")
            for _ in range(3):  # num_keys, num_tree_bytes, num_indirect
                r.varints(n, "child statistics")
            r.end()
            for key, c, child in zip(keys, common, children):
                if child is None:
                    r.fail("child", f"missing location under {key!r}")
                self._node(child, height - 1, prefix + key[:c], out)
            return
        lengths = r.varints(n, "value length")
        kinds = r.varints(n, "value kind")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k > 1 for k in kinds):
            r.fail("value kind", f"{max(kinds)} (0 inline, 1 indirect known)")
        ids = r.varints(len(indirect), "value data file id")
        offsets = r.varints(len(indirect), "value offset")
        refs = {}
        for i, fid, off in zip(indirect, ids, offsets):
            if fid >= len(files):
                r.fail("value data file id", f"{fid} not in a table of "
                                             f"{len(files)}")
            refs[i] = Location(files[fid][1], off, lengths[i], files[fid][0])
        for i, key in enumerate(keys):
            out[prefix + key] = refs[i] if i in refs else \
                r.take(lengths[i], "inline value")
        r.end()

    def _entries(self) -> dict[bytes, bytes | Location]:
        if self._index is None:
            index: dict[bytes, bytes | Location] = {}
            v = self.version
            if v.root is not None:
                self._node(v.root, v.root_height, b"", index)
            self._index = index
        return self._index

    def list(self, prefix: bytes | str = b"") -> list[bytes]:
        """Every key that starts with ``prefix``, in order."""
        prefix = prefix.encode() if isinstance(prefix, str) else prefix
        return sorted(k for k in self._entries() if k.startswith(prefix))

    def get(self, key: bytes | str) -> bytes | None:
        """The value under ``key``, or None."""
        key = key.encode() if isinstance(key, str) else key
        val = self._entries().get(key)
        return self._read(val) if isinstance(val, Location) else val

    def history(self) -> list[Version]:
        """Every version the database keeps, oldest first: the version-tree
        nodes' leaves and the manifest's own."""
        found = []

        def walk(height, loc):
            what = f"{loc.path}@{loc.offset}"
            r = _Bytes(_decode_file(self._read(loc), VERSION_MAGIC, what),
                       what)
            r.byte("version_tree_arity_log2")
            got = r.byte("height")
            if got != height:
                r.fail("height", f"{got}, its parent says {height}")
            files = _file_table(r, loc.base)
            if height == 0:
                found.extend(_version_entries(r, files))
            else:
                for _, child, _ in _version_refs(r, files, with_height=False):
                    walk(height - 1, child)
            r.end()

        for height, loc, _ in self.version_nodes:
            walk(height, loc)
        return sorted(found + self.versions, key=lambda v: v.generation)
