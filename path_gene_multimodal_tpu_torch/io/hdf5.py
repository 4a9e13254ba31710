"""A small HDF5 reader and writer: the subset of the format that h5py's
default files use, in pure Python and numpy.

The port writes and reads its H5 artifacts (the tessellation H5, the
features H5) through this module, so that it needs no h5py. The writer lays
a file out as h5py does by default (``libver="earliest"``):

- superblock version 0 (8-byte offsets and lengths, group K 4 / 16);
- every group a symbol table: a version-1 B-tree group node, a local heap
  (names 8-byte aligned, offset 0 the empty string) and one symbol-table
  node (``SNOD``); nested groups where a name holds ``/``;
- version-1 object headers; a dataset carries dataspace, datatype,
  fill-value (version 2) and layout (version 3, contiguous) messages; an
  empty dataset's data address is the undefined address;
- attribute messages (version 1) for integer, float and bool scalars and
  1-D arrays, fixed-length byte strings, and UTF-8 variable-length strings
  (scalars and 1-D arrays), whose bytes live in a global heap collection
  (``GCOL``, at least 4096 bytes).

Datatypes: little-endian int8-int64, uint8-uint64, float32, float64, bool
(h5py's enum of int8 with members FALSE = 0, TRUE = 1) and fixed-length
bytes (null-padded). The reader takes the same, big-endian numbers too, and
besides the contiguous layout reads chunked datasets (a version-1 B-tree of
chunks) with or without the deflate filter, compact datasets and object
header continuations. Everything else raises ``ValueError`` naming it:
superblock versions other than 0, version-2 object headers, new-style
groups (link messages), dense attribute storage, filters other than
deflate, layout message versions other than 3, and datatype classes other
than the ones above.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Any, Iterator, Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
GROUP_LEAF_K = 4       # symbol-table node holds 2K entries
GROUP_INTERNAL_K = 16  # group B-tree node holds 2K children
GCOL_MIN = 4096

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK, _LAYOUT = 0x1, 0x2, 0x3, 0x5, 0x6, 0x8
_FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE, _ATTR_INFO = 0xB, 0xC, 0x10, 0x11, 0x15


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# datatypes
# ---------------------------------------------------------------------------


def _float_props(size: int) -> tuple[int, bytes]:
    """(sign bit location, properties) of an IEEE float of ``size`` bytes."""
    if size == 4:
        return 31, struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
    if size == 8:
        return 63, struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
    raise ValueError(f"HDF5 writer: no float of {size} bytes")


def _fixed_type(size: int, signed: bool) -> bytes:
    return (bytes([0x10, 0x08 if signed else 0x00, 0, 0]) + struct.pack("<I", size)
            + struct.pack("<HH", 0, 8 * size))


def _encode_dtype(dt: np.dtype) -> bytes:
    """Datatype message (version 1) of a numpy dtype, as h5py writes it."""
    dt = np.dtype(dt)
    if dt.kind == "b":
        # h5py: an enum of int8 with members FALSE = 0, TRUE = 1
        base = _fixed_type(1, True)
        names = b"".join(n + b"\0" * (_pad8(len(n) + 1) - len(n)) for n in (b"FALSE", b"TRUE"))
        return (bytes([0x18, 2, 0, 0]) + struct.pack("<I", 1) + base + names + bytes([0, 1]))
    if dt.kind in "iu":
        if dt.byteorder == ">":
            raise ValueError("HDF5 writer: big-endian integers are not written")
        return _fixed_type(dt.itemsize, dt.kind == "i")
    if dt.kind == "f":
        if dt.byteorder == ">":
            raise ValueError("HDF5 writer: big-endian floats are not written")
        sign, props = _float_props(dt.itemsize)
        return bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", dt.itemsize) + props
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)
    raise ValueError(f"HDF5 writer: dtype {dt} is not written")


def _vlen_str_type() -> bytes:
    """Variable-length UTF-8 string (h5py's ``str``): class 9, version 1,
    type string, null-terminated, UTF-8, its base a 1-byte unsigned integer
    (as the library encodes it)."""
    return bytes([0x19, 0x01, 0x01, 0]) + struct.pack("<I", 16) + _fixed_type(1, False)


class _Type:
    """A decoded datatype: ``kind`` one of int, float, bool, bytes, vlen_str;
    ``dtype`` the numpy dtype of one element in the file (for vlen_str the
    16-byte heap reference)."""

    def __init__(self, kind: str, dtype: np.dtype, size: int):
        self.kind, self.dtype, self.size = kind, np.dtype(dtype), size


def _decode_dtype(buf: bytes, off: int = 0) -> tuple[_Type, int]:
    """→ (type, bytes consumed)."""
    cv, b0, b1, b2 = buf[off : off + 4]
    cls, ver = cv & 0x0F, cv >> 4
    size = struct.unpack_from("<I", buf, off + 4)[0]
    p = off + 8
    order = ">" if b0 & 1 else "<"
    if cls == 0:  # fixed-point
        signed = bool(b0 & 0x08)
        if size not in (1, 2, 4, 8):
            raise ValueError(f"HDF5: integers of {size} bytes are not read")
        return _Type("int", np.dtype(f"{order}{'i' if signed else 'u'}{size}"), size), 8 + 4
    if cls == 1:  # floating point
        if size not in (2, 4, 8):
            raise ValueError(f"HDF5: floats of {size} bytes are not read")
        return _Type("float", np.dtype(f"{order}f{size}"), size), 8 + 12
    if cls == 3:  # fixed-length string
        return _Type("bytes", np.dtype(f"S{size}"), size), 8
    if cls == 8:  # enumeration
        nmemb = b0 | (b1 << 8)
        base, nb = _decode_dtype(buf, p)
        p += nb
        names = []
        for _ in range(nmemb):
            end = buf.index(b"\0", p)
            names.append(buf[p:end])
            p += _pad8(end - p + 1) if ver < 3 else end - p + 1
        vals = np.frombuffer(buf, base.dtype, nmemb, p)
        p += nmemb * base.size
        if base.kind == "int" and base.size == 1 and sorted(zip(names, vals.tolist())) == [
                (b"FALSE", 0), (b"TRUE", 1)]:
            return _Type("bool", np.dtype("i1"), 1), p - off
        return _Type("int", base.dtype, base.size), p - off
    if cls == 9:  # variable length
        if (b0 & 0x0F) != 1:
            raise ValueError("HDF5: variable-length sequences (other than strings) are not read")
        base, nb = _decode_dtype(buf, p)
        return _Type("vlen_str", np.dtype("V16"), size), 8 + nb
    raise ValueError(f"HDF5: datatype class {cls} is not read")


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Msg:
    def __init__(self, mtype: int, data: bytes):
        self.type, self.data = mtype, data


class Dataset:
    """A dataset of an open file: ``shape``, ``dtype``, ``attrs``; ``[...]``
    or ``read()`` reads the whole array."""

    def __init__(self, f: "File", name: str, msgs: list[_Msg]):
        self.file, self.name = f, name
        self.attrs = f._attrs(msgs)
        self._msgs = msgs
        space = next((m for m in msgs if m.type == _DATASPACE), None)
        dtm = next((m for m in msgs if m.type == _DATATYPE), None)
        if space is None or dtm is None:
            raise ValueError(f"HDF5: dataset {name} has no dataspace or datatype")
        self.shape = _decode_space(space.data)
        self._type = _decode_dtype(dtm.data)[0]
        self.dtype = (np.dtype(bool) if self._type.kind == "bool" else
                      np.dtype(object) if self._type.kind == "vlen_str" else
                      self._type.dtype.newbyteorder("=") if self._type.kind != "bytes" else
                      self._type.dtype)

    def __getitem__(self, key):
        arr = self.read()
        return arr if key is Ellipsis or key == () else arr[key]

    def __len__(self) -> int:
        return self.shape[0]

    def read(self) -> np.ndarray:
        f, t = self.file, self._type
        n = int(np.prod(self.shape, dtype=np.int64))
        layout = next((m for m in self._msgs if m.type == _LAYOUT), None)
        if layout is None:
            raise ValueError(f"HDF5: dataset {self.name} has no layout message")
        filters = _decode_filters(next((m.data for m in self._msgs if m.type == _FILTERS), None))
        ver, cls = layout.data[0], layout.data[1]
        if ver != 3:
            raise ValueError(f"HDF5: layout message version {ver} is not read")
        if cls == 0:  # compact
            size = struct.unpack_from("<H", layout.data, 2)[0]
            raw = layout.data[4 : 4 + size]
        elif cls == 1:  # contiguous
            addr, size = struct.unpack_from("<QQ", layout.data, 2)
            raw = b"" if addr == UNDEF or n == 0 else f._read(addr, n * t.size)
        elif cls == 2:
            return self._read_chunked(layout.data, filters)
        else:
            raise ValueError(f"HDF5: layout class {cls} is not read")
        if filters and cls != 2:
            raise ValueError("HDF5: filters on an unchunked dataset are not read")
        return self._finish(raw, n)

    def _finish(self, raw: bytes, n: int) -> np.ndarray:
        t = self._type
        if n == 0 or not raw:
            return np.zeros(self.shape, self.dtype)
        a = np.frombuffer(raw, t.dtype, n)
        if t.kind == "vlen_str":
            return np.array(self.file._vlen_strings(raw, n), dtype=object).reshape(self.shape)
        a = a.astype(self.dtype) if t.kind != "bool" else a != 0
        return a.reshape(self.shape)

    def _read_chunked(self, data: bytes, filters: list[int]) -> np.ndarray:
        f, t = self.file, self._type
        rank = data[2] - 1
        addr = struct.unpack_from("<Q", data, 3)[0]
        chunk = struct.unpack_from(f"<{rank + 1}I", data, 11)[:rank]
        out = np.zeros(self.shape, t.dtype if t.kind != "vlen_str" else np.dtype("V16"))
        if addr == UNDEF or out.size == 0:
            return self._finish(b"", 0)
        per = int(np.prod(chunk)) * t.size
        for offs, mask, blob in f._chunks(addr, rank):
            for j, fid in enumerate(reversed(filters)):
                if mask & (1 << (len(filters) - 1 - j)):
                    continue  # this filter was skipped for the chunk
                if fid == 1:
                    blob = zlib.decompress(blob)
            a = np.frombuffer(blob[:per], out.dtype).reshape(chunk)
            sl = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offs, chunk, self.shape))
            out[sl] = a[tuple(slice(0, s.stop - s.start) for s in sl)]
        return self._finish(out.tobytes(), out.size)


class Group:
    """A group of an open file: ``keys()``, ``[name]`` (a path with ``/``),
    ``in``, ``attrs``, ``visititems``."""

    def __init__(self, f: "File", name: str, msgs: list[_Msg]):
        self.file, self.name = f, name
        self.attrs = f._attrs(msgs)
        for m in msgs:
            if m.type in (_LINK, _LINK_INFO):
                raise ValueError("HDF5: new-style groups (link messages) are not read")
        st = next((m for m in msgs if m.type == _SYMBOL_TABLE), None)
        self._links: dict[str, int] = {}
        if st is not None:
            btree, heap = struct.unpack_from("<QQ", st.data, 0)
            names = f._local_heap(heap)
            for name_off, hdr in f._group_entries(btree):
                self._links[_cstr(names, name_off)] = hdr

    def keys(self) -> list[str]:
        return list(self._links)

    def __iter__(self) -> Iterator[str]:
        return iter(self._links)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node: Any = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(path)
            node = node.file._object(f"{node.name.rstrip('/')}/{part}", node._links[part])
        return node

    def visititems(self, fn) -> None:
        """``fn(relative_name, obj)`` over every object below, depth first
        in name order (h5py's)."""
        def walk(g: Group, prefix: str):
            for k in sorted(g._links):
                obj = g[k]
                name = f"{prefix}{k}"
                fn(name, obj)
                if isinstance(obj, Group):
                    walk(obj, name + "/")
        walk(self, "")


def _cstr(buf: bytes, off: int) -> str:
    return buf[off : buf.index(b"\0", off)].decode("utf-8")


def _decode_space(data: bytes) -> tuple[int, ...]:
    ver, rank = data[0], data[1]
    if ver == 1:
        p = 8
    elif ver == 2:
        if data[3] == 2:  # null dataspace
            return (0,)
        p = 4
    else:
        raise ValueError(f"HDF5: dataspace message version {ver} is not read")
    return struct.unpack_from(f"<{rank}Q", data, p) if rank else ()


def _decode_filters(data: bytes | None) -> list[int]:
    if data is None:
        return []
    ver, n = data[0], data[1]
    p = 8 if ver == 1 else 2
    ids = []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, p)[0]
        if ver == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, p + 2)[0]
        else:
            name_len = 0
        nvals = struct.unpack_from("<H", data, p + 6 if (ver == 1 or fid >= 256) else p + 4)[0]
        p += (8 if (ver == 1 or fid >= 256) else 6) + (_pad8(name_len) if ver == 1 else name_len)
        p += 4 * nvals + (4 if ver == 1 and nvals % 2 else 0)
        if fid != 1:
            names = {2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset"}
            raise ValueError(f"HDF5: filter {names.get(fid, fid)} is not read (only deflate)")
        ids.append(fid)
    return ids


class File(Group):
    """``File(path)``: an HDF5 file of the supported subset, read-only; the
    root group (``with File(p) as f: f["coords"][...]``)."""

    def __init__(self, path: str | Path, mode: str = "r"):
        if mode != "r":
            raise ValueError("HDF5: File opens for reading; write with write_h5")
        self.path = Path(path)
        self._buf = self.path.read_bytes()
        b = self._buf
        if b[:8] != SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file (no signature at offset 0)")
        if b[8] != 0:
            raise ValueError(f"{path}: HDF5 superblock version {b[8]} is not read (only 0)")
        if b[13] != 8 or b[14] != 8:
            raise ValueError(f"{path}: HDF5 offsets/lengths of {b[13]}/{b[14]} bytes are not read")
        base = struct.unpack_from("<Q", b, 24)[0]
        if base != 0:
            raise ValueError(f"{path}: HDF5 base address {base} is not read (only 0)")
        root_hdr = struct.unpack_from("<Q", b, 56 + 8)[0]
        self._gcol: dict[int, dict[int, bytes]] = {}
        Group.__init__(self, self, "/", self._header(root_hdr))

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        pass

    def _read(self, addr: int, n: int) -> bytes:
        if addr + n > len(self._buf):
            raise ValueError(f"{self.path}: HDF5 read past the end of the file")
        return self._buf[addr : addr + n]

    def _object(self, name: str, addr: int):
        msgs = self._header(addr)
        if any(m.type == _SYMBOL_TABLE or m.type in (_LINK, _LINK_INFO) for m in msgs):
            return Group(self, name, msgs)
        return Dataset(self, name, msgs)

    def _header(self, addr: int) -> list[_Msg]:
        b = self._buf
        if b[addr : addr + 4] == b"OHDR":
            raise ValueError("HDF5: version-2 object headers are not read")
        if b[addr] != 1:
            raise ValueError(f"HDF5: object header version {b[addr]} is not read")
        nmsgs, _, size = struct.unpack_from("<HII", b, addr + 2)
        blocks = [(addr + 16, size)]
        msgs: list[_Msg] = []
        while blocks and len(msgs) < nmsgs:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and len(msgs) < nmsgs:
                mtype, msize, flags = struct.unpack_from("<HHB", b, p)
                data = b[p + 8 : p + 8 + msize]
                p += 8 + msize
                if flags & 0x02:
                    raise ValueError("HDF5: shared object header messages are not read")
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data, 0))
                elif mtype == _ATTR_INFO:
                    raise ValueError("HDF5: dense attribute storage is not read")
                msgs.append(_Msg(mtype, data))
        return msgs

    def _local_heap(self, addr: int) -> bytes:
        b = self._buf
        if b[addr : addr + 4] != b"HEAP":
            raise ValueError("HDF5: bad local heap signature")
        size, _, data = struct.unpack_from("<QQQ", b, addr + 8)
        return b[data : data + size]

    def _group_entries(self, addr: int) -> Iterator[tuple[int, int]]:
        """(name offset, object header address) of every entry below the
        group B-tree node at ``addr``."""
        b = self._buf
        if b[addr : addr + 4] != b"TREE" or b[addr + 4] != 0:
            raise ValueError("HDF5: bad group B-tree node")
        level, used = b[addr + 5], struct.unpack_from("<H", b, addr + 6)[0]
        p = addr + 24
        for i in range(used):
            child = struct.unpack_from("<Q", b, p + 8 + 16 * i)[0]
            if level > 0:
                yield from self._group_entries(child)
                continue
            if b[child : child + 4] != b"SNOD":
                raise ValueError("HDF5: bad symbol table node")
            n = struct.unpack_from("<H", b, child + 6)[0]
            for j in range(n):
                name_off, hdr = struct.unpack_from("<QQ", b, child + 8 + 40 * j)
                yield name_off, hdr

    def _chunks(self, addr: int, rank: int) -> Iterator[tuple[tuple[int, ...], int, bytes]]:
        b = self._buf
        if b[addr : addr + 4] != b"TREE" or b[addr + 4] != 1:
            raise ValueError("HDF5: bad chunk B-tree node")
        level, used = b[addr + 5], struct.unpack_from("<H", b, addr + 6)[0]
        key = 8 + 8 * (rank + 1)
        p = addr + 24
        for i in range(used):
            k = p + i * (key + 8)
            size, mask = struct.unpack_from("<II", b, k)
            offs = struct.unpack_from(f"<{rank}Q", b, k + 8)
            child = struct.unpack_from("<Q", b, k + key)[0]
            if level > 0:
                yield from self._chunks(child, rank)
            else:
                yield offs, mask, self._read(child, size)

    def _heap_object(self, coll: int, index: int) -> bytes:
        if coll not in self._gcol:
            b = self._buf
            if b[coll : coll + 4] != b"GCOL":
                raise ValueError("HDF5: bad global heap collection")
            size = struct.unpack_from("<Q", b, coll + 8)[0]
            objs, p, end = {}, coll + 16, coll + size
            while p + 16 <= end:
                idx, _, osize = struct.unpack_from("<HHxxxxQ", b, p)
                if idx == 0:
                    break
                objs[idx] = b[p + 16 : p + 16 + osize]
                p += 16 + _pad8(osize)
            self._gcol[coll] = objs
        return self._gcol[coll][index]

    def _vlen_strings(self, raw: bytes, n: int) -> list[str]:
        out = []
        for i in range(n):
            length, coll, idx = struct.unpack_from("<IQI", raw, 16 * i)
            out.append("" if coll == 0 else self._heap_object(coll, idx)[:length].decode("utf-8"))
        return out

    def _attrs(self, msgs: list[_Msg]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for m in msgs:
            if m.type != _ATTRIBUTE:
                continue
            d = m.data
            ver = d[0]
            if ver not in (1, 2, 3):
                raise ValueError(f"HDF5: attribute message version {ver} is not read")
            name_len, type_len, space_len = struct.unpack_from("<HHH", d, 2)
            p = 8 if ver == 1 else (8 if ver == 2 else 9)
            pad = _pad8 if ver == 1 else (lambda x: x)
            name = d[p : p + name_len - 1].decode("utf-8")
            p += pad(name_len)
            t, _ = _decode_dtype(d, p)
            p += pad(type_len)
            shape = _decode_space(d[p : p + space_len])
            p += pad(space_len)
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            raw = d[p : p + n * t.size]
            if t.kind == "vlen_str":
                vals = self._vlen_strings(raw, n)
                val: Any = vals[0] if not shape else np.array(vals, dtype=object).reshape(shape)
            else:
                a = np.frombuffer(raw, t.dtype, n)
                a = a != 0 if t.kind == "bool" else a.astype(
                    t.dtype.newbyteorder("=") if t.kind != "bytes" else t.dtype)
                val = a[0] if not shape else a.reshape(shape)
            out[name] = val
        return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _strings(v: Any) -> list[str] | None:
    """The strings of an attribute value that is written as variable-length
    UTF-8 (a str, a sequence of str, a numpy unicode array), else None."""
    if isinstance(v, str):
        return [v]
    if isinstance(v, (list, tuple)) and v and all(isinstance(x, str) for x in v):
        return list(v)
    if isinstance(v, np.ndarray) and v.dtype.kind == "U":
        if v.ndim > 1:
            raise ValueError("HDF5 writer: string attributes of more than one axis")
        return [str(x) for x in v.reshape(-1)]
    return None


class _Writer:
    """The file image in memory: the superblock's 96 bytes, then the global
    heap collection of every variable-length string (if any), then the
    objects as they are written."""

    def __init__(self, strings: list[str]):
        self.buf = bytearray(96)
        self.index: dict[str, int] = {}
        self.gcol = 0
        if strings:
            body = bytearray()
            for s in strings:
                if s in self.index:
                    continue
                data = s.encode("utf-8")
                self.index[s] = len(self.index) + 1
                body += struct.pack("<HH4xQ", self.index[s], 1, len(data)) + data
                body += b"\0" * (_pad8(len(data)) - len(data))
            size = max(GCOL_MIN, 16 + len(body) + 16)
            free = size - 16 - len(body)  # object 0: the free space, its header included
            body += struct.pack("<HH4xQ", 0, 0, free) + b"\0" * (free - 16)
            self.gcol = self.alloc(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size)
                                   + bytes(body))

    def alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data
        self.buf += b"\0" * (_pad8(len(self.buf)) - len(self.buf))
        return addr

    def vlen(self, s: str) -> bytes:
        """The 16-byte reference to ``s`` in the global heap: length,
        collection address, object index."""
        return struct.pack("<IQI", len(s.encode("utf-8")), self.gcol, self.index[s])


def _space(shape: tuple[int, ...]) -> bytes:
    """Dataspace message version 1 (max dims = dims, as h5py writes)."""
    rank = len(shape)
    head = bytes([1, rank, 1 if rank else 0, 0]) + b"\0" * 4
    return head + struct.pack(f"<{rank}Q", *shape) + (struct.pack(f"<{rank}Q", *shape) if rank else b"")


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _attr_value(w: _Writer, v: Any) -> tuple[bytes, tuple[int, ...], bytes]:
    """(datatype message, shape, raw data) of an attribute value."""
    strings = _strings(v)
    if strings is not None:
        shape = () if isinstance(v, str) or (isinstance(v, np.ndarray) and v.ndim == 0) else (
            len(strings),)
        return _vlen_str_type(), shape, b"".join(w.vlen(x) for x in strings)
    a = np.asarray(v)
    if a.dtype == object or a.ndim > 1:
        raise ValueError(f"HDF5 writer: attribute value {v!r} is not written "
                         "(numbers, bools, bytes or str; at most one axis)")
    if a.dtype.kind == "b":
        return _encode_dtype(a.dtype), a.shape, a.astype(np.int8).tobytes()
    return _encode_dtype(a.dtype), a.shape, np.ascontiguousarray(a).tobytes()


def _attribute(w: _Writer, name: str, value: Any) -> bytes:
    dtm, shape, raw = _attr_value(w, value)
    nm = name.encode("utf-8") + b"\0"
    sp = _space(shape)
    body = (struct.pack("<BxHHH", 1, len(nm), len(dtm), len(sp))
            + nm + b"\0" * (_pad8(len(nm)) - len(nm))
            + dtm + b"\0" * (_pad8(len(dtm)) - len(dtm))
            + sp + b"\0" * (_pad8(len(sp)) - len(sp)) + raw)
    return _message(_ATTRIBUTE, body)


def _fill_message() -> bytes:
    """Fill value message version 2 as the library writes h5py's default:
    allocation late, fill time if set, the default value (zeros) defined."""
    return _message(_FILL, bytes([2, 2, 2, 1]) + struct.pack("<I", 0))


def _write_dataset(w: _Writer, arr: np.ndarray, attrs: Mapping[str, Any]) -> int:
    arr = np.asarray(arr)
    if arr.dtype.kind == "U":
        arr = arr.astype("S")
    if arr.dtype.kind in "iuf" and arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    dtm = _encode_dtype(arr.dtype)
    raw = (arr.astype(np.int8) if arr.dtype.kind == "b" else np.ascontiguousarray(arr)).tobytes()
    data_addr = w.alloc(raw) if arr.size else UNDEF
    msgs = [_message(_DATASPACE, _space(arr.shape)), _message(_DATATYPE, dtm, flags=1),
            _fill_message(),
            _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, data_addr, len(raw)))]
    msgs += [_attribute(w, k, v) for k, v in attrs.items()]
    return w.alloc(_object_header(msgs))


def _write_group(w: _Writer, tree: dict, attrs: Mapping[str, Any]) -> tuple[int, int, int]:
    """Write the group ``tree`` ({name: ndarray | (ndarray, attrs) | dict})
    → (object header, B-tree, local heap) addresses."""
    names = sorted(tree, key=lambda s: s.encode("utf-8"))
    entries = []
    for name in names:
        node = tree[name]
        if isinstance(node, dict):
            hdr, bt, hp = _write_group(w, node, {})
            entries.append((name, hdr, 1, struct.pack("<QQ", bt, hp)))
        else:
            arr, a = node if isinstance(node, tuple) else (node, {})
            entries.append((name, _write_dataset(w, arr, a), 0, b"\0" * 16))
    # local heap: offset 0 the empty string, then each name 8-byte aligned
    heap = bytearray(b"\0" * 8)
    offsets = []
    for name, *_ in entries:
        offsets.append(len(heap))
        nm = name.encode("utf-8") + b"\0"
        heap += nm + b"\0" * (_pad8(len(nm)) - len(nm))
    free = len(heap)
    heap += struct.pack("<QQ", 1, 16)  # one free block at the end, as the library leaves
    data_addr = w.alloc(bytes(heap))
    heap_addr = w.alloc(b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", len(heap), free,
                                                                      data_addr))
    # symbol-table nodes of 2 * GROUP_LEAF_K entries, one B-tree node over them
    cap = 2 * GROUP_LEAF_K
    snods = []
    for s in range(0, max(len(entries), 1), cap):
        part = list(zip(offsets[s : s + cap], entries[s : s + cap]))
        body = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(part))
        for off, (_, hdr, cache, scratch) in part:
            body += struct.pack("<QQI4x", off, hdr, cache) + scratch
        body += b"\0" * (40 * (cap - len(part)))
        snods.append((w.alloc(body), part[-1][0] if part else 0))
    if len(snods) > 2 * GROUP_INTERNAL_K:
        raise ValueError(f"HDF5 writer: a group of more than "
                         f"{2 * GROUP_INTERNAL_K * cap} members is not written")
    used = len(snods) if entries else 0
    body = b"TREE" + bytes([0, 0]) + struct.pack("<HQQ", used, UNDEF, UNDEF)
    body += struct.pack("<Q", 0)
    for addr, last in snods[:used]:
        body += struct.pack("<QQ", addr, last)
    body += b"\0" * (16 * (2 * GROUP_INTERNAL_K - used))
    bt_addr = w.alloc(body)
    msgs = [_message(_SYMBOL_TABLE, struct.pack("<QQ", bt_addr, heap_addr))]
    msgs += [_attribute(w, k, v) for k, v in attrs.items()]
    return w.alloc(_object_header(msgs)), bt_addr, heap_addr


def write_h5(path: str | Path, datasets: Mapping[str, Any],
             attrs: Mapping[str, Any] | None = None) -> Path:
    """Write an HDF5 file. ``datasets`` maps a name (``/`` nests groups) to
    an array or to ``(array, attrs)``; ``attrs`` are the root group's. The
    file is written whole, to a temporary name first."""
    tree: dict = {}
    for name, node in datasets.items():
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError(f"HDF5 writer: empty dataset name {name!r}")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
            if not isinstance(d, dict):
                raise ValueError(f"HDF5 writer: {name!r} nests under a dataset")
        d[parts[-1]] = node
    strings: list[str] = []
    for a in [attrs or {}] + [n[1] for n in datasets.values() if isinstance(n, tuple)]:
        for v in a.values():
            strings += _strings(v) or []
    w = _Writer(strings)
    root_hdr, bt, hp = _write_group(w, tree, attrs or {})
    eof = len(w.buf)
    sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", GROUP_LEAF_K, GROUP_INTERNAL_K, 0)
          + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
          + struct.pack("<QQI4xQQ", 0, root_hdr, 1, bt, hp))
    w.buf[:96] = sb
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(bytes(w.buf))
    tmp.replace(path)
    return path
