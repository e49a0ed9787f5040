"""A reader and writer of the HDF5 subset that ``.cool`` files use, in
numpy and the standard library (``os.pread``, ``struct``, ``zlib``).

The port reads and writes cooler files without h5py.  The surface is a
small part of h5py's: ``File(path)``, ``f["pixels/count"]``, ``name in
group``, ``obj.attrs`` (a dict) and ``Dataset`` with ``shape``, ``dtype``
and ``[lo:hi]`` / ``[:]`` slicing along the first axis.  Attribute values
come back as h5py gives them: ``str`` for a variable-length string,
``np.bytes_`` for a fixed-length one, numpy scalars for numbers, numpy
arrays for non-scalar dataspaces; an enum reads as its base integer type.

What it reads is what h5py writes at its default library version
("earliest"), which is what cooler writes:

* superblock versions 0 and 1 (sizes of offsets and lengths from the
  superblock, a user block before it);
* version-1 object headers with continuation blocks;
* symbol-table groups: the v1 B-tree of type 0, ``SNOD`` nodes and the
  local heap;
* dataspaces (scalar, simple), datatypes of class 0 (integers, either
  byte order), 1 (IEEE floats), 3 (fixed strings), 8 (enums) and 9
  (variable-length strings, from the global heap);
* data layout version 3: compact, contiguous, and chunked through a v1
  B-tree of type 1 of any depth; the filters deflate, shuffle and
  fletcher32 (checked), honouring each chunk's filter mask; storage not
  allocated reads as the fill value;
* attribute messages of versions 1 to 3.

Anything else raises ``NotImplementedError`` naming the feature and the
file offset (superblock v2/v3, v2 object headers, link-message groups,
layout v4 chunk indexes, szip, nbit, ...): nothing is read wrong
silently.  A contiguous slice reads exactly its bytes; a chunked slice
inflates only the chunks that overlap it, from a chunk index walked once
per dataset.

The writer makes new files in the same subset (``write``: superblock
v0, symbol-table groups, contiguous datasets, attributes of integers,
floats and variable-length UTF-8 strings) and adds or replaces a
dataset of an existing file (``File(path, "r+").write_dataset``): the
data and its object header go at the end of the file, the symbol-table
node and its B-tree key and the local heap are updated in place (the
heap's data segment moves to the end of the file when it has no room),
and the superblock's end-of-file address follows.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5, 0x6
LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 0x8, 0xA, 0xB, 0xC
CONTINUATION, SYMBOL_TABLE = 0x10, 0x11
# messages that say nothing about the data read here
IGNORED = {NIL, 0x0D, 0x0E, 0x12, 0x13, 0x16}
# messages whose body this module interprets: a shared one lives elsewhere
INTERPRETED = {DATASPACE, DATATYPE, FILL_OLD, FILL, LAYOUT, FILTERS, ATTRIBUTE}
DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3
# local heap free-list terminator (H5HL_FREE_NULL)
FREE_NULL = 1
# group B-tree node sizes of the files this module writes (HDF5's defaults)
LEAF_K, INTERNAL_K = 4, 16
OFFSET_SIZE = LENGTH_SIZE = 8
UNDEF = (1 << 64) - 1
GLOBAL_HEAP_MIN = 4096


def _align8(n):
    return (n + 7) & ~7


def _pad8(data):
    return data + b"\0" * (_align8(len(data)) - len(data))


def _uint(data, pos, size):
    return int.from_bytes(data[pos : pos + size], "little")


class File:
    """An HDF5 file, opened read-only (``mode="r"``) or for adding
    datasets (``"r+"``).  ``f[path]`` gives a ``Group`` or a ``Dataset``;
    ``f.attrs`` are the root group's attributes."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "r+"):
            raise ValueError(f"mode must be 'r' or 'r+', not {mode!r}")
        self.filename = str(path)
        self.mode = mode
        self._fd = None
        self._fd = os.open(self.filename, os.O_RDONLY if mode == "r" else os.O_RDWR)
        self._objects = {}
        self._global_heaps = {}
        try:
            self._read_superblock()
            self.root = self._object(self._root_addr, "/")
        except BaseException:
            self.close()
            raise

    # -- lifetime ------------------------------------------------------ #
    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    # -- the h5py-like surface ----------------------------------------- #
    def __getitem__(self, path):
        return self.root[path]

    def __contains__(self, path):
        return path in self.root

    @property
    def attrs(self):
        return self.root.attrs

    # -- low level ----------------------------------------------------- #
    def _read(self, addr, size):
        """``size`` bytes at file address ``addr`` (relative to the base)."""
        data = os.pread(self._fd, size, self._base + addr)
        if len(data) != size:
            raise OSError(
                f"{self.filename}: truncated file, {size} bytes wanted at offset "
                f"{self._base + addr}, {len(data)} read"
            )
        return data

    def _read_into(self, addr, out):
        """Fill the bytes of array ``out`` from file address ``addr``."""
        view = memoryview(out).cast("B")
        done = 0
        while done < len(view):
            n = os.preadv(self._fd, [view[done:]], self._base + addr + done)
            if n <= 0:
                raise OSError(f"{self.filename}: truncated file at offset {addr + done}")
            done += n

    def _write(self, addr, data):
        view = memoryview(data).cast("B")
        done = 0
        while done < len(view):
            done += os.pwrite(self._fd, view[done:], self._base + addr + done)

    def _addr(self, data, pos):
        value = _uint(data, pos, self._so)
        return None if value == self._undef else value

    def _unsupported(self, what, offset):
        return NotImplementedError(
            f"{self.filename}: {what} at file offset {offset} is outside the HDF5 "
            "subset chromosight_torch.io.hdf5 reads"
        )

    def _read_superblock(self):
        size = os.fstat(self._fd).st_size
        base = 0
        while base + 8 <= size:
            if os.pread(self._fd, 8, base) == SIGNATURE:
                break
            base = 512 if base == 0 else base * 2
        else:
            raise OSError(f"{self.filename}: not an HDF5 file (no signature found)")
        head = os.pread(self._fd, 128, base)
        version = head[8]
        if version not in (0, 1):
            raise self._unsupported(f"superblock version {version}", base)
        self._so, self._sl = head[13], head[14]
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise self._unsupported(f"sizes of offsets {self._so} and lengths {self._sl}", base)
        self._undef = (1 << (8 * self._so)) - 1
        self._leaf_k, self._internal_k = struct.unpack_from("<HH", head, 16)
        pos = 24 if version == 0 else 28
        so = self._so
        # addresses count from the signature, wherever the stored base
        # address says it is (HDF5's H5F__super_read does the same)
        self._base = base
        self._eof_pos = base + pos + 2 * so
        self._eof = _uint(head, pos + 2 * so, so)
        entry = pos + 4 * so
        self._root_addr = _uint(head, entry + so, so)
        self._entry_size = 2 * so + 24

    # -- adding a dataset --------------------------------------------- #
    def write_dataset(self, path, data, attrs=None):
        """Add the dataset ``path`` ("bins/weight"), or replace it, in a
        file opened with ``"r+"``: the array contiguous and its object
        header at the end of the file, ``attrs`` its attributes (see
        ``_attribute_messages``).  The parent group's symbol-table node
        gets the entry in name order; a replaced entry points to the new
        header and the old object stays as dead space, as h5py's ``del``
        leaves it.  A full node, or a group B-tree of more than one level,
        raises ``NotImplementedError``."""
        if self.mode != "r+":
            raise ValueError(f"{self.filename} is open read-only")
        if self._base or (self._so, self._sl) != (OFFSET_SIZE, LENGTH_SIZE):
            raise self._unsupported("writing to a file with a user block or small offsets", 0)
        parent, _, name = str(path).strip("/").rpartition("/")
        group = self.root[parent]
        if not isinstance(group, Group):
            raise KeyError(f"{parent} is not a group")
        out = _Appender(self._fd, self._eof)
        header = _dataset_header(np.ascontiguousarray(data), out, attrs)
        self._link(group, name.encode("utf-8"), header, out)
        self._eof = out.finish()
        self._write(self._eof_pos, self._eof.to_bytes(self._so, "little"))
        group._links = None

    def _link(self, group, name, header, out):
        so, sl, size = self._so, self._sl, self._entry_size
        level, items, last = self._btree(group.btree, sl)
        if level != 0 or not items:
            raise self._unsupported("adding to a group whose B-tree is not one leaf node",
                                    group.btree)
        heap_size, _, heap_data = self._local_heap(group.heap)
        names = self._read(heap_data, heap_size)

        def name_at(offset):
            return names[offset : names.index(b"\0", offset)]

        keys = [_uint(key, 0, sl) for key, _ in items] + [_uint(last, 0, sl)]
        child = next((i for i in range(len(items)) if name <= name_at(keys[i + 1])), None)
        if child is None:
            child = len(items) - 1
        node = items[child][1]
        count, raw = self._snod(node)
        rows = [raw[i * size : (i + 1) * size] for i in range(count)]
        row_names = [name_at(_uint(row, 0, so)) for row in rows]
        if name in row_names:
            i = row_names.index(name)
            rows[i] = _entry(_uint(rows[i], 0, so), header)
        else:
            if count >= 2 * self._leaf_k:
                raise self._unsupported("adding to a full symbol-table node", node)
            offset = self._heap_insert(group.heap, name, out)
            rows.insert(sum(n < name for n in row_names), _entry(offset, header))
            if name > name_at(keys[child + 1]):
                key_pos = group.btree + 8 + 2 * so + (child + 1) * (sl + so)
                self._write(key_pos, offset.to_bytes(sl, "little"))
        self._write(node + 6, struct.pack("<H", len(rows)) + b"".join(rows))

    def _heap_insert(self, heap, name, out):
        """Put ``name`` (null-terminated, 8-byte aligned) in the local heap
        at ``heap``, from its free list as HDF5's ``H5HL_insert`` takes a
        block (an exact fit, or one that leaves a free block); with no
        such block the data segment moves to the end of the file, grown;
        the name's offset."""
        sl = self._sl
        size, head, data_addr = self._local_heap(heap)
        data = bytearray(self._read(data_addr, size))
        blocks, offset = [], head
        while offset != FREE_NULL and offset < size:
            blocks.append([offset, _uint(data, offset + sl, sl)])
            offset = _uint(data, offset, sl)
        need = _align8(len(name) + 1)
        fit = next((b for b in blocks if b[1] == need or b[1] - need >= 2 * sl), None)
        moved = fit is None
        if moved:
            grow = max(size, need + 2 * sl)
            fit = next((b for b in blocks if b[0] + b[1] == size), None)
            if fit is None:
                fit = [size, 0]
                blocks.append(fit)
            fit[1] += grow
            data += bytes(grow)
            size += grow
        offset = fit[0]
        if fit[1] == need:
            blocks.remove(fit)
        else:
            fit[0] += need
            fit[1] -= need
        data[offset : offset + need] = _pad8(name + b"\0")
        for i, (start, length) in enumerate(blocks):
            following = blocks[i + 1][0] if i + 1 < len(blocks) else FREE_NULL
            data[start : start + 2 * sl] = struct.pack("<QQ", following, length)
        if moved:
            data_addr = out.put(bytes(data))
        else:
            self._write(data_addr, data)
        head = blocks[0][0] if blocks else FREE_NULL
        self._write(heap + 8, struct.pack("<QQQ", size, head, data_addr))
        return offset

    # -- object headers ------------------------------------------------ #
    def _messages(self, addr):
        """(type, body, file offset of the body) of every message of the
        version-1 object header at ``addr``, continuation blocks followed."""
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise self._unsupported("a version-2 object header", addr)
        if prefix[0] != 1:
            raise self._unsupported(f"object header version {prefix[0]}", addr)
        blocks = [(addr + 16, struct.unpack_from("<I", prefix, 8)[0])]
        messages = []
        while blocks:
            start, length = blocks.pop(0)
            block = self._read(start, length)
            pos = 0
            while pos + 8 <= length:
                kind, size, flags = struct.unpack_from("<HHB", block, pos)
                body = block[pos + 8 : pos + 8 + size]
                where = start + pos + 8
                pos += 8 + size
                if kind == CONTINUATION:
                    blocks.append((_uint(body, 0, self._so), _uint(body, self._so, self._sl)))
                elif kind in INTERPRETED or kind == SYMBOL_TABLE:
                    if flags & 0x2:
                        raise self._unsupported(f"a shared message of type 0x{kind:04x}", where)
                    messages.append((kind, body, where))
                elif kind in (LINK_INFO, LINK, GROUP_INFO):
                    raise self._unsupported("a link-message group (new-style group)", where)
                elif kind not in IGNORED:
                    raise self._unsupported(f"object header message type 0x{kind:04x}", where)
        return messages

    def _object(self, addr, name):
        obj = self._objects.get(addr)
        if obj is None:
            messages = self._messages(addr)
            kinds = {kind for kind, _, _ in messages}
            if SYMBOL_TABLE in kinds:
                obj = Group(self, addr, name, messages)
            elif LAYOUT in kinds:
                obj = Dataset(self, addr, name, messages)
            else:
                raise self._unsupported("an object that is neither group nor dataset", addr)
            self._objects[addr] = obj
        return obj

    # -- B-trees, heaps ------------------------------------------------ #
    def _btree(self, addr, key_size):
        """(level, [(key bytes, child address)...], last key bytes) of the
        v1 B-tree node at ``addr``."""
        head = self._read(addr, 8 + 2 * self._so)
        if head[:4] != b"TREE":
            raise OSError(f"{self.filename}: no B-tree node at offset {addr}")
        level, entries = head[5], struct.unpack_from("<H", head, 6)[0]
        step = key_size + self._so
        body = self._read(addr + len(head), entries * step + key_size)
        items = [
            (body[i * step : i * step + key_size], _uint(body, i * step + key_size, self._so))
            for i in range(entries)
        ]
        return level, items, body[entries * step :]

    def _btree_leaves(self, addr, key_size):
        """(key bytes, child address) of every leaf entry under ``addr``."""
        level, items, _ = self._btree(addr, key_size)
        if level == 0:
            return items
        return [leaf for _, child in items for leaf in self._btree_leaves(child, key_size)]

    def _local_heap(self, addr):
        """(data segment size, free-list head, data segment address)."""
        head = self._read(addr, 8 + 2 * self._sl + self._so)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise self._unsupported("a local heap that is not version 0", addr)
        sl = self._sl
        return _uint(head, 8, sl), _uint(head, 8 + sl, sl), _uint(head, 8 + 2 * sl, self._so)

    def _snod(self, addr):
        """(entry count, raw entries) of the symbol-table node at ``addr``."""
        head = self._read(addr, 8)
        if head[:4] != b"SNOD" or head[4] != 1:
            raise OSError(f"{self.filename}: no symbol-table node at offset {addr}")
        count = struct.unpack_from("<H", head, 6)[0]
        return count, self._read(addr + 8, count * self._entry_size)

    def _global_heap(self, addr):
        """{index: bytes} of the global heap collection at ``addr``."""
        objects = self._global_heaps.get(addr)
        if objects is None:
            head = self._read(addr, 16)
            if head[:4] != b"GCOL":
                raise OSError(f"{self.filename}: no global heap at offset {addr}")
            size = _uint(head, 8, self._sl)
            data = self._read(addr, size)
            objects, pos = {}, 8 + self._sl
            while pos + 8 + self._sl <= size:
                index = struct.unpack_from("<H", data, pos)[0]
                length = _uint(data, pos + 8, self._sl)
                if index == 0:
                    break
                objects[index] = data[pos + 8 + self._sl : pos + 8 + self._sl + length]
                pos += 8 + self._sl + _align8(length)
            self._global_heaps[addr] = objects
        return objects

    # -- messages ------------------------------------------------------ #
    def _datatype(self, data, pos, where):
        """(_Type, end position) of the datatype encoded at ``pos``."""
        cls, version = data[pos] & 0x0F, data[pos] >> 4
        bits = _uint(data, pos + 1, 3)
        size = struct.unpack_from("<I", data, pos + 4)[0]
        end = pos + 8
        if cls == 0:
            precision = struct.unpack_from("<HH", data, end)
            if precision != (0, 8 * size) or size not in (1, 2, 4, 8):
                raise self._unsupported(f"an integer of {size} bytes at bits {precision}", where)
            order = ">" if bits & 1 else "<"
            return _Type(np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")), end + 4
        if cls == 1:
            if bits & 0x40 or size not in (2, 4, 8):
                raise self._unsupported(f"a float of {size} bytes (flags {bits:#x})", where)
            return _Type(np.dtype(f"{'>' if bits & 1 else '<'}f{size}")), end + 12
        if cls == 3:
            return _Type(np.dtype(f"S{size}")), end
        if cls == 8:
            base, end = self._datatype(data, end, where)
            if base.vlen:
                raise self._unsupported("an enum of a variable-length type", where)
            for _ in range(bits & 0xFFFF):
                stop = data.index(b"\0", end) + 1
                end += _align8(stop - end) if version < 3 else stop - end
            return base, end + (bits & 0xFFFF) * size
        if cls == 9:
            if bits & 0x0F != 1:
                raise self._unsupported("a variable-length sequence", where)
            _, end = self._datatype(data, end, where)
            return _Type(np.dtype(object), vlen=True, size=size), end
        raise self._unsupported(f"datatype class {cls}", where)

    def _dataspace(self, data, pos, where):
        version, rank = data[pos], data[pos + 1]
        if version == 1:
            start = pos + 8
        elif version == 2:
            if data[pos + 3] == 2:
                raise self._unsupported("a null dataspace", where)
            start = pos + 4
        else:
            raise self._unsupported(f"dataspace version {version}", where)
        return tuple(_uint(data, start + i * self._sl, self._sl) for i in range(rank))

    def _values(self, kind, raw, shape, decode):
        """The array of ``shape`` stored in ``raw``; variable-length
        strings resolved from the global heap (``str`` when ``decode``,
        else ``bytes``, as h5py gives them for attributes and datasets)."""
        count = int(np.prod(shape, dtype=np.int64))
        if not kind.vlen:
            return np.frombuffer(raw, kind.dtype, count).reshape(shape).copy()
        out = np.empty(count, dtype=object)
        so = self._so
        for i in range(count):
            pos = i * kind.size
            length = struct.unpack_from("<I", raw, pos)[0]
            value = b""
            if length:
                heap = self._global_heap(_uint(raw, pos + 4, so))
                value = heap[struct.unpack_from("<I", raw, pos + 4 + so)[0]][:length]
            out[i] = value.decode("utf-8", "surrogateescape") if decode else value
        return out.reshape(shape)

    def _attributes(self, messages):
        """The attribute messages as a dict, in name order (h5py's)."""
        attrs = {}
        for kind, body, where in messages:
            if kind != ATTRIBUTE:
                continue
            version = body[0]
            if version not in (1, 2, 3):
                raise self._unsupported(f"attribute message version {version}", where)
            if version > 1 and body[1] & 0x3:
                raise self._unsupported("an attribute of a shared type or space", where)
            name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
            pad = _align8 if version == 1 else int
            pos = 8 if version < 3 else 9
            name = body[pos : pos + name_size].split(b"\0", 1)[0].decode("utf-8")
            pos += pad(name_size)
            kind_, _ = self._datatype(body, pos, where)
            pos += pad(type_size)
            shape = self._dataspace(body, pos, where)
            pos += pad(space_size)
            value = self._values(kind_, body[pos:], shape, decode=True)
            attrs[name] = value[()] if shape == () else value
        return dict(sorted(attrs.items()))


class _Type:
    """A datatype: its numpy dtype (``object`` for variable-length
    strings), and the stored size of one element."""

    __slots__ = ("dtype", "vlen", "size")

    def __init__(self, dtype, vlen=False, size=None):
        self.dtype, self.vlen = dtype, vlen
        self.size = dtype.itemsize if size is None else size


class Group:
    """A symbol-table group: ``g[path]``, ``name in g``, ``g.keys()``,
    ``g.attrs``."""

    def __init__(self, file, addr, name, messages):
        self.file, self.addr, self.name = file, addr, name
        body = next(body for kind, body, _ in messages if kind == SYMBOL_TABLE)
        self.btree = _uint(body, 0, file._so)
        self.heap = _uint(body, file._so, file._so)
        self.attrs = file._attributes(messages)
        self._links = None

    def _members(self):
        """{name: object header address} of the group's entries."""
        if self._links is None:
            f = self.file
            size, _, heap_data = f._local_heap(self.heap)
            names = f._read(heap_data, size)
            links = {}
            for _, node in f._btree_leaves(self.btree, f._sl):
                count, entries = f._snod(node)
                for i in range(count):
                    pos = i * f._entry_size
                    offset = _uint(entries, pos, f._so)
                    name = names[offset : names.index(b"\0", offset)].decode("utf-8")
                    links[name] = _uint(entries, pos + f._so, f._so)
            self._links = links
        return self._links

    def keys(self):
        return list(self._members())

    def __getitem__(self, path):
        obj = self
        for part in [p for p in str(path).split("/") if p]:
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name} is a dataset, not a group")
            members = obj._members()
            if part not in members:
                raise KeyError(f"no object {part!r} in {obj.name}")
            obj = self.file._object(members[part], f"{obj.name.rstrip('/')}/{part}")
        return obj

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``, and ``d[lo:hi]``
    (first axis, step 1), ``d[:]`` or ``d[()]`` as numpy arrays."""

    def __init__(self, file, addr, name, messages):
        self.file, self.addr, self.name = file, addr, name
        self._filters, fill, self._chunks = [], None, None
        for kind, body, where in messages:
            if kind == DATASPACE:
                self.shape = file._dataspace(body, 0, where)
            elif kind == DATATYPE:
                self._type, _ = file._datatype(body, 0, where)
            elif kind == LAYOUT:
                self._layout(body, where)
            elif kind == FILTERS:
                self._filters = self._pipeline(body, where)
            elif kind == FILL:
                fill = self._fill_value(body, where)
            elif kind == FILL_OLD and fill is None:
                fill = body[4 : 4 + struct.unpack_from("<I", body, 0)[0]]
        self.dtype = self._type.dtype
        self._fill = fill or b""
        self.attrs = file._attributes(messages)

    def _layout(self, body, where):
        f = self.file
        if body[0] != 3:
            raise f._unsupported(f"data layout version {body[0]}", where)
        self._class = body[1]
        if self._class == 0:
            self._compact = body[4 : 4 + struct.unpack_from("<H", body, 2)[0]]
        elif self._class == 1:
            self._address = f._addr(body, 2)
        elif self._class == 2:
            rank = body[2] - 1
            self._btree_addr = f._addr(body, 3)
            pos = 3 + f._so
            self._chunk_shape = struct.unpack_from(f"<{rank}I", body, pos)
        else:
            raise f._unsupported(f"data layout class {self._class}", where)

    def _pipeline(self, body, where):
        version, count = body[0], body[1]
        if version not in (1, 2):
            raise self.file._unsupported(f"filter pipeline version {version}", where)
        pos, filters = (8 if version == 1 else 2), []
        for _ in range(count):
            fid = struct.unpack_from("<H", body, pos)[0]
            if version == 1 or fid >= 256:
                name_size, _, n_values = struct.unpack_from("<HHH", body, pos + 2)
                pos += 8
            else:
                name_size = 0
                _, n_values = struct.unpack_from("<HH", body, pos + 2)
                pos += 6
            name = body[pos : pos + name_size].split(b"\0", 1)[0].decode("latin-1")
            pos += _align8(name_size) if version == 1 else name_size
            values = struct.unpack_from(f"<{n_values}I", body, pos)
            pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
                raise self.file._unsupported(f"filter {fid} ({name or 'unnamed'})", where)
            filters.append((fid, values))
        return filters

    def _fill_value(self, body, where):
        version = body[0]
        if version not in (1, 2, 3):
            raise self.file._unsupported(f"fill value message version {version}", where)
        if version == 3:
            if not body[1] & 0x20:
                return None
            size, start = struct.unpack_from("<I", body, 2)[0], 6
        elif version == 1 or body[3]:
            size, start = struct.unpack_from("<I", body, 4)[0], 8
        else:
            return None
        return body[start : start + size] or None

    def _fill_array(self, shape):
        if self._type.vlen:
            return np.full(shape, b"", dtype=object)
        out = np.zeros(shape, dtype=self.dtype)
        if self._fill and len(self._fill) == self.dtype.itemsize:
            out[...] = np.frombuffer(self._fill, self.dtype)[0]
        return out

    def __getitem__(self, key):
        if not self.shape:
            if key == () or key is Ellipsis:
                return self._scalar()
            raise TypeError(f"{self.name} is scalar: index it with ()")
        if key == () or key is Ellipsis:
            lo, hi = 0, self.shape[0]
        elif isinstance(key, slice):
            lo, hi, step = key.indices(self.shape[0])
            if step != 1:
                raise NotImplementedError("only slices of step 1 are read")
            hi = max(lo, hi)
        else:
            raise TypeError(f"{self.name}: index with a slice, () or ..., not {key!r}")
        return self._rows(lo, hi)

    def _scalar(self):
        if self._class == 1 and self._address is None:
            return self._fill_array(())[()]
        raw = self._contiguous_bytes(0, self._type.size)
        return self.file._values(self._type, raw, (), decode=False)[()]

    def _contiguous_bytes(self, start, size):
        if self._class == 0:
            return self._compact[start : start + size]
        return self.file._read(self._address + start, size)

    def _rows(self, lo, hi):
        """Rows [lo, hi) of the first axis as an array."""
        tail = self.shape[1:]
        shape = (hi - lo, *tail)
        if hi <= lo:
            return self._fill_array(shape)
        if self._class == 2:
            return self._chunked_rows(lo, hi, shape)
        if self._class == 1 and self._address is None:
            return self._fill_array(shape)
        row = self._type.size * int(np.prod(tail, dtype=np.int64))
        if self._class == 1 and not self._type.vlen:
            out = np.empty(shape, dtype=self.dtype)
            self.file._read_into(self._address + lo * row, out)
            return out
        raw = self._contiguous_bytes(lo * row, (hi - lo) * row)
        return self.file._values(self._type, raw, shape, decode=False)

    # -- chunked ------------------------------------------------------- #
    def _chunk_index(self):
        """Chunk offsets (n, rank), addresses, stored sizes and filter
        masks, sorted by offset: the chunk B-tree walked once."""
        if self._chunks is None:
            f = self.file
            rank = len(self._chunk_shape)
            key_size = 16 + 8 * rank
            leaves = [] if self._btree_addr is None else f._btree_leaves(self._btree_addr, key_size)
            offsets = np.array(
                [struct.unpack_from(f"<{rank}Q", key, 8) for key, _ in leaves], dtype=np.int64
            ).reshape(len(leaves), rank)
            sizes = np.array([struct.unpack_from("<II", key)[0] for key, _ in leaves], np.int64)
            masks = np.array([struct.unpack_from("<II", key)[1] for key, _ in leaves], np.int64)
            addrs = np.array([child for _, child in leaves], dtype=np.uint64)
            order = np.lexsort(offsets.T[::-1])
            self._chunks = (offsets[order], addrs[order], sizes[order], masks[order])
        return self._chunks

    def _chunked_rows(self, lo, hi, shape):
        offsets, addrs, sizes, masks = self._chunk_index()
        chunk = self._chunk_shape
        first = offsets[:, 0]
        sel = np.flatnonzero((first < hi) & (first + chunk[0] > lo))
        expected = -(-hi // chunk[0]) - lo // chunk[0]
        for dim, extent in zip(chunk[1:], self.shape[1:]):
            expected *= -(-extent // dim)
        out = self._fill_array(shape) if len(sel) < expected else np.empty(shape, self.dtype)
        for i in sel:
            raw = self._unfilter(self.file._read(int(addrs[i]), int(sizes[i])), int(masks[i]), i)
            data = self.file._values(self._type, raw, chunk, decode=False)
            dst, src = [], []
            for axis, (start, dim) in enumerate(zip(offsets[i], chunk)):
                a, b = (lo, hi) if axis == 0 else (0, self.shape[axis])
                top = min(start + dim, b)
                begin = max(start, a)
                dst.append(slice(begin - a, top - a))
                src.append(slice(begin - start, top - start))
            out[tuple(dst)] = data[tuple(src)]
        return out

    def _unfilter(self, raw, mask, index):
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, values = self._filters[i]
            if fid == DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == SHUFFLE:
                raw = _unshuffle(raw, values[0] if values else self._type.size)
            else:
                raw = _fletcher32_checked(raw, f"{self.file.filename}:{self.name} chunk {index}")
        return raw


def _unshuffle(raw, size):
    """Undo HDF5's shuffle filter: a byte transpose by the element size
    (trailing bytes that fill no element stay as they are)."""
    n = len(raw) // size
    if size <= 1 or n == 0:
        return raw
    body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
    return body + raw[n * size :]


def _fletcher32_checked(raw, what):
    """``raw`` without its 4-byte fletcher32 checksum, which must match
    (HDF5's ``H5_checksum_fletcher32``, or its byte-swapped form of old
    files; sums compared modulo 65535)."""
    data, stored = raw[:-4], struct.unpack("<I", raw[-4:])[0]
    words = np.frombuffer(data, ">u2", len(data) // 2).astype(np.int64)
    if len(data) % 2:
        words = np.append(words, data[-1] << 8)
    weights = np.arange(len(words), 0, -1, dtype=np.int64) % 65535
    sum1 = int(words.sum() % 65535)
    sum2 = int((words * weights % 65535).sum() % 65535)
    swapped = int.from_bytes(bytes([raw[-3], raw[-4], raw[-1], raw[-2]]), "little")
    for value in (stored, swapped):
        if ((value & 0xFFFF) - sum1) % 65535 == 0 and ((value >> 16) - sum2) % 65535 == 0:
            return data
    raise OSError(f"{what}: fletcher32 checksum mismatch")


# -- writing ----------------------------------------------------------- #
# Files are written with 8-byte offsets and lengths, as h5py writes them.


def _type_message(dtype):
    """The version-1 datatype of a numpy dtype (integers, IEEE floats,
    fixed strings), or of a variable-length UTF-8 string (``str``)."""
    if dtype is str:
        char = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + char
    dtype = np.dtype(dtype)
    order, size = int(dtype.byteorder == ">"), dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        signed = 8 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, order | signed, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        exponent, bias = (8, 127) if size == 4 else (11, 1023)
        mantissa = 8 * size - 1 - exponent
        return struct.pack(
            "<BBBBIHHBBBBI", 0x11, 0x20 | order, 8 * size - 1, 0, size, 0, 8 * size,
            mantissa, exponent, 0, mantissa, bias,
        )
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, size)
    raise TypeError(f"no HDF5 type is written for numpy dtype {dtype}")


def _space_message(shape):
    dims = b"".join(struct.pack("<Q", n) for n in shape)
    return struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + dims + dims


def _message(kind, body):
    body = _pad8(body)
    return struct.pack("<HHB3x", kind, len(body), 0) + body


def _object_header(messages):
    size = sum(len(m) for m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, size) + b"".join(messages)


def _global_heap(items):
    """A global heap collection holding ``items`` (bytes) as objects 1..n,
    at least HDF5's 4096 bytes, the rest one free-space object."""
    body = b"".join(
        struct.pack("<HH4xQ", i + 1, 0, len(item)) + _pad8(item) for i, item in enumerate(items)
    )
    size = max(GLOBAL_HEAP_MIN, _align8(16 + len(body) + 16))
    free = size - 16 - len(body)
    return (
        b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body
        + struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)
    )


class _Appender:
    """Writes blocks at the end of a file, each at an 8-byte boundary."""

    def __init__(self, fd, eof):
        self.fd, self.eof = fd, _align8(eof)

    def put(self, data):
        """Write ``data`` (bytes or a contiguous array) at the end; its
        address."""
        view = memoryview(data).cast("B")
        addr, done = self.eof, 0
        while done < len(view):
            done += os.pwrite(self.fd, view[done:], addr + done)
        self.eof = _align8(addr + len(view))
        return addr

    def finish(self):
        """Extend the file to the end address (the last block's padding)."""
        if os.fstat(self.fd).st_size < self.eof:
            os.ftruncate(self.fd, self.eof)
        return self.eof


def _attribute_messages(attrs, out):
    """Version-1 attribute messages of ``attrs`` (str, ints, floats,
    ``np.bytes_``, numeric arrays; Python ints and floats as int64 and
    float64, as h5py stores them); the strings go into a new global heap
    collection written by ``out``."""
    strings = [v.encode("utf-8") for v in attrs.values() if isinstance(v, str)]
    heap = out.put(_global_heap(strings)) if strings else None
    messages, index = [], 0
    for name, value in attrs.items():
        if isinstance(value, str):
            index += 1
            kind, shape = _type_message(str), ()
            data = struct.pack("<IQI", len(strings[index - 1]), heap, index)
        else:
            array = np.asarray(value)
            if array.dtype.kind not in "iufS":
                raise TypeError(f"attribute {name!r}: no HDF5 type for {type(value).__name__}")
            kind, shape, data = _type_message(array.dtype), array.shape, array.tobytes()
        space = _space_message(shape)
        encoded = name.encode("utf-8") + b"\0"
        body = (
            struct.pack("<BBHHH", 1, 0, len(encoded), len(kind), len(space))
            + _pad8(encoded) + _pad8(kind) + _pad8(space) + data
        )
        messages.append(_message(ATTRIBUTE, body))
    return messages


def _dataset_header(array, out, attrs):
    """Write ``array`` contiguous, then its object header; the header's
    address."""
    data = out.put(array) if array.size else UNDEF
    attributes = _attribute_messages(attrs or {}, out)
    return out.put(_object_header([
        _message(DATASPACE, _space_message(array.shape)),
        _message(DATATYPE, _type_message(array.dtype)),
        # fill value version 2: allocated late, written if set, default
        _message(FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0])),
        _message(LAYOUT, struct.pack("<BBQQ", 3, 1, data, array.nbytes)),
        *attributes,
    ]))


def _entry(name_offset, header, cache=None):
    """A symbol-table entry; ``cache`` the (B-tree, heap) of a group."""
    if cache is None:
        return struct.pack("<QQII16x", name_offset, header, 0, 0)
    return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *cache)


def _write_group(out, tree, attrs):
    """Write the members of ``tree`` ({name: array or subtree}), then the
    group: its local heap, symbol-table nodes, B-tree and object header;
    (header, B-tree, heap) addresses."""
    names = sorted(tree, key=lambda n: n.encode("utf-8"))
    entries = []
    for name in names:
        node = tree[name]
        if isinstance(node, dict):
            header, btree, heap = _write_group(out, node, {})
            entries.append((header, (btree, heap)))
        else:
            entries.append((_dataset_header(np.ascontiguousarray(node), out, None), None))
    heap_data, offsets = bytearray(8), []
    for name in names:
        offsets.append(len(heap_data))
        heap_data += _pad8(name.encode("utf-8") + b"\0")
    free = len(heap_data)
    heap_data += struct.pack("<QQ", FREE_NULL, 64) + bytes(48)
    heap = out.eof
    out.put(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), free, heap + 32) + heap_data)
    per_node = 2 * LEAF_K
    if len(names) > per_node * 2 * INTERNAL_K:
        raise NotImplementedError(f"a group of more than {per_node * 2 * INTERNAL_K} members")
    children, keys = [], [0]
    for start in range(0, len(names), per_node):
        rows = [
            _entry(offsets[i], header, cache)
            for i, (header, cache) in zip(range(start, start + per_node), entries[start:])
        ]
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(rows)) + b"".join(rows)
        children.append(out.put(node + bytes(8 + per_node * 40 - len(node))))
        keys.append(offsets[min(start + per_node, len(names)) - 1])
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(children), UNDEF, UNDEF)
    for key, child in zip(keys, children):
        node += struct.pack("<QQ", key, child)
    node += struct.pack("<Q", keys[-1])
    btree = out.put(node + bytes(24 + (4 * INTERNAL_K + 1) * 8 - len(node)))
    table = struct.pack("<QQ", btree, heap)
    header = out.put(_object_header(
        [_message(SYMBOL_TABLE, table), *_attribute_messages(attrs, out)]
    ))
    return header, btree, heap


def write(path, datasets, attrs=None):
    """Write a new HDF5 file (superblock version 0): ``datasets`` maps
    paths ("bins/start") to numpy arrays of integers, floats or fixed
    strings, stored contiguous in symbol-table groups made from the paths;
    ``attrs`` are the root group's attributes (see
    ``_attribute_messages``)."""
    tree = {}
    for name, array in datasets.items():
        *groups, leaf = [p for p in name.split("/") if p]
        node = tree
        for group in groups:
            node = node.setdefault(group, {})
        node[leaf] = array
    fd = os.open(str(path), os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        out = _Appender(fd, 96)
        header, btree, heap = _write_group(out, tree, dict(attrs or {}))
        eof = out.finish()
        superblock = (
            SIGNATURE + bytes([0, 0, 0, 0, 0, OFFSET_SIZE, LENGTH_SIZE, 0])
            + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
            + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
            + _entry(0, header, (btree, heap))
        )
        os.pwrite(fd, superblock, 0)
    finally:
        os.close(fd)
    return str(path)
