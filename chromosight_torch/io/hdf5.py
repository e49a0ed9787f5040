"""A reader and writer of the HDF5 subset that ``.cool`` and ``.mcool``
files use, in numpy and the standard library (``os.pread``, ``struct``,
``zlib``); the newer formats' shared structures are in ``hdf5_index``.

The port reads and writes cooler files without h5py.  The surface is a
small part of h5py's: ``File(path)``, ``f["pixels/count"]``, ``name in
group``, ``obj.attrs`` (a dict, in h5py's order: by name, or by creation
order where the object tracks it) and ``Dataset`` with ``shape``,
``dtype`` and ``[lo:hi]`` / ``[:]`` slicing along the first axis.
Attribute values come back as h5py gives them: ``str`` for a
variable-length string, ``np.bytes_`` for a fixed-length one, numpy
scalars for numbers, numpy arrays for non-scalar dataspaces; an enum
reads as its base integer type.  ``File.walked`` counts the structures
read, by signature.

What it reads is what h5py writes at every library-version bound
("earliest" to "latest", with default property lists), which covers what
cooler writes:

* superblock versions 0 and 1, and 2 and 3 (lookup3 checksum; the
  superblock extension's B-tree K values), a user block before it;
* version-1 object headers with continuation blocks, and version-2
  object headers (``OHDR``, continuation chunks ``OCHK``, each chunk's
  checksum checked, creation order of messages);
* symbol-table groups (the v1 B-tree of type 0, ``SNOD`` nodes, the local
  heap) and new-style groups: link messages in the header (compact) or
  in a fractal heap under a v2 B-tree name index (dense); hard links;
* attribute messages of versions 1 to 3, in the header or dense (the
  attribute info message: a fractal heap under a v2 B-tree of record
  type 8, managed, tiny and huge heap objects);
* dataspaces of versions 1 and 2 with their maximum dimensions,
  datatypes of class 0 (integers, either byte order), 1 (IEEE floats),
  3 (fixed strings), 8 (enums) and 9 (variable-length strings, from the
  global heap);
* data layout versions 3 and 4: compact, contiguous, and chunked through
  a v1 B-tree of type 1 of any depth, or the chunk indexes of version 4
  (single chunk, implicit, fixed array, extensible array, v2 B-tree of
  record types 10 and 11, partial edge chunks left unfiltered); the
  filters deflate, shuffle, fletcher32 (checked) and LZF (h5py's filter
  32000), honouring each chunk's filter mask; storage not allocated reads
  as the fill value.  The filters run natively where g++ builds them
  (``native/lzf.cpp``, ``shuffle.cpp``, ``inflate.cpp``), else in Python
  and numpy.

Anything else raises ``NotImplementedError`` naming the feature and the
file offset: shared object-header messages and the shared-message
table, soft and external links, virtual and external storage, the
filters scale-offset, n-bit and szip, fractal heaps with I/O filters,
datatypes outside the list above.  Nothing is read wrong silently.  A
contiguous slice reads exactly its bytes; a chunked slice decodes only
the chunks that overlap it, from a chunk index walked once per dataset,
each straight into its rows of the output (those of a deflate or
shuffle + deflate pipeline in one native call on ``THREADS``
threads).

The writer makes new files (``write``: superblock v0, symbol-table
groups with attributes, contiguous datasets or chunked ones in cooler's
layout, attributes of integers, floats and variable-length UTF-8
strings) and adds, replaces or removes a link of an
existing file (``File(path, "r+").write_dataset`` and ``unlink``): the
data and its version-1 object header go at the end of the file; in a
symbol-table group the node and its B-tree key and the local heap are
updated in place (the heap's data segment moves to the end of the file
when it has no room, and a full node splits in two under a one-level
B-tree); in a compact new-style group a link message goes into a NIL
message of the group's version-2 header, or into a new ``OCHK`` chunk at
the end of the file; the superblock's end-of-file address (and, in
versions 2 and 3, its checksum) follows.  A group with dense link
storage, a link past a group's compact limit, and a group B-tree of
more than one level or a full B-tree node raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import struct
import zlib

import numpy as np

from chromosight_torch import native
from chromosight_torch.io import hdf5_index as index

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5, 0x6
LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 0x8, 0xA, 0xB, 0xC
SHARED_TABLE, CONTINUATION, SYMBOL_TABLE, BTREE_K, ATTRIBUTE_INFO = 0xF, 0x10, 0x11, 0x13, 0x15
# messages that say nothing about the data read here (comment, times,
# reference count, file space info)
IGNORED = {NIL, 0x0D, 0x0E, 0x12, 0x16, 0x17}
# messages whose body this module interprets: a shared one lives elsewhere
INTERPRETED = {DATASPACE, DATATYPE, FILL_OLD, FILL, LAYOUT, FILTERS, ATTRIBUTE, LINK_INFO,
               LINK, GROUP_INFO, ATTRIBUTE_INFO, SYMBOL_TABLE, BTREE_K}
DEFLATE, SHUFFLE, FLETCHER32, LZF = 1, 2, 3, 32000
# chunk indexes of data layout version 4
SINGLE_CHUNK, IMPLICIT, FIXED_ARRAY, EXTENSIBLE_ARRAY, BTREE2 = 1, 2, 3, 4, 5
UNLIMITED = (1 << 64) - 1
# local heap free-list terminator (H5HL_FREE_NULL)
FREE_NULL = 1
# group B-tree node sizes of the files this module writes (HDF5's defaults)
LEAF_K, INTERNAL_K = 4, 16
OFFSET_SIZE = LENGTH_SIZE = 8
UNDEF = (1 << 64) - 1
GLOBAL_HEAP_MIN = 4096
# the threads that decode the chunks of a slice (native.inflate_chunks's)
# and compress those that ``write`` writes
THREADS = min(8, os.cpu_count() or 1)


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
        # signatures and structures read, by name (see hdf5_index)
        self.walked = collections.Counter()
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
        self._version = version = head[8]
        if version not in (0, 1, 2, 3):
            raise self._unsupported(f"superblock version {version}", base)
        self._so, self._sl = (head[13], head[14]) if version < 2 else (head[9], head[10])
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise self._unsupported(f"sizes of offsets {self._so} and lengths {self._sl}", base)
        self._undef = (1 << (8 * self._so)) - 1
        so = self._so
        # addresses count from the signature, wherever the stored base
        # address says it is (HDF5's H5F__super_read does the same)
        self._base = base
        self._entry_size = 2 * so + 24
        self.walked[f"superblock v{version}"] += 1
        if version < 2:
            self._leaf_k, self._internal_k = struct.unpack_from("<HH", head, 16)
            pos = 24 if version == 0 else 28
            self._eof_pos = base + pos + 2 * so
            self._eof = _uint(head, pos + 2 * so, so)
            self._root_addr = _uint(head, pos + 5 * so, so)
            return
        # versions 2 and 3: base, extension, end-of-file and root header
        # addresses, then a lookup3 checksum of the whole superblock
        self._sb_size = 12 + 4 * so + 4
        index.checked(self, head[: self._sb_size], 0, f"superblock version {version}")
        self._leaf_k, self._internal_k = LEAF_K, INTERNAL_K
        self._eof_pos = base + 12 + 2 * so
        self._eof = _uint(head, 12 + 2 * so, so)
        self._root_addr = _uint(head, 12 + 3 * so, so)
        extension = self._addr(head, 12 + so)
        if extension is not None:
            for kind, body, where in self._messages(extension):
                if kind == BTREE_K:
                    # version 0: chunk internal K, group internal K, group leaf K
                    self._internal_k, self._leaf_k = struct.unpack_from("<HH", body, 3)

    # -- adding a dataset --------------------------------------------- #
    def write_dataset(self, path, data, attrs=None):
        """Add the dataset ``path`` ("bins/weight"), or replace it, in a
        file opened with ``"r+"``: the array contiguous and its (version 1)
        object header at the end of the file, ``attrs`` its attributes (see
        ``_attribute_messages``).  In a symbol-table group the entry goes
        into its node in name order (a full node is split in two); in a
        new-style group with compact links a link message goes into the
        group's header (see ``_add_link``).  A replaced link points to the
        new header and the old object stays as dead space, as h5py's
        ``del`` leaves it.  The superblock's end-of-file address follows
        (and its checksum, in versions 2 and 3).  A group B-tree of more
        than one level, a full B-tree node and a group with dense link
        storage raise ``NotImplementedError``."""
        if self.mode != "r+":
            raise ValueError(f"{self.filename} is open read-only")
        if self._base or (self._so, self._sl) != (OFFSET_SIZE, LENGTH_SIZE):
            raise self._unsupported("writing to a file with a user block or small offsets", 0)
        parent, _, name = str(path).strip("/").rpartition("/")
        group = self.root[parent]
        if not isinstance(group, Group):
            raise KeyError(f"{parent} is not a group")
        if group.dense:
            raise self._unsupported("adding a link to a group with dense link storage",
                                    group.addr)
        out = _Appender(self._fd, self._eof)
        header = _dataset_header(np.ascontiguousarray(data), out, attrs)
        if group.link_info is None:
            self._link(group, name.encode("utf-8"), header, out)
        else:
            self._add_link(group, name, header, out)
            group.__init__(self, group.addr, group.name, self._messages(group.addr))
        self._eof = out.finish()
        self._write(self._eof_pos, self._eof.to_bytes(self._so, "little"))
        if self._version >= 2:
            head = self._read(0, self._sb_size - 4)
            self._write(self._sb_size - 4, struct.pack("<I", index.lookup3(head)))
        group._links = None

    def unlink(self, path):
        """Remove the link ``path`` from its group, as h5py's ``del`` does
        (the object it pointed to stays as dead space): a link message of
        a compact new-style group becomes a NIL message; a symbol-table
        entry leaves its node (its name stays in the local heap).  A group
        with dense link storage raises ``NotImplementedError``."""
        if self.mode != "r+":
            raise ValueError(f"{self.filename} is open read-only")
        parent, _, name = str(path).strip("/").rpartition("/")
        group = self.root[parent]
        if not isinstance(group, Group) or name not in group._members():
            raise KeyError(f"no link {name!r} in {group.name}")
        if group.dense:
            raise self._unsupported("removing a link from a group with dense link storage",
                                    group.addr)
        if group.link_info is not None:
            if self._read(group.addr, 4) != b"OHDR":
                raise self._unsupported("removing a link from a version-1 object header",
                                        group.addr)
            where = next(where for kind, body, where in group.messages
                         if kind == LINK and self._link_message(body, where)[0] == name)
            self._patch_header(group.addr, where - _v2_hsize(group.messages.flags), bytes([NIL]))
            group.__init__(self, group.addr, group.name, self._messages(group.addr))
        else:
            size, _, heap_data = self._local_heap(group.heap)
            names = self._read(heap_data, size)
            encoded, width = name.encode("utf-8"), self._entry_size
            for _, node in self._btree_leaves(group.btree, self._sl):
                count, raw = self._snod(node)
                rows = [raw[i * width : (i + 1) * width] for i in range(count)]
                keep = [row for row in rows
                        if names[_uint(row, 0, self._so) :].split(b"\0", 1)[0] != encoded]
                if len(keep) < count:
                    if not keep:
                        raise self._unsupported("removing the last entry of a symbol-table node",
                                                node)
                    self._write(node + 6, struct.pack("<H", len(keep)) + b"".join(keep)
                                + bytes(width))
                    break
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
        children = [child for _, child in items]
        child = next((i for i in range(len(items)) if name <= name_at(keys[i + 1])), None)
        if child is None:
            child = len(items) - 1
        node = children[child]
        count, raw = self._snod(node)
        rows = [raw[i * size : (i + 1) * size] for i in range(count)]
        row_names = [name_at(_uint(row, 0, so)) for row in rows]
        if name in row_names:
            i = row_names.index(name)
            rows[i] = _entry(_uint(rows[i], 0, so), header)
            self._write(node + 6, struct.pack("<H", len(rows)) + b"".join(rows))
            return
        if count >= 2 * self._leaf_k and len(items) >= 2 * self._internal_k:
            raise self._unsupported("adding to a full group B-tree node", group.btree)
        offset = self._heap_insert(group.heap, name, out)
        rows.insert(sum(n < name for n in row_names), _entry(offset, header))
        if name > name_at(keys[child + 1]):
            keys[child + 1] = offset
        if count < 2 * self._leaf_k:
            self._write(node + 6, struct.pack("<H", len(rows)) + b"".join(rows))
        else:
            # a full node: the first half stays, the rest goes to a new
            # node after it in the B-tree, keyed by the first half's last
            # name (H5G__node_insert splits the same way)
            half = (len(rows) + 1) // 2
            self._write(node + 6, struct.pack("<H", half) + b"".join(rows[:half]))
            empty = bytes(8 + 2 * self._leaf_k * size)
            right = b"SNOD" + struct.pack("<BBH", 1, 0, len(rows) - half) + b"".join(rows[half:])
            children.insert(child + 1, out.put(right + empty[len(right):]))
            keys.insert(child + 1, _uint(rows[half - 1], 0, so))
        body = b"".join(k.to_bytes(sl, "little") + c.to_bytes(so, "little")
                        for k, c in zip(keys, children)) + keys[-1].to_bytes(sl, "little")
        self._write(group.btree + 6, struct.pack("<H", len(children)))
        self._write(group.btree + 8 + 2 * so, body)

    # -- links in a version-2 object header ------------------------------ #
    def _add_link(self, group, name, header, out):
        """Point the link ``name`` of a compact new-style group at
        ``header``: its address rewritten in place, or a new link message
        in the group's header (creation order from the link info message,
        whose maximum creation index goes up by one; a replaced link of a
        group that tracks creation order is made anew, as h5py's ``del``
        and create make it).  Past the group info's compact limit the
        group would turn dense: that raises."""
        so = self._so
        if self._read(group.addr, 4) != b"OHDR":
            raise self._unsupported("adding a link to a version-1 object header", group.addr)
        where, flags = group.link_info[:2]
        links = sum(kind == LINK for kind, _, _ in group.messages)
        for kind, body, at in group.messages:
            if kind == LINK and self._link_message(body, at)[0] == name:
                target = self._link_message(body, at)[1]
                if isinstance(target, _Soft):
                    raise self._unsupported(f"replacing a {target.kind} link", at)
                if not flags & 0x1:
                    self._patch_header(group.addr, at + len(body) - so,
                                       header.to_bytes(so, "little"))
                    return
                # creation order tracked: the link is made anew, last, as
                # h5py's del and create order it
                self._patch_header(group.addr, at - _v2_hsize(group.messages.flags),
                                   bytes([NIL]))
                links -= 1
        if links + 1 > group.max_compact:
            raise self._unsupported(
                f"adding a link past the compact limit of {group.max_compact} (dense link storage)",
                group.addr)
        encoded = name.encode("utf-8")
        width = 0 if len(encoded) < 256 else 1
        # version 1, flags: name length width, creation order, UTF-8
        body = bytearray([1, width])
        if flags & 0x1:
            order = struct.unpack_from("<q", self._read(where + 2, 8))[0]
            self._patch_header(group.addr, where + 2, struct.pack("<q", order + 1))
            body[1] |= 0x4
            body += struct.pack("<q", order)
        if not encoded.isascii():
            body[1] |= 0x10
            body.append(1)
        body += len(encoded).to_bytes(1 << width, "little") + encoded
        body += header.to_bytes(so, "little")
        self._add_message(group.addr, LINK, bytes(body), out)

    def _patch_header(self, addr, at, data):
        """Write ``data`` at file address ``at``, inside the version-2
        object header at ``addr``, and update that chunk's checksum."""
        _, chunks = self._v2_chunks(addr)
        for caddr, chunk, _ in chunks:
            if caddr <= at and at + len(data) <= caddr + len(chunk) - 4:
                chunk = bytearray(chunk)
                chunk[at - caddr : at - caddr + len(data)] = data
                chunk[-4:] = struct.pack("<I", index.lookup3(chunk[:-4]))
                self._write(caddr, chunk)
                return
        raise OSError(f"{self.filename}: offset {at} is not inside the object header at {addr}")

    def _add_message(self, addr, kind, body, out):
        """Put a message into the version-2 object header at ``addr``: into
        a NIL message that holds it (the rest stays NIL), or else into a new
        ``OCHK`` chunk at the end of the file, reached through a
        continuation message that takes the place of a NIL message or of
        a message moved into the new chunk with it."""
        flags, chunks = self._v2_chunks(addr)
        hsize = _v2_hsize(flags)

        def message(kind, body):
            head = struct.pack("<BHB", kind, len(body), 0) + (bytes(2) if hsize == 6 else b"")
            return head + body

        def fits(size, need):
            return size == need or size - need >= hsize

        slots = [(c, at, k, size) for c, (_, data, start) in enumerate(chunks)
                 for at, k, size, _ in _v2_slots(data, start, flags)]
        nil = next(((c, at, size) for c, at, k, size in slots
                    if k == NIL and fits(size, len(body))), None)
        if nil is None:
            cont = 2 * self._so
            nil = next(((c, at, size) for c, at, k, size in slots
                        if k == NIL and fits(size, cont)), None)
            moved = b""
            if nil is None:
                slot = next((s for s in reversed(slots)
                             if s[2] not in (NIL, CONTINUATION) and fits(s[3], cont)), None)
                if slot is None:
                    raise self._unsupported("an object header with no room for a continuation",
                                            addr)
                c, at, _, size = slot
                nil = (c, at, size)
                data = chunks[c][1]
                moved = data[at : at + hsize + size]
            block = b"OCHK" + moved + message(kind, body)
            block += struct.pack("<I", index.lookup3(block))
            target = out.put(block)
            kind = CONTINUATION
            body = struct.pack("<QQ", target, len(block))
        c, at, size = nil
        caddr, data, _ = chunks[c]
        data = bytearray(data)
        new = message(kind, body)
        if size > len(body):
            new += message(NIL, bytes(size - len(body) - hsize))
        data[at : at + len(new)] = new
        data[-4:] = struct.pack("<I", index.lookup3(data[:-4]))
        self._write(caddr, data)

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
        object header at ``addr`` (version 1, or version 2 with its
        checksums), continuation blocks followed, as a ``_Header``."""
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            return self._messages_v2(addr)
        if prefix[0] != 1:
            raise self._unsupported(f"object header version {prefix[0]}", addr)
        self.walked["object header v1"] += 1
        blocks = [(addr + 16, struct.unpack_from("<I", prefix, 8)[0])]
        messages = _Header()
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
                else:
                    self._keep(messages, kind, flags, body, where)
        return messages

    def _keep(self, messages, kind, flags, body, where):
        if kind in INTERPRETED:
            if flags & 0x2:
                raise self._unsupported(f"a shared message of type 0x{kind:04x}", where)
            messages.append((kind, body, where))
        elif kind == SHARED_TABLE:
            raise self._unsupported("a shared-message table", where)
        elif kind not in IGNORED:
            raise self._unsupported(f"object header message type 0x{kind:04x}", where)

    def _v2_chunks(self, addr):
        """The chunks of the version-2 object header at ``addr``: its flags
        and a list of (chunk address, chunk bytes with checksum, offset of
        the first message); each chunk's checksum checked."""
        head = self._read(addr, 6)
        flags = head[5]
        if head[4] != 2:
            raise self._unsupported(f"object header version {head[4]}", addr)
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 0x3)
        size = _uint(self._read(addr + pos, width), 0, width)
        first = index.checked(self, self._read(addr, pos + width + size + 4), addr, "OHDR")
        chunks = [(addr, first, pos + width)]
        self.walked["OHDR"] += 1
        for caddr, data, start in chunks:
            for at, kind, size, _ in _v2_slots(data, start, flags):
                if kind == CONTINUATION:
                    body = data[at + _v2_hsize(flags) :]
                    target = _uint(body, 0, self._so)
                    length = _uint(body, self._so, self._sl)
                    block = index.checked(self, self._read(target, length), target, "OCHK")
                    if block[:4] != b"OCHK":
                        raise OSError(f"{self.filename}: no OCHK at file offset {target}")
                    self.walked["OCHK"] += 1
                    chunks.append((target, block, 4))
        return flags, chunks

    def _messages_v2(self, addr):
        flags, chunks = self._v2_chunks(addr)
        messages = _Header(flags)
        hsize = _v2_hsize(flags)
        for caddr, data, start in chunks:
            for at, kind, size, mflags in _v2_slots(data, start, flags):
                if kind == CONTINUATION:
                    continue
                where = caddr + at + hsize
                body = data[at + hsize : at + hsize + size]
                if flags & 0x4:
                    messages.orders[where] = struct.unpack_from("<H", data, at + 4)[0]
                self._keep(messages, kind, mflags, body, where)
        return messages

    def _object(self, addr, name):
        obj = self._objects.get(addr)
        if obj is None:
            messages = self._messages(addr)
            kinds = {kind for kind, _, _ in messages}
            if SYMBOL_TABLE in kinds or LINK_INFO in kinds:
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
        return self._dataspace_dims(data, pos, where)[0]

    def _dataspace_dims(self, data, pos, where):
        """(dimensions, maximum dimensions) of the dataspace at ``pos``;
        an unlimited maximum is ``UNLIMITED``."""
        version, rank, flags = data[pos], data[pos + 1], data[pos + 2]
        if version == 1:
            start = pos + 8
        elif version == 2:
            if data[pos + 3] == 2:
                raise self._unsupported("a null dataspace", where)
            start = pos + 4
        else:
            raise self._unsupported(f"dataspace version {version}", where)
        sl = self._sl
        dims = tuple(_uint(data, start + i * sl, sl) for i in range(rank))
        if not flags & 0x1:
            return dims, dims
        top = (1 << (8 * sl)) - 1
        maxdims = tuple(_uint(data, start + (rank + i) * sl, sl) for i in range(rank))
        return dims, tuple(UNLIMITED if m == top else m for m in maxdims)

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
        """The attributes of an object header as a dict, compact (attribute
        messages) or dense (a fractal heap under a v2 B-tree of records of
        type 8), in h5py's order: by name, or by creation order where the
        header tracks it."""
        found = []  # (creation order, name, value)
        for kind, body, where in messages:
            if kind == ATTRIBUTE:
                found.append((messages.orders.get(where, 0), *self._attribute(body, where)))
            elif kind == ATTRIBUTE_INFO:
                found.extend(self._dense_attributes(body, where))
        if messages.flags & 0x4:
            found.sort(key=lambda item: item[0])
        else:
            found.sort(key=lambda item: item[1].encode("utf-8"))
        return {name: value for _, name, value in found}

    def _dense_attributes(self, body, where):
        if body[0] != 0:
            raise self._unsupported(f"attribute info message version {body[0]}", where)
        pos = 2 + (2 if body[1] & 0x1 else 0)
        heap_addr, names = self._addr(body, pos), self._addr(body, pos + self._so)
        if heap_addr is None:
            return []
        heap, tree = index.FractalHeap(self, heap_addr), index.BTree2(self, names)
        if tree.type != 8:
            raise self._unsupported(f"an attribute name index of record type {tree.type}", names)
        found = []
        for record in tree.records():
            # heap ID (8), message flags (1), creation order (4), name hash (4)
            if record[8] & 0x2:
                raise self._unsupported("a shared attribute in dense storage", names)
            message = heap.get(record[:8], heap_addr)
            order = struct.unpack_from("<I", record, 9)[0]
            found.append((order, *self._attribute(message, heap_addr)))
        return found

    def _attribute(self, body, where):
        """(name, value) of an attribute message."""
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
        kind, _ = self._datatype(body, pos, where)
        pos += pad(type_size)
        shape = self._dataspace(body, pos, where)
        pos += pad(space_size)
        value = self._values(kind, body[pos:], shape, decode=True)
        return name, value[()] if shape == () else value

    def _link_message(self, body, where):
        """(name, target, creation order) of a link message: ``target`` the
        object header address of a hard link, a ``_Soft`` otherwise."""
        if body[0] != 1:
            raise self._unsupported(f"link message version {body[0]}", where)
        flags, pos = body[1], 2
        kind = 0
        if flags & 0x8:
            kind, pos = body[pos], pos + 1
        order = None
        if flags & 0x4:
            order, pos = struct.unpack_from("<q", body, pos)[0], pos + 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 0x3)
        length = _uint(body, pos, width)
        pos += width
        name = body[pos : pos + length].decode("utf-8")
        pos += length
        if kind == 0:
            return name, _uint(body, pos, self._so), order
        return name, _Soft({1: "soft", 64: "external"}.get(kind, f"type {kind}"), where), order

class _Type:
    """A datatype: its numpy dtype (``object`` for variable-length
    strings), and the stored size of one element."""

    __slots__ = ("dtype", "vlen", "size")

    def __init__(self, dtype, vlen=False, size=None):
        self.dtype, self.vlen = dtype, vlen
        self.size = dtype.itemsize if size is None else size


class _Header(list):
    """The messages of an object header, a list of (type, body, file
    offset of the body); ``flags`` of a version-2 header (bit 2: the
    creation order of attributes is tracked) and ``orders``, the
    creation order of each message by its body's offset."""

    def __init__(self, flags=0):
        super().__init__()
        self.flags, self.orders = flags, {}


def _v2_hsize(flags):
    """Size of a message's header in a version-2 object header."""
    return 6 if flags & 0x4 else 4


def _v2_slots(data, start, flags):
    """(offset, type, body size, message flags) of the messages of a
    version-2 header chunk (``data`` ends in its checksum) from
    ``start``; a gap shorter than a message header ends the chunk."""
    hsize, end, pos = _v2_hsize(flags), len(data) - 4, start
    out = []
    while pos + hsize <= end:
        kind, size, mflags = data[pos], struct.unpack_from("<H", data, pos + 1)[0], data[pos + 3]
        if pos + hsize + size > end:
            raise OSError(f"message of {size} bytes past the end of its header chunk")
        out.append((pos, kind, size, mflags))
        pos += hsize + size
    return out


class _Soft:
    """A soft or external link: what it is and where its message is."""

    __slots__ = ("kind", "where")

    def __init__(self, kind, where):
        self.kind, self.where = kind, where


class Group:
    """A group, symbol-table (``btree`` and ``heap``) or new-style (link
    messages, compact in its header or dense in a fractal heap):
    ``g[path]``, ``name in g``, ``g.keys()``, ``g.attrs``."""

    def __init__(self, file, addr, name, messages):
        self.file, self.addr, self.name = file, addr, name
        self.btree = self.heap = None
        self.link_info = None
        so = file._so
        for kind, body, where in messages:
            if kind == SYMBOL_TABLE:
                self.btree, self.heap = _uint(body, 0, so), _uint(body, so, so)
            elif kind == LINK_INFO:
                if body[0] != 0:
                    raise file._unsupported(f"link info message version {body[0]}", where)
                pos = 2 + (8 if body[1] & 0x1 else 0)
                # (offset of the message body, flags, fractal heap, name index)
                self.link_info = (where, body[1], file._addr(body, pos),
                                  file._addr(body, pos + so))
        self.max_compact = next(
            (struct.unpack_from("<H", body, 2)[0] for kind, body, _ in messages
             if kind == GROUP_INFO and body[1] & 0x1), 8)
        self.messages = messages
        self.attrs = file._attributes(messages)
        self._links = None

    @property
    def dense(self):
        return self.link_info is not None and self.link_info[2] is not None

    def _members(self):
        """{name: object header address (or ``_Soft``)} of the group's
        links, by name or, where the group tracks it, by creation order."""
        if self._links is None:
            f = self.file
            if self.link_info is None:
                self._links = self._symbol_table()
                return self._links
            if self.dense:
                _, _, heap_addr, names = self.link_info
                heap, tree = index.FractalHeap(f, heap_addr), index.BTree2(f, names)
                if tree.type != 5:
                    raise f._unsupported(f"a link name index of record type {tree.type}", names)
                found = [f._link_message(heap.get(r[4:], heap_addr), heap_addr)
                         for r in tree.records()]
            else:
                found = [f._link_message(body, where) for kind, body, where in self.messages
                         if kind == LINK]
            if self.link_info[1] & 0x1:
                found.sort(key=lambda link: link[2])
            else:
                found.sort(key=lambda link: link[0].encode("utf-8"))
            self._links = {name: target for name, target, _ in found}
        return self._links

    def _symbol_table(self):
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
                if _uint(entries, pos + 2 * f._so, 4) == 2:
                    # cache type 2: a soft link, its value in the local heap
                    links[name] = _Soft("soft", node + 8 + pos)
                else:
                    links[name] = _uint(entries, pos + f._so, f._so)
        return links

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
            target = members[part]
            if isinstance(target, _Soft):
                raise self.file._unsupported(f"a {target.kind} link {part!r}", target.where)
            obj = self.file._object(target, f"{obj.name.rstrip('/')}/{part}")
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
        self._index_type, self._edge_unfiltered = None, False
        for kind, body, where in messages:
            if kind == DATASPACE:
                self.shape, self.maxshape = file._dataspace_dims(body, 0, where)
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
        version = body[0]
        if version not in (3, 4):
            raise f._unsupported(f"data layout version {version}", where)
        self._class = body[1]
        if self._class == 0:
            self._compact = body[4 : 4 + struct.unpack_from("<H", body, 2)[0]]
        elif self._class == 1:
            self._address = f._addr(body, 2)
        elif self._class == 2 and version == 3:
            rank = body[2] - 1
            self._btree_addr = f._addr(body, 3)
            pos = 3 + f._so
            self._chunk_shape = struct.unpack_from(f"<{rank}I", body, pos)
        elif self._class == 2:
            self._layout_v4(body, where)
        else:
            name = {3: " (virtual)"}.get(self._class, "")
            raise f._unsupported(f"data layout class {self._class}{name}", where)

    def _layout_v4(self, body, where):
        """A chunked layout of version 4: chunk dimensions of ``body[4]``
        bytes each (the last is the element size), then the chunk index's
        type, parameters and address."""
        f = self.file
        flags, dims, width = body[2], body[3], body[4]
        pos = 5
        self._chunk_shape = tuple(_uint(body, pos + i * width, width) for i in range(dims - 1))
        pos += dims * width
        self._index_type = kind = body[pos]
        pos += 1
        self._edge_unfiltered = bool(flags & 0x1)
        self._single = None
        if kind == SINGLE_CHUNK:
            if flags & 0x2:
                self._single = (_uint(body, pos, f._sl), struct.unpack_from("<I", body,
                                                                             pos + f._sl)[0])
                pos += f._sl + 4
        elif kind == FIXED_ARRAY:
            pos += 1
        elif kind == EXTENSIBLE_ARRAY:
            pos += 5
        elif kind == BTREE2:
            pos += 6
        elif kind != IMPLICIT:
            raise f._unsupported(f"chunk index type {kind}", where)
        self._index_addr = f._addr(body, pos)
        self._layout_where = where

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
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32, LZF):
                name = name or {4: "szip", 5: "nbit", 6: "scaleoffset"}.get(fid, "unnamed")
                raise self.file._unsupported(f"filter {fid} ({name})", where)
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
    @property
    def _chunk_bytes(self):
        return self._type.size * int(np.prod(self._chunk_shape, dtype=np.int64))

    def _chunk_grid(self, dims):
        """Chunks along each axis for dimensions ``dims``."""
        return [-(-int(d) // c) for d, c in zip(dims, self._chunk_shape)]

    def _chunk_index(self):
        """Chunk offsets (n, rank), addresses, stored sizes and filter
        masks, sorted by offset, of the chunks inside the dataset: the
        chunk index walked once."""
        if self._chunks is None:
            rank = len(self._chunk_shape)
            if self._index_type is None:
                offsets, addrs, sizes, masks = self._btree1_chunks(rank)
            else:
                offsets, addrs, sizes, masks = self._v4_chunks(rank)
                if not self._filters:
                    sizes = np.full(len(addrs), self._chunk_bytes, np.int64)
            offsets = np.asarray(offsets, np.int64).reshape(len(addrs), rank)
            inside = np.all(offsets < np.array(self.shape, np.int64), axis=1)
            offsets, addrs = offsets[inside], np.asarray(addrs, np.uint64)[inside]
            sizes, masks = np.asarray(sizes, np.int64)[inside], np.asarray(masks, np.int64)[inside]
            if self._edge_unfiltered and self._filters:
                edge = np.any(offsets + np.array(self._chunk_shape) > np.array(self.shape), axis=1)
                masks[edge] = -1
                sizes[edge] = self._chunk_bytes
            order = np.lexsort(offsets.T[::-1])
            self._chunks = (offsets[order], addrs[order], sizes[order], masks[order])
        return self._chunks

    def _btree1_chunks(self, rank):
        """The chunks of a version-3 layout, from its v1 B-tree of type 1."""
        f = self.file
        key_size = 16 + 8 * rank
        leaves = [] if self._btree_addr is None else f._btree_leaves(self._btree_addr, key_size)
        offsets = [struct.unpack_from(f"<{rank}Q", key, 8) for key, _ in leaves]
        sizes = [struct.unpack_from("<II", key)[0] for key, _ in leaves]
        masks = [struct.unpack_from("<II", key)[1] for key, _ in leaves]
        return offsets, [child for _, child in leaves], sizes, masks

    def _v4_chunks(self, rank):
        """The chunks of a version-4 layout, from its chunk index."""
        f, kind, addr = self.file, self._index_type, self._index_addr
        chunk = np.array(self._chunk_shape, np.int64)
        nothing = (np.zeros((0, rank), np.int64), [], [], [])
        f.walked[f"chunk index {kind}"] += 1
        if addr is None:
            return nothing
        if kind == SINGLE_CHUNK:
            size, mask = self._single or (self._chunk_bytes, 0)
            return np.zeros((1, rank), np.int64), [addr], [size], [mask]
        if kind == BTREE2:
            return self._btree2_chunks(rank, chunk)
        if kind == IMPLICIT:
            grid = self._chunk_grid(self.maxshape)
            linear = np.arange(int(np.prod(grid)), dtype=np.int64)
            addrs = np.uint64(addr) + linear.astype(np.uint64) * np.uint64(self._chunk_bytes)
            return self._unravel(linear, grid) * chunk, addrs, [0] * len(linear), [0] * len(linear)
        where = self._layout_where
        if kind == FIXED_ARRAY:
            linear, addrs, sizes, masks = index.fixed_array(f, addr, self._chunk_bytes, where)
            offsets = self._unravel(linear, self._chunk_grid(self.maxshape)) * chunk
            return offsets, addrs, sizes, masks
        linear, addrs, sizes, masks = index.extensible_array(f, addr, self._chunk_bytes, where)
        # H5D__earray: the linear index runs over the chunk grid with the
        # unlimited axis moved first (the slowest)
        unlimited = [i for i, m in enumerate(self.maxshape) if m == UNLIMITED]
        if len(unlimited) != 1:
            raise f._unsupported("an extensible-array index without one unlimited axis", where)
        axis = unlimited[0]
        grid = self._chunk_grid(self.maxshape)
        order = [axis] + [i for i in range(rank) if i != axis]
        grid[axis] = 1 << 62
        swizzled = self._unravel(linear, [grid[i] for i in order])
        offsets = np.empty_like(swizzled)
        offsets[:, order] = swizzled
        return offsets * chunk, addrs, sizes, masks

    @staticmethod
    def _unravel(linear, grid):
        """Row-major chunk coordinates (n, rank) of linear indexes."""
        out = np.empty((len(linear), len(grid)), np.int64)
        rest = np.asarray(linear, np.int64)
        for axis in reversed(range(len(grid))):
            out[:, axis] = rest % grid[axis]
            rest = rest // grid[axis]
        return out

    def _btree2_chunks(self, rank, chunk):
        """Chunks from a v2 B-tree of records of type 10 (address, scaled
        offsets) or 11 (address, size, filter mask, scaled offsets)."""
        f = self.file
        tree = index.BTree2(f, self._index_addr)
        records = tree.records()
        so = f._so
        if tree.type == 10:
            fields = [(0, so)] + [(so + 8 * i, 8) for i in range(rank)]
            width = so + 8 * rank
        elif tree.type == 11:
            size_len = index.chunk_size_len(self._chunk_bytes)
            base = so + size_len + 4
            fields = [(0, so), (so, size_len), (so + size_len, 4)] + [
                (base + 8 * i, 8) for i in range(rank)]
            width = base + 8 * rank
        else:
            raise f._unsupported(f"a chunk B-tree of record type {tree.type}", self._index_addr)
        if tree.record_size != width:
            raise f._unsupported(f"chunk B-tree records of {tree.record_size} bytes",
                                 self._index_addr)
        columns = index.uints(b"".join(records), len(records), width, fields)
        scaled = np.stack(columns[-rank:], axis=1).astype(np.int64).reshape(len(records), rank)
        if tree.type == 10:
            zeros = [0] * len(records)
            return scaled * chunk, columns[0], zeros, zeros
        return scaled * chunk, columns[0], columns[1].astype(np.int64), columns[2].astype(np.int64)

    def _chunked_rows(self, lo, hi, shape):
        offsets, addrs, sizes, masks = self._chunk_index()
        chunk = self._chunk_shape
        first = offsets[:, 0]
        sel = np.flatnonzero((first < hi) & (first + chunk[0] > lo))
        expected = -(-hi // chunk[0]) - lo // chunk[0]
        for dim, extent in zip(chunk[1:], self.shape[1:]):
            expected *= -(-extent // dim)
        out = self._fill_array(shape) if len(sel) < expected else np.empty(shape, self.dtype)
        lzf = [i for i, (fid, _) in enumerate(self._filters) if fid == LZF]
        if lzf:
            self.file.walked["LZF chunk"] += int(np.sum(masks[sel] & (1 << lzf[0]) == 0))
        if self._type.vlen or tuple(chunk[1:]) != tuple(self.shape[1:]):
            for i in sel:
                raw = self._decode(int(addrs[i]), int(sizes[i]), int(masks[i]), i)
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
        # chunks of whole rows: each chunk's rows are a run of ``out``'s
        # bytes, which a chunk inside [lo, hi) is decoded straight into,
        # natively on threads where the pipeline allows
        # (``_inflate_native``), the others here one by one
        row = self._type.size * int(np.prod(chunk[1:], dtype=np.int64))
        flat = out.reshape(-1).view(np.uint8)
        whole = (offsets[sel, 0] >= lo) & (offsets[sel, 0] + chunk[0] <= hi) & (masks[sel] == 0)
        if self._inflate_native(flat, (offsets[sel[whole], 0] - lo) * row, addrs[sel[whole]],
                                sizes[sel[whole]]):
            sel = sel[~whole]

        for i in sel:
            start = int(offsets[i, 0])
            begin, top = max(start, lo), min(start + chunk[0], hi)
            dst = flat[(begin - lo) * row : (top - lo) * row]
            if top - begin == chunk[0]:
                self._decode(int(addrs[i]), int(sizes[i]), int(masks[i]), i, dst)
            else:
                raw = self._decode(int(addrs[i]), int(sizes[i]), int(masks[i]), i)
                dst[:] = np.frombuffer(raw, np.uint8, len(dst), (begin - start) * row)
        return out

    def _inflate_native(self, flat, starts, addrs, sizes):
        """The chunks stored at ``addrs`` (``sizes`` bytes, every filter
        on) of a deflate or shuffle + deflate pipeline, read in runs of
        nearby chunks and decoded by ``native.inflate_chunks`` into
        ``flat`` at ``starts``: whether it decoded them (False for another
        pipeline, without the native library, or on a chunk it could not
        decode, which the caller's decoding then reports)."""
        kinds = [fid for fid, _ in self._filters]
        if kinds not in ([DEFLATE], [SHUFFLE, DEFLATE]) or not len(addrs):
            return False
        element = 1
        if kinds[0] == SHUFFLE:
            element = self._filters[0][1][0] if self._filters[0][1] else self._type.size
        order = np.argsort(addrs)
        addrs, sizes, starts = addrs[order].astype(np.int64), sizes[order], starts[order]
        # a new run where the next chunk starts past a gap of 64 KiB
        ends = addrs + sizes
        breaks = np.flatnonzero(addrs[1:] - ends[:-1] > 1 << 16) + 1
        firsts, lasts = np.r_[0, breaks], np.r_[breaks, len(addrs)] - 1
        spans = ends[lasts] - addrs[firsts]
        buf = np.empty(int(spans.sum()), np.uint8)
        bases = np.r_[0, np.cumsum(spans)[:-1]]
        in_off = np.empty(len(addrs), np.int64)
        for first, last, base, span in zip(firsts, lasts, bases, spans):
            self.file._read_into(int(addrs[first]), buf[base : base + span])
            in_off[first : last + 1] = base + addrs[first : last + 1] - addrs[first]
        return native.inflate_chunks(buf, in_off, sizes, flat, starts, self._chunk_bytes,
                                     element, THREADS)

    def _decode(self, addr, size, mask, index, into=None):
        """The bytes of the chunk ``index`` (``size`` bytes stored at
        ``addr``) through the filters that ``mask`` leaves on, in reverse
        pipeline order; written into ``into`` (a uint8 array of the
        chunk's bytes) when given."""
        on = [i for i in range(len(self._filters)) if not mask & (1 << i)]
        if not on and into is not None and size == len(into):
            self.file._read_into(addr, into)
            return into
        raw = self.file._read(addr, size)
        for i in reversed(on):
            fid, values = self._filters[i]
            if fid == DEFLATE:
                raw = zlib.decompress(raw, bufsize=self._chunk_bytes)
            elif fid == LZF:
                n_out = values[2] if len(values) > 2 and values[2] else self._chunk_bytes
                raw = native.lzf_decompress(raw, n_out)
            elif fid == SHUFFLE:
                element = values[0] if values else self._type.size
                if i == on[0] and into is not None and len(raw) == len(into):
                    return native.unshuffle(raw, element, into)
                raw = native.unshuffle(raw, element)
            else:
                raw = _fletcher32_checked(raw, f"{self.file.filename}:{self.name} chunk {index}")
        if into is not None:
            if len(raw) < len(into):
                raise OSError(f"{self.file.filename}:{self.name} chunk {index}: {len(raw)} "
                              f"bytes decoded, {len(into)} expected")
            into[:] = np.frombuffer(raw, np.uint8, len(into))
        return raw


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


def enum_dtype(mapping, basetype=np.int32):
    """The numpy dtype of an HDF5 enum ({name: value} over the integer
    ``basetype``), as h5py's ``enum_dtype`` makes it: arrays of it are
    written as an enum (``bins/chrom`` in cooler's layout)."""
    return np.dtype(np.dtype(basetype).str, metadata={"enum": dict(mapping)})


def _type_message(dtype):
    """The version-1 datatype of a numpy dtype (integers, IEEE floats,
    fixed strings, enums of ``enum_dtype``), or of a variable-length UTF-8
    string (``str``)."""
    if dtype is str:
        char = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + char
    dtype = np.dtype(dtype)
    if dtype.metadata and "enum" in dtype.metadata:
        # an enum (``enum_dtype``): its integer base type, then the
        # members' names (null-terminated, 8-byte aligned) and values, in
        # the order of their values
        base = np.dtype(dtype.str)
        members = sorted(dtype.metadata["enum"].items(), key=lambda item: item[1])
        names = b"".join(_pad8(name.encode("utf-8") + b"\0") for name, _ in members)
        values = np.array([value for _, value in members], base).tobytes()
        count = struct.pack("<H", len(members))
        return (struct.pack("<BccBI", 0x18, count[:1], count[1:], 0, base.itemsize)
                + _type_message(base) + names + values)
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


def _space_message(shape, unlimited=False):
    """A version-1 dataspace of ``shape``; its maximum the shape, or
    unlimited along the first axis."""
    dims = b"".join(struct.pack("<Q", n) for n in shape)
    top = dims
    if unlimited:
        top = struct.pack("<Q", UNDEF) + dims[8:]
    return struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + dims + top


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


def _dataset_header(array, out, attrs, chunk=None, pool=None):
    """Write ``array``, then its object header; the header's address.  The
    array is contiguous, or with ``chunk`` (rows) chunked as cooler writes
    (see ``_chunked_data``)."""
    if chunk is None:
        data = out.put(array) if array.size else UNDEF
        layout = [_message(LAYOUT, struct.pack("<BBQQ", 3, 1, data, array.nbytes))]
        # fill value version 2: allocated late, written if set, default
        fill = bytes([2, 2, 2, 1, 0, 0, 0, 0])
    else:
        layout = _chunked_data(array, int(chunk), out, pool)
        fill = bytes([2, 3, 2, 1, 0, 0, 0, 0])  # allocated incrementally
    attributes = _attribute_messages(attrs or {}, out)
    return out.put(_object_header([
        _message(DATASPACE, _space_message(array.shape, unlimited=chunk is not None)),
        _message(DATATYPE, _type_message(array.dtype)),
        _message(FILL, fill),
        *layout,
        *attributes,
    ]))


# chunk B-trees of the files this module writes: HDF5's default K for
# chunked datasets (a node holds up to 2K entries; superblock version 0
# stores no K for them)
CHUNK_K = 32
DEFLATE_LEVEL = 6


def _chunked_data(array, rows, out, pool):
    """Write ``array`` as chunks of ``rows`` rows (the trailing axes whole;
    the last chunk padded with zeros), each through HDF5's shuffle and then
    deflate at level 6, and a version-1 chunk B-tree of type 1 over them
    with as many levels as their count needs; the filter pipeline and
    layout (version 3, class 2) messages.  The chunks are compressed on
    ``pool`` when given; the bytes written do not depend on it."""
    tail, element = array.shape[1:], array.dtype.itemsize
    row = element * int(np.prod(tail, dtype=np.int64))
    flat = array.reshape(-1).view(np.uint8) if array.size else np.zeros(0, np.uint8)
    n_chunks = -(-array.shape[0] // rows) if array.shape and array.shape[0] else 0
    size = rows * row

    def compress(batch):
        done = []
        for k in batch:
            raw = flat[k * size : (k + 1) * size]
            if len(raw) < size:
                raw = np.concatenate([raw, np.zeros(size - len(raw), np.uint8)])
            shuffled = np.empty(size, np.uint8)
            native.shuffle(raw, element, shuffled)
            done.append(zlib.compress(shuffled, DEFLATE_LEVEL))
        return done

    batches = [range(k, min(k + 16, n_chunks)) for k in range(0, n_chunks, 16)]
    results = pool.map(compress, batches) if pool is not None else map(compress, batches)
    rank = len(array.shape)
    keys, children = [], []
    for batch, done in zip(batches, results):
        for k, data in zip(batch, done):
            children.append(out.put(data))
            keys.append(struct.pack(f"<II{rank + 1}Q", len(data), 0, k * rows, *[0] * rank))
    # the key after the last chunk: the end of its rows, and 1 in the
    # element dimension (as HDF5 writes it)
    keys.append(struct.pack(f"<II{rank + 1}Q", 0, 0, n_chunks * rows, *[0] * (rank - 1),
                            element))
    btree = _chunk_btree(keys, children, rank, out) if children else UNDEF
    pipeline = struct.pack("<BB6x", 1, 2)
    for fid, name, value in ((SHUFFLE, b"shuffle", element), (DEFLATE, b"deflate",
                                                                 DEFLATE_LEVEL)):
        # id, name length, flags (optional), one value, name, value, pad
        pipeline += struct.pack("<HHHH", fid, 8, 1, 1) + name + b"\0" + struct.pack(
            "<I4x", value)
    dims = struct.pack(f"<{rank + 1}I", rows, *tail, element)
    layout = struct.pack("<BBBQ", 3, 2, rank + 1, btree) + dims
    return [_message(FILTERS, pipeline), _message(LAYOUT, layout)]


def _chunk_btree(keys, children, rank, out):
    """Write a version-1 B-tree of type 1 (chunks) over ``children`` (chunk
    addresses, in order) and ``keys`` (one per chunk and one past the
    last): leaves of up to 2 * CHUNK_K chunks, then levels of nodes over
    them until one node holds the rest, each level's nodes adjacent and
    linked to their siblings, each node at its full size; the root's
    address."""
    per_node = 2 * CHUNK_K
    key_size = 8 + 8 * (rank + 1)
    node_size = 24 + per_node * 8 + (per_node + 1) * key_size
    level = 0
    while True:
        starts = range(0, len(children), per_node)
        base = _align8(out.eof)
        addrs = [base + i * node_size for i in range(len(starts))]
        up_keys = []
        for i, start in enumerate(starts):
            stop = min(start + per_node, len(children))
            left = addrs[i - 1] if i else UNDEF
            right = addrs[i + 1] if i + 1 < len(addrs) else UNDEF
            node = b"TREE" + struct.pack("<BBHQQ", 1, level, stop - start, left, right)
            node += b"".join(keys[j] + struct.pack("<Q", children[j]) for j in range(start, stop))
            node += keys[stop]
            put = out.put(node + bytes(node_size - len(node)))
            if put != addrs[i]:
                raise RuntimeError(f"chunk B-tree node written at {put}, not {addrs[i]}")
            up_keys.append(keys[start])
        if len(addrs) == 1:
            return addrs[0]
        keys, children = up_keys + [keys[-1]], addrs
        level += 1


def _entry(name_offset, header, cache=None):
    """A symbol-table entry; ``cache`` the (B-tree, heap) of a group."""
    if cache is None:
        return struct.pack("<QQII16x", name_offset, header, 0, 0)
    return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *cache)


def _write_group(out, tree, attrs, path="", chunks=None, group_attrs=None, pool=None):
    """Write the members of ``tree`` ({name: array or subtree}), then the
    group at ``path``: its local heap, symbol-table nodes, B-tree and
    object header; (header, B-tree, heap) addresses.  ``chunks`` and
    ``group_attrs`` are ``write``'s, by path from the root."""
    chunks, group_attrs = chunks or {}, group_attrs or {}
    names = sorted(tree, key=lambda n: n.encode("utf-8"))
    entries = []
    for name in names:
        node, where = tree[name], f"{path}/{name}".strip("/")
        if isinstance(node, dict):
            header, btree, heap = _write_group(out, node, group_attrs.get(where, {}), where,
                                               chunks, group_attrs, pool)
            entries.append((header, (btree, heap)))
        else:
            header = _dataset_header(np.ascontiguousarray(node), out, None, chunks.get(where),
                                     pool)
            entries.append((header, None))
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


def write(path, datasets, attrs=None, *, chunks=None, group_attrs=None):
    """Write a new HDF5 file (superblock version 0): ``datasets`` maps
    paths ("bins/start", "resolutions/5000/pixels/count") to numpy arrays
    of integers, floats, fixed strings or enums (``enum_dtype``), in
    symbol-table groups made from the paths; ``attrs`` are the root
    group's attributes and ``group_attrs`` {group path: attributes} those
    of other groups (see ``_attribute_messages``).  A dataset is stored
    contiguous, or, where ``chunks`` {path: rows} names it, chunked in
    cooler's layout: chunks of that many rows, shuffle then deflate at
    level 6, unlimited along the first axis (see ``_chunked_data``),
    compressed on ``THREADS`` threads; the bytes written do not depend on
    the thread count."""
    tree = {}
    for name, array in datasets.items():
        *groups, leaf = [p for p in name.split("/") if p]
        node = tree
        for group in groups:
            node = node.setdefault(group, {})
        node[leaf] = array
    chunks = {name.strip("/"): rows for name, rows in (chunks or {}).items()}
    group_attrs = {name.strip("/"): a for name, a in (group_attrs or {}).items()}
    pool = concurrent.futures.ThreadPoolExecutor(THREADS) if chunks and THREADS > 1 else None
    fd = os.open(str(path), os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        out = _Appender(fd, 96)
        header, btree, heap = _write_group(out, tree, dict(attrs or {}), "", chunks,
                                           group_attrs, pool)
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
        if pool is not None:
            pool.shutdown()
    return str(path)
