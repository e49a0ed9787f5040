"""A reader and writer of the HDF5 subset that ``.cool`` and ``.mcool``
files use, in numpy and the standard library (``os.pread``, ``struct``,
``zlib``); the newer formats' shared structures are read in
``hdf5_index`` and written in ``hdf5_write``.

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
("earliest" to "latest", with default property lists and the others
below), which covers what cooler writes:

* superblock versions 0 and 1, and 2 and 3 (lookup3 checksum; the
  superblock extension's B-tree K values and shared-message table), a
  user block before it;
* version-1 object headers with continuation blocks, and version-2
  object headers (``OHDR``, continuation chunks ``OCHK``, each chunk's
  checksum checked, creation order of messages); shared messages (in
  another object's header, or in the fractal heap of the shared-message
  table ``SMTB``), committed datatypes;
* symbol-table groups (the v1 B-tree of type 0, ``SNOD`` nodes, the local
  heap) and new-style groups: link messages in the header (compact) or
  in a fractal heap under a v2 B-tree name index (dense); hard links,
  soft links (followed as h5py follows them) and external links (the
  file opened from the linking file's directory, else the working
  directory, with this file's mode, and closed with it; a missing file is
  a ``KeyError``, more than ``LINK_DEPTH`` links a ``RuntimeError``, as
  in h5py);
* attribute messages of versions 1 to 3, in the header or dense (the
  attribute info message: a fractal heap under a v2 B-tree of record
  type 8, managed, tiny and huge heap objects), shared or not;
* dataspaces of versions 1 and 2 with their maximum dimensions,
  datatypes of class 0 (integers, either byte order, fewer significant
  bits converted as h5py converts them), 1 (IEEE floats; n-bit floats of
  a shorter mantissa), 3 (fixed strings), 8 (enums) and 9
  (variable-length strings, from the global heap);
* data layout versions 3 and 4: compact, contiguous (in the file or in
  external raw files, found as external links are), and chunked through
  a v1 B-tree of type 1 of any depth, or the chunk indexes of version 4
  (single chunk, implicit, fixed array, extensible array, v2 B-tree of
  record types 10 and 11, partial edge chunks left unfiltered); the
  filters deflate, shuffle, fletcher32 (checked), szip (CCSDS 121.0-B as
  libaec's szlib layer codes it), n-bit, scale-offset and LZF (h5py's
  filter 32000), honouring each chunk's filter mask; storage not
  allocated reads as the fill value.  The filters run natively where g++
  builds them (``native/lzf.cpp``, ``shuffle.cpp``, ``inflate.cpp``,
  ``bits.cpp``, ``aec.cpp``), else in Python and numpy;
* virtual datasets (layout class 3): the mappings in their global heap
  object (checksum checked), selections "all" and hyperslabs of rows
  whose other axes are whole, sources in this file (".") or in files
  found as external links' are (opened with this file's mode, closed with
  it); a missing source file or dataset, and rows no mapping covers, read
  as the fill value, as in h5py.  Unlimited hyperslabs along the first
  axis resolve as HDF5 resolves them when it opens the dataset
  (``H5D__virtual_set_extent_unlim``, its default view and printf gap):
  as many rows as the source's selection holds within its current
  extent, or, for printf-style names (``%b`` the block number, ``%%`` a
  ``%``), one source per block up to the first that is missing; the
  dataset's first dimension follows.

Anything else raises ``NotImplementedError`` naming the feature and the
file offset: fractal heaps with I/O filters, n-bit of compound or array
types, datatypes outside the list above, virtual datasets with point
selections (HDF5 makes none), unlimited selections along an inner axis
or of irregular blocks, selections of part of an inner axis or mappings
deeper than ``LINK_DEPTH``.  Nothing is read
wrong silently.  A contiguous slice reads exactly its bytes; a chunked
slice decodes only the chunks that overlap it, from a chunk index walked
once per dataset, each straight into its rows of the output (those of a
deflate or szip pipeline, shuffled first or not, in one native call on
``THREADS`` threads); a virtual slice reads only the mappings that
overlap it, each through its source's own slicing.

The writer makes new files (``write``: at ``libver="earliest"``
superblock 0, symbol-table groups, data layout 3; at ``libver="latest"``
what h5py writes at that bound: superblock 3, version-2 object headers,
new-style groups of compact or dense links, version-3 attribute
messages, compact or dense, layout 4 with the chunk index HDF5 picks;
attributes of integers, floats and variable-length UTF-8 strings,
contiguous datasets or chunked ones in cooler's layout, shuffle + gzip
or shuffle + szip) and adds,
replaces or removes a link in any group of an existing file
(``File(path, "r+").write_dataset`` and ``unlink``, what ``--norm
force`` and ICE's ``store_weights`` call): the data and its version-1
object header go at the end of the file; a symbol-table group gets new
nodes and a new B-tree of any depth (its cached address follows); a
new-style group keeps its link messages in its header (version 1 or 2)
up to its compact limit, a NIL message made or filled, or a new
continuation block; past the limit, or already dense, its links are
stored anew in a new fractal heap and v2 B-tree indexes, as HDF5 stores
them; replaced structures stay as dead space, as h5py's ``del`` leaves
them; the superblock's end-of-file address (and, in versions 2 and 3,
its checksum) follows.  Every address and length is written in the
file's sizes of offsets and lengths (2, 4 or 8 bytes) and counts from
its user block's end; a write that would end past what its offsets
address raises ``OSError`` (EFBIG) before a byte of it is written.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import struct
import zlib

import numpy as np

from chromosight_torch import native, observability
from chromosight_torch.io import hdf5_index as index
from chromosight_torch.io import hdf5_write as hw

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5, 0x6
EXTERNAL, LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 0x7, 0x8, 0xA, 0xB, 0xC
SHARED_TABLE, CONTINUATION, SYMBOL_TABLE, BTREE_K, ATTRIBUTE_INFO = 0xF, 0x10, 0x11, 0x13, 0x15
# messages that say nothing about the data read here (comment, times,
# reference count, file space info)
IGNORED = {NIL, 0x0D, 0x0E, 0x12, 0x16, 0x17}
# messages whose body this module interprets: a shared one lives elsewhere
INTERPRETED = {DATASPACE, DATATYPE, FILL_OLD, FILL, LAYOUT, FILTERS, ATTRIBUTE, LINK_INFO,
               LINK, GROUP_INFO, ATTRIBUTE_INFO, SYMBOL_TABLE, BTREE_K, EXTERNAL, SHARED_TABLE}
DEFLATE, SHUFFLE, FLETCHER32, SZIP, NBIT, SCALEOFFSET, LZF = 1, 2, 3, 4, 5, 6, 32000
# HDF5's default limit of soft and external links followed in one lookup
LINK_DEPTH = 16
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
# the threads that decode the chunks of a slice (native.inflate_chunks's
# and szip_chunks's) and compress those that ``write`` writes
THREADS = min(8, os.cpu_count() or 1)


_align8 = hw.align8


def _pad8(data):
    return data + b"\0" * (_align8(len(data)) - len(data))


def _uint(data, pos, size):
    return int.from_bytes(data[pos : pos + size], "little")


class File:
    """An HDF5 file, opened read-only (``mode="r"``) or for adding
    datasets (``"r+"``).  ``f[path]`` gives a ``Group`` or a ``Dataset``;
    ``f.attrs`` are the root group's attributes."""

    def __init__(self, path, mode="r", _externals=None):
        if mode not in ("r", "r+"):
            raise ValueError(f"mode must be 'r' or 'r+', not {mode!r}")
        self.filename = str(path)
        self.mode = mode
        self._fd = None
        # the files external links open, by real path: opened with this
        # file's mode, shared by every file reached from it, closed with it
        self._owner = _externals is None
        self._externals = {} if _externals is None else _externals
        self._fd = os.open(self.filename, os.O_RDONLY if mode == "r" else os.O_RDWR)
        self._externals.setdefault(os.path.realpath(self.filename), self)
        self._objects = {}
        self._global_heaps = {}
        self._sohm = {}  # the shared-message heap of each message type
        self._sohm_heaps = {}
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
        if getattr(self, "_owner", False):
            for other in self._externals.values():
                if other is not self:
                    other.close()
            self._externals.clear()

    def _external(self, name, where, missing_ok=False):
        """The file an external link (or a virtual dataset's mapping) names:
        an absolute path as it is, a relative one in this file's directory,
        else from the working directory (HDF5's default lookup); when there
        is none, None if ``missing_ok``, else KeyError."""
        tries = [name] if os.path.isabs(name) else [
            os.path.join(os.path.dirname(os.path.abspath(self.filename)), name), name]
        path = next((t for t in tries if os.path.isfile(t)), None)
        if path is None:
            if missing_ok:
                return None
            raise KeyError(f"{self.filename}: the external link at file offset {where} names "
                           f"{name!r}, which is not found")
        key = os.path.realpath(path)
        if key not in self._externals:
            self._externals[key] = File(path, self.mode, _externals=self._externals)
        self.walked["external file"] += 1
        return self._externals[key]

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
        # a symbol-table entry: name offset (a length), header address,
        # cache type, reserved, 16 bytes of scratch pad
        self._entry_size = self._sl + so + 24
        self.walked[f"superblock v{version}"] += 1
        if version < 2:
            self._leaf_k, self._internal_k = struct.unpack_from("<HH", head, 16)
            pos = 24 if version == 0 else 28
            self._eof_pos = pos + 2 * so
            self._root_entry = pos + 4 * so
            # the end-of-file address counts from the file's start
            # (H5F__super_read compares it with the base plus the size)
            self._eof = _uint(head, pos + 2 * so, so) - base
            self._root_addr = _uint(head, pos + 4 * so + self._sl, so)
            return
        # versions 2 and 3: base, extension, end-of-file and root header
        # addresses, then a lookup3 checksum of the whole superblock
        self._sb_size = 12 + 4 * so + 4
        index.checked(self, head[: self._sb_size], 0, f"superblock version {version}")
        self._leaf_k, self._internal_k = LEAF_K, INTERNAL_K
        self._eof_pos = 12 + 2 * so
        self._eof = _uint(head, 12 + 2 * so, so) - base
        self._root_addr = _uint(head, 12 + 3 * so, so)
        extension = self._addr(head, 12 + so)
        if extension is not None:
            for kind, body, where in self._messages(extension):
                if kind == BTREE_K:
                    # version 0: chunk internal K, group internal K, group leaf K
                    self._internal_k, self._leaf_k = struct.unpack_from("<HH", body, 3)
                elif kind == SHARED_TABLE:
                    self._shared_table(body, where)

    def _shared_table(self, body, where):
        """The superblock extension's shared-message table (``SMTB``): the
        fractal heap that holds the shared messages of each type."""
        if body[0] != 0:
            raise self._unsupported(f"shared message table message version {body[0]}", where)
        addr, count = self._addr(body, 1), body[1 + self._so]
        so, size = self._so, 1 + 1 + 2 + 4 + 2 + 2 + 2 + 2 * self._so
        data = index.checked(self, self._read(addr, 4 + count * size + 4), addr, "SMTB")
        if data[:4] != b"SMTB":
            raise OSError(f"{self.filename}: no SMTB at file offset {addr}")
        self.walked["SMTB"] += 1
        for i in range(count):
            pos = 4 + i * size
            flags = struct.unpack_from("<H", data, pos + 2)[0]
            heap = self._addr(data, pos + 14 + so)
            for kind in range(16):
                if flags & (1 << kind):
                    self._sohm[kind] = heap

    def _sohm_get(self, kind, heap_id, where):
        """The message of type ``kind`` stored at ``heap_id`` in the fractal
        heap of the shared-message table."""
        heap = self._sohm.get(kind)
        if heap is None:
            raise OSError(f"{self.filename}: a shared message of type 0x{kind:04x} at file "
                          f"offset {where} and no shared-message heap for it")
        self.walked["shared message in a heap"] += 1
        if heap not in self._sohm_heaps:
            self._sohm_heaps[heap] = index.FractalHeap(self, heap)
        return self._sohm_heaps[heap].get(heap_id, where)

    def _shared(self, kind, body, where):
        """The body of the message of type ``kind`` that the shared message
        ``body`` stands for: in another object's header (versions 1 to 3)
        or, version 3, in the fractal heap of the shared-message table."""
        version, stored = body[0], body[1]
        self.walked["shared message"] += 1
        if version == 3 and stored == 1:
            return self._sohm_get(kind, body[2:10], where)
        if version in (1, 2) or (version == 3 and stored == 2):
            addr = self._addr(body, 8 if version == 1 else 2)
            found = next((b for k, b, _ in self._messages(addr) if k == kind), None)
            if found is None:
                raise OSError(f"{self.filename}: the shared message at file offset {where} "
                              f"points to an object header without a message of type {kind}")
            return found
        raise self._unsupported(f"a shared message of version {version}, type {stored}", where)

    # -- adding a dataset --------------------------------------------- #
    def write_dataset(self, path, data, attrs=None):
        """Add the dataset ``path`` ("bins/weight"), or replace it, in a
        file opened with ``"r+"``: the array contiguous and its (version 1)
        object header at the end of the file, ``attrs`` its attributes (see
        ``_attribute_messages``), the link stored by ``_store_link``.  A
        replaced link points to the new header and the old object stays as
        dead space, as h5py's ``del`` leaves it.  The superblock's
        end-of-file address follows (and its checksum, in versions 2 and
        3).  A group reached through an external link is written in its
        own file."""
        group, name = self._parent(path)
        f = group.file
        out = f._appender()
        header = _dataset_header(np.ascontiguousarray(data), out, attrs)
        f._store_link(group, name, header, out)

    def unlink(self, path):
        """Remove the link ``path`` from its group, as h5py's ``del`` does
        (the object it pointed to stays as dead space; see
        ``_store_link``)."""
        group, name = self._parent(path)
        if name not in group._members():
            raise KeyError(f"no link {name!r} in {group.name}")
        f = group.file
        f._store_link(group, name, None, f._appender())

    def _parent(self, path):
        """(group, link name) of ``path`` in a file open for writing."""
        if self.mode != "r+":
            raise ValueError(f"{self.filename} is open read-only")
        parent, _, name = str(path).strip("/").rpartition("/")
        group = self.root[parent]
        if not isinstance(group, Group):
            raise KeyError(f"{parent} is not a group")
        if group.file.mode != "r+":
            raise ValueError(f"{group.file.filename} is open read-only")
        return group, name

    def _appender(self):
        """An ``hdf5_write.Appender`` at the end of this file, in its user
        block's base and its sizes of offsets and lengths."""
        return hw.Appender(self._fd, self._eof, self._base, self._so, self._sl)

    def _store_link(self, group, name, header, out):
        """Point the link ``name`` of ``group`` at the object header
        ``header`` (None: remove the link).  A symbol-table group gets new
        nodes and a new B-tree of as many levels as its entries need (the
        name goes into its local heap, see ``_heap_insert``); a new-style
        group keeps its link messages in its header while they stay within
        its compact limit (``_store_compact``), else its links are stored
        dense anew (``_store_dense``).  The new structures go at the end of
        the file and the old ones stay as dead space; the superblock's
        end-of-file address (and checksum) follows."""
        if group.link_info is None:
            self._store_symbol_table(group, name, header, out)
        else:
            count = len(group._members()) - (name in group._members()) + (header is not None)
            if not group.dense and count <= group.max_compact:
                self._store_compact(group, name, header, out)
            else:
                self._store_dense(group, name, header, out)
        if self._read(group.addr, 4) == b"OHDR":
            self._tidy(group.addr)
        self._eof = out.finish()
        self._write(self._eof_pos, (self._base + self._eof).to_bytes(self._so, "little"))
        if self._version >= 2:
            head = self._read(0, self._sb_size - 4)
            self._write(self._sb_size - 4, struct.pack("<I", index.lookup3(head)))
        group.__init__(self, group.addr, group.name, self._messages(group.addr))

    # -- symbol-table groups ------------------------------------------- #
    def _store_symbol_table(self, group, name, header, out):
        """The entries of a symbol-table group with ``name`` added,
        replaced or removed, in new nodes under a new B-tree (see
        ``hdf5_write.symbol_table``); the group's symbol-table message and
        the B-tree address cached in its entry (in its parent's node, or
        the superblock's root entry) point to it."""
        so = self._so
        heap_size, _, heap_data = self._local_heap(group.heap)
        names = self._read(heap_data, heap_size)
        encoded = name.encode("utf-8")
        _, items, _ = self._btree(group.btree, self._sl)
        first_key = _uint(items[0][0], 0, self._sl) if items else 0
        rows = []
        for _, node in self._btree_leaves(group.btree, self._sl):
            count, raw = self._snod(node)
            for i in range(count):
                row = raw[i * self._entry_size : (i + 1) * self._entry_size]
                offset = _uint(row, 0, self._sl)
                rows.append((names[offset : names.index(b"\0", offset)], row))
        old = [row for key, row in rows if key == encoded]
        rows = [(key, row) for key, row in rows if key != encoded]
        if header is not None:
            offset = _uint(old[0], 0, self._sl) if old else self._heap_insert(group.heap, encoded, out)
            rows.append((encoded, _entry(offset, header, so=so, sl=self._sl)))
        rows.sort(key=lambda item: item[0])
        btree = hw.symbol_table(out, [row for _, row in rows],
                                [_uint(row, 0, self._sl) for _, row in rows], first_key,
                                self._leaf_k, self._internal_k)
        where = next(at for kind, _, at in group.messages if kind == SYMBOL_TABLE)
        self._patch(group.addr, where, btree.to_bytes(so, "little"))
        self._cache_btree(group, btree)

    def _cache_btree(self, group, btree):
        """Write ``btree`` into the scratch pad of the symbol-table entries
        that cache ``group``'s symbol table: the superblock's root entry,
        or the group's entry in its parent's nodes."""
        if group.addr == self._root_addr:
            entry = self._root_entry if self._version < 2 else None
            cache = self._sl + self._so  # the cache type's place in an entry
            if entry is not None and _uint(self._read(entry + cache, 4), 0, 4) == 1:
                self._write(entry + cache + 8, btree.to_bytes(self._so, "little"))
            return
        parent = self.root[group.name.rsplit("/", 1)[0] or "/"]
        if parent.file is not self or parent.link_info is not None:
            return
        for _, node in self._btree_leaves(parent.btree, self._sl):
            count, raw = self._snod(node)
            for i in range(count):
                pos = i * self._entry_size
                cache = pos + self._sl + self._so
                if (_uint(raw, pos + self._sl, self._so) == group.addr
                        and _uint(raw, cache, 4) == 1):
                    self._write(node + 8 + cache + 8, btree.to_bytes(self._so, "little"))

    # -- new-style groups ---------------------------------------------- #
    def _link_body(self, group, name, header):
        """The body of a hard link message from ``name`` to ``header``,
        with the next creation order of a group that tracks it (the link
        info message's maximum creation index goes up by one)."""
        where, flags = group.link_info[:2]
        order = None
        if flags & 0x1:
            order = struct.unpack_from("<q", self._read(where + 2, 8))[0]
            self._patch(group.addr, where + 2, struct.pack("<q", order + 1))
        return _hard_link(name, header, order, so=self._so)

    def _store_compact(self, group, name, header, out):
        """A link message of a compact new-style group: its address
        rewritten in place, or the message made NIL and (unless removing)
        a new link message put into the group's header (see
        ``_add_message``), last in creation order where the group tracks
        it, as h5py's ``del`` and create order it."""
        flags = group.link_info[1]
        for kind, body, at in group.messages:
            if kind != LINK:
                continue
            link = self._link_message(body, at)
            if link[0] != name:
                continue
            if header is not None and not flags & 0x1 and not isinstance(link[1], _Soft):
                self._patch(group.addr, at + link[3] - self._so, header.to_bytes(self._so,
                                                                                "little"))
                return
            self._nil(group.addr, at)
        if header is not None:
            self._add_message(group.addr, LINK, self._link_body(group, name, header), out)

    def _store_dense(self, group, name, header, out):
        """The links of a new-style group with ``name`` added, replaced or
        removed, stored dense anew (``_dense_links``: a creation-order
        index where the group indexes creation order); the link messages
        of a compact header made NIL and the link info message pointed at
        the new structures."""
        where, flags = group.link_info[:2]
        links = [(n, order, body) for n, order, body in self._link_bodies(group) if n != name]
        if header is not None:
            body = self._link_body(group, name, header)
            links.append((name, self._link_message(body, 0)[2], body))
        try:
            heap, names, orders = _dense_links(out, links, bool(flags & 0x2))
        except NotImplementedError as err:
            raise self._unsupported(f"storing the links of {group.name} dense ({err})",
                                    group.addr) from None
        info = bytearray(self._read(where, 2 + (8 if flags & 0x1 else 0)))
        info += out.o(heap) + out.o(names)
        if orders is not None:
            info += out.o(orders)
        if not group.dense:
            for kind, _, at in group.messages:
                if kind == LINK:
                    self._nil(group.addr, at)
        self._patch(group.addr, where, bytes(info))

    def _link_bodies(self, group):
        """(name, creation order, message body) of each link of a
        new-style group, in h5py's order, each body cut to its fields."""
        f = self
        if group.dense:
            _, _, heap_addr, names = group.link_info[:4]
            heap = index.FractalHeap(f, heap_addr)
            raw = [heap.get(r[4:], heap_addr) for r in index.BTree2(f, names).records()]
        else:
            raw = [body for kind, body, _ in group.messages if kind == LINK]
        found = []
        for body in raw:
            name, _, order, end = f._link_message(body, group.addr)
            found.append((name, order, bytes(body[:end])))
        if group.link_info[1] & 0x1:
            found.sort(key=lambda link: link[1])
        else:
            found.sort(key=lambda link: link[0].encode("utf-8"))
        return found

    # -- object header edits ------------------------------------------- #
    def _patch(self, addr, at, data):
        """Write ``data`` at file address ``at`` inside the object header at
        ``addr``: in place in a version-1 header, through ``_patch_header``
        (its chunk's checksum updated) in a version-2 one."""
        if self._read(addr, 4) == b"OHDR":
            self._patch_header(addr, at, data)
        else:
            self._write(at, data)

    def _tidy(self, addr):
        """Rewrite each chunk of the version-2 object header at ``addr``
        that holds NIL messages and a gap (HDF5 refuses a chunk with both:
        it merges a gap into a NIL message): its other messages first, in
        their order, then one NIL message over the rest."""
        flags, chunks = self._v2_chunks(addr)
        hsize = _v2_hsize(flags)
        for caddr, data, start in chunks:
            slots = _v2_slots(data, start, flags)
            end = slots[-1][0] + hsize + slots[-1][2] if slots else start
            if end == len(data) - 4 or not any(kind == NIL for _, kind, _, _ in slots):
                continue
            kept = b"".join(data[at : at + hsize + size] for at, kind, size, _ in slots
                            if kind != NIL)
            rest = len(data) - 4 - start - len(kept)
            chunk = bytearray(data[:start] + kept)
            chunk += struct.pack("<BHB", NIL, rest - hsize, 0) + bytes(rest - 4)
            chunk += struct.pack("<I", index.lookup3(chunk))
            self._write(caddr, chunk)

    def _nil(self, addr, at):
        """Make the message whose body is at ``at`` in the object header at
        ``addr`` a NIL message."""
        if self._read(addr, 4) == b"OHDR":
            flags = self._read(addr, 6)[5]
            self._patch_header(addr, at - _v2_hsize(flags), bytes([NIL]))
        else:
            self._write(at - 8, struct.pack("<H", NIL))

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
        """Put a message into the object header at ``addr``: into a NIL
        message that holds it (the rest stays NIL), or else into a new
        continuation block (``OCHK`` in a version-2 header) at the end of
        the file, reached through a continuation message that takes the
        place of a NIL message or of a message moved into the new block
        with it."""
        if self._read(addr, 4) != b"OHDR":
            return self._add_message_v1(addr, kind, body, out)
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
            cont = self._so + self._sl
            nil = next(((c, at, size) for c, at, k, size in slots
                        if k == NIL and fits(size, cont)), None)
            moved = b""
            if nil is None:
                # the shortest run of messages that ends a chunk and has
                # room for the continuation goes into the new chunk
                run = _trailing_run([(c, at, k, hsize + size) for c, at, k, size in slots],
                                    lambda span: fits(span - hsize, cont))
                if run is None:
                    raise self._unsupported("an object header with no room for a continuation",
                                            addr)
                c, at, span = run
                data = chunks[c][1]
                moved = b"".join(data[a : a + hsize + z] for cc, a, k, z in slots
                                 if cc == c and at <= a < at + span and k != NIL)
                nil = (c, at, span - hsize)
            block = b"OCHK" + moved + message(kind, body)
            block += struct.pack("<I", index.lookup3(block))
            target = out.put(block)
            kind = CONTINUATION
            body = out.o(target) + out.n(len(block))
        c, at, size = nil
        caddr, data, _ = chunks[c]
        data = bytearray(data)
        new = message(kind, body)
        if size > len(body):
            new += message(NIL, bytes(size - len(body) - hsize))
        data[at : at + len(new)] = new
        data[-4:] = struct.pack("<I", index.lookup3(data[:-4]))
        self._write(caddr, data)

    def _add_message_v1(self, addr, kind, body, out):
        """``_add_message`` in a version-1 object header: bodies padded to
        8 bytes, a continuation block of bare messages, and the header's
        message count kept (HDF5 checks it)."""
        body = _pad8(body)
        slots = []  # (block, message header address, type, body size)
        prefix = self._read(addr, 16)
        blocks = [(addr + 16, struct.unpack_from("<I", prefix, 8)[0])]
        while blocks:
            start, length = blocks.pop(0)
            block = self._read(start, length)
            pos = 0
            while pos + 8 <= length:
                k, size = struct.unpack_from("<HH", block, pos)
                slots.append((start, start + pos, k, size))
                if k == CONTINUATION:
                    blocks.append((_uint(block, pos + 8, self._so),
                                   _uint(block, pos + 8 + self._so, self._sl)))
                pos += 8 + size
        count = struct.unpack_from("<H", prefix, 2)[0]

        def fits(size, need):
            return size == need or size - need >= 8

        def put(at, size, kind, data):
            """A message of ``data`` in the slot of ``size`` bytes at ``at``,
            the rest a NIL message; the messages added."""
            new = struct.pack("<HHB3x", kind, len(data), 0) + data
            if size > len(data):
                new += struct.pack("<HHB3x", NIL, size - len(data) - 8, 0)
            self._write(at, new)
            return int(size > len(data))

        nil = next(((at, size) for _, at, k, size in slots if k == NIL and fits(size, len(body))),
                   None)
        if nil is not None:
            count += put(*nil, kind, body)
        else:
            cont = _align8(self._so + self._sl)
            nil = next(((at, size) for _, at, k, size in slots if k == NIL and fits(size, cont)),
                       None)
            # messages added: the continuation, the new message (and a NIL
            # message left over, counted by ``put``), less the NIL messages
            # a moved run drops
            moved, added = b"", 1
            if nil is None:
                run = _trailing_run([(b, at, k, 8 + size) for b, at, k, size in slots],
                                    lambda span: fits(span - 8, cont))
                if run is None:
                    raise self._unsupported("an object header with no room for a continuation",
                                            addr)
                _, at, span = run
                inside = [(a, k, z) for _, a, k, z in slots if at <= a < at + span]
                moved = b"".join(self._read(a, 8 + z) for a, k, z in inside if k != NIL)
                nil = (at, span - 8)
                added = 2 - sum(k == NIL for _, k, _ in inside)
            block = moved + struct.pack("<HHB3x", kind, len(body), 0) + body
            target = out.put(block)
            count += added + put(*nil, CONTINUATION, _pad8(out.o(target) + out.n(len(block))))
        self._write(addr + 2, struct.pack("<H", count))

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
            data[start : start + 2 * sl] = out.n(following) + out.n(length)
        if moved:
            data_addr = out.put(bytes(data))
        else:
            self._write(data_addr, data)
        head = blocks[0][0] if blocks else FREE_NULL
        self._write(heap + 8, out.n(size) + out.n(head) + out.o(data_addr))
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
                body = self._shared(kind, body, where)
            messages.append((kind, body, where))
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
            elif DATATYPE in kinds:
                obj = Datatype(self, addr, name, messages)
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
            # the collection's and each object's header, 8-byte aligned
            # (H5HG_SIZEOF_HDR, H5HG_SIZEOF_OBJHDR)
            hdr = _align8(8 + self._sl)
            objects, pos = {}, hdr
            while pos + hdr <= size:
                index = struct.unpack_from("<H", data, pos)[0]
                length = _uint(data, pos + 8, self._sl)
                if index == 0:
                    break
                objects[index] = data[pos + hdr : pos + hdr + length]
                pos += hdr + _align8(length)
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
            offset, precision = struct.unpack_from("<HH", data, end)
            if size not in (1, 2, 4, 8) or not precision or offset + precision > 8 * size:
                raise self._unsupported(f"an integer of {size} bytes at bits "
                                        f"{(offset, precision)}", where)
            order = ">" if bits & 1 else "<"
            kind = _Type(np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"))
            if (offset, precision) != (0, 8 * size):
                # fewer significant bits (an n-bit type): read as h5py
                # converts them, shifted down and sign-extended
                kind.convert = _int_bits(offset, precision, bool(bits & 8))
            return kind, end + 4
        if cls == 1:
            if bits & 0x40 or size not in (2, 4, 8):
                raise self._unsupported(f"a float of {size} bytes (flags {bits:#x})", where)
            kind = _Type(np.dtype(f"{'>' if bits & 1 else '<'}f{size}"))
            offset, precision, epos, esize, mpos, msize, bias = struct.unpack_from(
                "<HHBBBBI", data, end)
            native_fields = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}[size]
            sign = (bits >> 8) & 0xFF
            if (offset, precision, sign, epos, mpos, msize) != (0, 8 * size, 8 * size - 1,
                                                              native_fields[0], 0,
                                                              native_fields[2]):
                # IEEE's exponent with a shorter mantissa, its fields where
                # the type puts them (an n-bit float): read as HDF5
                # converts it, the mantissa's bits the highest of IEEE's
                if ((esize, bias) != (native_fields[1], native_fields[3])
                        or msize > native_fields[2]):
                    raise self._unsupported(f"a float of {size} bytes at bits "
                                            f"{(offset, precision)}", where)
                kind.convert = _float_fields(8 * size, sign, epos, esize, mpos, msize,
                                             native_fields[2])
            return kind, end + 12
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
            return kind.converted(np.frombuffer(raw, kind.dtype, count).reshape(shape).copy())
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
                # a shared attribute: the ID is one of the shared-message heap
                self.walked["shared message"] += 1
                message = self._sohm_get(ATTRIBUTE, record[:8], names)
            else:
                message = heap.get(record[:8], heap_addr)
            order = struct.unpack_from("<I", record, 9)[0]
            found.append((order, *self._attribute(message, heap_addr)))
        return found

    def _attribute(self, body, where):
        """(name, value) of an attribute message."""
        version = body[0]
        if version not in (1, 2, 3):
            raise self._unsupported(f"attribute message version {version}", where)
        shared = body[1] if version > 1 else 0
        name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
        pad = _align8 if version == 1 else int
        pos = 8 if version < 3 else 9
        name = body[pos : pos + name_size].split(b"\0", 1)[0].decode("utf-8")
        pos += pad(name_size)
        # flags 0x1 and 0x2: the datatype and the dataspace are shared
        type_body = body[pos : pos + type_size]
        if shared & 0x1:
            type_body = self._shared(DATATYPE, type_body, where)
        kind, _ = self._datatype(type_body, 0, where)
        pos += pad(type_size)
        space_body = body[pos : pos + space_size]
        if shared & 0x2:
            space_body = self._shared(DATASPACE, space_body, where)
        shape = self._dataspace(space_body, 0, where)
        pos += pad(space_size)
        value = self._values(kind, body[pos:], shape, decode=True)
        return name, value[()] if shape == () else value

    def _link_message(self, body, where):
        """(name, target, creation order, end of the fields) of a link
        message: ``target`` the object header address of a hard link, a
        ``_Soft`` with the link's value otherwise."""
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
            return name, _uint(body, pos, self._so), order, pos + self._so
        size = struct.unpack_from("<H", body, pos)[0]
        value = bytes(body[pos + 2 : pos + 2 + size])
        end = pos + 2 + size
        if kind == 1:
            return name, _Soft("soft", where, value.split(b"\0", 1)[0].decode("utf-8")), order, end
        if kind == 64:
            if value[0] >> 4 != 0:
                raise self._unsupported(f"external link value version {value[0] >> 4}", where)
            filename, target = value[1:].split(b"\0")[:2]
            return name, _Soft("external", where, (filename.decode("utf-8"),
                                                   target.decode("utf-8"))), order, end
        return name, _Soft(f"type {kind}", where), order, end

class _Type:
    """A datatype: its numpy dtype (``object`` for variable-length
    strings), the stored size of one element, and ``convert`` (None, or a
    function that turns stored values into h5py's in place)."""

    __slots__ = ("dtype", "vlen", "size", "convert")

    def __init__(self, dtype, vlen=False, size=None):
        self.dtype, self.vlen = dtype, vlen
        self.size = dtype.itemsize if size is None else size
        self.convert = None

    def converted(self, array):
        if self.convert is not None:
            self.convert(array)
        return array


def _unsigned_view(array):
    return array.view(array.dtype.str[0] + "u" + array.dtype.str[2:])


def _int_bits(offset, precision, signed):
    """In place: integers of ``precision`` bits at bit ``offset``, shifted
    down and, when ``signed``, sign-extended (HDF5's integer conversion)."""
    def convert(array):
        raw = _unsigned_view(array)
        mask = np.array((1 << precision) - 1, raw.dtype)
        value = (raw >> np.array(offset, raw.dtype)) & mask
        if signed:
            negative = (value >> np.array(precision - 1, raw.dtype)) & np.array(1, raw.dtype)
            value = np.where(negative.astype(bool), value | ~mask, value)
        raw[...] = value
    return convert


def _float_fields(width, sign, epos, esize, mpos, msize, native_msize):
    """In place: floats of ``width`` bits whose sign, exponent and mantissa
    are at bits ``sign``, ``epos`` (``esize`` bits, IEEE's) and ``mpos``
    (``msize`` bits) moved to IEEE's places, the mantissa to its top."""
    def convert(array):
        raw = _unsigned_view(array)
        t = raw.dtype.type

        def field(pos, size):
            return (raw >> t(pos)) & t((1 << size) - 1)

        value = (field(sign, 1) << t(width - 1)) | (field(epos, esize) << t(native_msize))
        value |= field(mpos, msize) << t(native_msize - msize)
        raw[...] = value
    return convert


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


def _trailing_run(slots, fits):
    """(block, offset, span) of the shortest run of messages that ends a
    block of an object header and whose span ``fits``, the last block
    first; ``slots`` (block, offset, type, span with the message header)
    in order.  A continuation message ends a run."""
    for block in reversed(list(dict.fromkeys(b for b, _, _, _ in slots))):
        mine = [s for s in slots if s[0] == block]
        end = mine[-1][1] + mine[-1][3] if mine else 0
        for _, at, kind, _ in reversed(mine):
            if kind == CONTINUATION:
                break
            if fits(end - at):
                return block, at, end - at
    return None


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
    """A soft or external link: what it is, where its message is, and its
    value (a path; a (file name, object path) pair)."""

    __slots__ = ("kind", "where", "value")

    def __init__(self, kind, where, value=None):
        self.kind, self.where, self.value = kind, where, value


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
                # (offset of the message body, flags, fractal heap, name
                # index, creation-order index)
                self.link_info = (where, body[1], file._addr(body, pos),
                                  file._addr(body, pos + so),
                                  file._addr(body, pos + 2 * so) if body[1] & 0x2 else None)
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
                _, _, heap_addr, names, _ = self.link_info
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
            self._links = {name: target for name, target, _, _ in found}
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
                offset = _uint(entries, pos, f._sl)
                name = names[offset : names.index(b"\0", offset)].decode("utf-8")
                cache = pos + f._sl + f._so
                if _uint(entries, cache, 4) == 2:
                    # cache type 2: a soft link, its value in the local heap
                    at = _uint(entries, cache + 8, 4)
                    value = names[at : names.index(b"\0", at)].decode("utf-8")
                    links[name] = _Soft("soft", node + 8 + pos, value)
                else:
                    links[name] = _uint(entries, pos + f._sl, f._so)
        return links

    def keys(self):
        return list(self._members())

    def __getitem__(self, path):
        return self._lookup(path, 0)

    def _lookup(self, path, depth):
        """The object at ``path`` (from the root when absolute), soft and
        external links followed as h5py follows them, ``depth`` of them
        followed so far."""
        obj = self.file.root if str(path).startswith("/") else self
        for part in [p for p in str(path).split("/") if p not in ("", ".")]:
            if not isinstance(obj, Group):
                raise KeyError(f"{obj.name} is a dataset, not a group")
            members = obj._members()
            if part not in members:
                raise KeyError(f"no object {part!r} in {obj.name}")
            target = members[part]
            if not isinstance(target, _Soft):
                obj = obj.file._object(target, f"{obj.name.rstrip('/')}/{part}")
                continue
            if depth >= LINK_DEPTH:
                # h5py's error for HDF5's "too many links"
                raise RuntimeError(f"{obj.file.filename}: more than {LINK_DEPTH} soft or "
                                   f"external links followed to reach {part!r}")
            obj.file.walked[f"{target.kind} link"] += 1
            if target.kind == "soft":
                obj = obj._lookup(target.value, depth + 1)
            elif target.kind == "external":
                name, inside = target.value
                obj = obj.file._external(name, target.where).root._lookup(inside, depth + 1)
            else:
                raise obj.file._unsupported(f"a {target.kind} link {part!r}", target.where)
        return obj

    def __contains__(self, path):
        try:
            self[path]
        except (KeyError, RuntimeError):
            return False
        return True


class Datatype:
    """A committed (named) datatype: ``dtype`` and ``attrs``."""

    def __init__(self, file, addr, name, messages):
        self.file, self.addr, self.name = file, addr, name
        body, where = next((b, w) for k, b, w in messages if k == DATATYPE)
        self.dtype = file._datatype(body, 0, where)[0].dtype
        self.attrs = file._attributes(messages)


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``, and ``d[lo:hi]``
    (first axis, step 1), ``d[:]`` or ``d[()]`` as numpy arrays."""

    def __init__(self, file, addr, name, messages):
        self.file, self.addr, self.name = file, addr, name
        self._filters, fill, self._chunks, self._external = [], None, None, None
        self._index_type, self._edge_unfiltered = None, False
        # a virtual dataset's mappings, and the blocks they resolve to
        # (unlimited ones against their sources' extents), at first use
        self._mappings = self._blocks = None
        for kind, body, where in messages:
            if kind == DATASPACE:
                self._shape, self.maxshape = file._dataspace_dims(body, 0, where)
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
            elif kind == EXTERNAL:
                self._external = self._external_files(body, where)
        self.dtype = self._type.dtype
        self._fill = fill or b""
        self.attrs = file._attributes(messages)

    def _external_files(self, body, where):
        """[(path, offset, size)] of the raw files of external storage (the
        External Data Files message): names in its local heap, relative
        ones found in the HDF5 file's directory, else from the working
        directory; the last size may be unlimited."""
        f = self.file
        if body[0] != 1:
            raise f._unsupported(f"external data files message version {body[0]}", where)
        used = struct.unpack_from("<H", body, 6)[0]
        size, _, heap_data = f._local_heap(f._addr(body, 8))
        names = f._read(heap_data, size)
        slots, pos = [], 8 + f._so
        here = os.path.dirname(os.path.abspath(f.filename))
        for _ in range(used):
            at, offset, length = (_uint(body, pos + i * f._sl, f._sl) for i in range(3))
            pos += 3 * f._sl
            name = names[at : names.index(b"\0", at)].decode("utf-8")
            path = name if os.path.isabs(name) else next(
                (p for p in (os.path.join(here, name), name) if os.path.isfile(p)),
                os.path.join(here, name))
            slots.append((path, offset, length))
        f.walked["external storage"] += 1
        return slots

    def _external_bytes(self, start, size):
        """``size`` bytes from byte ``start`` of the data in external
        storage, read from each file's slot in turn (zeros past a file's
        end, as HDF5 reads them)."""
        out, base = bytearray(), 0
        for path, offset, length in self._external:
            lo, hi = max(start, base), min(start + size, base + length)
            if lo < hi:
                with open(path, "rb") as raw:
                    raw.seek(offset + lo - base)
                    got = raw.read(hi - lo)
                out += got + bytes(hi - lo - len(got))
            base += length
        if len(out) != size:
            raise OSError(f"{self.file.filename}:{self.name}: external storage holds "
                          f"{len(out)} of the {size} bytes wanted from byte {start}")
        return bytes(out)

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
        elif self._class == 3 and version == 4:
            # the global heap object holding the mappings
            self._vds = (f._addr(body, 2), struct.unpack_from("<I", body, 2 + f._so)[0])
            self._layout_where = where
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
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32, SZIP, NBIT, SCALEOFFSET, LZF):
                raise self.file._unsupported(f"filter {fid} ({name or 'unnamed'})", where)
            if fid == SZIP and not native.szip_options_valid(values):
                raise self.file._unsupported(f"the szip filter with client values {values}",
                                             where)
            if fid == NBIT and (len(values) < 8 or values[3] != 1):
                # n-bit of compound, array or no-op classes
                raise self.file._unsupported(f"the n-bit filter of datatype class code "
                                             f"{values[3] if len(values) > 3 else None}", where)
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
        if self._class == 3:
            raise self.file._unsupported("a scalar virtual dataset", self._layout_where)
        if self._class == 1 and self._address is None and self._external is None:
            return self._fill_array(())[()]
        raw = self._contiguous_bytes(0, self._type.size)
        return self.file._values(self._type, raw, (), decode=False)[()]

    def _contiguous_bytes(self, start, size):
        if self._class == 0:
            return self._compact[start : start + size]
        if self._external is not None:
            return self._external_bytes(start, size)
        return self.file._read(self._address + start, size)

    def _rows(self, lo, hi):
        """Rows [lo, hi) of the first axis as an array."""
        if self._class == 3:
            return self._virtual_rows(lo, hi, 0)
        out = self._stored_rows(lo, hi)
        return out if self._type.vlen else self._type.converted(out)

    def _stored_rows(self, lo, hi):
        """Rows [lo, hi) as stored (before ``_Type.convert``)."""
        tail = self.shape[1:]
        shape = (hi - lo, *tail)
        if hi <= lo:
            return self._fill_array(shape)
        if self._class == 2:
            return self._chunked_rows(lo, hi, shape)
        if self._class == 1 and self._address is None and self._external is None:
            return self._fill_array(shape)
        row = self._type.size * int(np.prod(tail, dtype=np.int64))
        if self._class == 1 and not self._type.vlen and self._external is None:
            out = np.empty(shape, dtype=self.dtype)
            with observability.stage("io: read"):
                self.file._read_into(self._address + lo * row, out)
            observability.count("io: bytes read", out.nbytes)
            return out
        raw = self._contiguous_bytes(lo * row, (hi - lo) * row)
        if not self._type.vlen:
            return np.frombuffer(raw, self.dtype).reshape(shape).copy()
        return self.file._values(self._type, raw, shape, decode=False)

    # -- virtual --------------------------------------------------------- #
    def _virtual_mappings(self):
        """[(source file, source dataset, source selection, virtual
        selection)] of a virtual dataset, from the heap object its layout
        names (version 0: the count, then each mapping's two names and two
        selections, then the lookup3 checksum, checked); parsed once."""
        if self._mappings is not None:
            return self._mappings
        f, where = self.file, self._layout_where
        addr, at = self._vds
        block = f._global_heap(addr).get(at) if addr is not None else None
        if block is None or len(block) < 5 + f._sl:
            raise OSError(f"{f.filename}:{self.name}: no virtual dataset mappings in global "
                          f"heap object {at} at offset {addr}")
        if block[0] != 0:
            raise f._unsupported(f"virtual dataset mappings of version {block[0]}", where)
        if index.lookup3(block[:-4]) != struct.unpack_from("<I", block, len(block) - 4)[0]:
            raise OSError(f"{f.filename}:{self.name}: virtual dataset mappings fail their "
                          "checksum")
        count, pos, maps = _uint(block, 1, f._sl), 1 + f._sl, []
        for _ in range(count):
            names = []
            for _ in range(2):
                end = block.index(b"\0", pos)
                names.append(_printf_parts(block[pos:end].decode("utf-8"), f, where))
                pos = end + 1
            source, pos = self._selection(block, pos, where)
            virtual, pos = self._selection(block, pos, where)
            maps.append((*names, source, virtual))
        self._mappings = maps
        return maps

    def _selection(self, data, pos, where):
        """(selection, end) of the serialized dataspace selection at
        ``pos``: None for "all", else rows [(start, stop)] along the first
        axis of a hyperslab whose other axes are whole, with those axes'
        (start, extent) pairs to check against the dataspace; "none" is no
        rows.  A hyperslab unlimited along the first axis gives
        ``_Unlimited`` rows instead.  Point selections, irregular or
        inner-axis unlimited ones and blocks that cut the other axes raise
        NotImplementedError."""
        f = self.file
        kind, version = struct.unpack_from("<II", data, pos)
        if kind in (0, 3):  # none, all: version 1, 8 bytes reserved and length
            return (None if kind == 3 else ([], ())), pos + 16
        if kind != 2:
            raise f._unsupported(f"a virtual dataset selection of type {kind} (points)", where)
        if version == 1:
            rank, n = struct.unpack_from("<II", data, pos + 16)
            pos, width, regular = pos + 24, 4, False
        elif version in (2, 3):
            flags = data[pos + 8]
            regular = bool(flags & 1)
            if version == 2:
                width, pos = 8, pos + 13
            else:
                width, pos = data[pos + 9], pos + 10
            rank = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            if not regular:
                n = _uint(data, pos, width)
                pos += width
        else:
            raise f._unsupported(f"a hyperslab selection of version {version}", where)
        values = [_uint(data, pos + i * width, width)
                  for i in range(4 * rank if regular else 2 * rank * n)]
        pos += len(values) * width
        unlimited = [v == (1 << 8 * width) - 1 for v in values]
        if any(unlimited) and (not regular or any(unlimited[4:])):
            raise f._unsupported("an unlimited virtual dataset selection along an inner axis "
                                 "or of irregular blocks", where)
        if regular:
            start, stride, count, block = (values[i::4] for i in range(4))
            if any(unlimited):
                boxes = [_Unlimited(start[0], stride[0], None if unlimited[2] else count[0],
                                    None if unlimited[3] else block[0])]
            else:
                boxes = [[(start[0] + i * stride[0], start[0] + i * stride[0] + block[0])
                          for i in range(count[0])]]
            for d in range(1, rank):
                if count[d] != 1 and stride[d] != block[d]:
                    raise f._unsupported("a virtual dataset selection of blocks across "
                                         "an inner axis", where)
                boxes.append((start[d], start[d] + count[d] * block[d]))
            rows, inner = boxes[0], tuple(boxes[1:])
        else:
            corners = [values[2 * rank * b : 2 * rank * (b + 1)] for b in range(n)]
            inner = {tuple((c[d], c[rank + d] + 1) for d in range(1, rank)) for c in corners}
            if len(inner) > 1:
                raise f._unsupported("an irregular virtual dataset selection", where)
            rows = sorted((c[0], c[rank] + 1) for c in corners)
            inner = inner.pop() if inner else ()
        return (rows, inner), pos

    @staticmethod
    def _rows_of(selection, shape):
        """(starts, stops) of the rows ``selection`` picks in a dataspace of
        ``shape`` (None when its inner axes are not whole)."""
        if selection is None:
            return np.array([0], np.int64), np.array([shape[0]], np.int64)
        rows, inner = selection
        if inner and tuple(inner) != tuple((0, extent) for extent in shape[1:]):
            return None
        rows = np.array(rows, np.int64).reshape(-1, 2)
        return rows[:, 0], rows[:, 1]

    def _source(self, file_name, dataset_name, where):
        """The source dataset of a mapping: ``"."`` this file, another name
        found as an external link's file is (opened with this file's mode,
        closed with it); None for a file or dataset that is not there,
        which reads as the fill value, as HDF5 reads it."""
        f = self.file
        source = f if file_name == "." else f._external(file_name, where, missing_ok=True)
        if source is None:
            return None
        try:
            obj = source[dataset_name]
        except KeyError:
            return None
        return obj if isinstance(obj, Dataset) else None

    @property
    def shape(self):
        """The dataset's dimensions; a virtual dataset with unlimited
        mappings takes them from its sources' extents (``_virtual_blocks``),
        as HDF5 sets them when it opens one."""
        if self._class == 3 and self._blocks is None:
            self._virtual_blocks()
        return self._shape

    def _virtual_blocks(self):
        """[(source file, source dataset, source selection or its ``_Runs``,
        virtual (starts, stops))] of a virtual dataset, HDF5's resolution of its
        unlimited mappings done (``H5D__virtual_set_extent_unlim``, the
        default view H5D_VDS_LAST_AVAILABLE and printf gap 0): an unlimited
        selection maps as many rows as its source's selection holds within
        the source's current extent; a printf-style mapping maps block k of
        its virtual selection to the source its names give with ``%b`` =
        k, for k from 0 until the first source that is missing.  The first
        dimension then spans the furthest row any unlimited mapping
        reaches, and at least the limited mappings' rows."""
        if self._blocks is not None:
            return self._blocks
        f, where = self.file, self._layout_where
        blocks, reach, least, unlimited = [], [], 0, False
        for files, dsets, source_sel, virtual_sel in self._virtual_mappings():
            v_rows = virtual_sel[0] if virtual_sel is not None else None
            s_rows = source_sel[0] if source_sel is not None else None
            printf = len(files) > 1 or len(dsets) > 1
            if not isinstance(v_rows, _Unlimited):
                if printf or isinstance(s_rows, _Unlimited):
                    raise f._unsupported("an unlimited or printf-style source of a limited "
                                         "virtual selection", where)
                virtual = self._rows_of(virtual_sel, self._shape)
                if virtual is not None and len(virtual[1]):
                    least = max(least, int(virtual[1].max()))
                blocks.append((files[0], dsets[0], source_sel, virtual))
                continue
            unlimited = True
            if printf:
                if v_rows.count is not None or isinstance(s_rows, _Unlimited):
                    raise f._unsupported("a printf-style mapping without an unlimited count "
                                         "of virtual blocks, or of an unlimited source", where)
                k = 0
                while self._source(str(k).join(files), str(k).join(dsets), where) is not None:
                    lo = v_rows.start + k * v_rows.stride
                    blocks.append((str(k).join(files), str(k).join(dsets), source_sel,
                                   (np.array([lo]), np.array([lo + v_rows.block]))))
                    k += 1
                reach.append(v_rows.start + (k - 1) * v_rows.stride + v_rows.block if k else 0)
                continue
            if not isinstance(s_rows, _Unlimited):
                raise f._unsupported("an unlimited virtual selection of a limited source "
                                     "selection", where)
            source = self._source(files[0], dsets[0], where)
            picked = _Runs(*s_rows.runs(extent=0 if source is None else source.shape[0]))
            virtual = v_rows.runs(count=int(np.sum(picked.stops - picked.starts)))
            blocks.append((files[0], dsets[0], picked, virtual))
            reach.append(int(virtual[1][-1]) if len(virtual[1]) else v_rows.start)
        if unlimited:
            self._shape = (max(max(reach), least), *self._shape[1:])
        self._blocks = blocks
        return blocks

    def _virtual_rows(self, lo, hi, depth):
        """Rows [lo, hi) of a virtual dataset: the fill value, then each
        mapping block (``_virtual_blocks``) that overlaps them read through
        its source's own slicing (a block whose source is virtual counts one
        level deeper than ``depth``; past ``LINK_DEPTH`` levels it raises),
        converted to this dataset's type; rows past a source's end stay the
        fill value."""
        f, where = self.file, self._layout_where
        if depth > LINK_DEPTH:
            raise f._unsupported(f"virtual dataset mappings deeper than {LINK_DEPTH} "
                                 "levels", where)
        if self._type.vlen:
            raise f._unsupported("a virtual dataset of variable-length strings", where)
        shape = (max(hi - lo, 0), *self.shape[1:])
        out = self._type.converted(self._fill_array(shape))
        for file_name, dataset_name, source_sel, virtual in self._virtual_blocks():
            if virtual is None:
                raise f._unsupported("a virtual dataset selection of part of an inner axis",
                                     where)
            v_start, v_stop = virtual
            if not np.any((v_start < hi) & (v_stop > lo)):
                continue
            f.walked["virtual mapping"] += 1
            source = self._source(file_name, dataset_name, where)
            if source is None:
                continue
            if source.shape[1:] != self.shape[1:]:
                raise f._unsupported("a virtual dataset mapping between inner axes of "
                                     "other shapes", where)
            picked = (source_sel if isinstance(source_sel, _Runs)
                      else self._rows_of(source_sel, source.shape))
            if picked is None:
                raise f._unsupported("a virtual dataset source selection of part of an "
                                     "inner axis", where)
            for v0, s0, n in _matched_runs(virtual, picked, lo, hi):
                s1 = min(s0 + n, source.shape[0])
                if s1 <= s0:
                    continue
                data = (source._virtual_rows(s0, s1, depth + 1) if source._class == 3
                        else source._rows(s0, s1))
                out[v0 - lo : v0 - lo + s1 - s0] = data.astype(out.dtype, copy=False)
        return out

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
        chunk index walked once (stage ``io: index``)."""
        if self._chunks is None:
            rank = len(self._chunk_shape)
            with observability.stage("io: index"):
                if self._index_type is None:
                    offsets, addrs, sizes, masks = self._btree1_chunks(rank)
                else:
                    offsets, addrs, sizes, masks = self._v4_chunks(rank)
            if self._index_type is not None and not self._filters:
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
        for fid, what in ((LZF, "LZF chunk"), (SZIP, "szip chunk")):
            at = [i for i, (kind, _) in enumerate(self._filters) if kind == fid]
            if at:
                self.file.walked[what] += int(np.sum(masks[sel] & (1 << at[0]) == 0))
        if self._type.vlen or tuple(chunk[1:]) != tuple(self.shape[1:]):
            for i in sel:
                raw = self._decode(int(addrs[i]), int(sizes[i]), int(masks[i]), i)
                if self._type.vlen:
                    data = self.file._values(self._type, raw, chunk, decode=False)
                else:
                    count = int(np.prod(chunk, dtype=np.int64))
                    data = np.frombuffer(raw, self.dtype, count).reshape(chunk)
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
        # (``_decode_native``), the others here one by one
        row = self._type.size * int(np.prod(chunk[1:], dtype=np.int64))
        flat = out.reshape(-1).view(np.uint8)
        whole = (offsets[sel, 0] >= lo) & (offsets[sel, 0] + chunk[0] <= hi) & (masks[sel] == 0)
        if self._decode_native(flat, (offsets[sel[whole], 0] - lo) * row, addrs[sel[whole]],
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

    def _decode_native(self, flat, starts, addrs, sizes):
        """The chunks stored at ``addrs`` (``sizes`` bytes, every filter
        on) of a deflate, szip, shuffle + deflate or shuffle + szip
        pipeline, read in runs of nearby chunks and decoded by
        ``native.inflate_chunks`` or ``native.szip_chunks`` into ``flat`` at
        ``starts``: whether it decoded them (False for another pipeline,
        without the native library, or on a chunk it could not decode,
        which the caller's decoding then reports)."""
        kinds = [fid for fid, _ in self._filters]
        if kinds[-1:] not in ([DEFLATE], [SZIP]) or kinds[:-1] not in ([], [SHUFFLE]) \
                or not len(addrs):
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
        with observability.stage("io: read"):
            for first, last, base, span in zip(firsts, lasts, bases, spans):
                self.file._read_into(int(addrs[first]), buf[base : base + span])
                in_off[first : last + 1] = base + addrs[first : last + 1] - addrs[first]
        with observability.stage("io: decode"):
            if kinds[-1] == SZIP:
                done = native.szip_chunks(buf, in_off, sizes, flat, starts, self._chunk_bytes,
                                          self._filters[-1][1], element, THREADS)
            else:
                done = native.inflate_chunks(buf, in_off, sizes, flat, starts,
                                             self._chunk_bytes, element, THREADS)
        if done:
            # counted only here: on False the caller's ``_decode`` reads
            # and counts these chunks again
            observability.count("io: bytes read", len(buf))
            observability.count("io: chunks decoded", len(addrs))
            observability.count("io: bytes decoded", len(addrs) * self._chunk_bytes)
        return done

    def _decode(self, addr, size, mask, index, into=None):
        """The bytes of the chunk ``index`` (``size`` bytes stored at
        ``addr``) through the filters that ``mask`` leaves on, in reverse
        pipeline order; written into ``into`` (a uint8 array of the
        chunk's bytes) when given."""
        on = [i for i in range(len(self._filters)) if not mask & (1 << i)]
        observability.count("io: bytes read", size)
        if not on and into is not None and size == len(into):
            with observability.stage("io: read"):
                self.file._read_into(addr, into)
            return into
        with observability.stage("io: read"):
            raw = self.file._read(addr, size)
        if on:
            observability.count("io: chunks decoded")
            observability.count("io: bytes decoded", self._chunk_bytes)
        with observability.stage("io: decode"):
            for i in reversed(on):
                fid, values = self._filters[i]
                if fid == DEFLATE:
                    raw = zlib.decompress(raw, bufsize=self._chunk_bytes)
                elif fid == LZF:
                    n_out = values[2] if len(values) > 2 and values[2] else self._chunk_bytes
                    raw = native.lzf_decompress(raw, n_out)
                elif fid == SZIP:
                    # the size it stores: the chunk's, or a little more before
                    # fletcher32 or another coder
                    raw = native.szip_decode(raw, values, 2 * self._chunk_bytes + 64)
                elif fid == NBIT:
                    self.file.walked["n-bit chunk"] += 1
                    raw = native.nbit_decode(raw, values)
                elif fid == SCALEOFFSET:
                    self.file.walked["scale-offset chunk"] += 1
                    raw = native.scaleoffset_decode(raw, values)
                elif fid == SHUFFLE:
                    element = values[0] if values else self._type.size
                    if i == on[0] and into is not None and len(raw) == len(into):
                        return native.unshuffle(raw, element, into)
                    raw = native.unshuffle(raw, element)
                else:
                    raw = _fletcher32_checked(
                        raw, f"{self.file.filename}:{self.name} chunk {index}")
            if into is not None:
                if len(raw) < len(into):
                    raise OSError(f"{self.file.filename}:{self.name} chunk {index}: {len(raw)} "
                                  f"bytes decoded, {len(into)} expected")
                into[:] = np.frombuffer(raw, np.uint8, len(into))
        return raw


_Runs = collections.namedtuple("_Runs", "starts stops")


class _Unlimited(collections.namedtuple("_Unlimited", "start stride count block")):
    """A hyperslab selection along the first axis whose ``count`` or
    ``block`` is unlimited (None)."""

    def runs(self, extent=None, count=None):
        """(starts, stops) of the rows it selects below ``extent``, or of
        its first ``count`` rows: a partial last block included, adjacent
        blocks merged into one run."""
        start, stride, block = self.start, self.stride, self.block
        if block is None or stride == block:
            stop = extent if extent is not None else start + count
            return np.array([start], np.int64), np.array([max(start, stop)], np.int64)
        if extent is not None:
            starts = start + stride * np.arange(max(0, -(-(extent - start) // stride)),
                                                 dtype=np.int64)
            return starts, np.minimum(starts + block, extent)
        starts = start + stride * np.arange(-(-count // block), dtype=np.int64)
        stops = starts + block
        if len(stops):
            stops[-1] -= len(stops) * block - count
        return starts, stops


def _printf_parts(name, f, where):
    """A mapping's source file or dataset name as its parts around HDF5's
    printf-style ``%b`` (the block number; ``%%`` is a ``%``): one part
    when it has none.  Any other ``%`` specifier raises, as HDF5 refuses
    it."""
    parts, text, i = [], "", 0
    while i < len(name):
        if name[i] != "%":
            text += name[i]
            i += 1
            continue
        code = name[i + 1 : i + 2]
        if code == "%":
            text += "%"
        elif code == "b":
            parts.append(text)
            text = ""
        else:
            raise f._unsupported(f"a source name {name!r} with the specifier %{code}", where)
        i += 2
    return [*parts, text]


def _matched_runs(virtual, source, lo, hi):
    """(virtual row, source row, rows) of each run in which the rows of a
    virtual selection (``(starts, stops)``) inside [lo, hi) meet the
    source selection's rows of the same rank (the k-th row picked maps to
    the k-th)."""
    (v_start, v_stop), (s_start, s_stop) = virtual, source
    v_rank = np.concatenate([[0], np.cumsum(v_stop - v_start)])
    s_rank = np.concatenate([[0], np.cumsum(s_stop - s_start)])
    runs = []
    for i in np.flatnonzero((v_start < hi) & (v_stop > lo)):
        a, b = max(int(v_start[i]), lo), min(int(v_stop[i]), hi)
        r0, r1 = int(v_rank[i]) + a - int(v_start[i]), int(v_rank[i]) + b - int(v_start[i])
        j = int(np.searchsorted(s_rank, r0, side="right")) - 1
        while r0 < r1 and j < len(s_start):
            n = min(r1, int(s_rank[j + 1])) - r0
            runs.append((a, int(s_start[j]) + r0 - int(s_rank[j]), n))
            a, r0, j = a + n, r0 + n, j + 1
    return runs


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
# Addresses and lengths are written in the file's sizes of offsets and
# lengths (``Appender.o`` and ``.n``; 8 bytes each, as h5py writes them,
# unless ``write`` is given others).


def enum_dtype(mapping, basetype=np.int32):
    """The numpy dtype of an HDF5 enum ({name: value} over the integer
    ``basetype``), as h5py's ``enum_dtype`` makes it: arrays of it are
    written as an enum (``bins/chrom`` in cooler's layout)."""
    return np.dtype(np.dtype(basetype).str, metadata={"enum": dict(mapping)})


def _type_message(dtype, so=8):
    """The version-1 datatype of a numpy dtype (integers, IEEE floats,
    fixed strings, enums of ``enum_dtype``), or of a variable-length UTF-8
    string (``str``: its length, then a global heap ID of an ``so``-byte
    address and an index)."""
    if dtype is str:
        char = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 4 + so + 4) + char
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


def _space_message(out, shape, unlimited=False):
    """A version-1 dataspace of ``shape``; its maximum the shape, or
    unlimited along the first axis."""
    dims = [out.n(n) for n in shape]
    top = [out.n(UNDEF)] + dims[1:] if unlimited else dims
    return struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + b"".join(dims + top)


def _space_v2(out, shape, unlimited=False, keep_max=True):
    """A version-2 dataspace of ``shape`` (scalar when empty), its maximum
    stored when ``keep_max`` (unlimited along the first axis, or the
    shape)."""
    if not shape:
        return bytes([2, 0, 0, 0])
    dims = [out.n(n) for n in shape]
    if not keep_max:
        return bytes([2, len(shape), 0, 1]) + b"".join(dims)
    top = [out.n(UNDEF)] + dims[1:] if unlimited else dims
    return bytes([2, len(shape), 1, 1]) + b"".join(dims + top)


def _message(kind, body):
    body = _pad8(body)
    return struct.pack("<HHB3x", kind, len(body), 0) + body


def _object_header(messages):
    size = sum(len(m) for m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, size) + b"".join(messages)


def _global_heap(out, items):
    """A global heap collection holding ``items`` (bytes) as objects 1..n,
    at least HDF5's 4096 bytes, the rest one free-space object."""
    # the collection's header and each object's (index, references,
    # reserved, size), 8-byte aligned (H5HG_SIZEOF_HDR, H5HG_SIZEOF_OBJHDR)
    head = _align8(8 + out.sl)

    def object_header(index, size):
        return (struct.pack("<HH4x", index, 0) + out.n(size)).ljust(head, b"\0")

    body = b"".join(object_header(i + 1, len(item)) + _pad8(item) for i, item in enumerate(items))
    size = max(GLOBAL_HEAP_MIN, head + len(body) + head)
    free = size - head - len(body)
    return (
        (b"GCOL" + bytes([1, 0, 0, 0]) + out.n(size)).ljust(head, b"\0") + body
        + object_header(0, free) + bytes(free - head)
    )


def _attribute_parts(attrs, out):
    """(name, datatype, shape, data) of each attribute of ``attrs`` (str,
    ints, floats, ``np.bytes_``, numeric arrays; Python ints and floats as
    int64 and float64, as h5py stores them); the strings go into a new
    global heap collection written by ``out``."""
    strings = [v.encode("utf-8") for v in attrs.values() if isinstance(v, str)]
    heap = out.put(_global_heap(out, strings)) if strings else None
    parts, index = [], 0
    for name, value in attrs.items():
        if isinstance(value, str):
            index += 1
            parts.append((name, _type_message(str, out.so), (),
                          struct.pack("<I", len(strings[index - 1])) + out.o(heap)
                          + struct.pack("<I", index)))
            continue
        array = np.asarray(value)
        if array.dtype.kind not in "iufS":
            raise TypeError(f"attribute {name!r}: no HDF5 type for {type(value).__name__}")
        parts.append((name, _type_message(array.dtype), array.shape, array.tobytes()))
    return parts


def _attribute_messages(attrs, out):
    """Version-1 attribute messages of ``attrs`` (see ``_attribute_parts``)."""
    messages = []
    for name, kind, shape, data in _attribute_parts(attrs, out):
        space = _space_message(out, shape)
        encoded = name.encode("utf-8") + b"\0"
        body = (
            struct.pack("<BBHHH", 1, 0, len(encoded), len(kind), len(space))
            + _pad8(encoded) + _pad8(kind) + _pad8(space) + data
        )
        messages.append(_message(ATTRIBUTE, body))
    return messages


# HDF5's default phase change of attributes and links: compact up to 8
MAX_COMPACT = 8


def _attribute_messages_v3(attrs, out):
    """(type, body) messages of ``attrs`` in a version-2 object header, as
    HDF5's newest format stores them: an attribute info message, then
    version-3 attribute messages up to ``MAX_COMPACT``, or past it every
    attribute message in a fractal heap (``hdf5_write.ATTRIBUTE_HEAP``)
    under a v2 B-tree name index of records of type 8 (heap ID, message
    flags, creation order 0xFFFF as HDF5 writes it untracked, the name's
    lookup3 hash; by hash, then name)."""
    if not attrs:
        return []
    bodies = []
    for name, kind, shape, data in _attribute_parts(attrs, out):
        encoded = name.encode("utf-8")
        space = _space_v2(out, shape, keep_max=False)
        bodies.append((encoded, struct.pack("<BBHHHB", 3, 0, len(encoded) + 1, len(kind),
                                            len(space), 0 if encoded.isascii() else 1)
                       + encoded + b"\0" + kind + space + data))
    if len(bodies) <= MAX_COMPACT:
        info = bytes([0, 0]) + out.o(UNDEF) + out.o(UNDEF)
        return [(ATTRIBUTE_INFO, info)] + [(ATTRIBUTE, body) for _, body in bodies]
    heap, ids = hw.fractal_heap(out, [body for _, body in bodies], hw.ATTRIBUTE_HEAP)
    records = sorted((index.lookup3(name), name, heap_id)
                     for (name, _), heap_id in zip(bodies, ids))
    names = hw.btree2(out, 8, [heap_id + struct.pack("<BII", 0, 0xFFFF, h)
                               for h, _, heap_id in records],
                      hw.ATTRIBUTE_HEAP.id_len + 9)
    return [(ATTRIBUTE_INFO, bytes([0, 0]) + out.o(heap) + out.o(names))]


def _fill_latest(chunked):
    """A version-3 fill value message: allocated late (contiguous) or
    incrementally (chunked), written if set, no value set."""
    return bytes([3, 0x0B if chunked else 0x0A])


def _dataset_header(array, out, attrs, chunk=None, pool=None, latest=False, fixed=False,
                    compression="gzip"):
    """Write ``array``, then its object header; the header's address.  The
    array is contiguous, or with ``chunk`` (rows) chunked as cooler writes
    (see ``_chunked_data``, which ``compression`` goes to), unlimited
    along its first axis unless ``fixed``.  ``latest``: HDF5's newest format (a version-2 object
    header, version-2 dataspace, version-3 fill value and attributes,
    data layout version 4)."""
    if latest:
        if chunk is None:
            data = out.put(array) if array.size else UNDEF
            layout = [(LAYOUT, bytes([4, 1]) + out.o(data) + out.n(array.nbytes))]
        else:
            layout = _chunked_data(array, int(chunk), out, pool, latest=True, fixed=fixed,
                                   compression=compression)
        return out.put(hw.object_header([
            (DATASPACE, _space_v2(out, array.shape, unlimited=chunk is not None and not fixed)),
            (DATATYPE, _type_message(array.dtype)),
            (FILL, _fill_latest(chunk is not None)),
            *layout,
            *_attribute_messages_v3(attrs or {}, out),
        ]))
    if chunk is None:
        data = out.put(array) if array.size else UNDEF
        layout = [_message(LAYOUT, bytes([3, 1]) + out.o(data) + out.n(array.nbytes))]
        # fill value version 2: allocated late, written if set, default
        fill = bytes([2, 2, 2, 1, 0, 0, 0, 0])
    else:
        layout = [_message(kind, body) for kind, body in
                  _chunked_data(array, int(chunk), out, pool, fixed=fixed,
                                compression=compression)]
        fill = bytes([2, 3, 2, 1, 0, 0, 0, 0])  # allocated incrementally
    attributes = _attribute_messages(attrs or {}, out)
    return out.put(_object_header([
        _message(DATASPACE, _space_message(out, array.shape, unlimited=chunk is not None
                                           and not fixed)),
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
# szip as h5py's compression="szip" sets it: ('nn', 8), HDF5's largest
# scanline of 128 blocks and of 4,096 pixels
SZIP_BLOCK, SZIP_SCANLINE_BLOCKS, SZIP_MAX_SCANLINE = 8, 128, 4096
# the pixels a batch of chunks of the szip writer holds at most
SZIP_BATCH_BYTES = 64 << 20


def szip_values(dtype, chunk):
    """The szip client values HDF5 stores for h5py's ``compression="szip"``
    (options 'nn', 8 pixels a block) on a chunk of shape ``chunk`` of
    ``dtype``, as its set-local callback completes them: options K13, RAW,
    NN and the byte order; bits per pixel from the size; pixels per
    scanline from the chunk's last axis.  None where HDF5 refuses szip:
    types other than integers and floats of 1, 2, 4 or 8 bytes (fixed
    strings), chunks of fewer than 8 elements."""
    dtype = np.dtype(dtype)
    points = int(np.prod(chunk, dtype=np.int64))
    if dtype.kind not in "iuf" or dtype.itemsize not in (1, 2, 4, 8) or points < SZIP_BLOCK:
        return None
    scanline, most = int(chunk[-1]), SZIP_BLOCK * SZIP_SCANLINE_BLOCKS
    if scanline < SZIP_BLOCK:
        scanline = min(most, points)
    else:
        scanline = min(most, scanline) if scanline <= SZIP_MAX_SCANLINE else most
    order = native.SZIP_MSB if dtype.byteorder == ">" else native.SZIP_LSB
    return (native.SZIP_ALWAYS | native.SZIP_NN | order, SZIP_BLOCK, 8 * dtype.itemsize,
            scanline)


def _szip_chunks(flat, n_chunks, size, element, values):
    """[(stored bytes, filter mask)] of ``n_chunks`` chunks of ``size``
    bytes of ``flat`` (the last padded with zeros) through shuffle and
    szip (``native.szip_encode_chunks``, in batches on ``THREADS``
    threads); a chunk szip does not shrink skips it (mask bit 1)."""
    done = []
    step = max(1, SZIP_BATCH_BYTES // max(size, 1))
    for k in range(0, n_chunks, step):
        raw = flat[k * size : (k + step) * size]
        whole = min(step, n_chunks - k) * size
        if len(raw) < whole:
            raw = np.concatenate([raw, np.zeros(whole - len(raw), np.uint8)])
        done += [(data, 0 if coded else 1 << 1) for data, coded in
                 native.szip_encode_chunks(raw, size, values, element, THREADS)]
    return done


def _chunked_data(array, rows, out, pool, latest=False, fixed=False, compression="gzip"):
    """Write ``array`` as chunks of ``rows`` rows (the trailing axes whole;
    the last chunk padded with zeros), each through HDF5's shuffle and then
    deflate at level 6 (``compression="gzip"``) or szip with h5py's
    default options (``"szip"``, where HDF5 takes szip: see
    ``szip_values``; deflate elsewhere), and the chunk index over them;
    the (type, body) of the filter pipeline and layout messages.  The
    index is a version-1 chunk B-tree of type 1 with as many levels as
    the chunks need (layout version 3), or with ``latest`` that of layout
    version 4 HDF5 picks: an extensible array along an unlimited first
    axis, a single chunk or a fixed array when the shape is ``fixed``.
    Deflate compresses the chunks on ``pool`` when given, szip on
    ``THREADS`` threads; the bytes written do not depend on either."""
    tail, element = array.shape[1:], array.dtype.itemsize
    row = element * int(np.prod(tail, dtype=np.int64))
    flat = array.reshape(-1).view(np.uint8) if array.size else np.zeros(0, np.uint8)
    n_chunks = -(-array.shape[0] // rows) if array.shape and array.shape[0] else 0
    size = rows * row
    szip = szip_values(array.dtype, (rows, *tail)) if compression == "szip" else None

    def compress(batch):
        done = []
        for k in batch:
            raw = flat[k * size : (k + 1) * size]
            if len(raw) < size:
                raw = np.concatenate([raw, np.zeros(size - len(raw), np.uint8)])
            shuffled = np.empty(size, np.uint8)
            native.shuffle(raw, element, shuffled)
            done.append((zlib.compress(shuffled, DEFLATE_LEVEL), 0))
        return done

    if szip is not None:
        results = [_szip_chunks(flat, n_chunks, size, element, szip)]
    else:
        batches = [range(k, min(k + 16, n_chunks)) for k in range(0, n_chunks, 16)]
        results = pool.map(compress, batches) if pool is not None else map(compress, batches)
    rank = len(array.shape)
    children, sizes, masks = [], [], []
    for done in results:
        for data, mask in done:
            children.append(out.put(data))
            sizes.append(len(data))
            masks.append(mask)
    dims = [rows, *tail, element]
    coder = (SZIP, b"szip", szip) if szip is not None else (DEFLATE, b"deflate",
                                                           (DEFLATE_LEVEL,))
    if latest:
        pipeline = struct.pack("<BB", 2, 2) + struct.pack("<HHHI", SHUFFLE, 1, 1, element)
        pipeline += struct.pack(f"<HHH{len(coder[2])}I", coder[0], 1, len(coder[2]), *coder[2])
        width = hw.enc_size(max(dims))
        head = struct.pack("<BBBBB", 4, 2, 0, rank + 1, width) + b"".join(
            int(d).to_bytes(width, "little") for d in dims)
        size_len = index.chunk_size_len(size)
        elements = list(zip(children, sizes, masks))
        if fixed and n_chunks == 1 and rows == array.shape[0]:
            head = bytearray(head)
            head[2] = 0x2  # a single chunk, filtered: its size and mask follow
            layout = (bytes(head) + bytes([SINGLE_CHUNK]) + out.n(sizes[0])
                      + struct.pack("<I", masks[0]) + out.o(children[0]))
        elif fixed:
            addr = hw.fixed_array(out, elements, size_len) if n_chunks else UNDEF
            layout = head + bytes([FIXED_ARRAY, hw.PAGE_BITS]) + out.o(addr)
        else:
            addr = hw.extensible_array(out, elements, size_len) if n_chunks else UNDEF
            layout = head + bytes([EXTENSIBLE_ARRAY, hw.EA_MAX_BITS, hw.EA_IBLOCK,
                                   hw.EA_SBLK_MIN, hw.EA_DBLK_MIN, hw.PAGE_BITS])
            layout += out.o(addr)
        return [(FILTERS, pipeline), (LAYOUT, layout)]
    keys = [struct.pack(f"<II{rank + 1}Q", n, mask, k * rows, *[0] * rank)
            for k, (n, mask) in enumerate(zip(sizes, masks))]
    # the key after the last chunk: the end of its rows, and 1 in the
    # element dimension (as HDF5 writes it)
    keys.append(struct.pack(f"<II{rank + 1}Q", 0, 0, n_chunks * rows, *[0] * (rank - 1),
                            element))
    per_node = 2 * CHUNK_K
    key_size = 8 + 8 * (rank + 1)
    btree = hw.btree1(out, 1, keys, children, per_node,
                      hw.btree1_size(out, per_node, key_size)) if children else UNDEF
    pipeline = struct.pack("<BB6x", 1, 2)
    for fid, name, values in ((SHUFFLE, b"shuffle", (element,)), coder):
        # id, name length, flags (optional), values, name, values (padded
        # to an even count)
        pipeline += struct.pack("<HHHH", fid, 8, 1, len(values)) + name.ljust(8, b"\0")
        pipeline += struct.pack(f"<{len(values)}I", *values) + bytes(4 * (len(values) % 2))
    layout = bytes([3, 2, rank + 1]) + out.o(btree) + struct.pack(f"<{rank + 1}I", *dims)
    return [(FILTERS, pipeline), (LAYOUT, layout)]


def _entry(name_offset, header, cache=None, so=8, sl=8):
    """A symbol-table entry (the name's offset a length of ``sl`` bytes,
    addresses of ``so``); ``cache`` the (B-tree, heap) of a group."""
    if cache is None:
        return hw.u(name_offset, sl) + hw.addr(header, so) + bytes(24)
    scratch = hw.addr(cache[0], so) + hw.addr(cache[1], so)
    return (hw.u(name_offset, sl) + hw.addr(header, so) + struct.pack("<II", 1, 0)
            + scratch.ljust(16, b"\0"))


def _write_members(out, tree, path, options):
    """Write the members of the group ``tree`` ({name: array or subtree})
    at ``path``, in name order; [(name, header address, (B-tree, heap)
    of a symbol-table subgroup or None)]."""
    chunks, group_attrs, fixed, pool, latest, compression = options
    members = []
    for name in sorted(tree, key=lambda n: n.encode("utf-8")):
        node, where = tree[name], f"{path}/{name}".strip("/")
        if isinstance(node, dict):
            writer = _write_group_latest if latest else _write_group
            header, cache = writer(out, node, group_attrs.get(where, {}), where, options)
            members.append((name, header, cache))
        else:
            header = _dataset_header(np.ascontiguousarray(node), out, None, chunks.get(where),
                                     pool, latest, where in fixed, compression)
            members.append((name, header, None))
    return members


def _write_group(out, tree, attrs, path, options):
    """Write the members of ``tree``, then the symbol-table group at
    ``path``: its local heap, symbol-table nodes, B-tree and object
    header; (header, (B-tree, heap)) addresses."""
    members = _write_members(out, tree, path, options)
    heap_data, offsets = bytearray(8), []
    for name, _, _ in members:
        offsets.append(len(heap_data))
        heap_data += _pad8(name.encode("utf-8") + b"\0")
    free = len(heap_data)
    heap_data += out.n(FREE_NULL) + out.n(64) + bytes(64 - 2 * out.sl)
    heap = out.eof
    data = heap + 8 + 2 * out.sl + out.so  # the data segment follows the header
    out.put(b"HEAP" + bytes(4) + out.n(len(heap_data)) + out.n(free) + out.o(data) + heap_data)
    entries = [_entry(offset, header, cache, out.so, out.sl)
               for offset, (_, header, cache) in zip(offsets, members)]
    btree = hw.symbol_table(out, entries, offsets, 0, LEAF_K, INTERNAL_K)
    header = out.put(_object_header(
        [_message(SYMBOL_TABLE, out.o(btree) + out.o(heap)),
         *_attribute_messages(attrs, out)]
    ))
    return header, (btree, heap)


def _hard_link(name, header, order=None, so=8):
    """The body of a hard link message (version 1) from ``name`` to the
    object header ``header`` (an address of ``so`` bytes), with its
    creation ``order`` when given."""
    encoded = name.encode("utf-8")
    width = 0 if len(encoded) < 256 else 1
    # flags: name length width, creation order, UTF-8
    body = bytearray([1, width])
    if order is not None:
        body[1] |= 0x4
        body += struct.pack("<q", order)
    if not encoded.isascii():
        body[1] |= 0x10
        body.append(1)
    body += len(encoded).to_bytes(1 << width, "little") + encoded
    return bytes(body + hw.addr(header, so))


def _dense_links(out, links, by_order):
    """Write the link messages of ``links`` ([(name, creation order,
    body)]) as HDF5's dense link storage: a fractal heap
    (``hdf5_write.LINK_HEAP``), a v2 B-tree name index of records of type
    5 (the name's lookup3 hash, the heap ID; by hash, then name) and, with
    ``by_order``, a creation-order index of type 6 (the creation order,
    the heap ID); (heap, name index, creation-order index or None)."""
    heap, ids = hw.fractal_heap(out, [body for _, _, body in links], hw.LINK_HEAP)
    id_len = hw.LINK_HEAP.id_len
    by_name = sorted((index.lookup3(n.encode("utf-8")), n.encode("utf-8"), heap_id)
                     for (n, _, _), heap_id in zip(links, ids))
    names = hw.btree2(out, 5, [struct.pack("<I", h) + i for h, _, i in by_name], 4 + id_len)
    orders = None
    if by_order:
        by_creation = sorted((order, heap_id) for (_, order, _), heap_id in zip(links, ids))
        orders = hw.btree2(out, 6, [struct.pack("<q", o) + i for o, i in by_creation],
                           8 + id_len)
    return heap, names, orders


def _write_group_latest(out, tree, attrs, path, options):
    """Write the members of ``tree``, then the new-style group at ``path``
    in HDF5's newest format: link messages in its version-2 header up to
    ``MAX_COMPACT``, past it dense (a fractal heap under a v2 B-tree
    name index, as ``File._store_dense`` stores them); (header, None)."""
    members = _write_members(out, tree, path, options)
    links = [(name, None, _hard_link(name, header, so=out.so)) for name, header, _ in members]
    heap = names = UNDEF
    messages = []
    if len(links) > MAX_COMPACT:
        heap, names, _ = _dense_links(out, links, False)
    else:
        messages = [(LINK, body) for _, _, body in links]
    return out.put(hw.object_header([
        (LINK_INFO, bytes([0, 0]) + out.o(heap) + out.o(names)),
        (GROUP_INFO, bytes([0, 0])),
        *_attribute_messages_v3(attrs, out),
        *messages,
    ])), None


def write(path, datasets, attrs=None, *, chunks=None, group_attrs=None, fixed=(),
          libver="earliest", compression="gzip", userblock=0, sizes=(OFFSET_SIZE, LENGTH_SIZE)):
    """Write a new HDF5 file: ``datasets`` maps paths ("bins/start",
    "resolutions/5000/pixels/count") to numpy arrays of integers, floats,
    fixed strings or enums (``enum_dtype``), in groups made from the
    paths; ``attrs`` are the root group's attributes and ``group_attrs``
    {group path: attributes} those of other groups (see
    ``_attribute_parts``).  A dataset is stored contiguous, or, where
    ``chunks`` {path: rows} names it, chunked in cooler's layout: chunks
    of that many rows, shuffle then deflate at level 6, unlimited along
    the first axis unless ``fixed`` names its path (see
    ``_chunked_data``), compressed on ``THREADS`` threads; the bytes
    written do not depend on the thread count.  ``compression="szip"``
    writes those chunks through shuffle and szip instead of deflate, with
    the options h5py's ``compression="szip"`` sets, wherever HDF5 takes
    szip (``szip_values``; fixed strings and chunks of fewer than 8
    elements keep deflate); it needs the native library.

    ``libver``: "earliest" (superblock version 0, version-1 object
    headers, symbol-table groups, data layout version 3) or "latest",
    what h5py writes at ``libver="latest"``: superblock version 3,
    version-2 object headers, new-style groups (compact up to 8 links,
    dense past them), version-3 attribute messages (dense past 8), data
    layout version 4 with the chunk index HDF5 picks (extensible array,
    fixed array or single chunk).

    ``userblock``: the bytes of a user block before the superblock (0, or
    a power of two from 512, as HDF5's ``H5Pset_userblock`` takes it),
    left zero for the caller to fill; ``sizes``: the sizes of offsets
    and lengths, each 2, 4 or 8 bytes (``H5Pset_sizes``).  A file that
    outgrows its offsets raises ``OSError`` (EFBIG) as it is written."""
    if libver not in ("earliest", "latest"):
        raise ValueError(f"libver must be 'earliest' or 'latest', not {libver!r}")
    if compression not in ("gzip", "szip"):
        raise ValueError(f"compression must be 'gzip' or 'szip', not {compression!r}")
    if userblock and (userblock < 512 or userblock & (userblock - 1)):
        raise ValueError(f"userblock must be 0 or a power of two from 512, not {userblock}")
    so, sl = sizes
    if so not in (2, 4, 8) or sl not in (2, 4, 8):
        raise ValueError(f"sizes of offsets and lengths must be 2, 4 or 8, not {sizes}")
    latest = libver == "latest"
    fixed = {name.strip("/") for name in fixed}
    if latest and sl < 8 and any(name.strip("/") not in fixed for name in chunks or {}):
        # HDF5 (1.14) decodes no unlimited dimension from lengths of fewer
        # than 8 bytes, and so opens no such dataset of layout version 4,
        # even one it wrote itself
        raise ValueError("an unlimited dataset at libver='latest' needs 8-byte lengths")
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
        options = (chunks, group_attrs, fixed, pool, latest, compression)
        if latest:
            out = hw.Appender(fd, 12 + 4 * so + 4, userblock, so, sl)
            header, _ = _write_group_latest(out, tree, dict(attrs or {}), "", options)
            eof = out.finish()
            superblock = hw.signed(SIGNATURE + bytes([3, so, sl, 0]) + out.o(userblock)
                                   + out.o(UNDEF) + out.o(userblock + eof) + out.o(header))
        else:
            out = hw.Appender(fd, 24 + 4 * so + so + sl + 24, userblock, so, sl)
            header, cache = _write_group(out, tree, dict(attrs or {}), "", options)
            eof = out.finish()
            superblock = (
                SIGNATURE + bytes([0, 0, 0, 0, 0, so, sl, 0])
                + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                + out.o(userblock) + out.o(UNDEF) + out.o(userblock + eof) + out.o(UNDEF)
                + _entry(0, header, cache, so, sl)
            )
        os.pwrite(fd, superblock, userblock)
    finally:
        os.close(fd)
        if pool is not None:
            pool.shutdown()
    return str(path)
