"""The shared structures of HDF5's newer file formats, for the reader in
``chromosight_torch.io.hdf5``: Jenkins' lookup3 checksum, the fractal
heap (``FRHP``, ``FHDB``, ``FHIB``), the version-2 B-tree (``BTHD``,
``BTIN``, ``BTLF``) and the chunk indexes of data layout version 4, the
fixed array (``FAHD``, ``FADB``) and the extensible array (``EAHD``,
``EAIB``, ``EASB``, ``EADB``).

Each function takes the open ``hdf5.File`` as ``f`` and reads through
its ``_read``; every structure's checksum is checked, and every
signature read is counted in ``f.walked``.  What is outside the subset
raises ``NotImplementedError`` through ``f._unsupported`` (feature and
file offset).
"""

from __future__ import annotations

import bisect
import struct

import numpy as np

MASK32 = 0xFFFFFFFF
# fractal heap ID types (bits 4-5 of the ID's first byte)
MANAGED, HUGE, TINY = 0, 1, 2


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & MASK32


def lookup3(data, initval=0):
    """HDF5's ``H5_checksum_lookup3``: Bob Jenkins' ``hashlittle`` of
    ``data``, byte by byte."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & MASK32
    words = struct.unpack_from(f"<{3 * ((n - 1) // 12)}I", data) if n > 12 else ()
    for i in range(0, len(words), 3):
        a = (a + words[i]) & MASK32
        b = (b + words[i + 1]) & MASK32
        c = (c + words[i + 2]) & MASK32
        a = (a - c) & MASK32; a ^= _rot(c, 4); c = (c + b) & MASK32    # noqa: E702
        b = (b - a) & MASK32; b ^= _rot(a, 6); a = (a + c) & MASK32    # noqa: E702
        c = (c - b) & MASK32; c ^= _rot(b, 8); b = (b + a) & MASK32    # noqa: E702
        a = (a - c) & MASK32; a ^= _rot(c, 16); c = (c + b) & MASK32   # noqa: E702
        b = (b - a) & MASK32; b ^= _rot(a, 19); a = (a + c) & MASK32   # noqa: E702
        c = (c - b) & MASK32; c ^= _rot(b, 4); b = (b + a) & MASK32    # noqa: E702
    tail = data[4 * len(words):]
    if not tail:
        return c
    tail = bytes(tail) + bytes(12 - len(tail))
    x, y, z = struct.unpack("<III", tail)
    a, b, c = (a + x) & MASK32, (b + y) & MASK32, (c + z) & MASK32
    c ^= b; c = (c - _rot(b, 14)) & MASK32   # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & MASK32   # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & MASK32   # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & MASK32   # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & MASK32    # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & MASK32   # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & MASK32   # noqa: E702
    return c


def checked(f, data, addr, what):
    """``data`` (a structure whose last 4 bytes are its lookup3 checksum)
    when the checksum matches; OSError naming ``what`` otherwise."""
    if lookup3(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise OSError(f"{f.filename}: {what} at file offset {f._base + addr}: checksum mismatch")
    return data


def read_signed(f, addr, size, signature):
    """``size`` bytes at ``addr``, which must start with ``signature`` and
    version 0; counted in ``f.walked``."""
    data = f._read(addr, size)
    if data[:4] != signature:
        raise OSError(f"{f.filename}: no {signature.decode()} at file offset {f._base + addr}")
    if data[4] != 0:
        raise f._unsupported(f"{signature.decode()} version {data[4]}", addr)
    f.walked[signature.decode()] += 1
    return data


def _enc_size(n):
    """Bytes that hold the integer ``n`` (``H5VM_limit_enc_size``)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


def uints(raw, count, width, fields):
    """Little-endian unsigned fields of ``count`` packed records of
    ``width`` bytes: ``fields`` are (offset, size) pairs; one uint64
    array per field."""
    rows = np.frombuffer(raw, np.uint8, count * width).reshape(count, width)
    out = []
    for offset, size in fields:
        value = np.zeros(count, np.uint64)
        for i in range(size):
            value |= rows[:, offset + i].astype(np.uint64) << np.uint64(8 * i)
        out.append(value)
    return out


# -- the version-2 B-tree ---------------------------------------------- #

class BTree2:
    """A version-2 B-tree: ``records()`` gives the raw bytes of every
    record, in key order, walking every level."""

    def __init__(self, f, addr):
        so, sl = f._so, f._sl
        head = checked(f, read_signed(f, addr, 16 + so + 2 + sl + 4, b"BTHD"), addr, "BTHD")
        self.f, self.type = f, head[5]
        self.node_size, self.record_size, self.depth = struct.unpack_from("<IHH", head, 6)
        self.root = f._addr(head, 16)
        self.root_records = struct.unpack_from("<H", head, 16 + so)[0]
        self.total = int.from_bytes(head[18 + so : 18 + so + sl], "little")
        # H5B2__hdr_init: records per node, and the widths of the
        # "records in child" and "total records" fields of internal nodes
        prefix = 10
        leaf_max = (self.node_size - prefix) // self.record_size
        self.nrec_size = _enc_size(leaf_max)
        cum_max, self.cum_size = [leaf_max], [0]
        for d in range(1, self.depth + 1):
            pointer = so + self.nrec_size + (self.cum_size[d - 1] if d > 1 else 0)
            max_nrec = (self.node_size - (prefix + pointer)) // (self.record_size + pointer)
            cum_max.append((max_nrec + 1) * cum_max[d - 1] + max_nrec)
            self.cum_size.append(_enc_size(cum_max[d]))
        f.walked[f"BTHD type {self.type}"] += 1

    def records(self):
        if self.root is None or self.total == 0:
            return []
        out = []
        self._node(self.root, self.root_records, self.depth, out)
        return out

    def _node(self, addr, nrec, depth, out):
        f, size = self.f, self.record_size
        if depth == 0:
            data = read_signed(f, addr, 10 + nrec * size, b"BTLF")
            checked(f, data, addr, "BTLF")
            out.extend(data[6 + i * size : 6 + (i + 1) * size] for i in range(nrec))
            return
        so = f._so
        pointer = so + self.nrec_size + (self.cum_size[depth - 1] if depth > 1 else 0)
        data = read_signed(f, addr, 10 + nrec * size + (nrec + 1) * pointer, b"BTIN")
        checked(f, data, addr, "BTIN")
        if data[5] != self.type:
            raise OSError(f"{f.filename}: BTIN at file offset {addr} of another tree type")
        base = 6 + nrec * size
        for i in range(nrec + 1):
            pos = base + i * pointer
            child = f._addr(data, pos)
            count = int.from_bytes(data[pos + so : pos + so + self.nrec_size], "little")
            self._node(child, count, depth - 1, out)
            if i < nrec:
                out.append(data[6 + i * size : 6 + (i + 1) * size])


# -- the fractal heap ----------------------------------------------------- #

class FractalHeap:
    """A fractal heap: ``get(heap_id)`` gives an object's bytes, from a
    managed block (walked once into a sorted table of direct blocks), from
    the ID itself (tiny) or through the heap's B-tree of huge objects."""

    def __init__(self, f, addr):
        so, sl = f._so, f._sl
        size = 4 + 1 + 2 + 2 + 1 + 4 + sl + so + sl + so + 8 * sl + 2 + 2 * sl + 2 + 2 + so + 2
        head = read_signed(f, addr, size + 4, b"FRHP")
        self.f = f
        self.id_len, filter_len = struct.unpack_from("<HH", head, 5)
        if filter_len:
            raise f._unsupported("a fractal heap with I/O filters", addr)
        checked(f, head, addr, "FRHP")
        self.flags = head[9]
        self.max_managed = struct.unpack_from("<I", head, 10)[0]
        pos = 14 + sl
        self.huge_btree = f._addr(head, pos)
        pos += so + sl + so + 8 * sl
        self.width = struct.unpack_from("<H", head, pos)[0]
        self.start_block = int.from_bytes(head[pos + 2 : pos + 2 + sl], "little")
        self.max_direct = int.from_bytes(head[pos + 2 + sl : pos + 2 + 2 * sl], "little")
        pos += 2 + 2 * sl
        self.max_heap_bits, _ = struct.unpack_from("<HH", head, pos)
        self.root = f._addr(head, pos + 4)
        self.root_rows = struct.unpack_from("<H", head, pos + 4 + so)[0]
        # H5HF__hdr_finish_init_phase1 / H5HF__dtable_init
        self.off_size = (self.max_heap_bits + 7) // 8
        max_direct_off = (self.max_direct.bit_length() - 1 + 7) // 8
        self.len_size = min(max_direct_off, _enc_size(self.max_managed))
        self.max_direct_rows = (self.max_direct.bit_length() - self.start_block.bit_length()) + 2
        self.first_row_bits = (self.start_block.bit_length() - 1) + (self.width.bit_length() - 1)
        self.checksummed = bool(self.flags & 0x2)
        self._blocks = None
        self._data = {}  # direct block bytes by address
        self._huge = None

    def _row_size(self, row):
        return self.start_block if row == 0 else self.start_block << (row - 1)

    def _direct_blocks(self):
        """Sorted (block offset, address, size) of every direct block."""
        if self._blocks is None:
            blocks = []
            if self.root is not None:
                if self.root_rows == 0:
                    blocks.append((0, self.root, self.start_block))
                else:
                    self._indirect(self.root, self.root_rows, blocks)
            blocks.sort()
            self._blocks = blocks
        return self._blocks

    def _indirect(self, addr, rows, blocks):
        f, so = self.f, self.f._so
        direct_rows = min(rows, self.max_direct_rows)
        n_direct, n_indirect = direct_rows * self.width, (rows - direct_rows) * self.width
        size = 5 + so + self.off_size + (n_direct + n_indirect) * so + 4
        data = checked(f, read_signed(f, addr, size, b"FHIB"), addr, "FHIB")
        pos = 5 + so + self.off_size
        for i in range(n_direct + n_indirect):
            child = f._addr(data, pos + i * so)
            if child is None:
                continue
            row = i // self.width
            if i < n_direct:
                blocks.append((self._block_offset(child), child, self._row_size(row)))
            else:
                span = self._row_size(row)
                self._indirect(child, span.bit_length() - 1 - self.first_row_bits + 1, blocks)

    def _block_offset(self, addr):
        f = self.f
        head = read_signed(f, addr, 5 + f._so + self.off_size, b"FHDB")
        return int.from_bytes(head[5 + f._so :], "little")

    def _block(self, addr, size):
        if addr in self._data:
            return self._data[addr]
        data = bytearray(read_signed(self.f, addr, size, b"FHDB"))
        if self.checksummed:
            pos = 5 + self.f._so + self.off_size
            stored = struct.unpack_from("<I", data, pos)[0]
            data[pos : pos + 4] = bytes(4)
            if lookup3(data) != stored:
                raise OSError(f"{self.f.filename}: FHDB at file offset {addr}: checksum mismatch")
            self.f.walked["FHDB checksum"] += 1
        self._data[addr] = data
        return data

    def get(self, heap_id, where):
        """The bytes of the object ``heap_id`` (raw ID bytes)."""
        f = self.f
        kind = (heap_id[0] >> 4) & 0x3
        if heap_id[0] >> 6:
            raise f._unsupported(f"fractal heap ID version {heap_id[0] >> 6}", where)
        if kind == TINY:
            f.walked["tiny object"] += 1
            if self.id_len <= 18:
                return bytes(heap_id[1 : 1 + (heap_id[0] & 0x0F) + 1])
            length = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return bytes(heap_id[2 : 2 + length])
        if kind == HUGE:
            return self._huge_object(heap_id, where)
        if kind != MANAGED:
            raise f._unsupported(f"fractal heap ID type {kind}", where)
        offset = int.from_bytes(heap_id[1 : 1 + self.off_size], "little")
        length = int.from_bytes(heap_id[1 + self.off_size : 1 + self.off_size + self.len_size],
                                "little")
        blocks = self._direct_blocks()
        i = bisect.bisect_right(blocks, (offset, float("inf"))) - 1
        if i < 0 or offset + length > blocks[i][0] + blocks[i][2]:
            raise OSError(f"{f.filename}: fractal heap object at heap offset {offset} "
                          f"(file offset {where}) lies in no direct block")
        start, addr, size = blocks[i]
        f.walked["managed object"] += 1
        return bytes(self._block(addr, size)[offset - start : offset - start + length])

    def _huge_object(self, heap_id, where):
        f = self.f
        so, sl = f._so, f._sl
        f.walked["huge object"] += 1
        if self.id_len >= 1 + so + sl:
            # the ID holds the object's address and length (records of type 3)
            addr = f._addr(heap_id, 1)
            return f._read(addr, int.from_bytes(heap_id[1 + so : 1 + so + sl], "little"))
        if self._huge is None:
            if self.huge_btree is None:
                raise OSError(f"{f.filename}: huge object at file offset {where} without a B-tree")
            tree = BTree2(f, self.huge_btree)
            if tree.type != 1:
                raise f._unsupported(f"huge objects indexed by B-tree records of type {tree.type}",
                                     self.huge_btree)
            self._huge = {
                int.from_bytes(r[so + sl : so + 2 * sl], "little"):
                    (f._addr(r, 0), int.from_bytes(r[so : so + sl], "little"))
                for r in tree.records()
            }
        key = int.from_bytes(heap_id[1 : 1 + min(self.id_len - 1, sl)], "little")
        if key not in self._huge:
            raise OSError(f"{f.filename}: huge object {key} (file offset {where}) not indexed")
        addr, length = self._huge[key]
        return f._read(addr, length)


# -- the chunk indexes of layout version 4 ------------------------------- #

def chunk_size_len(chunk_bytes):
    """Width of a filtered chunk's stored size in the index elements
    (``H5D__farray_crt_context`` / ``H5D__earray_crt_context``)."""
    return min(1 + ((int(chunk_bytes).bit_length() - 1) + 8) // 8, 8)


def _elements(raw, count, so, size_len, filtered):
    """(addresses, sizes, masks) of ``count`` index elements; sizes are
    0 where the chunks are not filtered (the caller fills them in)."""
    if filtered:
        width = so + size_len + 4
        addrs, sizes, masks = uints(raw, count, width, [(0, so), (so, size_len),
                                                        (so + size_len, 4)])
    else:
        (addrs,) = uints(raw, count, so, [(0, so)])
        sizes = masks = np.zeros(count, np.uint64)
    return addrs, sizes, masks


def _paged(f, addr, prefix, count, page, elem, bitmap, first, what):
    """Elements of a paged data block: ``count`` elements in pages of
    ``page`` elements of ``elem`` bytes after the ``prefix`` bytes at
    ``addr``, each page with its own checksum; (page index, raw bytes) of
    each page that ``bitmap`` (most significant bit first, page ``p`` at
    bit ``first + p``) marks as initialized (the others hold no chunk)."""
    out = []
    pos = addr + prefix
    for p in range(-(-count // page)):
        n = min(page, count - p * page)
        bit = first + p
        if bitmap[bit // 8] & (0x80 >> (bit % 8)):
            data = checked(f, f._read(pos, n * elem + 4), pos, f"{what} page {p}")
            out.append((p, data[:-4]))
            f.walked[f"{what} page"] += 1
        pos += n * elem + 4
    return out


def fixed_array(f, addr, chunk_bytes, where):
    """(index, address, size, mask) arrays of the set elements of the
    fixed array at ``addr``: element i is the chunk of linear index i."""
    so, sl = f._so, f._sl
    head = checked(f, read_signed(f, addr, 8 + sl + so + 4, b"FAHD"), addr, "FAHD")
    client, elem, page_bits = head[5], head[6], head[7]
    count = int.from_bytes(head[8 : 8 + sl], "little")
    dblock = f._addr(head, 8 + sl)
    filtered = client == 1
    size_len = chunk_size_len(chunk_bytes) if filtered else 0
    if elem != so + (size_len + 4 if filtered else 0):
        raise f._unsupported(f"fixed-array elements of {elem} bytes", addr)
    if dblock is None or count == 0:
        return _none()
    page = 1 << page_bits
    if count <= page:
        data = read_signed(f, dblock, 6 + so + count * elem + 4, b"FADB")
        checked(f, data, dblock, "FADB")
        parts = [(0, data[6 + so : -4])]
        page = count
    else:
        pages = -(-count // page)
        init_size = (pages + 7) // 8
        data = read_signed(f, dblock, 6 + so + init_size + 4, b"FADB")
        checked(f, data, dblock, "FADB")
        bitmap = data[6 + so : 6 + so + init_size]
        parts = _paged(f, dblock, len(data), count, page, elem, bitmap, 0, "FADB")
    return _gather(parts, page, so, size_len, filtered)


def _none():
    empty = np.zeros(0, np.uint64)
    return empty.astype(np.int64), empty, empty, empty


def _gather(parts, page, so, size_len, filtered, base=0):
    """Concatenate (page index, raw elements) parts into (index, address,
    size, mask), dropping elements whose address is undefined."""
    idx, addrs, sizes, masks = [], [], [], []
    elem = so + (size_len + 4 if filtered else 0)
    for p, raw in parts:
        n = len(raw) // elem
        a, s, m = _elements(raw, n, so, size_len, filtered)
        idx.append(base + p * page + np.arange(n, dtype=np.int64))
        addrs.append(a)
        sizes.append(s)
        masks.append(m)
    if not idx:
        return _none()
    idx, addrs, sizes, masks = map(np.concatenate, (idx, addrs, sizes, masks))
    keep = addrs != np.uint64((1 << (8 * so)) - 1)
    return idx[keep], addrs[keep], sizes[keep], masks[keep]


def extensible_array(f, addr, chunk_bytes, where):
    """(index, address, size, mask) arrays of the set elements of the
    extensible array at ``addr``: its index block's elements, the data
    blocks the index block points to, and the super blocks' data blocks,
    paged or not."""
    so, sl = f._so, f._sl
    head = checked(f, read_signed(f, addr, 12 + 6 * sl + so + 4, b"EAHD"), addr, "EAHD")
    client, elem, max_bits, iblock_elems, dblk_min, sblk_min, page_bits = head[5:12]
    max_set = int.from_bytes(head[12 + 4 * sl : 12 + 5 * sl], "little")
    iblock = f._addr(head, 12 + 6 * sl)
    filtered = client == 1
    size_len = chunk_size_len(chunk_bytes) if filtered else 0
    if elem != so + (size_len + 4 if filtered else 0):
        raise f._unsupported(f"extensible-array elements of {elem} bytes", addr)
    if iblock is None or max_set == 0:
        return _none()
    # H5EA__hdr_init: the super blocks' data blocks and elements
    nsblks = 1 + (max_bits - (dblk_min.bit_length() - 1))
    page = 1 << page_bits
    off_size = (max_bits + 7) // 8
    info, start_idx, start_dblk = [], 0, 0
    for u in range(nsblks):
        ndblks, nelmts = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        info.append((ndblks, nelmts, start_idx, start_dblk))
        start_idx += ndblks * nelmts
        start_dblk += ndblks
    ib_sblks = 2 * (sblk_min.bit_length() - 1)
    ib_dblk_addrs = 2 * (sblk_min - 1)
    ib_sblk_addrs = nsblks - ib_sblks
    size = 6 + so + iblock_elems * elem + (ib_dblk_addrs + ib_sblk_addrs) * so + 4
    data = checked(f, read_signed(f, iblock, size, b"EAIB"), iblock, "EAIB")
    pos = 6 + so
    parts = [_gather([(0, data[pos : pos + iblock_elems * elem])], 0, so, size_len, filtered)]
    pos += iblock_elems * elem
    dblk_addrs = [f._addr(data, pos + i * so) for i in range(ib_dblk_addrs)]
    pos += ib_dblk_addrs * so
    sblk_addrs = [f._addr(data, pos + i * so) for i in range(ib_sblk_addrs)]
    for u, (ndblks, nelmts, first, first_dblk) in enumerate(info):
        if iblock_elems + first >= max_set:
            break
        paged = nelmts > page
        npages = nelmts // page
        # H5EA__sblock_alloc: ceil(npages / 8) bytes for each data block,
        # but the bits run on from block to block (page p of data block k
        # is bit k * npages + p)
        init_size = ndblks * ((npages + 7) // 8) if paged else 0
        bitmap = None
        if u < ib_sblks:
            blocks = dblk_addrs[first_dblk : first_dblk + ndblks]
        else:
            sblock = sblk_addrs[u - ib_sblks]
            if sblock is None:
                continue
            ssize = 6 + so + off_size + init_size + ndblks * so + 4
            sdata = checked(f, read_signed(f, sblock, ssize, b"EASB"), sblock, "EASB")
            spos = 6 + so + off_size
            bitmap = sdata[spos : spos + init_size]
            spos += init_size
            blocks = [f._addr(sdata, spos + k * so) for k in range(ndblks)]
        for k, dblock in enumerate(blocks):
            base = iblock_elems + first + k * nelmts
            if dblock is None or base >= max_set:
                continue
            prefix = 6 + so + off_size
            if not paged:
                ddata = read_signed(f, dblock, prefix + nelmts * elem + 4, b"EADB")
                checked(f, ddata, dblock, "EADB")
                parts.append(_gather([(0, ddata[prefix:-4])], 0, so, size_len, filtered, base))
                continue
            ddata = checked(f, read_signed(f, dblock, prefix + 4, b"EADB"), dblock, "EADB")
            pages = _paged(f, dblock, prefix + 4, nelmts, page, elem, bitmap, k * npages, "EADB")
            parts.append(_gather(pages, page, so, size_len, filtered, base))
    idx, addrs, sizes, masks = (np.concatenate(x) for x in zip(*parts))
    keep = idx < max_set
    return idx[keep], addrs[keep], sizes[keep], masks[keep]
