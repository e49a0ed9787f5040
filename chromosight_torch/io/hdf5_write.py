"""The structures that ``chromosight_torch.io.hdf5`` writes: the
counterparts of the readers in ``hdf5_index`` and of the version-1
B-trees of ``hdf5``.

* ``fractal_heap``: a fractal heap (``FRHP``) holding a list of objects
  in a root direct block (``FHDB``) or, past one block, in the direct
  blocks of a root indirect block (``FHIB``), with the free-space manager
  (``FSHD``, ``FSSE``) of the space its blocks leave, as HDF5 closes a
  heap; ``LINK_HEAP`` and ``ATTRIBUTE_HEAP`` are the parameters HDF5
  creates a group's link heap and an object's attribute heap with.
* ``btree2``: a version-2 B-tree (``BTHD``, ``BTIN``, ``BTLF``) over
  sorted records, bulk-loaded to the depth their count needs.
* ``btree1``: a version-1 B-tree (``TREE``) of groups (type 0) or chunks
  (type 1) over children and keys, of as many levels as needed.
* ``extensible_array`` and ``fixed_array``: the chunk indexes of data
  layout version 4 (``EAHD``, ``EAIB``, ``EASB``, ``EADB``; ``FAHD``,
  ``FADB``), paged where HDF5 pages them.
* ``object_header``: a version-2 object header (``OHDR``).

Every structure is written through an ``Appender`` at the end of the
file, at an address known before it is written, and carries its lookup3
checksum.  Addresses and lengths take the file's sizes of offsets and
lengths (2, 4 or 8 bytes, the ``Appender``'s ``so`` and ``sl``); an
address of ``UNDEF`` is written as the file's undefined address.
"""

from __future__ import annotations

import errno
import os
import struct

from chromosight_torch.io.hdf5_index import lookup3

UNDEF = (1 << 64) - 1


def align8(n):
    return (n + 7) & ~7


def enc_size(n):
    """Bytes that hold the integer ``n`` (``H5VM_limit_enc_size``)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


def signed(data):
    """``data`` followed by its lookup3 checksum."""
    return data + struct.pack("<I", lookup3(data))


def u(value, size):
    """``value`` in ``size`` little-endian bytes (OverflowError when it
    does not fit)."""
    try:
        return int(value).to_bytes(size, "little")
    except OverflowError:
        raise OverflowError(f"{value} does not fit a field of {size} bytes") from None


def addr(value, so):
    """An address in ``so`` bytes, ``UNDEF`` as the undefined address."""
    return b"\xff" * so if value == UNDEF else u(value, so)


class Appender:
    """Writes blocks at the end of a file, each at an 8-byte boundary.
    Addresses count from ``base`` (the user block's size), in ``so``
    bytes; lengths take ``sl`` bytes.  A block that would end past what
    ``so`` bytes address (the file's end, user block included, is stored
    in them) raises ``OSError`` (EFBIG) before it is written."""

    def __init__(self, fd, eof, base=0, so=8, sl=8):
        self.fd, self.eof, self.base, self.so, self.sl = fd, align8(eof), base, so, sl

    def o(self, value):
        """An address (``UNDEF``: undefined) in the file's size of offsets."""
        return addr(value, self.so)

    def n(self, value):
        """A length in the file's size of lengths (``UNDEF``: all ones, an
        unlimited dimension)."""
        return b"\xff" * self.sl if value == UNDEF else u(value, self.sl)

    def put(self, data, at=None):
        """Write ``data`` (bytes or a contiguous array) at the end; its
        address, which must be ``at`` when given."""
        view = memoryview(data).cast("B")
        addr, done = self.eof, 0
        if at is not None and at != addr:
            raise RuntimeError(f"block written at {addr}, not at {at}")
        if self.base + align8(addr + len(view)) >= (1 << (8 * self.so)) - 1:
            raise OSError(errno.EFBIG, f"{len(view)} bytes at address {addr} end past what "
                          f"{self.so}-byte offsets address")
        while done < len(view):
            done += os.pwrite(self.fd, view[done:], self.base + addr + done)
        self.eof = align8(addr + len(view))
        return addr

    def finish(self):
        """Extend the file to the end address (the last block's padding)."""
        if os.fstat(self.fd).st_size < self.base + self.eof:
            os.ftruncate(self.fd, self.base + self.eof)
        return self.eof


# -- the fractal heap ---------------------------------------------------- #

class HeapParams:
    """Creation parameters of a fractal heap (``H5HF_create_t``)."""

    def __init__(self, start_block, max_index):
        self.width, self.start_block, self.max_direct = 4, start_block, 64 * 1024
        self.max_index, self.max_managed = max_index, 4096
        # H5HF__hdr_finish_init_phase1: heap offsets, object lengths
        self.off_size = (max_index + 7) // 8
        max_direct_off = (self.max_direct.bit_length() - 1 + 7) // 8
        self.len_size = min(max_direct_off, enc_size(self.max_managed))
        self.id_len = 1 + self.off_size + self.len_size

    def block_header(self, so):
        """Bytes before a (checksummed) direct block's objects."""
        return 5 + so + self.off_size + 4

    def row_size(self, row):
        return self.start_block if row == 0 else self.start_block << (row - 1)


# H5G dense link storage (H5Gdense.c) and H5A dense attribute storage
# (H5Adense.c): a start block of 512 / 1,024 bytes, 32 / 40 bits of
# heap offsets
LINK_HEAP = HeapParams(512, 32)
ATTRIBUTE_HEAP = HeapParams(1024, 40)


def fractal_heap(out, objects, params):
    """Write a fractal heap holding ``objects`` (bytes, each at most
    ``params.max_managed``) in order, packed into its blocks; (header
    address, heap ID of each object).  One root direct block holds them
    while they fit, else a root indirect block of 1, 2, 4 or 8 rows whose
    direct blocks are allocated in order as far as needed (the rest
    undefined, the allocation iterator at the next).  The free space each
    block leaves is one section of HDF5's free-space manager."""
    p, so, sl = params, out.so, out.sl
    block_header = p.block_header(so)
    blocks, placed = [], []  # [heap offset, size, objects, bytes used]
    start = 0
    for obj in objects:
        if len(obj) > p.max_managed:
            raise NotImplementedError(f"a fractal heap object of {len(obj)} bytes")
        if not blocks or blocks[-1][3] + len(obj) > blocks[-1][1]:
            size = p.row_size(len(blocks) // p.width)
            if block_header + len(obj) > size:
                raise NotImplementedError(f"a fractal heap object of {len(obj)} bytes past "
                                          f"a direct block of {size}")
            blocks.append([start, size, [], block_header])
            start += size
        block = blocks[-1]
        placed.append(block[0] + block[3])
        block[2].append(obj)
        block[3] += len(obj)
    if not blocks:
        blocks.append([0, p.start_block, [], block_header])
    nrows = 0
    if len(blocks) > 1:
        nrows = 1
        while nrows * p.width < len(blocks):
            nrows *= 2
        if nrows > 8:
            raise NotImplementedError(f"a fractal heap of {len(blocks)} direct blocks")
    free = [(b[0] + b[3], b[1] - b[3]) for b in blocks if b[1] > b[3]]
    head = align8(out.eof)
    at = align8(head + 26 + 12 * sl + 3 * so)  # the header's size
    iblock = None
    if nrows:
        iblock = at
        at = align8(at + 5 + so + p.off_size + nrows * p.width * so + 4)
    addrs = []
    for b in blocks:
        addrs.append(at)
        at = align8(at + b[1])
    fs_head = fs_list = UNDEF
    if free:
        fs_head = at
        fs_list = align8(at + 6 + 4 * sl + 8 + sl + so + 2 * sl + 4)
    # H5FS__sinfo_serialize: the sections grouped by size (their count and
    # size), each section its heap offset and class (0: a single section)
    count_size, len_size = enc_size(len(free)), enc_size(p.max_direct)
    by_size = {}
    for where, size in free:
        by_size.setdefault(size, []).append(where)
    sections = b"".join(
        u(len(w), count_size) + u(size, len_size)
        + b"".join(u(x, p.off_size) + b"\0" for x in sorted(w))
        for size, w in sorted(by_size.items()))
    section_list = signed(b"FSSE\0" + out.o(fs_head) + sections)
    total_free = sum(size for _, size in free)
    man_space = p.width * sum(p.row_size(r) for r in range(nrows)) if nrows else p.start_block
    iterator = blocks[-1][0] + blocks[-1][1] if nrows else 0
    header = (
        b"FRHP\0" + struct.pack("<HHBI", p.id_len, 0, 0x02, p.max_managed)
        + out.n(0) + out.o(UNDEF) + out.n(total_free) + out.o(fs_head)
        + out.n(man_space) + out.n(sum(b[1] for b in blocks)) + out.n(iterator)
        + out.n(len(objects)) + out.n(0) * 4 + struct.pack("<H", p.width)
        + out.n(p.start_block) + out.n(p.max_direct) + struct.pack("<HH", p.max_index, 1)
        + out.o(addrs[0] if iblock is None else iblock) + struct.pack("<H", nrows)
    )
    out.put(signed(header), head)
    if iblock is not None:
        children = [out.o(a) for a in addrs] + [out.o(UNDEF)] * (nrows * p.width - len(addrs))
        out.put(signed(b"FHIB\0" + out.o(head) + u(0, p.off_size) + b"".join(children)), iblock)
    for b, addr in zip(blocks, addrs):
        body = bytearray(b"FHDB\0" + out.o(head) + u(b[0], p.off_size) + bytes(4))
        for obj in b[2]:
            body += obj
        body += bytes(b[1] - len(body))
        body[block_header - 4 : block_header] = struct.pack("<I", lookup3(bytes(body)))
        out.put(bytes(body), addr)
    if free:
        fs_header = (
            b"FSHD\0\0" + out.n(total_free) + out.n(len(free)) + out.n(len(free)) + out.n(0)
            + struct.pack("<HHHH", 4, 80, 120, p.max_index) + out.n(p.max_direct)
            + out.o(fs_list) + out.n(len(section_list)) + out.n(len(section_list))
        )
        out.put(signed(fs_header), fs_head)
        out.put(section_list, fs_list)
    ids = [b"\0" + u(where, p.off_size) + u(len(obj), p.len_size)
           for where, obj in zip(placed, objects)]
    return head, ids


# -- the version-2 B-tree -------------------------------------------------- #

# the node size and split / merge percentages HDF5 gives the v2 B-trees of
# links and attributes
NODE_SIZE, SPLIT, MERGE = 512, 100, 40


def btree2(out, kind, records, record_size):
    """Write a version-2 B-tree of type ``kind`` over ``records`` (bytes of
    ``record_size`` each, in key order): leaves of up to their capacity,
    evenly filled, under internal nodes of as many levels as the count
    needs, every node ``NODE_SIZE`` bytes; the header's address."""
    node_size = NODE_SIZE
    leaf_max = (node_size - 10) // record_size
    nrec_size = enc_size(leaf_max)
    caps, cum_size, pointers = [leaf_max], [0], [0]
    while caps[-1] < len(records):
        d = len(caps)
        pointer = out.so + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec = (node_size - (10 + pointer)) // (record_size + pointer)
        caps.append((max_nrec + 1) * caps[d - 1] + max_nrec)
        cum_size.append(enc_size(caps[d]))
        pointers.append(pointer)
    depth = len(caps) - 1

    def build(recs, d):
        """(address, records in the node, records in the subtree) of a
        subtree of depth ``d`` over ``recs``."""
        if d == 0:
            node = signed(b"BTLF\0" + bytes([kind]) + b"".join(recs))
            return out.put(node + bytes(node_size - len(node))), len(recs), len(recs)
        n = len(recs)
        children = -(-(n + 1) // (caps[d - 1] + 1))
        per = n - (children - 1)
        parts, seps, at = [], [], 0
        for i in range(children):
            take = per // children + (1 if i < per % children else 0)
            parts.append(recs[at : at + take])
            at += take
            if i + 1 < children:
                seps.append(recs[at])
                at += 1
        body = b"BTIN\0" + bytes([kind]) + b"".join(seps)
        for part in parts:
            addr, nrec, total = build(part, d - 1)
            body += out.o(addr) + u(nrec, nrec_size)
            if d > 1:
                body += u(total, cum_size[d - 1])
        node = signed(body)
        return out.put(node + bytes(node_size - len(node))), len(seps), n

    root, root_records = UNDEF, 0
    if records:
        root, root_records, _ = build(list(records), depth)
    header = (b"BTHD\0" + bytes([kind]) + struct.pack("<IHHBB", node_size, record_size, depth,
                                                      SPLIT, MERGE)
              + out.o(root) + struct.pack("<H", root_records) + out.n(len(records)))
    return out.put(signed(header))


# -- the version-1 B-tree -------------------------------------------------- #

def btree1(out, kind, keys, children, per_node, node_size):
    """Write a version-1 B-tree of type ``kind`` (0: a group's, 1: a
    dataset's chunks) over ``children`` (addresses, in order) and
    ``keys`` (one before each child and one after the last): nodes of up
    to ``per_node`` children, then levels of nodes over them until one
    node holds the rest, each level's nodes adjacent and linked to their
    siblings, each node ``node_size`` bytes (``btree1_size``); the root's
    address."""
    level = 0
    while True:
        starts = range(0, len(children), per_node)
        base = align8(out.eof)
        addrs = [base + i * node_size for i in range(len(starts))]
        up_keys = []
        for i, start in enumerate(starts):
            stop = min(start + per_node, len(children))
            left = addrs[i - 1] if i else UNDEF
            right = addrs[i + 1] if i + 1 < len(addrs) else UNDEF
            node = b"TREE" + struct.pack("<BBH", kind, level, stop - start)
            node += out.o(left) + out.o(right)
            node += b"".join(keys[j] + out.o(children[j]) for j in range(start, stop))
            node += keys[stop]
            out.put(node + bytes(node_size - len(node)), addrs[i])
            up_keys.append(keys[start])
        if len(addrs) == 1:
            return addrs[0]
        keys, children = up_keys + [keys[-1]], addrs
        level += 1


def btree1_size(out, per_node, key_size):
    """Bytes of a version-1 B-tree node of ``per_node`` children and keys
    of ``key_size`` bytes (``H5B__compute_size``)."""
    return 8 + 2 * out.so + per_node * out.so + (per_node + 1) * key_size


def symbol_table(out, entries, name_keys, first_key, leaf_k, internal_k):
    """Write the symbol-table nodes (``SNOD``, up to 2 * ``leaf_k``
    entries each) of ``entries`` (so + sl + 24-byte entries in name order) and the
    group B-tree over them (type 0, 2 * ``internal_k`` children a node,
    keyed by the heap offset of each node's last name, ``name_keys``, and
    ``first_key`` before the first); the B-tree's address.  A group with
    no entry gets one empty node."""
    per_node = 2 * leaf_k
    size = 8 + per_node * (out.so + out.sl + 24)
    children, keys = [], [out.n(first_key)]
    for start in range(0, max(len(entries), 1), per_node):
        rows = entries[start : start + per_node]
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(rows)) + b"".join(rows)
        children.append(out.put(node + bytes(size - len(node))))
        last = name_keys[min(start + per_node, len(entries)) - 1] if entries else first_key
        keys.append(out.n(last))
    k = 2 * internal_k
    return btree1(out, 0, keys, children, k, btree1_size(out, k, out.sl))


# -- the chunk indexes of data layout version 4 ----------------------------- #

# H5D__earray_idx_create / H5D__farray_idx_create: HDF5's defaults
EA_MAX_BITS, EA_IBLOCK, EA_SBLK_MIN, EA_DBLK_MIN, PAGE_BITS = 32, 4, 4, 16, 10


def _element(out, at, size, mask, size_len):
    if size_len:
        return out.o(at) + u(size, size_len) + struct.pack("<I", mask)
    return out.o(at)


def _data_elements(out, elements, lo, n, size_len):
    """The raw elements lo .. lo + n of ``elements`` ((address, size,
    mask) each), undefined past its end."""
    empty = _element(out, UNDEF, 0, 0, size_len)
    return b"".join(_element(out, *elements[i], size_len) if i < len(elements) else empty
                    for i in range(lo, lo + n))


def _paged(raw_pages):
    """Pages of elements, each followed by its checksum."""
    return b"".join(signed(page) for page in raw_pages)


def extensible_array(out, elements, size_len):
    """Write the extensible array of a chunked dataset with one unlimited
    axis (HDF5's default parameters): ``elements`` (address, stored size,
    filter mask) of chunks 0..n-1, ``size_len`` the width of a filtered
    chunk's size (0: not filtered); the header's address.  The index
    block holds the first 4 elements and the data blocks of the first
    super blocks, then super blocks of data blocks; data blocks above
    1,024 elements are paged."""
    n, elem = len(elements), out.so + (size_len + 4 if size_len else 0)
    nsblks = 1 + (EA_MAX_BITS - (EA_DBLK_MIN.bit_length() - 1))
    off_size = (EA_MAX_BITS + 7) // 8
    page = 1 << PAGE_BITS
    info, start_idx, start_dblk = [], 0, 0
    for s in range(nsblks):
        ndblks, nelmts = 1 << (s // 2), (1 << ((s + 1) // 2)) * EA_DBLK_MIN
        info.append((ndblks, nelmts, start_idx, start_dblk))
        start_idx += ndblks * nelmts
        start_dblk += ndblks
    ib_sblks = 2 * (EA_SBLK_MIN.bit_length() - 1)
    ib_dblk_addrs, ib_sblk_addrs = 2 * (EA_SBLK_MIN - 1), nsblks - ib_sblks
    head = align8(out.eof)
    header_size = 12 + 6 * out.sl + out.so + 4
    iblock = align8(head + header_size)
    iblock_size = 6 + out.so + EA_IBLOCK * elem + (ib_dblk_addrs + ib_sblk_addrs) * out.so + 4
    at = align8(iblock + iblock_size)
    dblk_addrs, sblk_addrs = [UNDEF] * ib_dblk_addrs, [UNDEF] * ib_sblk_addrs
    writes = []  # (address, bytes)
    stats = [0, 0, 0, 0]  # super blocks, their bytes, data blocks, their bytes
    realized = EA_IBLOCK
    prefix = 6 + out.so + off_size
    for s, (ndblks, nelmts, first, first_dblk) in enumerate(info):
        if EA_IBLOCK + first >= n:
            break
        paged = nelmts > page
        npages = nelmts // page
        init_size = ndblks * ((npages + 7) // 8) if paged else 0
        sblock, bitmap, blocks = None, bytearray(init_size), []
        if s >= ib_sblks:
            sblock = at
            at = align8(at + prefix + init_size + ndblks * out.so + 4)
        for k in range(ndblks):
            base = EA_IBLOCK + first + k * nelmts
            if base >= n:
                blocks.append(UNDEF)
                continue
            # H5EA__lookup_elmt: the offset of a data block of the index
            # block counts its index over all data blocks
            offset = first + (first_dblk + k if sblock is None else k) * nelmts
            head_bytes = b"EADB\0\x01" + out.o(head) + u(offset, off_size)
            if not paged:
                data = signed(head_bytes + _data_elements(out, elements, base, nelmts, size_len))
            else:
                pages = []
                for q in range(npages):
                    lo = base + q * page
                    pages.append(_data_elements(out, elements, lo, page, size_len))
                    if lo < n:
                        bit = k * npages + q
                        bitmap[bit // 8] |= 0x80 >> (bit % 8)
                data = signed(head_bytes) + _paged(pages)
            blocks.append(at)
            writes.append((at, data))
            at = align8(at + len(data))
            stats[2] += 1
            stats[3] += len(data)
            realized += nelmts
        if sblock is None:
            dblk_addrs[first_dblk : first_dblk + ndblks] = blocks
        else:
            body = signed(b"EASB\0\x01" + out.o(head) + u(first, off_size) + bytes(bitmap)
                          + b"".join(out.o(a) for a in blocks))
            writes.append((sblock, body))
            sblk_addrs[s - ib_sblks] = sblock
            stats[0] += 1
            stats[1] += len(body)
    header = (b"EAHD\0\x01" + bytes([elem, EA_MAX_BITS, EA_IBLOCK, EA_DBLK_MIN, EA_SBLK_MIN,
                                      PAGE_BITS])
              + b"".join(out.n(v) for v in stats) + out.n(n) + out.n(realized if n else 0)
              + out.o(iblock if n else UNDEF))
    out.put(signed(header), head)
    if not n:
        return head
    body = (b"EAIB\0\x01" + out.o(head) + _data_elements(out, elements, 0, EA_IBLOCK, size_len)
            + b"".join(out.o(a) for a in dblk_addrs) + b"".join(out.o(a) for a in sblk_addrs))
    out.put(signed(body), iblock)
    for addr, data in sorted(writes):
        out.put(data, addr)
    return head


def fixed_array(out, elements, size_len):
    """Write the fixed array of a chunked dataset of fixed size: one
    element (address, stored size, filter mask) per chunk, paged by 1,024
    elements past that; the header's address."""
    n, elem = len(elements), out.so + (size_len + 4 if size_len else 0)
    page = 1 << PAGE_BITS
    head = align8(out.eof)
    dblock = align8(head + 8 + out.sl + out.so + 4)
    out.put(signed(b"FAHD\0" + bytes([1 if size_len else 0, elem, PAGE_BITS]) + out.n(n)
                   + out.o(dblock)), head)
    prefix = b"FADB\0" + bytes([1 if size_len else 0]) + out.o(head)
    if n <= page:
        out.put(signed(prefix + _data_elements(out, elements, 0, n, size_len)), dblock)
    else:
        pages = -(-n // page)
        bitmap = bytearray((pages + 7) // 8)
        for q in range(pages):
            bitmap[q // 8] |= 0x80 >> (q % 8)
        raw = [_data_elements(out, elements, q * page, min(page, n - q * page), size_len)
               for q in range(pages)]
        out.put(signed(prefix + bytes(bitmap)) + _paged(raw), dblock)
    return head


# -- the version-2 object header ------------------------------------------ #

def object_header(messages):
    """A version-2 object header (no times, no attribute phase change)
    of ``messages``, (type, body) pairs, in one chunk."""
    body = b"".join(struct.pack("<BHB", kind, len(data), 0) + data for kind, data in messages)
    width = 0 if len(body) < 1 << 8 else 1 if len(body) < 1 << 16 else 2
    return signed(b"OHDR\x02" + bytes([width]) + u(len(body), 1 << width) + body)
