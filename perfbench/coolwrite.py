"""A frozen cooler-layout HDF5 writer: the benchmark's own copy.

Writes one resolution of an ``.mcool`` in cooler's layout as cooler
creates it: int64 pixel ids, ``bins/chrom`` an enum of the chromosome
names, every dataset chunked in the rows h5py picks, through HDF5's
shuffle and deflate at level 6, unlimited along its first axis, in
HDF5's earliest format (superblock version 0, version-1 object headers,
symbol-table groups, version-1 chunk B-trees).

It is a condensed copy of ``chromosight_torch/io/cool.py:cool_tables``,
``chunk_rows`` and ``write_cooler_layout`` with the ``libver="earliest"``,
gzip path of ``chromosight_torch/io/hdf5.py:write`` and the version-1
B-tree and symbol-table code of ``chromosight_torch/io/hdf5_write.py``,
frozen here so that the benchmark's input files do not change when the
program's writer does.  It needs numpy and zlib only.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
DATASPACE, DATATYPE, FILL, LAYOUT, FILTERS, ATTRIBUTE, SYMBOL_TABLE = (
    0x1, 0x3, 0x5, 0x8, 0xB, 0xC, 0x11)
DEFLATE, SHUFFLE = 1, 2
UNDEF = (1 << 64) - 1
FREE_NULL = 1
LEAF_K, INTERNAL_K = 4, 16
CHUNK_K = 32
DEFLATE_LEVEL = 6
GLOBAL_HEAP_MIN = 4096
SO = SL = 8
THREADS = min(8, os.cpu_count() or 1)


def _align8(n):
    return (n + 7) & ~7


def _pad8(data):
    return data + b"\0" * (_align8(len(data)) - len(data))


def _o(value):
    return b"\xff" * SO if value == UNDEF else int(value).to_bytes(SO, "little")


class _Appender:
    """Blocks written at the end of a file, each at an 8-byte boundary."""

    def __init__(self, fd, eof):
        self.fd, self.eof = fd, _align8(eof)

    def put(self, data, at=None):
        view = memoryview(data).cast("B")
        addr, done = self.eof, 0
        if at is not None and at != addr:
            raise RuntimeError(f"block written at {addr}, not at {at}")
        while done < len(view):
            done += os.pwrite(self.fd, view[done:], addr + done)
        self.eof = _align8(addr + len(view))
        return addr

    def finish(self):
        if os.fstat(self.fd).st_size < self.eof:
            os.ftruncate(self.fd, self.eof)
        return self.eof


def enum_dtype(mapping, basetype=np.int32):
    """The numpy dtype of an HDF5 enum ({name: value}), as h5py makes it."""
    return np.dtype(np.dtype(basetype).str, metadata={"enum": dict(mapping)})


def _type_message(dtype):
    """The version-1 datatype of a numpy dtype (integers, IEEE floats,
    fixed strings, enums) or of a variable-length UTF-8 string (``str``)."""
    if dtype is str:
        char = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 4 + SO + 4) + char
    dtype = np.dtype(dtype)
    if dtype.metadata and "enum" in dtype.metadata:
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


def _n(value):
    return b"\xff" * SL if value == UNDEF else int(value).to_bytes(SL, "little")


def _space_message(shape, unlimited=False):
    dims = [_n(n) for n in shape]
    top = [_n(UNDEF)] + dims[1:] if unlimited else dims
    return struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + b"".join(dims + top)


def _message(kind, body):
    body = _pad8(body)
    return struct.pack("<HHB3x", kind, len(body), 0) + body


def _object_header(messages):
    size = sum(len(m) for m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, size) + b"".join(messages)


def _global_heap(items):
    """A global heap collection holding ``items`` (bytes) as objects 1..n."""
    head = _align8(8 + SL)

    def object_header(index, size):
        return (struct.pack("<HH4x", index, 0) + _n(size)).ljust(head, b"\0")

    body = b"".join(object_header(i + 1, len(item)) + _pad8(item) for i, item in enumerate(items))
    size = max(GLOBAL_HEAP_MIN, head + len(body) + head)
    free = size - head - len(body)
    return ((b"GCOL" + bytes([1, 0, 0, 0]) + _n(size)).ljust(head, b"\0") + body
            + object_header(0, free) + bytes(free - head))


def _attribute_messages(attrs, out):
    """Version-1 attribute messages of ``attrs`` (str, ints, floats);
    the strings go into a new global heap collection."""
    strings = [v.encode("utf-8") for v in attrs.values() if isinstance(v, str)]
    heap = out.put(_global_heap(strings)) if strings else None
    messages, index = [], 0
    for name, value in attrs.items():
        if isinstance(value, str):
            index += 1
            kind, shape = _type_message(str), ()
            data = struct.pack("<I", len(strings[index - 1])) + _o(heap) + struct.pack("<I", index)
        else:
            array = np.asarray(value)
            kind, shape, data = _type_message(array.dtype), array.shape, array.tobytes()
        space = _space_message(shape)
        encoded = name.encode("utf-8") + b"\0"
        body = (struct.pack("<BBHHH", 1, 0, len(encoded), len(kind), len(space))
                + _pad8(encoded) + _pad8(kind) + _pad8(space) + data)
        messages.append(_message(ATTRIBUTE, body))
    return messages


def _btree1(out, kind, keys, children, per_node, node_size):
    """A version-1 B-tree of type ``kind`` over ``children``; the root."""
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
            node = b"TREE" + struct.pack("<BBH", kind, level, stop - start)
            node += _o(left) + _o(right)
            node += b"".join(keys[j] + _o(children[j]) for j in range(start, stop))
            node += keys[stop]
            out.put(node + bytes(node_size - len(node)), addrs[i])
            up_keys.append(keys[start])
        if len(addrs) == 1:
            return addrs[0]
        keys, children = up_keys + [keys[-1]], addrs
        level += 1


def _btree1_size(per_node, key_size):
    return 8 + 2 * SO + per_node * SO + (per_node + 1) * key_size


def _symbol_table(out, entries, name_keys, first_key):
    per_node = 2 * LEAF_K
    size = 8 + per_node * (SO + SL + 24)
    children, keys = [], [_n(first_key)]
    for start in range(0, max(len(entries), 1), per_node):
        rows = entries[start : start + per_node]
        node = b"SNOD" + struct.pack("<BBH", 1, 0, len(rows)) + b"".join(rows)
        children.append(out.put(node + bytes(size - len(node))))
        last = name_keys[min(start + per_node, len(entries)) - 1] if entries else first_key
        keys.append(_n(last))
    k = 2 * INTERNAL_K
    return _btree1(out, 0, keys, children, k, _btree1_size(k, SL))


def _shuffled_chunks(flat, first, count, size, element):
    """HDF5's byte shuffle of chunks ``first`` .. ``first + count`` of
    ``size`` bytes of ``flat`` (uint8; the last chunk padded with zeros),
    in one numpy call: a (count, size) uint8 array."""
    raw = flat[first * size : (first + count) * size]
    if len(raw) < count * size:
        raw = np.concatenate([raw, np.zeros(count * size - len(raw), np.uint8)])
    if element == 1:
        return raw.reshape(count, size)
    return np.ascontiguousarray(
        raw.reshape(count, size // element, element).transpose(0, 2, 1)).reshape(count, size)


# chunks shuffled and compressed by one task of the pool
BATCH = 64


def _chunked_data(array, rows, out, pool):
    """Write ``array`` as chunks of ``rows`` rows through shuffle and
    deflate 6, and its version-1 chunk B-tree; the filter pipeline and
    layout messages."""
    tail, element = array.shape[1:], array.dtype.itemsize
    row = element * int(np.prod(tail, dtype=np.int64))
    flat = array.reshape(-1).view(np.uint8) if array.size else np.zeros(0, np.uint8)
    n_chunks = -(-array.shape[0] // rows) if array.shape and array.shape[0] else 0
    size = rows * row

    def compress(first):
        count = min(BATCH, n_chunks - first)
        shuffled = _shuffled_chunks(flat, first, count, size, element)
        return [zlib.compress(chunk, DEFLATE_LEVEL) for chunk in shuffled]

    starts = range(0, n_chunks, BATCH)
    results = pool.map(compress, starts) if pool is not None else map(compress, starts)
    rank = len(array.shape)
    children, sizes = [], []
    for done in results:
        for data in done:
            children.append(out.put(data))
            sizes.append(len(data))
    dims = [rows, *tail, element]
    keys = [struct.pack(f"<II{rank + 1}Q", n, 0, k * rows, *[0] * rank)
            for k, n in enumerate(sizes)]
    keys.append(struct.pack(f"<II{rank + 1}Q", 0, 0, n_chunks * rows, *[0] * (rank - 1),
                            element))
    per_node = 2 * CHUNK_K
    key_size = 8 + 8 * (rank + 1)
    btree = _btree1(out, 1, keys, children, per_node,
                    _btree1_size(per_node, key_size)) if children else UNDEF
    pipeline = struct.pack("<BB6x", 1, 2)
    for fid, name, values in ((SHUFFLE, b"shuffle", (element,)),
                              (DEFLATE, b"deflate", (DEFLATE_LEVEL,))):
        pipeline += struct.pack("<HHHH", fid, 8, 1, len(values)) + name.ljust(8, b"\0")
        pipeline += struct.pack(f"<{len(values)}I", *values) + bytes(4 * (len(values) % 2))
    layout = bytes([3, 2, rank + 1]) + _o(btree) + struct.pack(f"<{rank + 1}I", *dims)
    return [(FILTERS, pipeline), (LAYOUT, layout)]


def _dataset_header(array, out, chunk, pool):
    layout = [_message(kind, body) for kind, body in _chunked_data(array, int(chunk), out, pool)]
    fill = bytes([2, 3, 2, 1, 0, 0, 0, 0])  # allocated incrementally
    return out.put(_object_header([
        _message(DATASPACE, _space_message(array.shape, unlimited=True)),
        _message(DATATYPE, _type_message(array.dtype)),
        _message(FILL, fill),
        *layout,
    ]))


def _entry(name_offset, header, cache=None):
    if cache is None:
        return _n(name_offset) + _o(header) + bytes(24)
    scratch = _o(cache[0]) + _o(cache[1])
    return _n(name_offset) + _o(header) + struct.pack("<II", 1, 0) + scratch.ljust(16, b"\0")


def _write_group(out, tree, attrs, path, options):
    """Write the members of ``tree`` ({name: array or subtree}), then the
    symbol-table group at ``path``; (header, (B-tree, heap))."""
    chunks, group_attrs, pool = options
    members = []
    for name in sorted(tree, key=lambda n: n.encode("utf-8")):
        node, where = tree[name], f"{path}/{name}".strip("/")
        if isinstance(node, dict):
            header, cache = _write_group(out, node, group_attrs.get(where, {}), where, options)
            members.append((name, header, cache))
        else:
            header = _dataset_header(np.ascontiguousarray(node), out, chunks[where], pool)
            members.append((name, header, None))
    heap_data, offsets = bytearray(8), []
    for name, _, _ in members:
        offsets.append(len(heap_data))
        heap_data += _pad8(name.encode("utf-8") + b"\0")
    free = len(heap_data)
    heap_data += _n(FREE_NULL) + _n(64) + bytes(64 - 2 * SL)
    heap = out.eof
    data = heap + 8 + 2 * SL + SO
    out.put(b"HEAP" + bytes(4) + _n(len(heap_data)) + _n(free) + _o(data) + heap_data)
    entries = [_entry(offset, header, cache) for offset, (_, header, cache) in zip(offsets, members)]
    btree = _symbol_table(out, entries, offsets, 0)
    header = out.put(_object_header(
        [_message(SYMBOL_TABLE, _o(btree) + _o(heap)), *_attribute_messages(attrs, out)]
    ))
    return header, (btree, heap)


def write_hdf5(path, datasets, attrs, chunks, group_attrs):
    """Write a new HDF5 file of chunked ``datasets`` ({path: array}), the
    root's ``attrs`` and ``group_attrs`` ({group path: attributes})."""
    tree = {}
    for name, array in datasets.items():
        *groups, leaf = [p for p in name.split("/") if p]
        node = tree
        for group in groups:
            node = node.setdefault(group, {})
        node[leaf] = array
    pool = concurrent.futures.ThreadPoolExecutor(THREADS) if THREADS > 1 else None
    fd = os.open(str(path), os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
    try:
        out = _Appender(fd, 24 + 4 * SO + SO + SL + 24)
        header, cache = _write_group(out, tree, dict(attrs), "", (chunks, group_attrs, pool))
        eof = out.finish()
        superblock = (
            SIGNATURE + bytes([0, 0, 0, 0, 0, SO, SL, 0])
            + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
            + _o(0) + _o(UNDEF) + _o(eof) + _o(UNDEF)
            + _entry(0, header, cache)
        )
        os.pwrite(fd, superblock, 0)
    finally:
        os.close(fd)
        if pool is not None:
            pool.shutdown()
    return str(path)


def chunk_rows(rows, itemsize):
    """The rows of a chunk that h5py picks for a one-dimensional dataset
    of ``rows`` elements of ``itemsize`` bytes (``guess_chunk``)."""
    chunks = float(rows or 1024)
    target = 16 * 1024 * 2 ** np.log10(chunks * itemsize / (1024.0 * 1024))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    while True:
        size = chunks * itemsize
        if (size < target or abs(size - target) / target < 0.5) and size < 1024 * 1024:
            break
        if chunks == 1:
            break
        chunks = np.ceil(chunks / 2.0)
    return int(chunks)


def write_mcool(path, chrom_names, chrom_lengths, binsize, weights, bin1, bin2, count,
                resolution_group, pixel_rows):
    """Write one resolution of an ``.mcool`` in cooler's layout.

    ``chrom_names``/``chrom_lengths``: the chromosomes in order (bp);
    bins are ``binsize`` wide, the last of each chromosome cut at its
    length; ``weights``: float64 per bin (NaN: no weight), stored as
    ``bins/weight``; ``bin1``, ``bin2``, ``count``: the pixels, sorted by
    (bin1, bin2), upper triangle; ``resolution_group``:
    "resolutions/<binsize>"; ``pixel_rows``: the length cooler creates
    the pixel columns at, from which h5py picks their chunks."""
    lengths = np.asarray(chrom_lengths, np.int64)
    n_per = -(-lengths // binsize)
    chrom_ids = np.repeat(np.arange(len(lengths), dtype=np.int32), n_per)
    starts = np.concatenate([np.arange(n, dtype=np.int64) * binsize for n in n_per])
    ends = np.minimum(starts + binsize, np.repeat(lengths, n_per))
    n_bins = int(n_per.sum())
    chrom_offset = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(n_per, out=chrom_offset[1:])
    bin1_offset = np.zeros(n_bins + 1, dtype=np.int64)
    np.cumsum(np.bincount(bin1, minlength=n_bins), out=bin1_offset[1:])
    enum = enum_dtype({name: i for i, name in enumerate(chrom_names)}, np.int32)
    tables = {
        "chroms/name": np.array(chrom_names, dtype="S32"),
        "chroms/length": lengths.astype(np.int32),
        "bins/chrom": chrom_ids.view(enum),
        "bins/start": starts.astype(np.int32),
        "bins/end": ends.astype(np.int32),
        "bins/weight": np.asarray(weights, np.float64),
        "pixels/bin1_id": np.asarray(bin1, np.int64),
        "pixels/bin2_id": np.asarray(bin2, np.int64),
        "pixels/count": np.asarray(count, np.int32),
        "indexes/chrom_offset": chrom_offset,
        "indexes/bin1_offset": bin1_offset,
    }
    attrs = {
        "format": "HDF5::Cooler",
        "format-version": "3",
        "format-url": "https://github.com/mirnylab/cooler",
        "bin-type": "fixed",
        "bin-size": int(binsize),
        "storage-mode": "symmetric-upper",
        "nbins": n_bins,
        "nchroms": len(chrom_names),
        "nnz": len(bin1),
        "sum": float(np.asarray(count, np.float64).sum()),
        "genome-assembly": "unknown",
        "generated-by": "perfbench",
        "metadata": json.dumps({}),
    }
    prefix = resolution_group.strip("/")
    chunks, datasets = {}, {}
    for name, array in tables.items():
        rows = pixel_rows if name.startswith("pixels/") else len(array)
        chunks[f"{prefix}/{name}"] = chunk_rows(rows, array.dtype.itemsize)
        datasets[f"{prefix}/{name}"] = array
    root = {"format": "HDF5::MCOOL", "format-version": 2}
    return write_hdf5(path, datasets, root, chunks, {prefix: attrs})
