"""Native (C++) host kernels, bound via ctypes with transparent fallback.

The port's copy of the entries of ``chromosight_tpu/native`` that it
calls: ``cc_label``, ``coo_to_band``, ``band_scatter_fused``, the raw-count
band scatters (``band_scatter_counts_indptr``,
``band_scatter_counts_u8_indptr``, ``band_scatter_counts_u4_indptr``),
``trans_coo_balanced``, ``remove_neighbours`` and the ICE loops
(``marginal_sums``, ``ice_iterate``, ``ice_iterate_csr``,
``ice_prep_csr``, ``ice_iterate_csr_prebuilt``), with the same bodies.

``kernels.cpp`` is built with g++ (OpenMP when the toolchain has it) at
first use into ``build/chromosight_torch/native/<hash>/`` at the
repository root; the hash covers the source and the command line, so an
edited source rebuilds, and nothing is written beside the source.  Every
entry returns None when the library cannot be built or loaded, and its
callers then take their numpy versions.  Set CHROMOSIGHT_TPU_NO_NATIVE=1
to disable it, as for the JAX package.

The HDF5 reader's and writer's filters are built the same way from
``lzf.cpp`` (LZF decoding), ``shuffle.cpp`` (the shuffle filter),
``inflate.cpp`` (deflate-filtered chunks of a slice on threads, with
``shuffle.cpp`` and zlib), ``bits.cpp`` (the n-bit and scale-offset
filters) and ``aec.cpp`` (the szip filter's decoder and encoder, with
``shuffle.cpp``), each into a library of its own; ``lzf_decompress``,
``unshuffle``, ``shuffle``, ``nbit_decode``, ``scaleoffset_decode`` and
``aec_decode`` take their Python and numpy versions under the same rule,
``inflate_chunks`` and ``szip_chunks`` leave their chunks to the caller's
Python decoding, and ``szip_encode_chunks`` (the writer's) raises.

The window writer's formatter, ``jsonwin.cpp``, is built the same way into
a library of its own: ``json_windows`` writes a float64 stack of windows
as ``json.dump(..., indent=4)`` writes it, byte for byte, on threads, and
returns None without the library, when ``io.writers.save_windows`` calls
``json.dump`` itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np

_SRC = pathlib.Path(__file__).parent / "kernels.cpp"
_LZF_SRC = pathlib.Path(__file__).parent / "lzf.cpp"
_SHUFFLE_SRC = pathlib.Path(__file__).parent / "shuffle.cpp"
_INFLATE_SRC = pathlib.Path(__file__).parent / "inflate.cpp"
_BITS_SRC = pathlib.Path(__file__).parent / "bits.cpp"
_AEC_SRC = pathlib.Path(__file__).parent / "aec.cpp"
_JSONWIN_SRC = pathlib.Path(__file__).parent / "jsonwin.cpp"
BUILD_DIR = pathlib.Path(__file__).parents[2] / "build" / "chromosight_torch" / "native"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIB = None
_TRIED = False
_FILTER_LIBS = {}  # the filters' libraries (None: not built), by source stem
_LOCK = threading.Lock()


def _build(openmp=True, src=_SRC, name="libchromosight_native.so", more=(), libs=()):
    """Compile ``src`` (``kernels.cpp``), with the sources ``more`` and
    the libraries ``libs`` ("-lz"), unless these sources and command line
    were built before; returns the library's path."""
    flags = [*_FLAGS, "-fopenmp"] if openmp else list(_FLAGS)
    srcs = [src, *more]
    digest = hashlib.sha256(" ".join([*flags, *libs]).encode())
    for path in srcs:
        digest.update(path.read_bytes())
    out = BUILD_DIR / digest.hexdigest()[:16] / name
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"tmp{os.getpid()}.so"
    subprocess.run(
        ["g++", *flags, *map(str, srcs), "-o", str(tmp), *libs], check=True,
        capture_output=True,
    )
    os.replace(tmp, out)
    return out


def _load():
    """Build then dlopen, without OpenMP when the toolchain or the
    runtime loader has no libgomp (a successful compile does not imply
    the .so is loadable on this host)."""
    try:
        return ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError):
        return ctypes.CDLL(str(_build(openmp=False)))


def get_lib():
    """Load (building if needed) the native library, or None.

    Thread-safe: concurrent first callers block on the build and load
    instead of observing a half-initialized state."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    if os.environ.get("CHROMOSIGHT_TPU_NO_NATIVE"):
        _TRIED = True
        return None
    try:
        lib = _load()
        lib.cc_label.restype = ctypes.c_int64
        lib.cc_label.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.coo_to_band_f64.restype = None
        lib.coo_to_band_f64.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.coo_to_band_f32.restype = None
        lib.coo_to_band_f32.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        for suffix, ctype in (
            ("f64", ctypes.c_double),
            ("i32", ctypes.c_int32),
            ("i64", ctypes.c_int64),
        ):
            fn = getattr(lib, f"band_scatter_fused_{suffix}")
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctype),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
        # indptr-driven count scatters come in b2-int64 and b2-int32
        # flavors (minimal-dtype cool files store 4-byte ids; reading
        # them straight skips a whole-table host cast).
        for b2suf, b2ctype in (("", ctypes.c_int64), ("_b2i32", ctypes.c_int32)):
            for suffix, ctype in (
                ("i32", ctypes.c_int32),
                ("i64", ctypes.c_int64),
                ("f64", ctypes.c_double),
            ):
                fn = getattr(lib, f"band_scatter_counts_indptr_{suffix}{b2suf}")
                fn.restype = ctypes.c_int64
                fn.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(b2ctype),
                    ctypes.POINTER(ctype),
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint16),
                ]
                fn8 = getattr(
                    lib, f"band_scatter_counts_u8_indptr_{suffix}{b2suf}"
                )
                fn8.restype = ctypes.c_int64
                fn8.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(b2ctype),
                    ctypes.POINTER(ctype),
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64,
                ]
                fn4 = getattr(
                    lib, f"band_scatter_counts_u4_indptr_{suffix}{b2suf}"
                )
                fn4.restype = ctypes.c_int64
                fn4.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(b2ctype),
                    ctypes.POINTER(ctype),
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64,
                ]
        lib.remove_neighbours.restype = None
        lib.remove_neighbours.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.marginal_sums.restype = None
        lib.marginal_sums.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.marginal_sums_i32.restype = None
        lib.marginal_sums_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.ice_iterate.restype = ctypes.c_int64
        lib.ice_iterate.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        for b2suf, b2ctype in (
            ("", ctypes.c_int64),
            ("_b2i32", ctypes.c_int32),
        ):
            for csuf, cctype in (
                ("i32", ctypes.c_int32),
                ("i64", ctypes.c_int64),
                ("f64", ctypes.c_double),
            ):
                fnp = getattr(lib, f"ice_prep_csr_{csuf}{b2suf}")
                fnp.restype = ctypes.c_int64
                fnp.argtypes = [
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(b2ctype),
                    ctypes.POINTER(cctype),
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_int64),
                ]
        lib.ice_iterate_csr.restype = ctypes.c_int64
        lib.ice_iterate_csr.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        for b2suf, b2ct in (("", ctypes.c_int64), ("_b2i32", ctypes.c_int32)):
            fno = getattr(lib, f"trans_range_offsets{b2suf}")
            fno.restype = ctypes.c_int64
            fno.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(b2ct),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            for csuf, cct in (
                ("i32", ctypes.c_int32),
                ("i64", ctypes.c_int64),
                ("f32", ctypes.c_float),
                ("f64", ctypes.c_double),
            ):
                fnf = getattr(lib, f"trans_fill_{csuf}{b2suf}")
                fnf.restype = None
                fnf.argtypes = [
                    ctypes.POINTER(b2ct),
                    ctypes.POINTER(cct),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int64,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_float),
                ]
        _LIB = lib
    except Exception as exc:  # toolchain missing, build failure, ...
        sys.stderr.write(f"chromosight-torch: native build unavailable ({exc})\n")
        _LIB = None
    # Publish the flag only after _LIB is final: the unlocked fast path
    # in get_lib() reads (_TRIED, _LIB) without the lock.
    _TRIED = True
    return _LIB


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _b2_native(b2):
    """(contiguous b2, export-name suffix): int32-stored bin2 ids run
    through the ``_b2i32`` kernels in their stored dtype — casting a
    genome's pixel table to int64 is a multi-second sweep on slow hosts."""
    b2 = np.ascontiguousarray(b2)
    if b2.dtype == np.int32:
        return b2, "_b2i32"
    return np.ascontiguousarray(b2, dtype=np.int64), ""


def _b2p(b2):
    ct = ctypes.c_int32 if b2.dtype == np.int32 else ctypes.c_int64
    return b2.ctypes.data_as(ctypes.POINTER(ct))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def cc_label(rows, cols, ncols):
    """Union-find CC labels (min pixel index per component) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    labels = np.empty(len(rows), dtype=np.int64)
    lib.cc_label(
        _i64p(rows), _i64p(cols), len(rows), int(ncols), _i64p(labels)
    )
    return labels


def coo_to_band(rows, cols, vals, n, width, dtype=np.float64):
    """Scatter COO triplets into an (n, width) upper band B[i, d] =
    M[i, i+d] of ``dtype`` (float32 or float64), dropping entries off the
    band; None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    if dtype == np.float32:
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        band = np.empty((int(n), int(width)), dtype=np.float32)
        lib.coo_to_band_f32(
            _i64p(rows),
            _i64p(cols),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(rows),
            int(n),
            int(width),
            band.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return band
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    band = np.empty((int(n), int(width)), dtype=np.float64)
    lib.coo_to_band_f64(
        _i64p(rows),
        _i64p(cols),
        _f64p(vals),
        len(rows),
        int(n),
        int(width),
        _f64p(band),
    )
    return band


def band_scatter_fused(b1, b2, counts, weights, s, e, width, n_rows=None):
    """Filter + balance + scatter raw pixel-slice arrays into an upper
    band tensor in one native pass, or None if unavailable.

    ``b1``/``b2`` are *global* bin ids (any integer dtype), ``counts`` the
    raw values, ``weights`` the full per-bin weight vector or None for raw
    mode.  Returns a float32 (n_rows, width) band (``n_rows`` defaults to
    e-s; larger values add zero padding rows).
    """
    lib = get_lib()
    if lib is None:
        return None
    if n_rows is None:
        n_rows = int(e) - int(s)
    b1 = np.ascontiguousarray(b1, dtype=np.int64)
    b2 = np.ascontiguousarray(b2, dtype=np.int64)
    counts = np.ascontiguousarray(counts)
    if counts.dtype == np.float64:
        fn, cptr = lib.band_scatter_fused_f64, ctypes.c_double
    elif counts.dtype == np.int32:
        fn, cptr = lib.band_scatter_fused_i32, ctypes.c_int32
    elif counts.dtype == np.int64:
        fn, cptr = lib.band_scatter_fused_i64, ctypes.c_int64
    else:
        counts = np.ascontiguousarray(counts, dtype=np.float64)
        fn, cptr = lib.band_scatter_fused_f64, ctypes.c_double
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        wp = _f64p(weights)
    else:
        wp = ctypes.POINTER(ctypes.c_double)()
    band = np.empty((int(n_rows), int(width)), dtype=np.float32)
    fn(
        _i64p(b1),
        _i64p(b2),
        counts.ctypes.data_as(ctypes.POINTER(cptr)),
        len(b1),
        wp,
        int(s),
        int(e),
        int(width),
        int(n_rows),
        band.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return band


def band_scatter_counts_u8_indptr(
    indptr, b2, counts, s, e, width, n_rows=None, exc_cap=None
):
    """Indptr-driven uint8 + exceptions count scatter: the band ships as
    1-byte pixels (half the uint16 path again) plus a short (flat index,
    value) exception list for counts > 255, so values stay exact.
    Returns ``(band_u8, exc_idx, exc_val)`` or None when the native tier
    is unavailable, a value is non-integral / negative / > 2^24, or the
    exception list would not be worth the bytes (caller falls back to
    the uint16 path)."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts)
    b2, b2suf = _b2_native(b2)
    if counts.dtype == np.int32:
        csuf, cptr = "i32", ctypes.c_int32
    elif counts.dtype == np.int64:
        csuf, cptr = "i64", ctypes.c_int64
    elif counts.dtype in (np.float64, np.float32):
        counts = np.ascontiguousarray(counts, dtype=np.float64)
        csuf, cptr = "f64", ctypes.c_double
    else:
        return None
    fn = getattr(lib, f"band_scatter_counts_u8_indptr_{csuf}{b2suf}")
    if n_rows is None:
        n_rows = int(e) - int(s)
    if int(n_rows) * int(width) >= 1 << 31:
        return None  # exception flat indices upload as int32
    if exc_cap is None:
        # u8 + 8-byte exceptions beat the u16 band only while
        # n_exc * 8 < n_rows * width; past that the caller should ship
        # uint16 anyway.
        exc_cap = max(1024, (int(n_rows) * int(width)) // 8)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    n_rows_src = len(indptr) - 1
    band = np.empty((int(n_rows), int(width)), dtype=np.uint8)
    exc_idx = np.empty(int(exc_cap), dtype=np.int64)
    exc_val = np.empty(int(exc_cap), dtype=np.float32)
    n_exc = fn(
        _i64p(indptr),
        _b2p(b2),
        counts.ctypes.data_as(ctypes.POINTER(cptr)),
        n_rows_src,
        int(s),
        int(e),
        int(width),
        int(n_rows),
        band.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(exc_idx),
        exc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(exc_cap),
    )
    if n_exc < 0 or n_exc > exc_cap:
        return None
    return band, exc_idx[:n_exc], exc_val[:n_exc]


def band_scatter_counts_u4_indptr(
    indptr, b2, counts, s, e, width, d0, n_rows=None, exc_cap=None
):
    """Split uint8-head / packed-uint4-tail count scatter: columns
    ``[0, d0)`` (near-diagonal, large Poisson means) ship as 1-byte
    pixels and columns ``[d0, width)`` pack two 4-bit counts per byte —
    about half the u8 path's bytes again for wide scan bands.  Counts
    that do not fit their lane (head > 255, tail > 15) ride a (flat
    UNPACKED-band index, value) exception list, so values stay exact.
    Returns ``(head_u8, tail_packed_u8, exc_idx, exc_val)`` or None when
    the native tier is unavailable, a value is non-integral / negative /
    > 2^24, or the exception list outgrows the bytes the packing saves
    (caller falls back to the u8 path)."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts)
    b2, b2suf = _b2_native(b2)
    if counts.dtype == np.int32:
        csuf, cptr = "i32", ctypes.c_int32
    elif counts.dtype == np.int64:
        csuf, cptr = "i64", ctypes.c_int64
    elif counts.dtype in (np.float64, np.float32):
        counts = np.ascontiguousarray(counts, dtype=np.float64)
        csuf, cptr = "f64", ctypes.c_double
    else:
        return None
    fn = getattr(lib, f"band_scatter_counts_u4_indptr_{csuf}{b2suf}")
    if n_rows is None:
        n_rows = int(e) - int(s)
    d0 = int(min(d0, width))
    if int(n_rows) * int(width) >= 1 << 31:
        return None  # exception flat indices upload as int32
    tp = (int(width) - d0 + 1) // 2
    if exc_cap is None:
        # the nibble pack saves n_rows * (width - d0) / 2 bytes over u8;
        # exceptions cost 8 bytes each on the link, so past saved/8 of
        # them the caller should ship u8 anyway.
        exc_cap = max(1024, (int(n_rows) * (int(width) - d0)) // 16)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    n_rows_src = len(indptr) - 1
    head = np.empty((int(n_rows), d0), dtype=np.uint8)
    tail = np.empty((int(n_rows), tp), dtype=np.uint8)
    exc_idx = np.empty(int(exc_cap), dtype=np.int64)
    exc_val = np.empty(int(exc_cap), dtype=np.float32)
    n_exc = fn(
        _i64p(indptr),
        _b2p(b2),
        counts.ctypes.data_as(ctypes.POINTER(cptr)),
        n_rows_src,
        int(s),
        int(e),
        int(width),
        d0,
        int(n_rows),
        head.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(exc_idx),
        exc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(exc_cap),
    )
    if n_exc < 0 or n_exc > exc_cap:
        return None
    return head, tail, exc_idx[:n_exc], exc_val[:n_exc]


def band_scatter_counts_indptr(indptr, b2, counts, s, e, width, n_rows=None):
    """Scatter RAW integer counts into a uint16 (n_rows, width) band —
    half the upload bytes of the balanced f32 band, with exact values
    (the device applies weights and casts, see
    ``ops.band.band_weighted``).  bin1 ids are implied by the cool file's
    per-row pixel offsets (``indptr[r]..indptr[r+1]`` are row ``s+r``'s
    pixels, absolute into the pixel table), so the bin1_id dataset is
    never read or materialised.

    Returns None when the native library is unavailable, the count dtype
    is not integral, or any kept pixel is non-integral, negative or
    overflows uint16 (callers fall back to the f32 path).
    """
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts)
    b2, b2suf = _b2_native(b2)
    if counts.dtype == np.int32:
        csuf, cptr = "i32", ctypes.c_int32
    elif counts.dtype == np.int64:
        csuf, cptr = "i64", ctypes.c_int64
    elif counts.dtype in (np.float64, np.float32):
        counts = np.ascontiguousarray(counts, dtype=np.float64)
        csuf, cptr = "f64", ctypes.c_double
    else:
        return None
    fn = getattr(lib, f"band_scatter_counts_indptr_{csuf}{b2suf}")
    if n_rows is None:
        n_rows = int(e) - int(s)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    n_rows_src = len(indptr) - 1
    band = np.empty((int(n_rows), int(width)), dtype=np.uint16)
    overflow = fn(
        _i64p(indptr),
        _b2p(b2),
        counts.ctypes.data_as(ctypes.POINTER(cptr)),
        n_rows_src,
        int(s),
        int(e),
        int(width),
        int(n_rows),
        band.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    if overflow:
        return None
    return band


def trans_coo_balanced(indptr, b2, counts, s2, e2, w1=None, w2=None):
    """Stored-dtype trans rectangle fetch (see kernels.cpp
    ``trans_range_offsets`` / ``trans_fill_*``).

    ``indptr`` is the absolute ``bin1_offset[s1 : e1 + 1]`` slice; ``b2``
    and ``counts`` the matching pixel-table slices in their STORED
    dtypes.  Each row's kept column range [s2, e2) is located with two
    binary searches (cooler sort invariant), then exact-sized
    ``(rows_i32, cols_i32, vals_f32)`` local-coordinate triplets are
    filled in one parallel pass, applying the ``w1[r] * w2[j]``
    balancing product (f64 weights, f64 accumulate, f32 store; NaN
    weights propagate).  Returns None when the native library is
    unavailable (callers fall back to the generic python fetch).
    """
    lib = get_lib()
    if lib is None:
        return None
    b2, b2suf = _b2_native(b2)
    counts = np.ascontiguousarray(counts)
    suffixes = {
        np.dtype(np.int32): ("i32", ctypes.c_int32),
        np.dtype(np.int64): ("i64", ctypes.c_int64),
        np.dtype(np.float32): ("f32", ctypes.c_float),
        np.dtype(np.float64): ("f64", ctypes.c_double),
    }
    if counts.dtype not in suffixes:
        return None
    csuf, cptr = suffixes[counts.dtype]
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    n_rows = len(indptr) - 1
    offsets = np.empty(n_rows + 1, dtype=np.int64)
    klo = np.empty(max(n_rows, 1), dtype=np.int64)
    total = getattr(lib, f"trans_range_offsets{b2suf}")(
        _i64p(indptr),
        _b2p(b2),
        n_rows,
        int(s2),
        int(e2),
        _i64p(offsets),
        _i64p(klo),
    )
    rows = np.empty(total, dtype=np.int32)
    cols = np.empty(total, dtype=np.int32)
    vals = np.empty(total, dtype=np.float32)
    if (w1 is None) != (w2 is None):
        raise ValueError("w1 and w2 must be supplied together")
    if w1 is not None:
        w1 = np.ascontiguousarray(w1, dtype=np.float64)
        w2 = np.ascontiguousarray(w2, dtype=np.float64)
        w1p, w2p = _f64p(w1), _f64p(w2)
    else:
        w1p = w2p = ctypes.POINTER(ctypes.c_double)()
    if total:
        getattr(lib, f"trans_fill_{csuf}{b2suf}")(
            _b2p(b2),
            counts.ctypes.data_as(ctypes.POINTER(cptr)),
            _i64p(offsets),
            _i64p(klo),
            n_rows,
            int(s2),
            w1p,
            w2p,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    return rows, cols, vals


def remove_neighbours(bin1, bin2, score, win_size):
    """Grid-hashed greedy neighbour suppression; bool keep mask in the
    original row order, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bin1 = np.ascontiguousarray(bin1, dtype=np.int64)
    bin2 = np.ascontiguousarray(bin2, dtype=np.int64)
    score = np.ascontiguousarray(score, dtype=np.float64)
    keep = np.empty(len(bin1), dtype=np.uint8)
    lib.remove_neighbours(
        _i64p(bin1),
        _i64p(bin2),
        _f64p(score),
        len(bin1),
        int(win_size),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)


def ice_iterate(b1, b2, counts, bias, max_iters, tol):
    """Run the whole ICE iteration loop natively with cache-blocked
    marginals (one stable counting sort by column block, then every
    iteration's two random streams stay in ~L2).  Requires compact
    triplets (int32 ids, float32 counts).  Updates ``bias`` IN PLACE
    (0 = excluded) and returns ``(scale, var, n_iters)``, or None when
    the native library is unavailable or the triplets are not compact —
    callers then run the per-iteration loop via ``marginal_sums``."""
    lib = get_lib()
    if lib is None:
        return None
    if not (
        b1.dtype == np.int32
        and b2.dtype == np.int32
        and counts.dtype == np.float32
    ):
        return None
    b1 = np.ascontiguousarray(b1)
    b2 = np.ascontiguousarray(b2)
    counts = np.ascontiguousarray(counts)
    assert bias.dtype == np.float64 and bias.flags.c_contiguous
    scale = ctypes.c_double(float("nan"))
    var = ctypes.c_double(float("inf"))
    n_iters = lib.ice_iterate(
        b1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(b1),
        len(bias),
        _f64p(bias),
        int(max_iters),
        float(tol),
        ctypes.byref(scale),
        ctypes.byref(var),
    )
    return scale.value, var.value, int(n_iters)


def ice_iterate_csr(b1, b2, counts, bias, max_iters, tol):
    """ICE iteration loop over a compressed pixel stream: 3 B/pixel
    (CSR indptr + uint16 diagonal offsets + uint8 counts with an
    exception list) instead of 12 B/pixel triplets — the loop is
    stream-bandwidth-bound, so the compression is the speedup.

    Requires compact triplets sorted by (b1, b2) with every diagonal
    offset < 65536 (cis blocks at scan resolutions).  Updates ``bias``
    in place; returns (scale, var, n_iters) or None when ineligible.
    """
    lib = get_lib()
    if lib is None:
        return None
    if not (
        b1.dtype == np.int32
        and b2.dtype == np.int32
        and counts.dtype == np.float32
    ):
        return None
    n_bins = len(bias)
    if len(b1) == 0:
        return None
    d = b2 - b1  # int32; rows are local so this never overflows
    if d.min() < 0 or d.max() >= 65536:
        return None
    if not np.all(np.diff(b1) >= 0):  # indptr requires row-sorted pixels
        return None
    # counts must be non-negative integers to pack exactly into u8
    small = (counts < 256) & (counts >= 0) & (counts == np.floor(counts))
    ct8 = np.where(small, counts, 0).astype(np.uint8)
    exc = np.flatnonzero(~small)
    exc_i = b1[exc].astype(np.int32, copy=False)
    exc_j = b2[exc].astype(np.int32, copy=False)
    exc_val = counts[exc].astype(np.float32, copy=False)
    indptr = np.zeros(n_bins + 1, dtype=np.int64)
    np.cumsum(np.bincount(b1, minlength=n_bins), out=indptr[1:])
    d16 = d.astype(np.uint16)
    assert bias.dtype == np.float64 and bias.flags.c_contiguous
    scale = ctypes.c_double(float("nan"))
    var = ctypes.c_double(float("inf"))
    n_iters = lib.ice_iterate_csr(
        _i64p(indptr),
        d16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ct8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.ascontiguousarray(exc_i).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(exc_j).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(exc_val).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)
        ),
        len(exc),
        n_bins,
        _f64p(bias),
        int(max_iters),
        float(tol),
        ctypes.byref(scale),
        ctypes.byref(var),
    )
    return scale.value, var.value, int(n_iters)


def ice_prep_csr(indptr, b2, ct, s, e, ignore_diags):
    """One native pass over a cis block's raw pixel-table slice: emits
    the 3 B/pixel compressed stream ``ice_iterate_csr_prebuilt``
    consumes (local-row indptr + uint16 diagonal offsets + uint8 counts
    + (i, j, value) exceptions) plus the nnz / raw-marginal vectors the
    min_nnz and MAD-max filters need.  ``b2``/``ct`` stay in their
    STORED dtypes (int32 cool ids run cast-free) and bin1 is implied by
    the file's CSR ``bin1_offset`` slice ``indptr``.

    Returns ``(indptr_out, d16, ct8, exc_i, exc_j, exc_val, nnz, marg)``
    or None when the native tier is unavailable, a count is negative /
    not exactly f32-representable, or the block is taller than the u16
    diagonal stream supports (callers fall back to the numpy path).
    """
    lib = get_lib()
    if lib is None:
        return None
    ct = np.ascontiguousarray(ct)
    b2, b2suf = _b2_native(b2)
    if ct.dtype == np.int32:
        csuf = "i32"
    elif ct.dtype == np.int64:
        csuf = "i64"
    elif ct.dtype in (np.float64, np.float32):
        ct = np.ascontiguousarray(ct, dtype=np.float64)
        csuf = "f64"
    else:
        return None
    fn = getattr(lib, f"ice_prep_csr_{csuf}{b2suf}")
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    if n >= 2**31:
        return None  # exception ids upload as int32
    cap = len(b2)
    indptr_out = np.empty(n + 1, dtype=np.int64)
    d16 = np.empty(cap, dtype=np.uint16)
    ct8 = np.empty(cap, dtype=np.uint8)
    nnz = np.empty(n, dtype=np.int64)
    marg = np.empty(n, dtype=np.float64)
    n_exc_out = ctypes.c_int64(0)
    exc_cap = max(4096, cap // 16)
    for _ in range(2):
        exc_i = np.empty(int(exc_cap), dtype=np.int32)
        exc_j = np.empty(int(exc_cap), dtype=np.int32)
        exc_val = np.empty(int(exc_cap), dtype=np.float32)
        m = fn(
            _i64p(indptr),
            _b2p(b2),
            ct.ctypes.data_as(
                ctypes.POINTER(
                    {"i32": ctypes.c_int32, "i64": ctypes.c_int64,
                     "f64": ctypes.c_double}[csuf]
                )
            ),
            n,
            int(s),
            int(e),
            int(ignore_diags),
            _i64p(indptr_out),
            d16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ct8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            exc_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            exc_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            exc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(exc_cap),
            _i64p(nnz),
            _f64p(marg),
            ctypes.byref(n_exc_out),
        )
        if m == -3:  # exception list overflowed: exact retry, in-memory
            exc_cap = int(n_exc_out.value)
            continue
        break
    if m < 0:
        return None
    ne = int(n_exc_out.value)
    return (
        indptr_out,
        d16[:m].copy(),
        ct8[:m].copy(),
        exc_i[:ne],
        exc_j[:ne],
        exc_val[:ne],
        nnz,
        marg,
    )


def ice_iterate_csr_prebuilt(
    indptr, d16, ct8, exc_i, exc_j, exc_val, bias, max_iters, tol
):
    """Run the compressed-stream ICE loop on a prebuilt stream (from
    :func:`ice_prep_csr`).  Updates ``bias`` in place; returns
    ``(scale, var, n_iters)`` or None when the native tier is missing."""
    lib = get_lib()
    if lib is None:
        return None
    assert bias.dtype == np.float64 and bias.flags.c_contiguous
    scale = ctypes.c_double(float("nan"))
    var = ctypes.c_double(float("inf"))
    n_iters = lib.ice_iterate_csr(
        _i64p(np.ascontiguousarray(indptr, dtype=np.int64)),
        np.ascontiguousarray(d16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)
        ),
        np.ascontiguousarray(ct8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)
        ),
        np.ascontiguousarray(exc_i).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(exc_j).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(exc_val).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)
        ),
        len(exc_i),
        len(bias),
        _f64p(bias),
        int(max_iters),
        float(tol),
        ctypes.byref(scale),
        ctypes.byref(var),
    )
    return scale.value, var.value, int(n_iters)


def marginal_sums(b1, b2, counts, bias, n_bins):
    """Marginals of the symmetric matrix from upper-triangle triplets.

    When the caller hands in compact triplets (int32 ids + float32
    counts, the memory-bound ICE iteration's layout) the half-bandwidth
    i32 kernel runs; products are computed in double either way, so both
    entry points return bitwise-identical marginals."""
    lib = get_lib()
    if lib is None:
        return None
    bias = np.ascontiguousarray(bias, dtype=np.float64)
    marg = np.empty(int(n_bins), dtype=np.float64)
    if (
        b1.dtype == np.int32
        and b2.dtype == np.int32
        and counts.dtype == np.float32
    ):
        b1 = np.ascontiguousarray(b1)
        b2 = np.ascontiguousarray(b2)
        counts = np.ascontiguousarray(counts)
        lib.marginal_sums_i32(
            b1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _f64p(bias),
            len(b1),
            int(n_bins),
            _f64p(marg),
        )
        return marg
    b1 = np.ascontiguousarray(b1, dtype=np.int64)
    b2 = np.ascontiguousarray(b2, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.float64)
    lib.marginal_sums(
        _i64p(b1),
        _i64p(b2),
        _f64p(counts),
        _f64p(bias),
        len(b1),
        int(n_bins),
        _f64p(marg),
    )
    return marg


def _filter_lib(src):
    """The library built from ``src`` (``lzf.cpp``, ``shuffle.cpp``,
    ``bits.cpp``, ``inflate.cpp`` with ``shuffle.cpp`` and zlib, or
    ``aec.cpp`` with ``shuffle.cpp``: the HDF5 reader's filters; or
    ``jsonwin.cpp``, the window writer's formatter) with g++
    at first use, beside ``kernels.cpp``'s, or None under
    CHROMOSIGHT_TPU_NO_NATIVE or when it cannot be built or loaded (as
    ``get_lib``); tried once per process."""
    name = src.stem
    if name not in _FILTER_LIBS:
        with _LOCK:
            if name not in _FILTER_LIBS:
                lib = None
                more = (_SHUFFLE_SRC,) if name in ("inflate", "aec") else ()
                libs = ("-lz",) if name == "inflate" else ()
                if not os.environ.get("CHROMOSIGHT_TPU_NO_NATIVE"):
                    try:
                        lib = ctypes.CDLL(str(_build(openmp=False, src=src, name=f"lib{name}.so",
                                                     more=more, libs=libs)))
                    except (OSError, subprocess.CalledProcessError):
                        lib = None
                if lib is not None and name == "lzf":
                    lib.lzf_decompress.restype = ctypes.c_int64
                    lib.lzf_decompress.argtypes = [
                        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ]
                elif lib is not None and name == "bits":
                    lib.hdf5_nbit_decode.restype = ctypes.c_int64
                    lib.hdf5_nbit_decode.argtypes = [
                        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ]
                    lib.hdf5_scaleoffset_decode.restype = ctypes.c_int64
                    lib.hdf5_scaleoffset_decode.argtypes = [
                        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_char_p, ctypes.c_void_p,
                    ]
                elif lib is not None and name == "aec":
                    lib.hdf5_aec_decode.restype = ctypes.c_int64
                    lib.hdf5_aec_decode.argtypes = [
                        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                        *[ctypes.c_int] * 4,
                    ]
                    lib.hdf5_szip_chunks.restype = ctypes.c_int64
                    lib.hdf5_szip_chunks.argtypes = [
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, *[ctypes.c_int] * 4,
                        ctypes.c_int64, ctypes.c_int64,
                    ]
                    lib.hdf5_szip_encode_chunks.restype = ctypes.c_int64
                    lib.hdf5_szip_encode_chunks.argtypes = [
                        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                        *[ctypes.c_int] * 4, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ]
                elif lib is not None and name == "jsonwin":
                    lib.json_windows_write.restype = ctypes.c_int64
                    lib.json_windows_write.argtypes = [
                        ctypes.c_char_p, ctypes.c_void_p, *[ctypes.c_int64] * 5,
                    ]
                elif lib is not None and name == "inflate":
                    lib.hdf5_inflate_chunks.restype = ctypes.c_int64
                    lib.hdf5_inflate_chunks.argtypes = [
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                        ctypes.c_int64,
                    ]
                elif lib is not None:
                    for fn in (lib.hdf5_unshuffle, lib.hdf5_shuffle):
                        fn.restype = None
                        fn.argtypes = [
                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                        ]
                _FILTER_LIBS[name] = lib
    return _FILTER_LIBS[name]


def filters_native():
    """Whether the HDF5 filters run natively (``lzf.cpp``, ``shuffle.cpp``,
    ``inflate.cpp``, ``bits.cpp`` and ``aec.cpp`` built and loaded)."""
    return all(_filter_lib(src) is not None
               for src in (_LZF_SRC, _SHUFFLE_SRC, _INFLATE_SRC, _BITS_SRC, _AEC_SRC))


def _chunk_batch(buf, in_off, in_len, out, out_off, chunk_bytes):
    """The arguments of a native batch of chunks, checked to lie inside
    their buffers."""
    buf = np.ascontiguousarray(buf, np.uint8)
    in_off, in_len, out_off = (np.ascontiguousarray(a, np.int64) for a in (in_off, in_len,
                                                                          out_off))
    if (in_off.min() < 0 or (in_off + in_len).max() > len(buf) or out_off.min() < 0
            or out_off.max() + chunk_bytes > out.nbytes):
        raise ValueError("chunks outside their buffers")
    return (buf.ctypes.data, in_off.ctypes.data, in_len.ctypes.data, len(in_off),
            out.ctypes.data, out_off.ctypes.data, int(chunk_bytes)), (buf, in_off, in_len,
                                                                      out_off)


def inflate_chunks(buf, in_off, in_len, out, out_off, chunk_bytes, element, threads):
    """Inflate the deflate-filtered chunks ``buf[in_off[i]:][:in_len[i]]``
    (and unshuffle them by elements of ``element`` bytes, when above 1)
    into ``out`` (a writable uint8 array) at ``out_off[i]``, each exactly
    ``chunk_bytes`` bytes, on ``threads`` threads of ``inflate.cpp``'s own:
    True when every chunk decoded; False when one did not, or without the
    library (CHROMOSIGHT_TPU_NO_NATIVE, no compiler or no zlib headers),
    and then the caller decodes them in Python."""
    lib = _filter_lib(_INFLATE_SRC)
    if lib is None or not len(in_off):
        return lib is not None
    args, _keep = _chunk_batch(buf, in_off, in_len, out, out_off, chunk_bytes)
    return lib.hdf5_inflate_chunks(*args, int(element), int(threads)) < 0


def lzf_decompress(data, size):
    """The ``size`` bytes LZF-compressed in ``data`` (one chunk of h5py's
    LZF filter), decoded by ``lzf.cpp`` (built with g++ at first use), or
    by ``lzf_decompress_py`` under CHROMOSIGHT_TPU_NO_NATIVE or without a
    compiler.  Raises OSError when the block does not decode to exactly
    ``size`` bytes."""
    lib = _filter_lib(_LZF_SRC)
    if lib is None:
        return lzf_decompress_py(data, size)
    out = np.empty(int(size), dtype=np.uint8)
    got = lib.lzf_decompress(bytes(data), len(data), out.ctypes.data, out.size)
    _lzf_check(got, len(data), size)
    return out.tobytes()


def lzf_decompress_py(data, size):
    """``lzf.cpp``'s decoder in Python, the fallback of ``lzf_decompress``
    (the same bytes, the same OSError): a control byte below 32 starts a
    run of ctrl + 1 literal bytes; above, its top three bits (7: plus the
    next byte) give a back reference of length + 2 bytes at a distance of
    ((ctrl & 31) << 8) + next byte + 1, which may overlap what it
    writes."""
    src = bytes(data)
    n_in, size = len(src), int(size)
    out = bytearray(size)
    ip = op = 0
    got = None
    while ip < n_in:
        ctrl = src[ip]
        ip += 1
        if ctrl < 32:
            ctrl += 1
            if op + ctrl > size:
                got = -1
                break
            if ip + ctrl > n_in:
                got = -2
                break
            out[op : op + ctrl] = src[ip : ip + ctrl]
            ip += ctrl
            op += ctrl
            continue
        length = ctrl >> 5
        if length == 7:
            if ip >= n_in:
                got = -2
                break
            length += src[ip]
            ip += 1
        if ip >= n_in:
            got = -2
            break
        back = ((ctrl & 0x1F) << 8) + src[ip] + 1
        ip += 1
        length += 2
        if op + length > size:
            got = -1
            break
        if back > op:
            got = -2
            break
        ref = op - back
        if back >= length:
            out[op : op + length] = out[ref : ref + length]
        else:
            # the reference overlaps what it writes: its bytes repeat
            out[op : op + length] = (out[ref:op] * -(-length // back))[:length]
        op += length
    _lzf_check(op if got is None else got, n_in, size)
    return bytes(out)


def _lzf_check(got, n_in, size):
    if got != size:
        why = {-1: "more than the chunk's bytes", -2: "not a valid LZF block"}
        raise OSError(f"LZF block of {n_in} bytes: {why.get(got, f'{got} bytes')}, "
                      f"{size} expected")


def unshuffle(raw, size, out=None):
    """Undo HDF5's shuffle filter on the bytes ``raw`` (elements of
    ``size`` bytes; trailing bytes that fill no element stay as they are),
    by ``shuffle.cpp`` or, under CHROMOSIGHT_TPU_NO_NATIVE or without a
    compiler, by ``unshuffle_numpy``: into ``out`` (a writable buffer of
    ``len(raw)`` bytes) when given, else into new bytes."""
    return _shuffled(raw, size, out, "hdf5_unshuffle", unshuffle_numpy)


def shuffle(raw, size, out=None):
    """HDF5's shuffle filter, the inverse of ``unshuffle`` (the writer's)."""
    return _shuffled(raw, size, out, "hdf5_shuffle", shuffle_numpy)


def _shuffled(raw, size, out, entry, fallback):
    lib = _filter_lib(_SHUFFLE_SRC)
    src = np.frombuffer(raw, np.uint8)
    dst = np.empty(len(src), np.uint8) if out is None else np.frombuffer(out, np.uint8)
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} shuffled bytes into a buffer of {len(dst)}")
    if lib is None:
        dst[:] = np.frombuffer(fallback(src.tobytes(), size), np.uint8)
    else:
        getattr(lib, entry)(src.ctypes.data, len(src), int(size), dst.ctypes.data)
    return dst.tobytes() if out is None else out


def unshuffle_numpy(raw, size):
    """The numpy version of ``unshuffle``: a byte transpose by the element
    size."""
    n = len(raw) // size
    if size <= 1 or n == 0:
        return bytes(raw)
    body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
    return body + bytes(raw[n * size :])


def shuffle_numpy(raw, size):
    """The numpy version of ``shuffle``."""
    n = len(raw) // size
    if size <= 1 or n == 0:
        return bytes(raw)
    body = np.frombuffer(raw, np.uint8, n * size).reshape(n, size).T.tobytes()
    return body + bytes(raw[n * size :])


# -- the n-bit and scale-offset filters ------------------------------------ #

def _bits_check(got, what, n_in):
    if got != 0:
        raise OSError(f"{what}: a chunk of {n_in} bytes ends before its elements")


def nbit_decode(data, values):
    """One chunk of HDF5's n-bit filter (``values`` its client data:
    parameter count, whether the data went uncompressed, elements, class
    code 1, element size, byte order, precision, bit offset) decoded by
    ``bits.cpp``, or by ``nbit_decode_numpy`` under
    CHROMOSIGHT_TPU_NO_NATIVE or without a compiler: each element's
    precision bits at its bit offset, its other bits 0.  Raises OSError
    when the chunk ends early."""
    _, raw_copy, n, _, size, order, precision, offset = values[:8]
    if raw_copy:
        return bytes(data)
    lib = _filter_lib(_BITS_SRC)
    if lib is None:
        return nbit_decode_numpy(data, values)
    out = np.empty(n * size, np.uint8)
    _bits_check(lib.hdf5_nbit_decode(bytes(data), len(data), n, size, order, precision, offset,
                                     out.ctypes.data), "n-bit", len(data))
    return out.tobytes()


def scaleoffset_decode(data, values):
    """One chunk of HDF5's scale-offset filter (``values`` its client
    data: scale type, scale factor, elements, class (0 integer, 1 float),
    element size, sign, byte order, whether a fill value is set, the fill
    value's bytes) decoded by ``bits.cpp``, or by
    ``scaleoffset_decode_numpy`` under CHROMOSIGHT_TPU_NO_NATIVE or
    without a compiler.  Raises OSError when the chunk ends early."""
    lib = _filter_lib(_BITS_SRC)
    if lib is None:
        return scaleoffset_decode_numpy(data, values)
    scale_type, scale, n, cls, size, _, order, filavail = values[:8]
    if cls == 1 and scale_type != 0:
        raise OSError(f"scale-offset: float scale type {scale_type} (HDF5 decodes D-scaling only)")
    fill = np.asarray(values[8:], "<u4").tobytes() + bytes(8)
    out = np.empty(n * size, np.uint8)
    _bits_check(lib.hdf5_scaleoffset_decode(bytes(data), len(data), n, cls, size, order,
                                            np.int32(np.uint32(scale)), filavail, fill,
                                            out.ctypes.data), "scale-offset", len(data))
    return out.tobytes()


def unpack_bits_numpy(data, n, bits):
    """``n`` values of ``bits`` bits each (at most 64) from the start of
    ``data``, most significant bit first, as uint64; None when ``data``
    ends first."""
    if bits == 0:
        return np.zeros(n, np.uint64)
    if len(data) * 8 < n * bits:
        return None
    stream = np.unpackbits(np.frombuffer(data, np.uint8))[: n * bits].reshape(n, bits)
    out = np.zeros(n, np.uint64)
    for column in range(bits):
        out = (out << np.uint64(1)) | stream[:, column].astype(np.uint64)
    return out


def _ordered(values, size, order):
    """uint64 ``values`` as elements of ``size`` bytes in byte order
    ``order`` (0: little endian)."""
    kind = np.dtype(f"{'>' if order else '<'}u{size}")
    return values.astype(kind.newbyteorder("=")).astype(kind).tobytes()


def nbit_decode_numpy(data, values):
    """The numpy version of ``nbit_decode``."""
    _, raw_copy, n, _, size, order, precision, offset = values[:8]
    if raw_copy:
        return bytes(data)
    v = unpack_bits_numpy(bytes(data), n, precision)
    _bits_check(0 if v is not None else -1, "n-bit", len(data))
    return _ordered(v << np.uint64(offset) if offset < 64 else v * np.uint64(0), size, order)


def scaleoffset_decode_numpy(data, values):
    """The numpy version of ``scaleoffset_decode``: the same arithmetic,
    in the element's own type (float32 for 4-byte floats)."""
    scale_type, scale, n, cls, size, _, order, filavail = values[:8]
    if cls == 1 and scale_type != 0:
        raise OSError(f"scale-offset: float scale type {scale_type} (HDF5 decodes D-scaling only)")
    data = bytes(data)
    _bits_check(0 if len(data) >= 21 else -1, "scale-offset", len(data))
    minbits = int.from_bytes(data[:4], "little")
    minval = int.from_bytes(data[5 : 5 + min(data[4], 8)], "little")
    body = data[21:]
    if minbits == size * 8:
        _bits_check(0 if len(body) >= n * size else -1, "scale-offset", len(data))
        raw = np.frombuffer(body, f"<u{size}", n).astype(np.uint64)
        return _ordered(raw, size, order)
    v = unpack_bits_numpy(body, n, minbits)
    _bits_check(0 if v is not None else -1, "scale-offset", len(data))
    mask = np.uint64((1 << (8 * size)) - 1) if size < 8 else np.uint64(~0 & (2**64 - 1))
    if cls == 0:
        value = (v + np.uint64(minval & int(mask))) & mask
    elif size == 4:
        low = np.array([minval & 0xFFFFFFFF], np.uint32).view(np.float32)[0]
        scale = int(np.int32(np.uint32(scale)))
        x = (v.astype(np.uint32).view(np.int32).astype(np.float32)
             / np.float32(np.power(np.float32(10.0), np.float32(scale))) + low)
        value = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    else:
        low = np.array([minval], np.uint64).view(np.float64)[0]
        scale = int(np.int32(np.uint32(scale)))
        x = v.view(np.int64).astype(np.float64) / np.power(10.0, float(scale)) + low
        value = x.view(np.uint64)
    if filavail:
        fill = np.asarray(values[8:], "<u4").tobytes() + bytes(8)
        all_ones = np.uint64((1 << minbits) - 1) if minbits < 64 else np.uint64(2**64 - 1)
        value = np.where(v == all_ones, np.uint64(int.from_bytes(fill[:size], "little")), value)
    return _ordered(value.astype(np.uint64), size, order)


# -- the szip filter --------------------------------------------------------- #
# HDF5's filter 4: CCSDS 121.0-B adaptive entropy coding through libaec's
# szlib layer (see aec.cpp).  Client values: options mask, pixels per
# block, bits per pixel, pixels per scanline.

SZIP_EC, SZIP_LSB, SZIP_MSB, SZIP_NN = 4, 8, 16, 32
# HDF5 also sets K13 and RAW, which the szlib layer ignores
SZIP_ALWAYS = 1 | 128
_AEC_ERRORS = {
    -1: "the stream ends before its samples",
    -2: "a code outside CCSDS 121.0-B's options",
    -4: "options outside HDF5's szip (8, 16, 32 or 64 bits per pixel, an even block of "
        "2 to 32 pixels)",
    -5: "not a whole number of samples",
}
_BITS01 = bytes.maketrans(b"\0\1", b"01")


def szip_options_valid(values):
    """Whether szip client ``values`` are ones ``aec.cpp`` decodes: 8,
    16, 32 or 64 bits per pixel, an even block of 2 to 32 pixels, a
    scanline of at least one."""
    if len(values) < 4:
        return False
    _, ppb, bpp, pps = values[:4]
    return bpp in (8, 16, 32, 64) and 2 <= ppb <= 32 and ppb % 2 == 0 and pps >= 1


def _aec_check(got, n_in, size):
    if got != 0:
        raise OSError(f"szip stream of {n_in} bytes: {_AEC_ERRORS.get(got, got)}, {size} "
                      "bytes expected")


def szip_decode(data, values, limit):
    """One chunk of HDF5's szip filter (``values`` its client values): the
    4-byte little-endian size it decodes to, then the stream, decoded by
    ``aec_decode``.  Raises OSError when the size passes ``limit`` or the
    stream does not decode to it."""
    data = bytes(data)
    size = int.from_bytes(data[:4], "little") if len(data) >= 4 else None
    if size is None or size > limit:
        raise OSError(f"szip chunk of {len(data)} bytes: size {size}, at most {limit} "
                      "expected")
    return aec_decode(data[4:], values, size)


def aec_decode(body, values, size):
    """The szip stream ``body`` (a chunk past its size) decoded to ``size``
    bytes by ``aec.cpp`` (built with g++ at first use), or by
    ``aec_decode_py`` under CHROMOSIGHT_TPU_NO_NATIVE or without a
    compiler: the same bytes, the same OSError."""
    lib = _filter_lib(_AEC_SRC)
    if lib is None:
        return aec_decode_py(body, values, size)
    body = bytes(body)
    out = np.empty(int(size), np.uint8)
    _aec_check(lib.hdf5_aec_decode(body, len(body), out.ctypes.data, out.size,
                                   *map(int, values[:4])), len(body), size)
    return out.tobytes()


def aec_decode_py(body, values, size):
    """``aec.cpp``'s decoder in Python and numpy, the fallback of
    ``aec_decode``: the samples (8 bits, or 16 in the byte order of the
    options; 32- and 64-bit pixels split into bytes interleaved by words)
    decoded RSI by RSI, each scanline's blocks until its samples are out,
    with the same checks in the same order."""
    mask, ppb, bpp, pps = (int(v) for v in values[:4])
    body, size = bytes(body), int(size)
    if not szip_options_valid(values):
        _aec_check(-4, len(body), size)
    word = bpp // 8 if bpp > 16 else 1
    n = 8 if bpp > 16 else bpp
    width = n // 8
    if size % width or size % word:
        _aec_check(-5, len(body), size)
    out = np.empty(size // width, np.uint32)
    _aec_check(_aec_samples(body, out, n, ppb, pps, bool(mask & SZIP_NN)), len(body), size)
    if width == 1:
        raw = out.astype(np.uint8).tobytes()
    else:
        raw = out.astype(">u2" if mask & SZIP_MSB else "<u2").tobytes()
    return unshuffle_numpy(raw, word) if word > 1 else raw


def _aec_samples(body, out, n, block, pps, pp):
    """Decode the samples of ``body`` into ``out`` (uint32): 0, or the
    error code of ``aec.cpp``'s ``decode_samples``."""
    bits = np.unpackbits(np.frombuffer(body, np.uint8)).tobytes().translate(_BITS01)
    total, pos = len(bits), 0
    rsi = -(-pps // block)
    rsi_size = rsi * block
    id_len = 4 if n > 8 else 3
    xmax, uncompressed = (1 << n) - 1, (1 << id_len) - 1
    need, done = len(out), 0
    while done < need:
        line = min(pps, need - done)
        buf = []
        while len(buf) < line:
            ref = pp and not buf
            if pos + id_len > total:
                return -1
            ident = int(bits[pos : pos + id_len], 2)
            pos += id_len
            if ident == 0:
                if pos + 1 > total:
                    return -1
                second = bits[pos] == 49
                pos += 1
                if ref:
                    if pos + n > total:
                        return -1
                    buf.append(int(bits[pos : pos + n], 2))
                    pos += n
                if not second:
                    end = bits.find(b"1", pos)
                    if end < 0:
                        return -1
                    blocks, pos = end - pos + 1, end + 1
                    b = len(buf) // block
                    if blocks == 5:
                        blocks = min(rsi - b, 64 - b % 64)
                    elif blocks > 5:
                        blocks -= 1
                    zeros = blocks * block - ref
                    if blocks > rsi_size or zeros > rsi_size - len(buf):
                        return -2
                    buf.extend([0] * zeros)
                    continue
                i = 1 if ref else 0
                while i < block:
                    end = bits.find(b"1", pos)
                    if end < 0:
                        return -1
                    m, pos = end - pos, end + 1
                    if m > 90:
                        return -2
                    beta = int(((8 * m + 1) ** 0.5 - 1) / 2)
                    while beta * (beta + 1) // 2 > m:
                        beta -= 1
                    d1 = m - beta * (beta + 1) // 2
                    if i % 2 == 0:
                        buf.append(beta - d1)
                        i += 1
                    buf.append(d1)
                    i += 1
            elif ident == uncompressed:
                if pos + block * n > total:
                    return -1
                buf.extend(int(bits[pos + j * n : pos + (j + 1) * n], 2) for j in range(block))
                pos += block * n
            else:
                k = ident - 1
                if ref:
                    if pos + n > total:
                        return -1
                    buf.append(int(bits[pos : pos + n], 2))
                    pos += n
                high, top = [], xmax >> k
                for _ in range(block - ref):
                    end = bits.find(b"1", pos)
                    if end < 0:
                        return -1
                    if end - pos > top:
                        return -2
                    high.append((end - pos) << k)
                    pos = end + 1
                if k:
                    if pos + k * len(high) > total:
                        return -1
                    high = [h | int(bits[pos + j * k : pos + (j + 1) * k], 2)
                            for j, h in enumerate(high)]
                    pos += k * len(high)
                buf.extend(high)
        out[done : done + line] = _unmapped(buf[:line], xmax) if pp else buf[:line]
        done += line
    return 0


def _unmapped(deltas, xmax):
    """The samples of an RSI from its reference and mapped differences
    (CCSDS's unit-delay predictor and mapping, inverted)."""
    x = deltas[0]
    if not any(deltas[1:]):
        return [x] * len(deltas)
    samples = [x]
    for d in deltas[1:]:
        theta = min(x, xmax - x)
        if d <= 2 * theta:
            x = x - ((d + 1) >> 1) if d & 1 else x + (d >> 1)
        else:
            x = d if theta == x else xmax - d
        samples.append(x)
    return samples


def szip_chunks(buf, in_off, in_len, out, out_off, chunk_bytes, values, element, threads):
    """Decode the szip chunks ``buf[in_off[i]:][:in_len[i]]`` (each its size
    and stream, exactly ``chunk_bytes`` bytes; unshuffled by elements of
    ``element`` bytes when above 1) into ``out`` at ``out_off[i]`` on
    ``threads`` threads of ``aec.cpp``'s own: True when every chunk
    decoded; False when one did not, or without the library, and then the
    caller decodes them in Python."""
    lib = _filter_lib(_AEC_SRC)
    if lib is None or not len(in_off):
        return lib is not None
    args, _keep = _chunk_batch(buf, in_off, in_len, out, out_off, chunk_bytes)
    return lib.hdf5_szip_chunks(*args, *map(int, values[:4]), int(element), int(threads)) < 0


def szip_encode_chunks(flat, chunk_bytes, values, element, threads):
    """The chunks of ``chunk_bytes`` bytes of ``flat`` (a uint8 array of
    whole chunks), shuffled by elements of ``element`` bytes when above 1,
    then szip-coded with client ``values`` by ``aec.cpp`` on ``threads``
    threads: [(bytes stored, whether szip coded it)]; a chunk szip would
    not shrink below its size is stored shuffled only, as HDF5 stores it.
    The bytes do not depend on ``threads``.  Raises RuntimeError without
    the native library (there is no Python encoder)."""
    lib = _filter_lib(_AEC_SRC)
    if lib is None:
        raise RuntimeError("writing szip needs aec.cpp built (g++; not under "
                           "CHROMOSIGHT_TPU_NO_NATIVE)")
    flat = np.ascontiguousarray(flat, np.uint8)
    n = len(flat) // chunk_bytes if chunk_bytes else 0
    slots = np.empty((n, chunk_bytes + 4), np.uint8)
    lengths = np.zeros(n, np.int64)
    if n:
        got = lib.hdf5_szip_encode_chunks(flat.ctypes.data, n, int(chunk_bytes), int(element),
                                          *map(int, values[:4]), slots.ctypes.data,
                                          lengths.ctypes.data, int(threads))
        _aec_check(got, len(flat), len(flat))
    return [(slots[k, : lengths[k]].tobytes(), True) if lengths[k] else
            (slots[k, :chunk_bytes].tobytes(), False) for k in range(n)]


def json_windows(path, windows, block, threads):
    """Write the stack ``windows`` (a 3-D C-contiguous float64 array) to a
    new file at ``path`` as ``json.dump({i: window.tolist()}, handle,
    indent=4)`` writes it, byte for byte, with ``jsonwin.cpp``: ``block``
    windows at a time on ``threads`` threads.  Returns the bytes written,
    or None without the library (CHROMOSIGHT_TPU_NO_NATIVE, no compiler),
    and then nothing was written; raises OSError when the file cannot be
    opened or written."""
    lib = _filter_lib(_JSONWIN_SRC)
    if lib is None:
        return None
    if (windows.ndim != 3 or windows.dtype != np.float64
            or not windows.flags.c_contiguous or block < 1):
        raise ValueError("json_windows takes a C-contiguous 3-D float64 stack")
    got = lib.json_windows_write(os.fsencode(path), windows.ctypes.data, *windows.shape,
                                 int(block), int(threads))
    if got < 0:
        raise OSError(-got, os.strerror(-got), os.fspath(path))
    return got
