"""ICE (iterative correction) matrix balancing.

The port's copy of ``chromosight_tpu/ops/balance.py``, line for line,
on the port's own ``native`` library and stage timers: the weights
equal the JAX package's bit for bit at the same thread count.

Replaces ``cooler.balance_cooler`` which the reference calls with
``mad_max=n_mads, cis_only=not inter, ignore_diags=2, max_iters=200,
min_nnz=10, store=True`` (reference ``contacts_map.py:209-219``).

Algorithm follows cooler's iterative-correction procedure (validated
against the cooler-generated weight column vendored in
``data_test/example.cool``):

1. drop pixels on the first ``ignore_diags`` diagonals (and all trans
   pixels when ``cis_only``);
2. exclude bins with fewer than ``min_nnz`` nonzero pixels;
3. exclude bins by the MAD-max rule: raw marginals are scaled by each
   chromosome's median nonzero marginal (cis mode only), then a single
   genome-wide cutoff ``exp(med - mad_max * dev)`` is applied to the log
   marginals, where ``dev`` is the UNSCALED median absolute deviation
   (cooler.util.mad uses no 1/0.6745 normal-consistency factor);
4. iterate  bias /= marginal(bias * A * bias) / mean  until the variance
   of the scaled nonzero marginals drops below ``tol`` (per block in cis
   mode, genome-wide otherwise);
5. rescale biases by sqrt(mean marginal) so the balanced matrix has unit
   marginals; excluded bins get NaN weights.

The pixel table is streamed twice (filter pass, then balance pass) so
peak memory is one chunk + the largest chromosome's intra pixels in cis
mode — never the whole genome-scale table.
"""

from __future__ import annotations

import os

import numpy as np


def _marginals(b1, b2, counts, bias, n_bins):
    """Marginal sums of the symmetric matrix given upper-triangle pixels."""
    from chromosight_torch import native

    marg = native.marginal_sums(b1, b2, counts, bias, n_bins)
    if marg is not None:
        return marg
    vals = counts * bias[b1] * bias[b2]
    marg = np.bincount(b1, weights=vals, minlength=n_bins)
    marg += np.bincount(b2, weights=vals, minlength=n_bins)
    return marg


def _compact_triplets(b1, b2, counts):
    """Downcast triplets to int32 ids + float32 counts when exact.

    The ICE iteration is memory-bound on the triplet stream; halving the
    bytes per pixel nearly halves the per-iteration wall.  Counts are
    only compacted when exactly representable in f32 (integer Hi-C
    counts < 2^24 always are), and the marginal kernels compute every
    product in double, so the resulting weights are bitwise identical to
    the wide path's."""
    if len(b1) and max(int(b1.max()), int(b2.max())) >= 2**31:
        return b1, b2, counts.astype(np.float64, copy=False)
    ct32 = counts.astype(np.float32, copy=False)
    if counts.dtype != np.float32 and not np.array_equal(
        ct32.astype(np.float64), np.asarray(counts, np.float64)
    ):
        return b1, b2, counts.astype(np.float64, copy=False)
    return (
        b1.astype(np.int32, copy=False),
        b2.astype(np.int32, copy=False),
        ct32,
    )


def _iterate_block(b1, b2, counts, bias, max_iters, tol):
    """Run the ICE iteration on one block given the initial (filtered)
    bias vector (0 = excluded). Bin ids are block-local. Returns the
    final bias with excluded bins as NaN, rescaled by sqrt(scale)."""
    from chromosight_torch import native, observability as obs

    n_bins = bias.shape[0]
    b1, b2, counts = _compact_triplets(b1, b2, counts)
    bias = np.ascontiguousarray(bias, dtype=np.float64).copy()
    with obs.stage("ice: iterate"):
        res = native.ice_iterate_csr(b1, b2, counts, bias, max_iters, tol)
        if res is None:
            res = native.ice_iterate(b1, b2, counts, bias, max_iters, tol)
        if res is not None:
            scale, var, n_iters = res
        else:
            scale = np.nan
            var = np.inf
            n_iters = 0
            for _ in range(max_iters):
                marg = _marginals(b1, b2, counts, bias, n_bins)
                nzmarg = marg[marg != 0]
                if len(nzmarg) == 0:
                    break
                scale = nzmarg.mean()
                adj = marg / scale
                adj[adj == 0] = 1.0
                bias /= adj
                n_iters += 1
                var = float(((nzmarg / scale) - 1).var())
                if var < tol:
                    break
    if os.environ.get("CHROMOSIGHT_TPU_ICE_VERBOSE"):
        import sys

        sys.stderr.write(
            f"ice: block n_bins={n_bins} nnz={len(b1)} iters={n_iters} "
            f"var={var:.3g} native={res is not None}\n"
        )
    bias[bias == 0] = np.nan
    if np.isfinite(scale):
        bias /= np.sqrt(scale)
    return bias


def _filter_bias(marg, nnz, offsets, mad_max, min_nnz, cis_only):
    """Initial 0/1 bias from the min_nnz and MAD-max exclusion rules
    (cooler semantics, see module docstring)."""
    n_bins = marg.shape[0]
    bias = np.ones(n_bins, dtype=np.float64)
    bias[nnz < min_nnz] = 0.0
    if mad_max > 0:
        m = marg.astype(np.float64).copy()
        if cis_only:
            # scale each chromosome by its median nonzero marginal so one
            # genome-wide cutoff applies across coverage differences
            for cid in range(len(offsets) - 1):
                s, e = int(offsets[cid]), int(offsets[cid + 1])
                nzc = m[s:e][m[s:e] > 0]
                if len(nzc):
                    m[s:e] /= np.median(nzc)
        nz = m > 0
        if np.any(nz):
            log_m = np.log(m[nz])
            med = np.median(log_m)
            dev = np.median(np.abs(log_m - med))  # unscaled (cooler.util.mad)
            cutoff = np.exp(med - mad_max * dev)
            bias[m < cutoff] = 0.0
    return bias


def _ice_cis_native(clr, offsets, mad_max, ignore_diags, max_iters,
                    min_nnz, tol):
    """Whole-loop native cis balancing: ONE stored-dtype pass per
    chromosome over the raw pixel slice (``native.ice_prep_csr``: bin1
    implied by the file's CSR index, no casts, no intermediate copies)
    emits both the filter vectors and the 3 B/pixel iteration stream,
    then the compressed-stream loop runs per block.  Weights are
    bitwise identical to the numpy pass-1 + ``ice_iterate_csr`` path up
    to f64 summation order in the raw marginals (the MAD-max inputs).

    Returns the weight vector, or None when ineligible (no native tier,
    non-f32-exact counts, blocks taller than the u16 diagonal stream,
    or stream bytes over CHROMOSIGHT_TPU_ICE_CACHE_BYTES) — callers
    fall back to the streaming path."""
    from chromosight_torch import native, observability as obs

    if native.get_lib() is None:
        return None
    if os.environ.get("CHROMOSIGHT_TPU_ICE_NATIVE", "1") == "0":
        return None
    budget = float(os.environ.get("CHROMOSIGHT_TPU_ICE_CACHE_BYTES", 2e9))
    if clr.nnz * 4 > budget:  # ~3.25 B/px stream + exceptions, held whole
        return None
    n_bins = clr.n_bins
    n_chroms = len(offsets) - 1
    nnz = np.zeros(n_bins, dtype=np.int64)
    marg = np.zeros(n_bins, dtype=np.float64)
    streams = []
    for cid in range(n_chroms):
        s, e = int(offsets[cid]), int(offsets[cid + 1])
        with obs.stage("ice: prep"):
            indptr, b2, ct = clr.row_slice_raw(s, e)
            prep = native.ice_prep_csr(indptr, b2, ct, s, e, ignore_diags)
        if prep is None:
            return None
        nnz[s:e] = prep[6]
        marg[s:e] = prep[7]
        streams.append(prep[:6])
    bias0 = _filter_bias(marg, nnz, offsets, mad_max, min_nnz, True)
    weights = np.full(n_bins, np.nan)

    def one_block(cid):
        s, e = int(offsets[cid]), int(offsets[cid + 1])
        ip, d16, ct8, exc_i, exc_j, exc_val = streams[cid]
        streams[cid] = None
        bias = np.ascontiguousarray(bias0[s:e], dtype=np.float64).copy()
        with obs.stage("ice: iterate"):
            res = native.ice_iterate_csr_prebuilt(
                ip, d16, ct8, exc_i, exc_j, exc_val, bias, max_iters, tol
            )
        if res is None:
            return False
        scale, var, n_iters = res
        if os.environ.get("CHROMOSIGHT_TPU_ICE_VERBOSE"):
            import sys

            sys.stderr.write(
                f"ice: block n_bins={e - s} nnz={len(d16)} "
                f"iters={n_iters} var={var:.3g} native=prep\n"
            )
        bias[bias == 0] = np.nan
        if np.isfinite(scale):
            bias /= np.sqrt(scale)
        weights[s:e] = bias
        return True

    # Chromosome blocks are independent (disjoint weight slices, private
    # streams), so they run concurrently: the ctypes iterate releases the
    # GIL and each block's serial sections (bias update, exceptions)
    # overlap another block's parallel marginals.  Results are identical
    # to the serial order — mirrors the reference's pooled balancing
    # (contacts_map.py:208-219).  CHROMOSIGHT_TPU_ICE_BLOCK_THREADS=1
    # restores the serial loop.
    pool_n = int(
        os.environ.get(
            "CHROMOSIGHT_TPU_ICE_BLOCK_THREADS",
            max(1, min(4, (os.cpu_count() or 1) // 2, n_chroms)),
        )
    )
    if pool_n > 1 and n_chroms > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=pool_n) as pool:
            ok = list(pool.map(one_block, range(n_chroms)))
    else:
        ok = [one_block(cid) for cid in range(n_chroms)]
    if not all(ok):
        return None
    return weights


def ice_balance(
    clr,
    mad_max=5,
    cis_only=True,
    ignore_diags=2,
    max_iters=200,
    min_nnz=10,
    tol=1e-5,
    chunksize=10_000_000,
    store=True,
):
    """Balance a cool file in place, writing the ``weight`` column.

    Parameters mirror the reference's cooler.balance_cooler invocation
    (``contacts_map.py:209-219``).
    """
    n_bins = clr.n_bins
    offsets = np.asarray(clr._chrom_offset, np.int64)
    n_chroms = len(offsets) - 1
    weights = np.full(n_bins, np.nan)
    stats = {"mad_max": mad_max, "min_nnz": min_nnz, "ignore_diags": ignore_diags}

    if cis_only:
        fast = _ice_cis_native(
            clr, offsets, mad_max, ignore_diags, max_iters, min_nnz, tol
        )
        if fast is not None:
            if store:
                clr.store_weights(fast, stats=stats)
            return fast

    def filtered_chunks():
        """Stream (b1, b2, ct, cid1) pixel chunks with ignore_diags (and,
        in cis mode, trans pixels) already dropped."""
        for b1, b2, ct in clr.pixel_chunks(chunksize):
            keep = (b2 - b1) >= ignore_diags
            b1, b2, ct = b1[keep], b2[keep], ct[keep]
            cid1 = np.searchsorted(offsets, b1, side="right") - 1
            if cis_only:
                cid2 = np.searchsorted(offsets, b2, side="right") - 1
                intra = cid1 == cid2
                b1, b2, ct, cid1 = b1[intra], b2[intra], ct[intra], cid1[intra]
            yield b1, b2, ct.astype(np.float64), cid1

    # Retain pass-1 triplets (compact: int32 local ids + f32 counts,
    # ~12 B/pixel) so pass 2 skips a second stream over the pixel table
    # — an HDF5 re-read plus re-filtering that costs ~10% of a
    # genome-scale norm=force run.  Budget-gated so human-scale tables
    # (331M px ≈ 4 GB) fall back to the memory-safe two-stream path.
    budget = float(os.environ.get("CHROMOSIGHT_TPU_ICE_CACHE_BYTES", 2e9))
    retain = clr.nnz * 12 <= budget
    retained = [[] for _ in range(n_chroms)] if cis_only else []

    def _retain_part(bucket, b1, b2, ct, base):
        bb1 = (b1 - base).astype(np.int32)
        bb2 = (b2 - base).astype(np.int32)
        ct32 = ct.astype(np.float32)
        if not np.array_equal(ct32.astype(np.float64), ct):
            bucket.append((bb1, bb2, ct))
        else:
            bucket.append((bb1, bb2, ct32))

    # ---- pass 1: accumulate nnz + raw marginals for the filters ---- #
    nnz = np.zeros(n_bins, dtype=np.int64)
    marg = np.zeros(n_bins, dtype=np.float64)
    for b1, b2, ct, cid1 in filtered_chunks():
        nnz += np.bincount(b1, minlength=n_bins)
        nnz += np.bincount(b2, minlength=n_bins)
        marg += np.bincount(b1, weights=ct, minlength=n_bins)
        marg += np.bincount(b2, weights=ct, minlength=n_bins)
        if retain and n_bins < 2**31:
            if cis_only:
                for cid in np.unique(cid1):
                    m = cid1 == cid
                    _retain_part(
                        retained[cid], b1[m], b2[m], ct[m], int(offsets[cid])
                    )
            else:
                _retain_part(retained, b1, b2, ct, 0)
    bias0 = _filter_bias(marg, nnz, offsets, mad_max, min_nnz, cis_only)

    def _concat(parts):
        if not parts:
            return (
                np.zeros(0, np.int64),
                np.zeros(0, np.int64),
                np.zeros(0, np.float64),
            )
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
        )

    # ---- pass 2: iterate (from the retained triplets, else re-stream) - #
    if cis_only:
        if retain and n_bins < 2**31:

            def _balance_block(cid):
                s, e = int(offsets[cid]), int(offsets[cid + 1])
                bb1, bb2, cct = _concat(retained[cid])
                retained[cid] = None
                weights[s:e] = _iterate_block(
                    bb1, bb2, cct, bias0[s:e], max_iters, tol
                )

            # independent blocks, GIL-released native iterates: run them
            # concurrently (same rationale/env knob as _ice_cis_native)
            pool_n = int(
                os.environ.get(
                    "CHROMOSIGHT_TPU_ICE_BLOCK_THREADS",
                    max(1, min(4, (os.cpu_count() or 1) // 2, n_chroms)),
                )
            )
            if pool_n > 1 and n_chroms > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=pool_n) as pool:
                    list(pool.map(_balance_block, range(n_chroms)))
            else:
                for cid in range(n_chroms):
                    _balance_block(cid)
        else:
            # Bucket intra triplets per chromosome and balance each block
            # as soon as the stream moves past its rows (cool pixels are
            # sorted by bin1, so a block is complete once bin1 leaves its
            # range): peak memory is one chunk + the largest chromosome's
            # pixels.
            buckets = [[] for _ in range(n_chroms)]

            def flush(cid):
                s, e = int(offsets[cid]), int(offsets[cid + 1])
                parts = buckets[cid]
                if parts:
                    bb1 = np.concatenate([p[0] for p in parts]) - s
                    bb2 = np.concatenate([p[1] for p in parts]) - s
                    cct = np.concatenate([p[2] for p in parts])
                else:
                    bb1 = bb2 = np.zeros(0, np.int64)
                    cct = np.zeros(0, np.float64)
                buckets[cid] = None
                weights[s:e] = _iterate_block(
                    bb1, bb2, cct, bias0[s:e], max_iters, tol
                )

            done = 0  # blocks [0, done) already balanced
            for b1, b2, ct, cid1 in filtered_chunks():
                for cid in np.unique(cid1):
                    m = cid1 == cid
                    buckets[cid].append((b1[m], b2[m], ct[m]))
                low = int(cid1.min()) if len(cid1) else done
                while done < low:
                    flush(done)
                    done += 1
            while done < n_chroms:
                flush(done)
                done += 1
    else:
        # Trans-inclusive balancing iterates over every pixel genome-wide
        # each round, so the triplets are held in memory for the duration.
        if retain and n_bins < 2**31:
            b1, b2, ct = _concat(retained)
            retained = None
        else:
            b1_l, b2_l, ct_l = [], [], []
            for b1, b2, ct, _ in filtered_chunks():
                b1_l.append(b1)
                b2_l.append(b2)
                ct_l.append(ct)
            b1 = np.concatenate(b1_l) if b1_l else np.zeros(0, np.int64)
            b2 = np.concatenate(b2_l) if b2_l else np.zeros(0, np.int64)
            ct = np.concatenate(ct_l) if ct_l else np.zeros(0, np.float64)
        weights[:] = _iterate_block(b1, b2, ct, bias0, max_iters, tol)

    if store:
        clr.store_weights(weights, stats=stats)
    return weights
