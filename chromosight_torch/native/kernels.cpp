// Native host-side kernels for chromosight-torch.
//
// The port's copy of the entries of chromosight_tpu/native/kernels.cpp
// that it calls, with their helpers and unchanged bodies: connected-
// component labelling of candidate pixels (reference
// utils/detection.py:459-554), the COO -> band scatter (--subsample),
// the fused filter + balance + scatter of a pixel slice into the upper
// band, the raw-count scatters into u16, u8 + exceptions and u8-head /
// nibble-packed-tail bands (COO and bin1_offset-driven, with int32 and
// int64 bin2 ids), greedy neighbour suppression, the ICE balancing loops,
// and the trans rectangle fetch.  Built as a plain shared library with
// g++ and bound through ctypes (chromosight_torch/native/__init__.py).
//
// All index arrays are int64 unless a name says otherwise; pixel lists
// must be sorted row-major (row, col ascending), which is how both the
// sparse fetch layer and numpy's nonzero produce them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>

// Deterministic parallel merge of per-thread partial marginals: every
// thread sums a fixed bin range over the partials in thread-id order,
// so the result is bitwise reproducible for a given thread count (a
// `critical` merge adds partials in arrival order, which varies run to
// run and changes the f64 sums in the last ulp — ICE iterates 200x on
// those sums, amplifying the wobble into visibly different weights).
// `parts` must hold one pointer per thread (unused slots null).
static void merge_partials(double *const *parts, int nth, int64_t n_bins,
                           double *out) {
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_bins; ++i) {
        double s = out[i];
        for (int t = 0; t < nth; ++t)
            if (parts[t] != nullptr) s += parts[t][i];
        out[i] = s;
    }
}
#endif

extern "C" {

// ------------------------------------------------------------------ //
// Union-find with path halving; union by smaller root index so the final
// label of each component is the (row-major) index of its first pixel,
// matching scipy.sparse.csgraph.connected_components ordering.
// ------------------------------------------------------------------ //
static inline int64_t uf_find(int64_t *parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

static inline void uf_union(int64_t *parent, int64_t a, int64_t b) {
    int64_t ra = uf_find(parent, a);
    int64_t rb = uf_find(parent, b);
    if (ra == rb) return;
    if (ra < rb)
        parent[rb] = ra;
    else
        parent[ra] = rb;
}

// Label 4-way connected components of a sorted row-major pixel list.
// rows/cols: the pixel coordinates; n: number of pixels; ncols: matrix
// width (for flat ids). labels_out[i] receives the min pixel index of
// pixel i's component. Returns the number of components.
int64_t cc_label(const int64_t *rows, const int64_t *cols, int64_t n,
                 int64_t ncols, int64_t *labels_out) {
    if (n == 0) return 0;
    std::vector<int64_t> parent(n);
    for (int64_t i = 0; i < n; ++i) parent[i] = i;

    std::vector<int64_t> flat(n);
    for (int64_t i = 0; i < n; ++i) flat[i] = rows[i] * ncols + cols[i];

    // Right neighbours: consecutive entries on the same row.
    for (int64_t i = 0; i + 1 < n; ++i) {
        if (rows[i + 1] == rows[i] && cols[i + 1] == cols[i] + 1)
            uf_union(parent.data(), i, i + 1);
    }
    // Down neighbours: binary search for flat id + ncols.
    for (int64_t i = 0; i < n; ++i) {
        int64_t target = flat[i] + ncols;
        // lower_bound over flat (sorted ascending)
        int64_t lo = i + 1, hi = n;
        while (lo < hi) {
            int64_t mid = lo + (hi - lo) / 2;
            if (flat[mid] < target)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo < n && flat[lo] == target) uf_union(parent.data(), i, lo);
    }
    // Resolve all roots; count components.
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = uf_find(parent.data(), i);
        labels_out[i] = r;
        if (r == i) ++count;
    }
    return count;
}

// ------------------------------------------------------------------ //
// Scatter symmetric COO triplets into the upper band B[i, d] = M[i, i+d].
// Entries with d outside [0, width) are skipped.
// ------------------------------------------------------------------ //
void coo_to_band_f64(const int64_t *rows, const int64_t *cols,
                     const double *vals, int64_t nnz, int64_t n,
                     int64_t width, double *band_out) {
    std::memset(band_out, 0, sizeof(double) * (size_t)n * (size_t)width);
    for (int64_t k = 0; k < nnz; ++k) {
        int64_t i = rows[k];
        int64_t d = cols[k] - i;
        if (d >= 0 && d < width && i >= 0 && i < n)
            band_out[i * width + d] = vals[k];
    }
}

// float32 variant feeding device tensors directly.
void coo_to_band_f32(const int64_t *rows, const int64_t *cols,
                     const float *vals, int64_t nnz, int64_t n,
                     int64_t width, float *band_out) {
    std::memset(band_out, 0, sizeof(float) * (size_t)n * (size_t)width);
    for (int64_t k = 0; k < nnz; ++k) {
        int64_t i = rows[k];
        int64_t d = cols[k] - i;
        if (d >= 0 && d < width && i >= 0 && i < n)
            band_out[i * width + d] = vals[k];
    }
}

}  // extern "C" (templates need C++ linkage)

// ------------------------------------------------------------------ //
// Fused fetch tail: filter to the scan band, balance, and scatter into
// the upper band tensor in ONE pass over the raw pixel-table slices.
// Replaces four separate numpy passes (keep-mask, filter copies, dtype
// cast, weight gathers) that dominate host time at genome scale.
//
// b1/b2: raw bin ids (global coords, bin1-sorted) of the [lo, hi) pixel
// slice for rows [s, e); counts: raw count values; weights: per-bin
// balancing weights indexed by global bin id, or nullptr for raw mode
// (NaN weights propagate, matching cooler's balanced selector).
// band_out: (e-s, width) float32, B[i, d] = M[i, i+d].
// ------------------------------------------------------------------ //
// n_rows: allocated row count of band_out (>= e-s; extra rows are the
// shape-bucket padding and stay zero).

template <typename CT>
static void band_scatter_fused_impl(const int64_t *b1, const int64_t *b2,
                                    const CT *counts, int64_t nnz,
                                    const double *weights, int64_t s,
                                    int64_t e, int64_t width,
                                    int64_t n_rows, float *band_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows * width; ++i) band_out[i] = 0.0f;
    if (weights) {
#pragma omp parallel for schedule(static)
        for (int64_t k = 0; k < nnz; ++k) {
            int64_t i = b1[k], j = b2[k];
            int64_t d = j - i;
            if (d < 0 || d >= width || j >= e) continue;
            if (i < s || i - s >= n_rows) continue;  // never write OOB
            band_out[(i - s) * width + d] =
                (float)((double)counts[k] * weights[i] * weights[j]);
        }
    } else {
#pragma omp parallel for schedule(static)
        for (int64_t k = 0; k < nnz; ++k) {
            int64_t i = b1[k], j = b2[k];
            int64_t d = j - i;
            if (d < 0 || d >= width || j >= e) continue;
            if (i < s || i - s >= n_rows) continue;  // never write OOB
            band_out[(i - s) * width + d] = (float)counts[k];
        }
    }
}

// Scatter RAW integer counts into a uint16 band (half the bytes of the
// f32 band, exact values): the device applies the balancing weights and
// casts to f32 (ops/band.py:band_weighted).  bin1 ids are implied by the
// cool file's bin1_offset index (indptr[r] .. indptr[r+1] are row s+r's
// pixels), so the host never reads or materialises the bin1_id dataset
// at all — one-third of the pixel-table bytes on the fetch path.
// Parallelises over rows.  Returns 1 when any kept pixel is
// non-integral, negative or overflows uint16 (caller falls back to the
// f32 path).
template <typename CT, typename B2>
static int64_t band_scatter_counts_indptr_impl(
    const int64_t *indptr, const B2 *b2, const CT *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width,
    int64_t n_rows, uint16_t *band_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows * width; ++i) band_out[i] = 0;
    int64_t overflow = 0;
    const int64_t base = indptr[0];
    // never write past the allocated band (bucket padding rows excluded)
    const int64_t r_end = n_rows_src < n_rows ? n_rows_src : n_rows;
#pragma omp parallel for schedule(dynamic, 64) reduction(| : overflow)
    for (int64_t r = 0; r < r_end; ++r) {
        uint16_t *row_out = band_out + r * width;
        for (int64_t k = indptr[r] - base; k < indptr[r + 1] - base; ++k) {
            int64_t j = b2[k];
            int64_t d = j - (s + r);
            if (d < 0 || d >= width || j >= e) continue;
            double c = (double)counts[k];
            int64_t ci = (int64_t)c;
            if (c != (double)ci || ci < 0 || ci > 65535) {
                overflow = 1;
                continue;
            }
            row_out[d] = (uint16_t)ci;
        }
    }
    return overflow;
}

extern "C" {

int64_t band_scatter_counts_indptr_i32(const int64_t *indptr,
                                       const int64_t *b2,
                                       const int32_t *counts,
                                       int64_t n_rows_src, int64_t s,
                                       int64_t e, int64_t width,
                                       int64_t n_rows,
                                       uint16_t *band_out) {
    return band_scatter_counts_indptr_impl(indptr, b2, counts, n_rows_src,
                                           s, e, width, n_rows, band_out);
}

int64_t band_scatter_counts_indptr_i64(const int64_t *indptr,
                                       const int64_t *b2,
                                       const int64_t *counts,
                                       int64_t n_rows_src, int64_t s,
                                       int64_t e, int64_t width,
                                       int64_t n_rows,
                                       uint16_t *band_out) {
    return band_scatter_counts_indptr_impl(indptr, b2, counts, n_rows_src,
                                           s, e, width, n_rows, band_out);
}

int64_t band_scatter_counts_indptr_f64(const int64_t *indptr,
                                       const int64_t *b2,
                                       const double *counts,
                                       int64_t n_rows_src, int64_t s,
                                       int64_t e, int64_t width,
                                       int64_t n_rows,
                                       uint16_t *band_out) {
    return band_scatter_counts_indptr_impl(indptr, b2, counts, n_rows_src,
                                           s, e, width, n_rows, band_out);
}

}  // extern "C" (template below needs C++ linkage)

// uint8 + exceptions variant: most Hi-C counts fit one byte, so the
// host ships a 1-byte band (half the uint16 path's bytes again) plus a
// short exception list (flat index, value) for the rare counts > 255.
// Values stay exact: exceptions hold anything up to 2^24 (f32-exact on
// the device side, where they are scattered over the cast band).
// Returns the exception count, or -1 when a kept value is non-integral,
// negative, or > 2^24 (caller falls back to uint16 / f32).  Exceptions
// past exc_cap are not written (caller compares the returned count).
template <typename CT, typename B2>
static int64_t band_scatter_counts_u8_indptr_impl(
    const int64_t *indptr, const B2 *b2, const CT *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width,
    int64_t n_rows, uint8_t *band_out, int64_t *exc_idx, float *exc_val,
    int64_t exc_cap) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows * width; ++i) band_out[i] = 0;
    int64_t bad = 0;
    int64_t n_exc = 0;
    const int64_t base = indptr[0];
    // never write past the allocated band (bucket padding rows excluded)
    const int64_t r_end = n_rows_src < n_rows ? n_rows_src : n_rows;
#pragma omp parallel for schedule(dynamic, 64) reduction(| : bad)
    for (int64_t r = 0; r < r_end; ++r) {
        uint8_t *row_out = band_out + r * width;
        for (int64_t k = indptr[r] - base; k < indptr[r + 1] - base; ++k) {
            int64_t j = b2[k];
            int64_t d = j - (s + r);
            if (d < 0 || d >= width || j >= e) continue;
            double c = (double)counts[k];
            int64_t ci = (int64_t)c;
            if (c != (double)ci || ci < 0 || ci > (1 << 24)) {
                bad = 1;
                continue;
            }
            if (ci <= 255) {
                row_out[d] = (uint8_t)ci;
            } else {
                int64_t slot;
#pragma omp atomic capture
                slot = n_exc++;
                if (slot < exc_cap) {
                    exc_idx[slot] = r * width + d;
                    exc_val[slot] = (float)ci;
                }
            }
        }
    }
    if (bad) return -1;
    return n_exc;
}

extern "C" {

int64_t band_scatter_counts_u8_indptr_i32(
    const int64_t *indptr, const int64_t *b2, const int32_t *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width,
    int64_t n_rows, uint8_t *band_out, int64_t *exc_idx, float *exc_val,
    int64_t exc_cap) {
    return band_scatter_counts_u8_indptr_impl(
        indptr, b2, counts, n_rows_src, s, e, width, n_rows, band_out,
        exc_idx, exc_val, exc_cap);
}

int64_t band_scatter_counts_u8_indptr_i64(
    const int64_t *indptr, const int64_t *b2, const int64_t *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width,
    int64_t n_rows, uint8_t *band_out, int64_t *exc_idx, float *exc_val,
    int64_t exc_cap) {
    return band_scatter_counts_u8_indptr_impl(
        indptr, b2, counts, n_rows_src, s, e, width, n_rows, band_out,
        exc_idx, exc_val, exc_cap);
}

int64_t band_scatter_counts_u8_indptr_f64(
    const int64_t *indptr, const int64_t *b2, const double *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width,
    int64_t n_rows, uint8_t *band_out, int64_t *exc_idx, float *exc_val,
    int64_t exc_cap) {
    return band_scatter_counts_u8_indptr_impl(
        indptr, b2, counts, n_rows_src, s, e, width, n_rows, band_out,
        exc_idx, exc_val, exc_cap);
}

}  // extern "C" (template below needs C++ linkage)

// uint4 split variant: Hi-C counts decay with diagonal distance, so the
// first d0 band columns (near the diagonal, where Poisson means are
// large) ship as 1-byte pixels and the remaining width-d0 columns pack
// TWO 4-bit counts per byte — roughly half the u8 path's bytes again
// for wide bands.  Counts that do not fit their lane (head > 255, tail
// > 15) ride the same (flat logical index, value) exception list as the
// u8 path; flat indices address the UNPACKED (n_rows, width) band, so
// the device scatters them after nibble expansion.  Same -1-on-bad /
// count-vs-cap contract as the u8 scatter.
template <typename CT, typename B2>
static int64_t band_scatter_counts_u4_indptr_impl(
    const int64_t *indptr, const B2 *b2, const CT *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width, int64_t d0,
    int64_t n_rows, uint8_t *head_out, uint8_t *tail_out,
    int64_t *exc_idx, float *exc_val, int64_t exc_cap) {
    const int64_t tp = (width - d0 + 1) / 2;  // packed tail bytes/row
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows * d0; ++i) head_out[i] = 0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_rows * tp; ++i) tail_out[i] = 0;
    int64_t bad = 0;
    int64_t n_exc = 0;
    const int64_t base = indptr[0];
    const int64_t r_end = n_rows_src < n_rows ? n_rows_src : n_rows;
#pragma omp parallel for schedule(dynamic, 64) reduction(| : bad)
    for (int64_t r = 0; r < r_end; ++r) {
        uint8_t *hrow = head_out + r * d0;
        uint8_t *trow = tail_out + r * tp;
        for (int64_t k = indptr[r] - base; k < indptr[r + 1] - base; ++k) {
            int64_t j = b2[k];
            int64_t d = j - (s + r);
            if (d < 0 || d >= width || j >= e) continue;
            double c = (double)counts[k];
            int64_t ci = (int64_t)c;
            if (c != (double)ci || ci < 0 || ci > (1 << 24)) {
                bad = 1;
                continue;
            }
            bool exc;
            if (d < d0) {
                exc = ci > 255;
                if (!exc) hrow[d] = (uint8_t)ci;
            } else {
                exc = ci > 15;
                if (!exc) {
                    int64_t t = d - d0;
                    // even tail column -> low nibble, odd -> high
                    if (t & 1)
                        trow[t >> 1] |= (uint8_t)(ci << 4);
                    else
                        trow[t >> 1] |= (uint8_t)ci;
                }
            }
            if (exc) {
                int64_t slot;
#pragma omp atomic capture
                slot = n_exc++;
                if (slot < exc_cap) {
                    exc_idx[slot] = r * width + d;
                    exc_val[slot] = (float)ci;
                }
            }
        }
    }
    if (bad) return -1;
    return n_exc;
}

extern "C" {

int64_t band_scatter_counts_u4_indptr_i32(
    const int64_t *indptr, const int64_t *b2, const int32_t *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width, int64_t d0,
    int64_t n_rows, uint8_t *head_out, uint8_t *tail_out,
    int64_t *exc_idx, float *exc_val, int64_t exc_cap) {
    return band_scatter_counts_u4_indptr_impl(
        indptr, b2, counts, n_rows_src, s, e, width, d0, n_rows, head_out,
        tail_out, exc_idx, exc_val, exc_cap);
}

int64_t band_scatter_counts_u4_indptr_i64(
    const int64_t *indptr, const int64_t *b2, const int64_t *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width, int64_t d0,
    int64_t n_rows, uint8_t *head_out, uint8_t *tail_out,
    int64_t *exc_idx, float *exc_val, int64_t exc_cap) {
    return band_scatter_counts_u4_indptr_impl(
        indptr, b2, counts, n_rows_src, s, e, width, d0, n_rows, head_out,
        tail_out, exc_idx, exc_val, exc_cap);
}

int64_t band_scatter_counts_u4_indptr_f64(
    const int64_t *indptr, const int64_t *b2, const double *counts,
    int64_t n_rows_src, int64_t s, int64_t e, int64_t width, int64_t d0,
    int64_t n_rows, uint8_t *head_out, uint8_t *tail_out,
    int64_t *exc_idx, float *exc_val, int64_t exc_cap) {
    return band_scatter_counts_u4_indptr_impl(
        indptr, b2, counts, n_rows_src, s, e, width, d0, n_rows, head_out,
        tail_out, exc_idx, exc_val, exc_cap);
}

// int32 bin2_id variants: cool files written with minimal pixel dtypes
// (io/cool.py:create_cool) store 4-byte ids; scattering straight from
// the stored dtype skips a whole-pixel-table int64 cast on the host
// (a multi-second per-genome sweep on slow-memory hosts).
#define CHROMO_EXPORT_B2I32(CTSUF, CT)                                      \
    int64_t band_scatter_counts_indptr_##CTSUF##_b2i32(                     \
        const int64_t *indptr, const int32_t *b2, const CT *counts,         \
        int64_t n_rows_src, int64_t s, int64_t e, int64_t width,            \
        int64_t n_rows, uint16_t *band_out) {                               \
        return band_scatter_counts_indptr_impl(                             \
            indptr, b2, counts, n_rows_src, s, e, width, n_rows, band_out); \
    }                                                                       \
    int64_t band_scatter_counts_u8_indptr_##CTSUF##_b2i32(                  \
        const int64_t *indptr, const int32_t *b2, const CT *counts,         \
        int64_t n_rows_src, int64_t s, int64_t e, int64_t width,            \
        int64_t n_rows, uint8_t *band_out, int64_t *exc_idx,                \
        float *exc_val, int64_t exc_cap) {                                  \
        return band_scatter_counts_u8_indptr_impl(                          \
            indptr, b2, counts, n_rows_src, s, e, width, n_rows, band_out,  \
            exc_idx, exc_val, exc_cap);                                     \
    }                                                                       \
    int64_t band_scatter_counts_u4_indptr_##CTSUF##_b2i32(                  \
        const int64_t *indptr, const int32_t *b2, const CT *counts,         \
        int64_t n_rows_src, int64_t s, int64_t e, int64_t width,            \
        int64_t d0, int64_t n_rows, uint8_t *head_out, uint8_t *tail_out,   \
        int64_t *exc_idx, float *exc_val, int64_t exc_cap) {                \
        return band_scatter_counts_u4_indptr_impl(                          \
            indptr, b2, counts, n_rows_src, s, e, width, d0, n_rows,       \
            head_out, tail_out, exc_idx, exc_val, exc_cap);                 \
    }

CHROMO_EXPORT_B2I32(i32, int32_t)
CHROMO_EXPORT_B2I32(i64, int64_t)
CHROMO_EXPORT_B2I32(f64, double)
#undef CHROMO_EXPORT_B2I32

}  // extern "C"

extern "C" {

void band_scatter_fused_f64(const int64_t *b1, const int64_t *b2,
                            const double *counts, int64_t nnz,
                            const double *weights, int64_t s, int64_t e,
                            int64_t width, int64_t n_rows,
                            float *band_out) {
    band_scatter_fused_impl(b1, b2, counts, nnz, weights, s, e, width,
                            n_rows, band_out);
}

void band_scatter_fused_i32(const int64_t *b1, const int64_t *b2,
                            const int32_t *counts, int64_t nnz,
                            const double *weights, int64_t s, int64_t e,
                            int64_t width, int64_t n_rows,
                            float *band_out) {
    band_scatter_fused_impl(b1, b2, counts, nnz, weights, s, e, width,
                            n_rows, band_out);
}

void band_scatter_fused_i64(const int64_t *b1, const int64_t *b2,
                            const int64_t *counts, int64_t nnz,
                            const double *weights, int64_t s, int64_t e,
                            int64_t width, int64_t n_rows,
                            float *band_out) {
    band_scatter_fused_impl(b1, b2, counts, nnz, weights, s, e, width,
                            n_rows, band_out);
}

// ------------------------------------------------------------------ //
// Greedy neighbour suppression (reference utils/detection.py:348-384):
// process patterns by descending score (ties: lower original index
// first) and kill every other pattern within win_size of a survivor in
// both axes.  Grid-hashed so genome-scale candidate lists stay ~O(n)
// instead of the O(n^2) Python loop.  keep_out[i] = 1 to keep row i.
// ------------------------------------------------------------------ //
void remove_neighbours(const int64_t *bin1, const int64_t *bin2,
                       const double *score, int64_t n, int64_t win_size,
                       uint8_t *keep_out) {
    if (n == 0) return;
    if (win_size <= 0) {
        // strict |d| < win_size can never hold: nothing is suppressed
        // (matches the numpy fallback and the reference's comparison).
        for (int64_t i = 0; i < n; ++i) keep_out[i] = 1;
        return;
    }
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                         bool an = std::isnan(score[a]);
                         bool bn = std::isnan(score[b]);
                         if (an != bn) return bn;  // NaN scores sort last
                         if (an) return a < b;
                         if (score[a] != score[b]) return score[a] > score[b];
                         return a < b;
                     });
    const int64_t w = win_size;
    // Spatial hash: cell edge = win_size, so all neighbours of a pattern
    // live in its 3x3 cell neighbourhood.
    std::unordered_map<uint64_t, std::vector<int64_t>> grid;
    grid.reserve((size_t)n * 2);
    auto key = [&](int64_t c1, int64_t c2) {
        return (uint64_t)(c1 + 1) * 0x100000001b3ULL ^ (uint64_t)(c2 + 1);
    };
    for (int64_t i = 0; i < n; ++i)
        grid[key(bin1[i] / w, bin2[i] / w)].push_back(i);
    std::vector<uint8_t> killed((size_t)n, 0);
    for (int64_t k = 0; k < n; ++k) {
        int64_t i = order[k];
        if (killed[i]) continue;
        int64_t c1 = bin1[i] / w, c2 = bin2[i] / w;
        for (int64_t d1 = -1; d1 <= 1; ++d1) {
            for (int64_t d2 = -1; d2 <= 1; ++d2) {
                auto it = grid.find(key(c1 + d1, c2 + d2));
                if (it == grid.end()) continue;
                for (int64_t j : it->second) {
                    if (j == i) continue;
                    if (std::llabs(bin1[j] - bin1[i]) < w &&
                        std::llabs(bin2[j] - bin2[i]) < w)
                        killed[j] = 1;
                }
            }
        }
    }
    for (int64_t i = 0; i < n; ++i) keep_out[i] = !killed[i];
}

// Count pixels per bin (marginal nnz / sums) for ICE balancing.
// Parallelised with per-thread partial vectors (scatter-adds collide on
// shared bins); ICE calls this hundreds of times per chromosome, so it
// is the hot loop of norm=force on a multicore host.
void marginal_sums(const int64_t *b1, const int64_t *b2, const double *counts,
                   const double *bias, int64_t nnz, int64_t n_bins,
                   double *marg_out) {
    std::memset(marg_out, 0, sizeof(double) * (size_t)n_bins);
#ifdef _OPENMP
    std::vector<double *> parts;
#pragma omp parallel
    {
#pragma omp single
        parts.assign((size_t)omp_get_num_threads(), nullptr);
        std::vector<double> part((size_t)n_bins, 0.0);
        parts[omp_get_thread_num()] = part.data();
#pragma omp for schedule(static) nowait
        for (int64_t k = 0; k < nnz; ++k) {
            double v = counts[k] * bias[b1[k]] * bias[b2[k]];
            part[b1[k]] += v;
            part[b2[k]] += v;
        }
#pragma omp barrier
        merge_partials(parts.data(), (int)parts.size(), n_bins, marg_out);
    }
#else
    for (int64_t k = 0; k < nnz; ++k) {
        double v = counts[k] * bias[b1[k]] * bias[b2[k]];
        marg_out[b1[k]] += v;
        marg_out[b2[k]] += v;
    }
#endif
}

// Compact-dtype variant of marginal_sums: the per-iteration ICE marginal
// is memory-bound on the triplet stream (indices + counts dominate the
// reads), so int32 ids + float counts halve the bytes per pixel.  Counts
// are only routed here when exactly representable in f32 (integer Hi-C
// counts < 2^24), and each product is computed in double, so the result
// is bitwise identical to the i64/f64 path.
void marginal_sums_i32(const int32_t *b1, const int32_t *b2,
                       const float *counts, const double *bias, int64_t nnz,
                       int64_t n_bins, double *marg_out) {
    std::memset(marg_out, 0, sizeof(double) * (size_t)n_bins);
#ifdef _OPENMP
    std::vector<double *> parts;
#pragma omp parallel
    {
#pragma omp single
        parts.assign((size_t)omp_get_num_threads(), nullptr);
        std::vector<double> part((size_t)n_bins, 0.0);
        parts[omp_get_thread_num()] = part.data();
#pragma omp for schedule(static) nowait
        for (int64_t k = 0; k < nnz; ++k) {
            double v = (double)counts[k] * bias[b1[k]] * bias[b2[k]];
            part[b1[k]] += v;
            part[b2[k]] += v;
        }
#pragma omp barrier
        merge_partials(parts.data(), (int)parts.size(), n_bins, marg_out);
    }
#else
    for (int64_t k = 0; k < nnz; ++k) {
        double v = (double)counts[k] * bias[b1[k]] * bias[b2[k]];
        marg_out[b1[k]] += v;
        marg_out[b2[k]] += v;
    }
#endif
}

// ------------------------------------------------------------------ //
// Whole ICE iteration loop with cache-blocked marginals.
//
// The per-iteration marginal over a chromosome's triplets is latency-
// bound on the two random accesses (bias[b2] read + marg[b2] update):
// at 50k bins the working set is ~800 KB, past L2 on most hosts.  This
// routine counting-sorts the triplets ONCE by column block (stable, so
// each bin's accumulation order within a role is preserved) and then
// iterates with both random streams confined to a ~256 KB window, which
// turns the loop stream-bandwidth-bound.  Semantics match
// ops/balance.py::_iterate_block's Python loop: marg = marginal(bias),
// scale = mean of nonzero marginals, bias /= (marg/scale with 0 -> 1),
// stop when the population variance of (nzmarg/scale - 1) < tol.
// (Blocked summation reorders float adds across the row/col roles of a
// bin; weights agree with the unblocked path to ~1e-14 relative, well
// inside the cooler-parity tolerance.)
//
// Returns the number of iterations executed; *scale_out / *var_out get
// the final scale and variance.  bias is updated in place (0 = excluded
// bin; caller applies the NaN/sqrt(scale) rescale).
// ------------------------------------------------------------------ //
static void ice_update_bias(const double *marg, double *bias, int64_t n_bins,
                            double *scale_io, double *var_out,
                            int64_t *nnz_bins_out);

int64_t ice_iterate(const int32_t *b1, const int32_t *b2, const float *ct,
                    int64_t nnz, int64_t n_bins, double *bias,
                    int64_t max_iters, double tol, double *scale_out,
                    double *var_out) {
    const int64_t B = 16384;  // col-block: 2 f64 arrays x 16k = 256 KB
    const int64_t n_blocks = (n_bins + B - 1) / B;

    // One-time stable counting sort by column block (skipped when the
    // whole bias fits one block or the permuted copy cannot be
    // allocated — the unblocked loop is still correct, just slower).
    const int32_t *sb1 = b1, *sb2 = b2;
    const float *sct = ct;
    int32_t *pb1 = nullptr, *pb2 = nullptr;
    float *pct = nullptr;
    std::vector<int64_t> off;
    bool blocked = n_blocks > 1 && nnz > (int64_t)1e6;
    if (blocked) {
        pb1 = (int32_t *)malloc(sizeof(int32_t) * (size_t)nnz);
        pb2 = (int32_t *)malloc(sizeof(int32_t) * (size_t)nnz);
        pct = (float *)malloc(sizeof(float) * (size_t)nnz);
        if (!pb1 || !pb2 || !pct) {
            free(pb1); free(pb2); free(pct);
            pb1 = pb2 = nullptr; pct = nullptr;
            blocked = false;
        }
    }
    if (blocked) {
        off.assign((size_t)n_blocks + 1, 0);
        for (int64_t k = 0; k < nnz; ++k) off[(size_t)(b2[k] / B) + 1]++;
        for (int64_t i = 0; i < n_blocks; ++i) off[(size_t)i + 1] += off[(size_t)i];
        std::vector<int64_t> cur(off.begin(), off.end() - 1);
        for (int64_t k = 0; k < nnz; ++k) {
            int64_t p = cur[(size_t)(b2[k] / B)]++;
            pb1[p] = b1[k];
            pb2[p] = b2[k];
            pct[p] = ct[k];
        }
        sb1 = pb1; sb2 = pb2; sct = pct;
    } else {
        off.assign(2, 0);
        off[1] = nnz;
    }
    const int64_t nb = (int64_t)off.size() - 1;

    std::vector<double> marg((size_t)n_bins);
    double scale = std::numeric_limits<double>::quiet_NaN();
    double var = std::numeric_limits<double>::infinity();
    int64_t it = 0;
    for (; it < max_iters; ++it) {
        std::memset(marg.data(), 0, sizeof(double) * (size_t)n_bins);
#ifdef _OPENMP
        std::vector<double *> parts;
#pragma omp parallel
        {
#pragma omp single
            parts.assign((size_t)omp_get_num_threads(), nullptr);
            std::vector<double> rowpart((size_t)n_bins, 0.0);
            parts[omp_get_thread_num()] = rowpart.data();
            // Column contributions scatter straight into the shared marg
            // (col blocks are disjoint so those writes never collide and
            // land deterministically); row contributions go to the
            // per-thread partial.  The barrier completes every scatter
            // before the deterministic thread-ordered merge reads marg.
#pragma omp for schedule(dynamic, 1)
            for (int64_t blk = 0; blk < nb; ++blk) {
                for (int64_t k = off[(size_t)blk]; k < off[(size_t)blk + 1]; ++k) {
                    double v = (double)sct[k] * bias[sb1[k]] * bias[sb2[k]];
                    rowpart[sb1[k]] += v;
                    marg[sb2[k]] += v;  // col blocks are disjoint
                }
            }
#pragma omp barrier
            merge_partials(parts.data(), (int)parts.size(), n_bins,
                           marg.data());
        }
#else
        for (int64_t blk = 0; blk < nb; ++blk) {
            for (int64_t k = off[(size_t)blk]; k < off[(size_t)blk + 1]; ++k) {
                double v = (double)sct[k] * bias[sb1[k]] * bias[sb2[k]];
                marg[(size_t)sb1[k]] += v;
                marg[(size_t)sb2[k]] += v;
            }
        }
#endif
        // scale = mean of nonzero marginals; bias /= (marg/scale, 0 -> 1);
        // population variance of (nzmarg/scale - 1) with numpy's two-pass
        // mean-then-deviation formula (ice_update_bias, defined below)
        int64_t nnz_bins = 0;
        ice_update_bias(marg.data(), bias, n_bins, &scale, &var, &nnz_bins);
        if (nnz_bins == 0) break;
        if (var < tol) { ++it; break; }
    }
    free(pb1); free(pb2); free(pct);
    *scale_out = scale;
    *var_out = var;
    return it;
}

// ------------------------------------------------------------------ //
// ICE iteration loop over a COMPRESSED pixel stream.
//
// On a slow-memory host the iteration is stream-bandwidth-bound, so the
// bytes per pixel are the wall: the 12 B/pixel triplet stream becomes
// 3 B/pixel — rows come implicitly from a CSR indptr (b1 is never
// stored), the column is a uint16 diagonal offset d = b2 - b1 (cis
// scans stay < 65536 diagonals), and counts are uint8 with an
// (index, i, j, value) exception list for values > 255 (the stored
// byte is 0 there, so the main loop adds nothing and the exception
// pass adds the exact value).  Products accumulate in double; the
// result matches the triplet path to float-add-reordering (~1e-14).
// ------------------------------------------------------------------ //
static void ice_update_bias(const double *marg, double *bias, int64_t n_bins,
                            double *scale_io, double *var_out,
                            int64_t *nnz_bins_out) {
    double sum = 0.0;
    int64_t nnz_bins = 0;
    for (int64_t i = 0; i < n_bins; ++i)
        if (marg[i] != 0.0) { sum += marg[i]; ++nnz_bins; }
    *nnz_bins_out = nnz_bins;
    if (nnz_bins == 0) return;
    double scale = sum / (double)nnz_bins;
    *scale_io = scale;
    for (int64_t i = 0; i < n_bins; ++i) {
        double adj = marg[i] / scale;
        if (adj != 0.0) bias[i] /= adj;
    }
    double m = 0.0;
    for (int64_t i = 0; i < n_bins; ++i)
        if (marg[i] != 0.0) m += marg[i] / scale - 1.0;
    m /= (double)nnz_bins;
    double acc = 0.0;
    for (int64_t i = 0; i < n_bins; ++i)
        if (marg[i] != 0.0) {
            double dd = marg[i] / scale - 1.0 - m;
            acc += dd * dd;
        }
    *var_out = acc / (double)nnz_bins;
}

// One row's marginal contributions: 4 independent accumulators break
// the serial FP-add dependency chain (4-5 cycles per pixel otherwise —
// the measured per-iteration floor on one core).  Within a row the
// column ids are strictly increasing (cool pixels are unique), so the
// four col_out updates per group never alias.
static inline double ice_row_acc(const int64_t *indptr, const uint16_t *dcol,
                                 const uint8_t *ct8, const double *bias,
                                 double *col_out, int64_t i, double bi) {
    const int64_t k1 = indptr[i + 1];
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    int64_t k = indptr[i];
    for (; k + 4 <= k1; k += 4) {
        const int64_t j0 = i + (int64_t)dcol[k];
        const int64_t j1 = i + (int64_t)dcol[k + 1];
        const int64_t j2 = i + (int64_t)dcol[k + 2];
        const int64_t j3 = i + (int64_t)dcol[k + 3];
        const double v0 = (double)ct8[k] * bi * bias[j0];
        const double v1 = (double)ct8[k + 1] * bi * bias[j1];
        const double v2 = (double)ct8[k + 2] * bi * bias[j2];
        const double v3 = (double)ct8[k + 3] * bi * bias[j3];
        col_out[(size_t)j0] += v0;
        col_out[(size_t)j1] += v1;
        col_out[(size_t)j2] += v2;
        col_out[(size_t)j3] += v3;
        a0 += v0;
        a1 += v1;
        a2 += v2;
        a3 += v3;
    }
    for (; k < k1; ++k) {
        const int64_t j = i + (int64_t)dcol[k];
        const double v = (double)ct8[k] * bi * bias[j];
        col_out[(size_t)j] += v;
        a0 += v;
    }
    return (a0 + a1) + (a2 + a3);
}

int64_t ice_iterate_csr(const int64_t *indptr, const uint16_t *dcol,
                        const uint8_t *ct8, const int32_t *exc_i,
                        const int32_t *exc_j, const float *exc_val,
                        int64_t n_exc, int64_t n_bins, double *bias,
                        int64_t max_iters, double tol, double *scale_out,
                        double *var_out) {
    std::vector<double> marg((size_t)n_bins);
    double scale = std::numeric_limits<double>::quiet_NaN();
    double var = std::numeric_limits<double>::infinity();
    int64_t it = 0;
    for (; it < max_iters; ++it) {
        std::memset(marg.data(), 0, sizeof(double) * (size_t)n_bins);
#ifdef _OPENMP
        std::vector<double *> parts;
#pragma omp parallel
        {
#pragma omp single
            parts.assign((size_t)omp_get_num_threads(), nullptr);
            std::vector<double> part((size_t)n_bins, 0.0);
            parts[omp_get_thread_num()] = part.data();
#pragma omp for schedule(static) nowait
            for (int64_t i = 0; i < n_bins; ++i) {
                const double bi = bias[i];
                if (bi == 0.0) {
                    // excluded row still contributes nothing either way,
                    // but its pixels' column updates are also zero
                    continue;
                }
                part[(size_t)i] += ice_row_acc(indptr, dcol, ct8, bias,
                                               part.data(), i, bi);
            }
#pragma omp barrier
            merge_partials(parts.data(), (int)parts.size(), n_bins,
                           marg.data());
        }
#else
        for (int64_t i = 0; i < n_bins; ++i) {
            const double bi = bias[i];
            if (bi == 0.0) continue;
            marg[(size_t)i] += ice_row_acc(indptr, dcol, ct8, bias,
                                           marg.data(), i, bi);
        }
#endif
        for (int64_t e = 0; e < n_exc; ++e) {
            const double v =
                (double)exc_val[e] * bias[exc_i[e]] * bias[exc_j[e]];
            marg[(size_t)exc_i[e]] += v;
            marg[(size_t)exc_j[e]] += v;
        }
        int64_t nnz_bins = 0;
        ice_update_bias(marg.data(), bias, n_bins, &scale, &var, &nnz_bins);
        if (nnz_bins == 0) break;
        if (var < tol) { ++it; break; }
    }
    *scale_out = scale;
    *var_out = var;
    return it;
}

}  // extern "C"

// ------------------------------------------------------------------ //
// One-pass ICE preparation for a cis block (ops/balance.py): streams
// the chromosome's raw pixel-table slice ONCE — in its STORED dtypes,
// bin1 implied by the cool CSR index — and emits everything the
// balancing loop needs: the 3 B/pixel compressed stream ice_iterate_csr
// consumes (local row indptr + uint16 diagonal offsets + uint8 counts
// with a (local i, local j, f32 value) exception list), plus the nnz
// and raw-marginal vectors the min_nnz / MAD-max filters are built
// from.  Replaces ~15 whole-table numpy sweeps (casts, masks, filtered
// gathers, bincounts, integrality checks) with one native pass.
//
// Returns the kept pixel count m >= 0, or:
//   -1  a kept count is negative or not exactly float32-representable
//       (the compressed stream would round it) — caller falls back;
//   -2  a diagonal offset >= 65536 (block taller than the u16 stream
//       supports) — caller falls back;
//   -3  the exception list overflowed exc_cap — caller retries with
//       n_exc_out's value as the capacity (arrays are already in RAM).
template <typename CT, typename B2>
static int64_t ice_prep_csr_impl(
    const int64_t *indptr, const B2 *b2, const CT *ct, int64_t n,
    int64_t s, int64_t e, int64_t ignore_diags, int64_t *indptr_out,
    uint16_t *d16, uint8_t *ct8, int32_t *exc_i, int32_t *exc_j,
    float *exc_val, int64_t exc_cap, int64_t *nnz, double *marg,
    int64_t *n_exc_out) {
    for (int64_t i = 0; i < n; ++i) nnz[i] = 0;
    for (int64_t i = 0; i < n; ++i) marg[i] = 0.0;
    const int64_t base = indptr[0];
    int64_t m = 0, n_exc = 0, bad = 0, tall = 0;
    indptr_out[0] = 0;
    for (int64_t r = 0; r < n; ++r) {
        for (int64_t k = indptr[r] - base; k < indptr[r + 1] - base; ++k) {
            const int64_t j = (int64_t)b2[k];
            if (j >= e) break;  // within-row b2 is ascending; rest is trans
            const int64_t d = j - (s + r);
            if (d < ignore_diags) continue;
            const double c = (double)ct[k];
            if (c < 0.0 || c != (double)(float)c) {
                bad = 1;
                continue;
            }
            if (d >= 65536) {
                tall = 1;
                continue;
            }
            const int64_t jl = j - s;
            nnz[r] += 1;
            nnz[jl] += 1;
            marg[r] += c;
            marg[jl] += c;
            const int64_t ci = (int64_t)c;
            if (c == (double)ci && ci <= 255) {
                d16[m] = (uint16_t)d;
                ct8[m] = (uint8_t)ci;
                ++m;
            } else {
                // large / fractional-but-f32-exact counts ride the
                // exception list and are omitted from the inline stream
                // (indptr_out tracks kept inline pixels only)
                if (n_exc < exc_cap) {
                    exc_i[n_exc] = (int32_t)r;
                    exc_j[n_exc] = (int32_t)jl;
                    exc_val[n_exc] = (float)c;
                }
                ++n_exc;
            }
        }
        indptr_out[r + 1] = m;
    }
    *n_exc_out = n_exc;
    if (bad) return -1;
    if (tall) return -2;
    if (n_exc > exc_cap) return -3;
    return m;
}

extern "C" {

#define CHROMO_EXPORT_ICE_PREP(CTSUF, CT, B2SUF, B2T)                      \
    int64_t ice_prep_csr_##CTSUF##B2SUF(                                   \
        const int64_t *indptr, const B2T *b2, const CT *ct, int64_t n,     \
        int64_t s, int64_t e, int64_t ignore_diags, int64_t *indptr_out,   \
        uint16_t *d16, uint8_t *ct8, int32_t *exc_i, int32_t *exc_j,       \
        float *exc_val, int64_t exc_cap, int64_t *nnz, double *marg,       \
        int64_t *n_exc_out) {                                              \
        return ice_prep_csr_impl(indptr, b2, ct, n, s, e, ignore_diags,    \
                                 indptr_out, d16, ct8, exc_i, exc_j,       \
                                 exc_val, exc_cap, nnz, marg, n_exc_out);  \
    }

CHROMO_EXPORT_ICE_PREP(i32, int32_t, , int64_t)
CHROMO_EXPORT_ICE_PREP(i64, int64_t, , int64_t)
CHROMO_EXPORT_ICE_PREP(f64, double, , int64_t)
CHROMO_EXPORT_ICE_PREP(i32, int32_t, _b2i32, int32_t)
CHROMO_EXPORT_ICE_PREP(i64, int64_t, _b2i32, int32_t)
CHROMO_EXPORT_ICE_PREP(f64, double, _b2i32, int32_t)
#undef CHROMO_EXPORT_ICE_PREP

}  // extern "C"

// ------------------------------------------------------------------ //
// Stored-dtype trans (inter) rectangle fetch.
//
// For a trans chromosome pair (row range strictly below the column
// range) the stored upper triangle holds the ENTIRE rectangle, so the
// mirror query the generic pixels_coo path issues is provably empty —
// and its full-slab read of the column chromosome's pixel rows is pure
// waste.  This path reads only the row slab, in the file's stored
// dtypes (no int64/f64 cast sweeps), and exploits the cooler sort
// invariant (pixels ordered by (bin1_id, bin2_id) — the same invariant
// the bin1_offset CSR index relies on) to locate each row's kept
// column range with two binary searches instead of a per-pixel filter.
// Pass 1 emits per-row offsets (prefix-summed) + slice starts; pass 2
// fills exact-sized (rows, cols, vals) triplets, applying the ICE
// balancing product in the same sweep (double accumulate, f32 store —
// NaN weights propagate).  Replaces reference contacts_map.py:529's
// cooler fetch on the --inter path.
// ------------------------------------------------------------------ //
template <typename B2>
static int64_t trans_range_offsets_impl(const int64_t *indptr, const B2 *b2,
                                        int64_t n_rows, int64_t s2,
                                        int64_t e2, int64_t *offsets,
                                        int64_t *klo) {
    const int64_t base = indptr[0];
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t r = 0; r < n_rows; ++r) {
        const B2 *lo_p = b2 + (indptr[r] - base);
        const B2 *hi_p = b2 + (indptr[r + 1] - base);
        const B2 *a = std::lower_bound(lo_p, hi_p, (B2)s2);
        const B2 *bN = std::lower_bound(a, hi_p, (B2)e2);
        klo[r] = a - b2;
        offsets[r + 1] = bN - a;
    }
    offsets[0] = 0;
    for (int64_t r = 0; r < n_rows; ++r) offsets[r + 1] += offsets[r];
    return offsets[n_rows];
}

template <typename CT, typename B2>
static void trans_fill_balance_impl(const B2 *b2, const CT *ct,
                                    const int64_t *offsets,
                                    const int64_t *klo, int64_t n_rows,
                                    int64_t s2, const double *w1,
                                    const double *w2, int32_t *rows_out,
                                    int32_t *cols_out, float *vals_out) {
#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t o = offsets[r];
        const int64_t cnt = offsets[r + 1] - o;
        const int64_t k0 = klo[r];
        if (w1 != nullptr) {
            const double wr = w1[r];
            for (int64_t t = 0; t < cnt; ++t) {
                const int64_t j = (int64_t)b2[k0 + t] - s2;
                rows_out[o + t] = (int32_t)r;
                cols_out[o + t] = (int32_t)j;
                vals_out[o + t] = (float)((double)ct[k0 + t] * wr * w2[j]);
            }
        } else {
            for (int64_t t = 0; t < cnt; ++t) {
                rows_out[o + t] = (int32_t)r;
                cols_out[o + t] = (int32_t)((int64_t)b2[k0 + t] - s2);
                vals_out[o + t] = (float)ct[k0 + t];
            }
        }
    }
}

extern "C" {

int64_t trans_range_offsets(const int64_t *indptr, const int64_t *b2,
                            int64_t n_rows, int64_t s2, int64_t e2,
                            int64_t *offsets, int64_t *klo) {
    return trans_range_offsets_impl(indptr, b2, n_rows, s2, e2, offsets,
                                    klo);
}

int64_t trans_range_offsets_b2i32(const int64_t *indptr, const int32_t *b2,
                                  int64_t n_rows, int64_t s2, int64_t e2,
                                  int64_t *offsets, int64_t *klo) {
    return trans_range_offsets_impl(indptr, b2, n_rows, s2, e2, offsets,
                                    klo);
}

#define CHROMO_EXPORT_TRANS_FILL(CTSUF, CT, B2SUF, B2T)                    \
    void trans_fill_##CTSUF##B2SUF(                                       \
        const B2T *b2, const CT *ct, const int64_t *offsets,              \
        const int64_t *klo, int64_t n_rows, int64_t s2, const double *w1, \
        const double *w2, int32_t *rows_out, int32_t *cols_out,           \
        float *vals_out) {                                                \
        trans_fill_balance_impl(b2, ct, offsets, klo, n_rows, s2, w1, w2, \
                                rows_out, cols_out, vals_out);            \
    }

CHROMO_EXPORT_TRANS_FILL(i32, int32_t, , int64_t)
CHROMO_EXPORT_TRANS_FILL(i64, int64_t, , int64_t)
CHROMO_EXPORT_TRANS_FILL(f32, float, , int64_t)
CHROMO_EXPORT_TRANS_FILL(f64, double, , int64_t)
CHROMO_EXPORT_TRANS_FILL(i32, int32_t, _b2i32, int32_t)
CHROMO_EXPORT_TRANS_FILL(i64, int64_t, _b2i32, int32_t)
CHROMO_EXPORT_TRANS_FILL(f32, float, _b2i32, int32_t)
CHROMO_EXPORT_TRANS_FILL(f64, double, _b2i32, int32_t)
#undef CHROMO_EXPORT_TRANS_FILL

}  // extern "C"
