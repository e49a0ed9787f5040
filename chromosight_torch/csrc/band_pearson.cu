// Fused band Pearson for Hopper (sm_90a).
//
// Replaces chromosight_tpu/ops/pallas_band.py::_fused_kernel (:31-179,
// launched by band_normxcorr_pallas through pl.pallas_call at :299)
// together with its XLA epilogue: for every output pixel (i, d) of a
// chromosome's band it computes the missing-corrected Pearson correlation
// with an (mk, nk) kernel, its two-sided log10 p-value, the diagonal trim
// and the candidate mask, in one pass, for K <= 8 same-shape kernels.
//
// Inputs are the framed, padded signal and missing-mask bands
// (chromosight_torch.ops.band.band_frame): (n_pad + 2(mk-1), w_in) f32,
// w_in = w_out + mk + nk - 2.  Output pixel (i, d) reads
//     x = sig[i + kh + u][d + mk-1-u + v],  m = mask[i + kh + u][d + mk-1-u + v]
// for the taps (u, v) of the sheared kernel.  Per kernel it forms three tap
// sums, sum (K/ksize) x, sum K m and sum K^2 m, each in (u, v) order with
// the float64 taps of the float64 kernel and fma; the three
// window sums (x, x^2, m) are separable: anti-diagonal sums
// A[i][c] = sum_u x[i+kh+u][c+mk-1-u] in u order, then sum_v A[i][d+v] in
// v order (the mask sums are integer counts).  All six sums run in
// float64: on detrended maps the Pearson numerator cancels most of them,
// and float32 sums leave ~5e-5 of error in corr.  Each is snapped to 0
// below `threshold` on its float32 rounding (window sums after the
// 1/ksize scaling), as the JAX package decides it, and a surviving sum
// enters the algebra unrounded: the float64 epilogue runs the Pearson
// algebra of chromosight_tpu/ops/band.py:618-634 with the float64 (ksum,
// k2sum) of the float64 kernel, and the p-value
//     log10p = (log(0.5 erfcx(a/sqrt2)) - a^2/2 + log 2) / log 10,
//     a = |atanh(corr) sqrt(n_pres - 3)|,
// which is log_ndtr(-a) + log 2 without underflow, in double; corr and
// log10p are rounded to float32 once, at the end (a float32 numerator
// cancels to 0 below one ulp on windows whose score is ~1e-6).  The
// p-value comes from the untrimmed corr; the trim keeps d <= max_dist,
// i < n, i + d < n, and the candidate test reads the float32 corr.
// ops/band_pearson.py:band_pearson_emulated transcribes this arithmetic.
//
// Bound.  The work the inputs need per output pixel: K mk nk float64 FMAs
// for the x taps, 2K mk nk for the mask taps, and 3(mk + nk) adds for the
// separable window sums; it reads 8 bytes of input and writes 9K.  Only
// taps over a non-zero x or a set mask bit change a sum, and missing bins
// are few (1.8% of chr1's bins in chip_smoke.py's genome), so chip_smoke.py
// counts the FMAs over these inputs' non-zero operands and takes them at
// the card's float64 tensor-core rate (132 SMs x 128 FMA per clock x
// 1.98 GHz, the data sheet's 67 TFLOP/s): a lower bound, as this kernel
// does its FMAs on the CUDA cores (64 per clock), and all the x taps.
// The first version of this kernel (one thread per pixel) spent its time
// elsewhere: each tap converted 2 + 3K float32 values to float64 (16
// conversions per clock per SM against 64 FMAs), issued 2 + 3K loads,
// summed the windows over all mk nk taps, and left 13 of 32 lanes idle on
// the 19-diagonal band.  This design:
//
// 1. A block owns 32 output rows (one per lane) x d diagonals: one strip
//    of W diagonals per warp, up to 8 warps, no more strips than
//    the band has.  W is 7, or 5 on a band narrower than one block of
//    7-wide strips (borders' 19 diagonals: 20 computed, four warps per
//    block).  The block stages its tile with the mk-1 row and mk+nk-2
//    column halo in shared memory once: asynchronous copies of the
//    float32 inputs, then x converted to float64 (once per value) and
//    the mask packed to bits.
// 2. Taps are float64 in the __constant__ bank (one copy per launch from
//    the device table); the DFMAs take them through uniform registers,
//    and each tap row's mask bits come out of one 64-bit shift: the
//    inner loop does no conversion and no per-lane tap load.  Each staged
//    x feeds up to 3W FMAs (W accumulators per tap plane); lanes read
//    rows an odd pitch apart, free of bank conflicts.  The row loop is
//    not unrolled, so the code stays small.  A tap row under which no
//    lane of the warp has a set mask bit skips the two mask planes
//    (__any_sync; a zero product leaves a float64 sum as it is), so the
//    mask planes, two thirds of the dense FMAs, run mostly where bins are
//    missing.
// 3. The window sums are separable: the A planes (anti-diagonal sums of
//    the 32 output rows) once per block, then nk adds per output.
// 4. K kernels run one after the other over the staged tile, each with
//    the K = 1 loop and registers (at most 128 per thread, no spills),
//    and its output plane leaves through shared memory, written
//    coalesced.  The float64 epilogue is two outlined calls per pixel
//    (pixel_stats, pearson), which keeps the unrolled strip small: fewer
//    registers and instructions than W inlined copies.
// Compile-time instances: square 7, 15, 17 and 31, each with W = 7 and 5
// (K per launch limited so the table fits the 64 KB constant bank: 8, or
// 2 for 31x31).  Every other shape (centromeres' 81x81, rectangular
// kernels) takes the runtime-shape instance of the same kernel (NK = 0,
// W = 7 and 5): the same tile, loops and order, with the sides read from
// the arguments, taps through the read-only cache (81x81's 157 KB table
// fits neither the constant bank nor shared memory beside its tile), the
// tile loaded and converted in one pass (its float32 copy would not fit
// beside the float64 one), and fewer warps where the tile needs it (three
// 7-wide strips at 81x81, 227,712 bytes).  Per-kernel sums take their
// taps in the same (u, v) order in every instance and for every K, so
// slice k of a K-kernel launch equals a single-kernel launch bit for bit.
// Float64 tensor cores (DMMA) are not used: at most 3K output planes, and
// a banded Toeplitz GEMM would be mostly zeros.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py
// (kernel-only, torch.profiler), with the float32 epilogue: 1.453 ms for
// loops and 3.758 ms for borders on 48,000 x 418, 0.298 ms on borders'
// 19 diagonals, from 9.34, 19.69 and 1.42 ms for the first version;
// 16.0%, 15.4% and 8.6% of the bound above.  Without the mask-row skip
// this design took 2.107, 5.789 and 0.372 ms.  The float64 epilogue
// costs ~0.36 ms per 2e7 pixels and kernel (compare_kernels.py, parent
// and this design in turns on one card): 1.463 -> 1.823, 3.787 -> 4.736
// and 0.298 -> 0.403 ms.  What keeps it from the bound: the CUDA cores'
// half rate, every x tap (93.5% of them are non-zero on chr1), the mask
// planes of every row near a missing bin, and a block life outside the
// tap loop (staging, A planes, the float64 epilogue, the output plane)
// that the tap loop's float64 pipe sits out; the narrow band also stages
// 48 rows for 32.
//
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a), float64 epilogue: 128 registers
// for 17x17 W = 7 (124 at W = 5), 106-128 over the other instances, a
// 160-byte stack frame (the outlined calls' frames), 0 bytes of spill
// stores and loads in every instance.
//
// Launch contract: the caller allocates the outputs, the kernel runs on
// the given stream without synchronising, and the C entry returns
// cudaGetLastError() (or cudaErrorInvalidValue for K outside the
// instance's range) so a refused launch is reported.  The constant bank
// holds one tap table per device, so the compile-time instances' launches
// on a device are ordered whatever their streams: each copies its table
// (asynchronously, on its stream) only after the previous such launch has
// ended, through an event, under a host lock.  Each instance's dynamic
// shared memory is allowed once per device, not at every launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int ROWS = 32;            // output rows per block: one per lane
constexpr int COL_WARPS = 8;        // most warps per block along the diagonals
constexpr int TAP_CAPACITY = 7168;  // float64 taps in the constant bank
constexpr int MAX_K = 8;
constexpr int MAX_DEVICES = 64;

__constant__ double c_taps[TAP_CAPACITY];  // (K, 3, mk, nk) of one launch

struct Args {
  const float* sig;
  const float* mask;
  const double* taps;  // (K, 3, mk, nk) float64 on the card
  const double* sums;  // (K, 2): ksum, k2sum
  int n_k, n_pad, w_out, w_in, mk, nk, n, max_dist;
  float min_pres, threshold, pearson_min;
  float* corr;
  float* logp;
  uint8_t* cand;
};

// Diagonals per thread: WIDE_W, or NARROW_W on a band narrower than one
// block of wide strips, where the narrower strips give each block more
// warps (and pad 19 diagonals to 20, not 21).
constexpr int WIDE_W = 7;
constexpr int NARROW_W = 5;

__host__ __device__ constexpr int strip_width(int w_out) {
  return w_out < WIDE_W * COL_WARPS ? NARROW_W : WIDE_W;
}

__host__ __device__ inline int odd_at_least(int x) { return x | 1; }

// Shared-memory layout of a block: the x tile (float64) of rows x px, the
// mask tile as bits (32 columns per word, pmw words per row, two words of
// zero padding), the anti-diagonal sums of the 32 output rows, A_x and
// A_x2 (float64) and A_m (bytes), over dc columns, and one output plane
// (corr, log10 p, candidates) of 32 x d.  In the compile-time instances
// (`staged`) the float32 input tiles land first where the A planes go
// (asynchronous copies), and are converted from there.  Pitches are odd
// in 4-byte words, so lanes on consecutive rows hit distinct banks.
struct Tile {
  int rows, d, dc, px, pmw, pa, pam, op;
  bool staged;
  __host__ __device__ Tile(int mk, int nk, int w, int warps, bool staged_)
      : staged(staged_) {
    rows = ROWS + mk - 1;
    d = w * warps;
    dc = d + nk - 1;
    px = odd_at_least(d + mk + nk - 2);
    pmw = odd_at_least((px + 31) / 32 + 2);
    pa = odd_at_least(dc);
    pam = 4 * odd_at_least((dc + 3) / 4);
    op = d + 1;
  }
  __host__ __device__ size_t diag_bytes() const {
    const size_t planes = (size_t)ROWS * (2 * (size_t)pa * 8 + (size_t)pam);
    const size_t raw = staged ? 2 * (size_t)rows * (size_t)px * 4 : 0;
    return planes > raw ? planes : raw;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)rows * px * 8 + diag_bytes() + (size_t)rows * pmw * 4 +
           (size_t)ROWS * op * 9;
  }
};

// `x` unrounded, or 0 where its float32 rounding `xr` is below the
// threshold: the JAX package's snap decision, the sum itself kept.
__device__ __forceinline__ double snap(double x, float xr, float threshold) {
  return fabsf(xr) < threshold ? 0.0 : x;
}

__device__ __forceinline__ double snap(double x, float threshold) {
  return snap(x, (float)x, threshold);
}

// Shared epilogue state of one pixel: what the K kernels have in common.
struct PixelStats {
  double n_pres, corr_f, sig_mean, sig_var, sqrt_dof;
  bool low;
};

__device__ __noinline__ PixelStats pixel_stats(double s_x, double s_x2,
                                                  double s_m,
                                                  const Args& a) {
  PixelStats p;
  const int ksize = a.mk * a.nk;
  const float inv_ksize = 1.0f / (float)ksize;
  const double sig_mean0 =
      snap(s_x / ksize, (float)s_x * inv_ksize, a.threshold);
  const double sig2_mean0 =
      snap(s_x2 / ksize, (float)s_x2 * inv_ksize, a.threshold);
  const double n_miss = snap(s_m, a.threshold);
  p.n_pres = ksize - n_miss;
  p.corr_f = ksize / p.n_pres;
  p.sig_mean = sig_mean0 * p.corr_f;
  const double sig2_mean = sig2_mean0 * p.corr_f;
  p.sig_var = sig2_mean - p.sig_mean * p.sig_mean;
  p.sqrt_dof = sqrt(p.n_pres - 3.);
  p.low = p.n_pres < a.min_pres;
  return p;
}

// corr (untrimmed) and log10 p of kernel k from its three tap sums, in
// double, each rounded to float32 once.
__device__ __noinline__ void pearson(const PixelStats& p, double s_k,
                                        double s_mk, double s_mk2, int k,
                                        const Args& a, float* corr,
                                        float* logp) {
  const double conv_sk = snap(s_k, a.threshold);
  const double conv_mk = snap(s_mk, a.threshold);
  const double conv_mk2 = snap(s_mk2, a.threshold);
  const double kmean_eff = (__ldg(a.sums + 2 * k) - conv_mk) / p.n_pres;
  const double k2mean_eff = (__ldg(a.sums + 2 * k + 1) - conv_mk2) / p.n_pres;
  double denom = sqrt(p.sig_var * (k2mean_eff - kmean_eff * kmean_eff));
  if (p.low) denom = 0.;
  const double num = (conv_sk - p.sig_mean * kmean_eff / p.corr_f) * p.corr_f;
  const double inv_denom = fabs(denom) < 1e-10 ? 0. : 1. / denom;
  double out = num * inv_denom;
  if (!isfinite(out)) out = 0.;
  out = fmin(fmax(out, -1.), 1.);
  const double z = fabs(atanh(out) * p.sqrt_dof);
  const double log_tail =
      log(0.5 * erfcx(z * 0.70710678118654752)) - 0.5 * z * z;
  *logp = (float)((log_tail + log(2.)) / log(10.));
  *corr = (float)out;
}

__device__ __forceinline__ bool kept(int i, int d, const Args& a) {
  return d <= a.max_dist && i < a.n && i + d < a.n;
}

// Tap i of the launch's (K, 3, mk, nk) table: from the constant bank in
// the compile-time instances, through the read-only cache in the
// runtime-shape instance (NK == 0).
template <int NK>
__device__ __forceinline__ double tap(const Args& a, int i) {
  if constexpr (NK != 0) {
    return c_taps[i];
  } else {
    return __ldg(a.taps + i);
  }
}

struct Smem {
  double* xs;       // rows x px
  double* ax;       // ROWS x pa
  double* ax2;      // ROWS x pa
  uint8_t* am;      // ROWS x pam
  float* raw;       // 2 x rows x px float32 inputs, aliasing ax..am
  uint32_t* mw;     // rows x pmw mask bits
  float* corr;      // ROWS x op
  float* logp;      // ROWS x op
  uint8_t* cand;    // ROWS x op
};

__device__ __forceinline__ Smem carve(double* smem, const Tile& t) {
  Smem m;
  m.xs = smem;
  m.ax = m.xs + t.rows * t.px;
  m.ax2 = m.ax + ROWS * t.pa;
  m.am = reinterpret_cast<uint8_t*>(m.ax2 + ROWS * t.pa);
  m.raw = reinterpret_cast<float*>(m.ax);
  m.mw = reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(m.ax) +
                                     t.diag_bytes());
  m.corr = reinterpret_cast<float*>(m.mw + t.rows * t.pmw);
  m.logp = m.corr + ROWS * t.op;
  m.cand = reinterpret_cast<uint8_t*>(m.logp + ROWS * t.op);
  return m;
}

// Phase 1: the block's x (float32 -> float64) and mask (bits) tile, zero
// outside the inputs.  Compile-time instances request every float32 value
// at once with an asynchronous copy (zero-filled outside), then convert in
// shared memory; the runtime-shape instance loads and converts in one
// pass.  Warps take rows, lanes columns; for the bits, lanes take rows.
template <int NK>
__device__ __forceinline__ void stage_tile(const Args& a, const Tile& t,
                                           int mk, int i0, int d0, int lane,
                                           int g, int warps, const Smem& sm) {
  const int kh = (mk - 1) / 2;
  const int rows_in = a.n_pad + 2 * (mk - 1);
  const int nthreads = ROWS * warps;
  if constexpr (NK != 0) {
    const int plane = t.rows * t.px;
    for (int rr = g; rr < t.rows; rr += warps) {
      const int gr = i0 + kh + rr;
      const bool row_in = gr < rows_in;
      const size_t base = (size_t)gr * (size_t)a.w_in + (size_t)d0;
      for (int cc = lane; cc < t.px; cc += ROWS) {
        const bool in = row_in && d0 + cc < a.w_in;
        const size_t off = in ? base + cc : 0;
        __pipeline_memcpy_async(sm.raw + rr * t.px + cc, a.sig + off, 4,
                                in ? 0 : 4);
        __pipeline_memcpy_async(sm.raw + plane + rr * t.px + cc,
                                a.mask + off, 4, in ? 0 : 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int rr = g; rr < t.rows; rr += warps)
      for (int cc = lane; cc < t.px; cc += ROWS)
        sm.xs[rr * t.px + cc] = (double)sm.raw[rr * t.px + cc];
    for (int it = g * ROWS + lane; it < t.rows * t.pmw; it += nthreads) {
      const int rr = it % t.rows;
      const int c0 = (it / t.rows) * 32;
      const float* mrow = sm.raw + plane + rr * t.px;
      uint32_t word = 0;
      for (int b = 0; b < 32 && c0 + b < t.px; ++b)
        word |= (uint32_t)(mrow[c0 + b] != 0.f) << b;
      sm.mw[rr * t.pmw + it / t.rows] = word;
    }
  } else {
    for (int rr = g; rr < t.rows; rr += warps) {
      const int gr = i0 + kh + rr;
      const float* row = a.sig + (size_t)gr * (size_t)a.w_in + d0;
      for (int cc = lane; cc < t.px; cc += ROWS)
        sm.xs[rr * t.px + cc] =
            gr < rows_in && d0 + cc < a.w_in ? (double)__ldg(row + cc) : 0.;
    }
    for (int it = g * ROWS + lane; it < t.rows * t.pmw; it += nthreads) {
      const int rr = it % t.rows;
      const int c0 = (it / t.rows) * 32;
      const int gr = i0 + kh + rr;
      uint32_t word = 0;
      if (gr < rows_in) {
        const float* mrow = a.mask + (size_t)gr * (size_t)a.w_in + d0;
        for (int b = 0; b < 32 && c0 + b < t.px && d0 + c0 + b < a.w_in; ++b)
          word |= (uint32_t)(__ldg(mrow + c0 + b) != 0.f) << b;
      }
      sm.mw[rr * t.pmw + it / t.rows] = word;
    }
  }
}

// Bit c of mask row r.
__device__ __forceinline__ int mask_bit(const Tile& t, const Smem& sm, int r,
                                        int c) {
  return (sm.mw[r * t.pmw + (c >> 5)] >> (c & 31)) & 1;
}

// Bits c0 .. c0 + 63 of mask row r (the row holds two words of padding).
__device__ __forceinline__ uint64_t mask_bits(const Tile& t, const Smem& sm,
                                              int r, int c0) {
  const uint32_t* w = sm.mw + r * t.pmw + (c0 >> 5);
  const int s = c0 & 31;
  const uint64_t lo = (uint64_t)w[0] | ((uint64_t)w[1] << 32);
  return s ? (lo >> s) | ((uint64_t)w[2] << (64 - s)) : lo;
}

// Phase 2: anti-diagonal sums of the 32 output rows,
//   A[i][c] = sum_u x[i + u][c + mk-1-u]  (u in order; also x^2 and m),
// for c in [0, dc).  Lanes take rows, warps columns.
__device__ __forceinline__ void diag_sums(const Tile& t, int mk, int lane,
                                          int g, int warps, const Smem& sm) {
#pragma unroll 2
  for (int c = g; c < t.dc; c += warps) {
    const double* xp = sm.xs + lane * t.px + c + mk - 1;
    double s = 0., s2 = 0.;
    int n_m = 0;
#pragma unroll
    for (int u = 0; u < mk; ++u) {
      const double x = xp[u * (t.px - 1)];
      if (u == 0) {
        s = x;
        s2 = x * x;
      } else {
        s += x;
        s2 = fma(x, x, s2);
      }
      n_m += mask_bit(t, sm, lane + u, c + mk - 1 - u);
    }
    sm.ax[lane * t.pa + c] = s;
    sm.ax2[lane * t.pa + c] = s2;
    sm.am[lane * t.pam + c] = (uint8_t)n_m;
  }
}

// The window sums of the thread's W diagonals: sum over v of the A planes.
template <int W>
__device__ __forceinline__ void window_sums(const Tile& t, int nk, int lane,
                                            int dl0, const Smem& sm,
                                            double (&sx)[W], double (&sx2)[W],
                                            int (&sm_n)[W]) {
  const double* ar = sm.ax + lane * t.pa + dl0;
  const double* ar2 = sm.ax2 + lane * t.pa + dl0;
  const uint8_t* amr = sm.am + lane * t.pam + dl0;
#pragma unroll
  for (int j = 0; j < W + nk - 1; ++j) {
    const double v1 = ar[j], v2 = ar2[j];
    const int vm = amr[j];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int v = j - w;
      if (v == 0) {
        sx[w] = v1;
        sx2[w] = v2;
        sm_n[w] = vm;
      } else if (v > 0 && v < nk) {
        sx[w] += v1;
        sx2[w] += v2;
        sm_n[w] += vm;
      }
    }
  }
}

// The taps of one row of the kernel for the thread's W diagonals: each
// staged value x_j feeds the W outputs it lies under, and with MASK the
// two mask planes too (bit(j): the mask bit under x_j).
template <int NK, int W, bool MASK, class Bit>
__device__ __forceinline__ void row_taps(const Args& a, const double* xr,
                                         Bit bit, int nk, int base, int taps,
                                         double (&sk)[W], double (&smk)[W],
                                         double (&smk2)[W]) {
#pragma unroll
  for (int j = 0; j < W + nk - 1; ++j) {
    const double x = xr[j];
    const double m = MASK && bit(j) ? 1. : 0.;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int v = j - w;
      if (v >= 0 && v < nk) {
        sk[w] = fma(tap<NK>(a, base + v), x, sk[w]);
        if constexpr (MASK) {
          smk[w] = fma(tap<NK>(a, base + taps + v), m, smk[w]);
          smk2[w] = fma(tap<NK>(a, base + 2 * taps + v), m, smk2[w]);
        }
      }
    }
  }
}

// The three tap sums of kernel k for the thread's W diagonals, in (u, v)
// order per output (3 W FMAs per two loads).  In the compile-time
// instances a row with no set mask bit under any lane of the warp skips
// the mask planes: a zero product leaves a float64 sum as it is, so the
// sums do not change, and missing bins are few.
template <int NK, int W>
__device__ __forceinline__ void tap_sums(const Args& a, const Tile& t, int mk,
                                         int nk, int lane, int dl0,
                                         const Smem& sm, int k, double (&sk)[W],
                                         double (&smk)[W], double (&smk2)[W]) {
  static_assert(NK == 0 || W + NK - 1 <= 64,
                "a tap row's mask bits fill one word");
  const int taps = mk * nk;
#pragma unroll
  for (int w = 0; w < W; ++w) sk[w] = smk[w] = smk2[w] = 0.;
#pragma unroll 1
  for (int u = 0; u < mk; ++u) {
    const int r = lane + u, c0 = dl0 + mk - 1 - u;
    const double* xr = sm.xs + r * t.px + c0;
    const int base = k * 3 * taps + u * nk;
    if constexpr (NK != 0) {
      const uint64_t mbits = mask_bits(t, sm, r, c0);
      const auto bit = [mbits](int j) { return (mbits >> j) & 1; };
      if (__any_sync(0xffffffffu, mbits != 0))
        row_taps<NK, W, true>(a, xr, bit, nk, base, taps, sk, smk, smk2);
      else
        row_taps<NK, W, false>(a, xr, bit, nk, base, taps, sk, smk, smk2);
    } else {
      const auto bit = [&](int j) { return mask_bit(t, sm, r, c0 + j); };
      row_taps<NK, W, true>(a, xr, bit, nk, base, taps, sk, smk, smk2);
    }
  }
}

// One block: 32 output rows x d diagonals, for the K kernels in turn
// over the same staged tile; each kernel's plane leaves through shared
// memory, written coalesced.  NK x NK kernels, or any shape for NK = 0.
template <int NK, int W>
__global__ void __launch_bounds__(256) band_pearson_tiled(Args a) {
  extern __shared__ double smem[];
  const int mk = NK ? NK : a.mk, nk = NK ? NK : a.nk;
  const int warps = blockDim.y;
  const Tile t(mk, nk, W, warps, NK != 0);
  const int lane = threadIdx.x, g = threadIdx.y;
  const int tid = g * ROWS + lane, nthreads = ROWS * warps;
  const int i0 = blockIdx.x * ROWS;
  const int d0 = blockIdx.y * t.d;
  const int dl0 = g * W;
  const bool busy = d0 + dl0 < a.w_out;
  const Smem sm = carve(smem, t);
  const size_t plane = (size_t)a.n_pad * (size_t)a.w_out;

  stage_tile<NK>(a, t, mk, i0, d0, lane, g, warps, sm);
  __syncthreads();
  diag_sums(t, mk, lane, g, warps, sm);
  __syncthreads();
  for (int k = 0; k < a.n_k; ++k) {
    if (busy) {
      double sk[W], smk[W], smk2[W], sx[W], sx2[W];
      int sm_n[W];
      tap_sums<NK, W>(a, t, mk, nk, lane, dl0, sm, k, sk, smk, smk2);
      window_sums<W>(t, nk, lane, dl0, sm, sx, sx2, sm_n);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const PixelStats p = pixel_stats(sx[w], sx2[w], (double)sm_n[w], a);
        float c, l;
        pearson(p, sk[w], smk[w], smk2[w], k, a, &c, &l);
        const int o = lane * t.op + dl0 + w;
        c = kept(i0 + lane, d0 + dl0 + w, a) ? c : 0.f;
        sm.corr[o] = c;
        sm.logp[o] = l;
        sm.cand[o] = (c >= a.pearson_min && c != 0.f) ? 1 : 0;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < ROWS * t.d; idx += nthreads) {
      const int r = idx / t.d;
      const int c = idx - r * t.d;
      const int i = i0 + r;
      const int d = d0 + c;
      if (i < a.n_pad && d < a.w_out) {
        const size_t o = k * plane + (size_t)i * (size_t)a.w_out + (size_t)d;
        const int so = r * t.op + c;
        a.corr[o] = sm.corr[so];
        a.logp[o] = sm.logp[so];
        a.cand[o] = sm.cand[so];
      }
    }
    __syncthreads();
  }
}

// ---- launch ----

bool compiled_shape(int mk, int nk) {
  return mk == nk && (nk == 7 || nk == 15 || nk == 17 || nk == 31);
}

int max_kernels(int mk, int nk) {
  if (!compiled_shape(mk, nk)) return MAX_K;
  const int fit = TAP_CAPACITY / (3 * mk * nk);
  return fit < MAX_K ? fit : MAX_K;
}

std::mutex launch_lock;  // held by every launch and by the reports

// Opt-in dynamic shared memory per block of the current device (read once
// per device; 0 where it cannot be read), and the device in *dev.
size_t smem_limit(int* dev) {
  static int optin[MAX_DEVICES];
  if (cudaGetDevice(dev) != cudaSuccess || *dev < 0 || *dev >= MAX_DEVICES)
    return 0;
  int& bytes = optin[*dev];
  if (bytes == 0 &&
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             *dev) != cudaSuccess)
    bytes = 0;
  return (size_t)bytes;
}

struct Plan {
  dim3 grid, block;
  size_t bytes;
};

// Blocks of 32 rows x (warps strips of w diagonals): at most COL_WARPS
// warps, no more strips than the band has, and no more warps than shared
// memory holds.
Plan plan(int mk, int nk, int n_pad, int w_out, int w, bool staged,
          size_t smem_max) {
  const int strips = (w_out + w - 1) / w;
  const int tiles = (strips + COL_WARPS - 1) / COL_WARPS;
  int warps = (strips + tiles - 1) / tiles;
  while (warps > 1 && Tile(mk, nk, w, warps, staged).bytes() > smem_max)
    --warps;
  const int col_tiles = (strips + warps - 1) / warps;
  return {dim3((n_pad + ROWS - 1) / ROWS, col_tiles), dim3(ROWS, warps),
          Tile(mk, nk, w, warps, staged).bytes()};
}

cudaEvent_t table_free[MAX_DEVICES];  // per device: the last table's launch

template <int NK, int W>
int launch_strips(const Args& a, cudaStream_t stream) {
  static int allowed[MAX_DEVICES];  // dynamic shared memory allowed so far
  const std::lock_guard<std::mutex> hold(launch_lock);
  int dev = 0;
  const size_t limit = smem_limit(&dev);
  if (limit == 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan(a.mk, a.nk, a.n_pad, a.w_out, W, NK != 0, limit);
  cudaError_t err = cudaSuccess;
  if ((int)p.bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(band_pearson_tiled<NK, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = (int)p.bytes;
  }
  if constexpr (NK == 0) {
    band_pearson_tiled<NK, W><<<p.grid, p.block, p.bytes, stream>>>(a);
    return (int)cudaGetLastError();
  } else {
    cudaEvent_t& done = table_free[dev];
    err = done ? cudaStreamWaitEvent(stream, done, 0)
               : cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyToSymbolAsync(c_taps, a.taps,
                                  sizeof(double) * a.n_k * 3 * NK * NK, 0,
                                  cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    band_pearson_tiled<NK, W><<<p.grid, p.block, p.bytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaEventRecord(done, stream);
  }
}

template <int NK>
int launch(const Args& a, cudaStream_t stream) {
  return strip_width(a.w_out) == NARROW_W
             ? launch_strips<NK, NARROW_W>(a, stream)
             : launch_strips<NK, WIDE_W>(a, stream);
}

}  // namespace

// Kernels per launch for an (mk, nk) stack: the compile-time instances
// hold the whole tap table in the constant bank.
extern "C" int band_pearson_max_kernels(int mk, int nk) {
  return max_kernels(mk, nk);
}

// Dynamic shared memory of a launch on the current device, in bytes, for
// reports (0 for K out of range).
extern "C" long long band_pearson_smem_bytes(int mk, int nk, int n_k,
                                             int w_out) {
  if (n_k < 1 || n_k > max_kernels(mk, nk)) return 0;
  const std::lock_guard<std::mutex> hold(launch_lock);
  int dev = 0;
  return (long long)plan(mk, nk, ROWS, w_out, strip_width(w_out),
                         compiled_shape(mk, nk), smem_limit(&dev))
      .bytes;
}

// n_k kernels in one launch, 1 <= n_k <= band_pearson_max_kernels(mk, nk);
// taps (n_k, 3, mk, nk) and sums (n_k, 2) float64 on the card.
extern "C" int band_pearson_f32(const float* sig, const float* mask,
                                const double* taps, const double* sums,
                                int n_k, int n_pad, int w_out, int w_in,
                                int mk, int nk, int n, int max_dist,
                                float min_pres, float threshold,
                                float pearson_min, float* corr, float* logp,
                                uint8_t* cand, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_k < 1 || n_k > max_kernels(mk, nk))
    return (int)cudaErrorInvalidValue;
  const Args a{sig, mask, taps, sums, n_k, n_pad, w_out, w_in, mk, nk, n,
               max_dist, min_pres, threshold, pearson_min, corr, logp, cand};
  if (compiled_shape(mk, nk)) {
    switch (nk) {
      case 7: return launch<7>(a, st);
      case 15: return launch<15>(a, st);
      case 17: return launch<17>(a, st);
      case 31: return launch<31>(a, st);
    }
  }
  return launch<0>(a, st);
}
