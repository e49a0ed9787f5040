// Fused band Pearson for Hopper (sm_90a).
//
// Replaces chromosight_tpu/ops/pallas_band.py::_fused_kernel (the Pallas TPU
// kernel) together with its XLA epilogue: for every output pixel (i, d) of a
// chromosome's band it computes the missing-corrected Pearson correlation
// with an (mk, nk) kernel, its two-sided log10 p-value, the diagonal trim and
// the candidate mask, in one pass.
//
// Inputs are the framed, padded signal and missing-mask bands
// (chromosight_torch.ops.band.band_frame): (n_pad + 2(mk-1), w_in) f32, with
// w_in = w_out + mk + nk - 2 for odd kernels.  Output pixel (i, d) reads conv
// row r = i + kh.  In band coordinates the kernel is sheared,
// Ksh[u, mk-1-u+v] = K[u, v], and the parallelogram window sums have the same
// support, so ONE loop over the mk*nk taps (u, v) reads
//     x = sig[r + u][d + mk-1-u + v],  m = mask[r + u][d + mk-1-u + v]
// once each and accumulates all six sums: sum (K/ksize) x, sum x, sum x^2,
// sum m, sum K m, sum K^2 m.  The sums run in float64: on detrended maps the
// Pearson numerator cancels most of them, and 289-term float32 sums leave
// ~5e-5 of error in corr (see chromosight_torch/ops/band.py).  They are
// rounded to float32, and each is snapped to 0 below `threshold`
// (window sums after the 1/ksize scaling, as the JAX band engine does), then
// the Pearson algebra of chromosight_tpu/ops/band.py:618-634 and the p-value
//     log10p = (log(0.5 erfcx(a/sqrt2)) - a^2/2 + log 2) / log 10,
//     a = |atanh(corr) sqrt(n_pres - 3)|,
// which is log_ndtr(-a) + log 2 without underflow.  The p-value comes from
// the untrimmed corr; the trim keeps d <= max_dist, i < n, i + d < n.
//
// K kernels per launch.  With a (K, 3, mk, nk) tap table (K <= 8, one
// template instance per K) each thread still reads x and m once per tap and
// accumulates the three kernel-independent window sums (x, x^2, m) once,
// plus 3K float64 sums; the epilogue shares n_pres, the signal means and
// the corrections across the K kernels and writes (K, n_pad, w_out) maps.
// Every per-kernel sum takes its taps in the same order as the K = 1
// instance, so slice k equals a single-kernel launch on kernel k bit for
// bit.  The tap planes may differ from the kernel (--tsvd convolves the
// rank-truncated kernels): ksum and k2sum come from `sums`, taken from the
// original kernel, and only the planes change.
//
// Work per tap and pixel: 2 band loads through __ldg (578 per pixel for a
// 17x17 kernel), 3K tap-table loads (warp-wide broadcasts), 3 + 3K float64
// adds or FMAs, and 2 + 3K float32->float64 conversions, which sm_90 issues
// at a fraction of its FP64 FMA rate.  Which of these bounds the kernel is
// not known: no hardware profile has been taken.  The FP64 work and the
// conversions both grow with K, the band loads do not.  Neighbouring
// threads read neighbouring columns, and a warp's rows overlap across u, so
// the working set stays in L1/L2.  This version is simple on purpose: one
// thread per pixel, 32x8 blocks, no shared-memory tiles.  A float64 tap
// table holding the exact casts of the float32 taps would drop the 3K
// conversions per tap with bit-identical output.
// Staging the tile and its (mk-1)-row halo in shared memory (TMA or
// cp.async), reusing taps along the anti-diagonals in registers, and
// folding the frame rules into the kernel so sig_p and mask_p are never
// written are left for later.
//
// Launch contract: the caller allocates the outputs, the kernel runs on the
// given stream without synchronising, and the C entry returns
// cudaGetLastError() (or cudaErrorInvalidValue for K outside [1, 8]) so a
// refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float snap(float x, float threshold) {
  return fabsf(x) < threshold ? 0.0f : x;
}

template <int K>
__global__ void band_pearson_kernel(
    const float* __restrict__ sig, const float* __restrict__ mask,
    const float* __restrict__ coef,  // (K, 3, mk, nk): K/ksize, K, K^2
    const float* __restrict__ sums,  // (K, 2): ksum, k2sum
    int n_pad, int w_out, int w_in, int mk, int nk, int n, int max_dist,
    float min_pres, float threshold, float pearson_min,
    float* __restrict__ corr, float* __restrict__ logp,
    uint8_t* __restrict__ cand) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= w_out) return;
  const int taps = mk * nk;
  const int kh = (mk - 1) / 2;
  const float ksize = (float)taps;
  const float inv_ksize = 1.0f / ksize;
  const size_t plane = (size_t)n_pad * (size_t)w_out;
  for (int i = blockIdx.y * blockDim.y + threadIdx.y; i < n_pad;
       i += gridDim.y * blockDim.y) {
    double s_x = 0., s_x2 = 0., s_m = 0.;
    double s_k[K], s_mk[K], s_mk2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s_k[k] = s_mk[k] = s_mk2[k] = 0.;
    for (int u = 0; u < mk; ++u) {
      const size_t base =
          (size_t)(i + kh + u) * (size_t)w_in + (size_t)(d + mk - 1 - u);
      const float* cu = coef + u * nk;
      for (int v = 0; v < nk; ++v) {
        const double x = __ldg(sig + base + v);
        const double m = __ldg(mask + base + v);
        s_x += x;
        s_x2 = fma(x, x, s_x2);
        s_m += m;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float* ck = cu + k * 3 * taps + v;
          s_k[k] = fma((double)__ldg(ck), x, s_k[k]);
          s_mk[k] = fma((double)__ldg(ck + taps), m, s_mk[k]);
          s_mk2[k] = fma((double)__ldg(ck + 2 * taps), m, s_mk2[k]);
        }
      }
    }
    const float sig_mean0 = snap((float)s_x * inv_ksize, threshold);
    const float sig2_mean0 = snap((float)s_x2 * inv_ksize, threshold);
    const float n_miss = snap((float)s_m, threshold);
    const float n_pres = ksize - n_miss;
    const float corr_f = ksize / n_pres;
    const float sig_mean = sig_mean0 * corr_f;
    const float sig2_mean = sig2_mean0 * corr_f;
    const float sig_var = sig2_mean - sig_mean * sig_mean;
    const float sqrt_dof = sqrtf(n_pres - 3.f);
    const bool keep = d <= max_dist && i < n && i + d < n;
    const size_t o = (size_t)i * (size_t)w_out + (size_t)d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float conv_sk = snap((float)s_k[k], threshold);
      const float conv_mk = snap((float)s_mk[k], threshold);
      const float conv_mk2 = snap((float)s_mk2[k], threshold);
      const float kmean_eff = (__ldg(sums + 2 * k) - conv_mk) / n_pres;
      const float k2mean_eff = (__ldg(sums + 2 * k + 1) - conv_mk2) / n_pres;
      float denom = sqrtf(sig_var * (k2mean_eff - kmean_eff * kmean_eff));
      if (n_pres < min_pres) denom = 0.f;
      const float num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f;
      const float inv_denom = fabsf(denom) < 1e-10f ? 0.f : 1.f / denom;
      float out = num * inv_denom;
      if (!isfinite(out)) out = 0.f;
      out = fminf(fmaxf(out, -1.f), 1.f);

      const float a = fabsf(atanhf(out) * sqrt_dof);
      const float log_tail =
          logf(0.5f * erfcxf(a * 0.70710678118654752f)) - 0.5f * a * a;
      logp[k * plane + o] = (log_tail + logf(2.f)) / logf(10.f);
      const float c = keep ? out : 0.f;
      corr[k * plane + o] = c;
      cand[k * plane + o] = (c >= pearson_min && c != 0.f) ? 1 : 0;
    }
  }
}

template <int K>
int launch(const float* sig, const float* mask, const float* coef,
           const float* sums, int n_pad, int w_out, int w_in, int mk, int nk,
           int n, int max_dist, float min_pres, float threshold,
           float pearson_min, float* corr, float* logp, uint8_t* cand,
           cudaStream_t stream) {
  const dim3 block(32, 8);
  const int rows = (n_pad + block.y - 1) / block.y;
  const dim3 grid((w_out + block.x - 1) / block.x, rows < 65535 ? rows : 65535);
  band_pearson_kernel<K><<<grid, block, 0, stream>>>(
      sig, mask, coef, sums, n_pad, w_out, w_in, mk, nk, n, max_dist,
      min_pres, threshold, pearson_min, corr, logp, cand);
  return (int)cudaGetLastError();
}

}  // namespace

// n_k kernels in one launch, 1 <= n_k <= MAX_K.
extern "C" int band_pearson_f32(const float* sig, const float* mask,
                                const float* coef, const float* sums, int n_k,
                                int n_pad, int w_out, int w_in, int mk, int nk,
                                int n, int max_dist, float min_pres,
                                float threshold, float pearson_min,
                                float* corr, float* logp, uint8_t* cand,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define BAND_PEARSON_CASE(K)                                                \
  case K:                                                                  \
    return launch<K>(sig, mask, coef, sums, n_pad, w_out, w_in, mk, nk, n, \
                     max_dist, min_pres, threshold, pearson_min, corr, logp, \
                     cand, st);
  switch (n_k) {
    BAND_PEARSON_CASE(1)
    BAND_PEARSON_CASE(2)
    BAND_PEARSON_CASE(3)
    BAND_PEARSON_CASE(4)
    BAND_PEARSON_CASE(5)
    BAND_PEARSON_CASE(6)
    BAND_PEARSON_CASE(7)
    BAND_PEARSON_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BAND_PEARSON_CASE
}
