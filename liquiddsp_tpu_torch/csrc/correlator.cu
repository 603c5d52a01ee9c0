// Fused multi-template preamble correlator, reduced outputs only.
//
// Replaces the TPU kernel liquiddsp_tpu/kernels/correlator.py `_fused_kernel`
// (entry `correlate_reduced_pallas`). For every lag t of every row it computes
//   c_f[t] = sum_n x[t+n] * conj(s_f[n])   (F = 5 templates, L = 128 taps)
//   E[t]   = sum_n |x[t+n]|^2
// and writes only rho2 = max_f |c_f|^2 / (E_s * max(E, 1e-12)), the first
// arg-max bin, the complex correlation at that bin, and E. Samples past the
// end of a row read as zero.
//
// Bound on this card: operations. The function needs 128 * 5 * 8 flops a lag
// (E could be a sliding sum; this kernel sums it directly, 128 * 4 more) against
// 8 bytes read and 20 written, about 180 flop per byte, far above the float32
// CUDA-core balance of an H100 (about 20 flop per byte). The TPU kernel turned
// the sliding sum into block-Toeplitz matrix products because its matrix unit
// is its only fast arithmetic; here the direct form in float32 on CUDA cores
// is simple, keeps float32 parity tolerances, and wastes no multiply on the
// structural zeros of the Toeplitz form.
//
// Design: a block owns a tile of 512 lags of one row and stages tile + 127
// samples (split into real and imaginary planes, so that neighbouring threads
// read neighbouring banks) and the 5 x 128 templates in shared memory. Each
// thread accumulates 4 lags (strided by the block size), so each template
// value fetched from shared memory feeds 4 lags: 11 shared-memory loads per
// 88 fused multiply-adds. Max, arg-max and normalisation happen in registers.
// Tensor-core operands (bf16 or tf32 with `wgmma`) are a later decision.

#include <cuda_runtime.h>

namespace {

constexpr int L = 128;       // template length
constexpr int F = 5;         // templates (CFO bins)
constexpr int THREADS = 128;
constexpr int LPT = 4;       // lags per thread
constexpr int TILE = THREADS * LPT;
constexpr int TROW = 12;     // floats per template row: 5 re, 5 im, 2 pad

__global__ void __launch_bounds__(THREADS)
correlate_kernel(const float2* __restrict__ x, const float2* __restrict__ tmpl,
                 float* __restrict__ rho2, int* __restrict__ fbin,
                 float2* __restrict__ corr, float* __restrict__ energy,
                 int T, float inv_es) {
  __shared__ float xr[TILE + L];
  __shared__ float xi[TILE + L];
  __shared__ __align__(16) float st[L * TROW];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TILE;
  const float2* row = x + (size_t)blockIdx.y * T;

  for (int i = tid; i < TILE + L - 1; i += THREADS) {
    const int t = t0 + i;
    float2 v = make_float2(0.f, 0.f);
    if (t < T) v = row[t];
    xr[i] = v.x;
    xi[i] = v.y;
  }
  for (int i = tid; i < F * L; i += THREADS) {
    const int f = i / L, n = i - f * L;
    const float2 v = tmpl[i];
    st[n * TROW + f] = v.x;
    st[n * TROW + F + f] = v.y;
  }
  __syncthreads();

  float cr[LPT][F], ci[LPT][F], en[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    en[j] = 0.f;
#pragma unroll
    for (int f = 0; f < F; ++f) { cr[j][f] = 0.f; ci[j][f] = 0.f; }
  }

#pragma unroll 4
  for (int n = 0; n < L; ++n) {
    const float4* srow = reinterpret_cast<const float4*>(&st[n * TROW]);
    const float4 s0 = srow[0], s1 = srow[1], s2 = srow[2];
    const float sr[F] = {s0.x, s0.y, s0.z, s0.w, s1.x};
    const float si[F] = {s1.y, s1.z, s1.w, s2.x, s2.y};
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const float a = xr[tid + j * THREADS + n];
      const float b = xi[tid + j * THREADS + n];
      en[j] = fmaf(a, a, en[j]);
      en[j] = fmaf(b, b, en[j]);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        // x * conj(s) = (a sr + b si) + j (b sr - a si)
        cr[j][f] = fmaf(a, sr[f], cr[j][f]);
        cr[j][f] = fmaf(b, si[f], cr[j][f]);
        ci[j][f] = fmaf(b, sr[f], ci[j][f]);
        ci[j][f] = fmaf(-a, si[f], ci[j][f]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int t = t0 + tid + j * THREADS;
    if (t >= T) continue;
    float best = cr[j][0] * cr[j][0] + ci[j][0] * ci[j][0];
    int fb = 0;
    float br = cr[j][0], bi = ci[j][0];
#pragma unroll
    for (int f = 1; f < F; ++f) {
      const float m = cr[j][f] * cr[j][f] + ci[j][f] * ci[j][f];
      if (m > best) { best = m; fb = f; br = cr[j][f]; bi = ci[j][f]; }
    }
    const size_t o = (size_t)blockIdx.y * T + t;
    rho2[o] = best * inv_es / fmaxf(en[j], 1e-12f);
    fbin[o] = fb;
    corr[o] = make_float2(br, bi);
    energy[o] = en[j];
  }
}

}  // namespace

// x [B, T] complex64, tmpl [5, 128] complex64 -> rho2 f32, fbin i32,
// corr complex64, energy f32, all [B, T].
extern "C" int lq_correlate_reduced(const void* x, const void* tmpl, void* rho2,
                                    void* fbin, void* corr, void* energy, int B,
                                    int T, float inv_es, void* stream) {
  dim3 grid((T + TILE - 1) / TILE, B);
  correlate_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(tmpl),
      static_cast<float*>(rho2), static_cast<int*>(fbin),
      static_cast<float2*>(corr), static_cast<float*>(energy), T, inv_es);
  return static_cast<int>(cudaGetLastError());
}
