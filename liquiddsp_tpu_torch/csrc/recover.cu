// Fused NCO derotation + per-candidate 30-tap matched filter + decimation by 2.
//
// Replaces the TPU kernel liquiddsp_tpu/kernels/recover.py `_recover_kernel`
// (entry `recover_symbols_planes`). Per candidate window w[m] (real and
// imaginary float32 planes), with that candidate's dphi, phi, gamma and tap
// row t[0..29]:
//   d[m] = w[m] * exp(-j (dphi * m + phi)) / max(gamma, 1e-9)
//   y[s] = sum_{v < 30} d[2 s + v] * t[v]            s = 0 .. n_syms - 1
// written as complex64 [candidates, n_syms].
//
// Bound on this card: bytes, nearly: per symbol 16 bytes read and 8 written
// against one sincosf pair per sample and 120 flops per symbol. The TPU kernel
// computed the undecimated filter with lane rolls and let the caller throw
// half of it away; here each thread computes one even output only. A block
// owns 256 output symbols of one candidate: it derotates the 540 samples they
// need once into shared memory, split into even and odd samples so that the
// stride-2 filter reads hit distinct banks, then runs the 30 multiply-adds.
// The phase reaches tens of radians, so the full-range sincosf is used, not
// the fast intrinsics.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 256;      // output symbols per block
constexpr int NTAPS = 30;
constexpr int HALF = NTAPS / 2;
constexpr int NSAMP = 2 * TS + NTAPS - 2;  // samples a block needs

__global__ void __launch_bounds__(TS)
recover_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
               const float* __restrict__ dphi, const float* __restrict__ phi,
               const float* __restrict__ gamma, const float* __restrict__ taps,
               float2* __restrict__ y, int n, int n_syms) {
  __shared__ float er[TS + HALF], ei[TS + HALF];  // even samples
  __shared__ float qr[TS + HALF], qi[TS + HALF];  // odd samples
  __shared__ float tp[NTAPS];

  const int tid = threadIdx.x;
  const int c = blockIdx.x;  // candidates on x: no 65535 limit
  const int s0 = blockIdx.y * TS;
  const float dp = dphi[c], ph = phi[c];
  const float ig = 1.0f / fmaxf(gamma[c], 1e-9f);
  if (tid < NTAPS) tp[tid] = taps[(size_t)c * NTAPS + tid];
  const float* pr = wr + (size_t)c * n;
  const float* pi = wi + (size_t)c * n;

  for (int i = tid; i < NSAMP; i += TS) {
    const int m = 2 * s0 + i;
    float a = 0.f, b = 0.f;
    if (m < n) { a = pr[m]; b = pi[m]; }
    const float th = dp * (float)m + ph;
    float sn, cs;
    sincosf(th, &sn, &cs);
    const float dr = (a * cs + b * sn) * ig;
    const float di = (b * cs - a * sn) * ig;
    if (i & 1) { qr[i >> 1] = dr; qi[i >> 1] = di; }
    else       { er[i >> 1] = dr; ei[i >> 1] = di; }
  }
  __syncthreads();

  const int s = s0 + tid;
  if (s >= n_syms) return;
  float yr = 0.f, yi = 0.f;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float te = tp[2 * j], to = tp[2 * j + 1];
    yr = fmaf(er[tid + j], te, yr);
    yi = fmaf(ei[tid + j], te, yi);
    yr = fmaf(qr[tid + j], to, yr);
    yi = fmaf(qi[tid + j], to, yi);
  }
  y[(size_t)c * n_syms + s] = make_float2(yr, yi);
}

}  // namespace

// wr, wi [C, n] float32; dphi, phi, gamma [C]; taps [C, 30];
// y [C, n_syms] complex64 (C = rows x candidates).
extern "C" int lq_recover_symbols(const void* wr, const void* wi,
                                  const void* dphi, const void* phi,
                                  const void* gamma, const void* taps, void* y,
                                  int C, int n, int n_syms, void* stream) {
  dim3 grid(C, (n_syms + TS - 1) / TS);
  recover_kernel<<<grid, TS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const float*>(dphi), static_cast<const float*>(phi),
      static_cast<const float*>(gamma), static_cast<const float*>(taps),
      static_cast<float2*>(y), n, n_syms);
  return static_cast<int>(cudaGetLastError());
}
