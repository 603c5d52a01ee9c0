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
// Bound on this card: bytes: per symbol 16 bytes read and 8 written against
// 120 flops and half a sincosf. What stood in the way of that bound was the
// shared-memory pipe (90 four-byte loads for a symbol's 60 multiply-adds) and
// a full-range sincosf for every sample. So:
//
// * A block of 128 threads owns a tile of up to 512 output symbols of one
//   candidate; the wrapper picks the tile (kernels/recover.py `recover_tile`)
//   so that a candidate's blocks are equally full. A tile is a multiple of 4
//   symbols, so it starts on a multiple of 8 samples and keeps its row's
//   16-byte phase.
// * Derotation, 4 consecutive samples a thread: one load of 16 bytes per
//   plane where the row's address allows it, else two of 8 or four of 4
//   (`load_width`; rows have 2 * n_syms + 28 samples, so an odd n_syms puts
//   every other row on an 8-byte phase); one full-range sincosf of the first
//   sample's phase dphi * m + phi (it reaches tens of radians: no fast
//   intrinsic), then three steps of the phasor by (cos dphi, sin dphi). The
//   reference's own phase is rounded to an ulp of about 1e-5 rad there, so
//   three complex multiplies stay far inside the tolerance; a longer
//   recurrence would save little more. Samples at m >= n read as zero. The
//   result goes to shared memory split into even and odd samples, which makes
//   the stride-2 filter's reads contiguous.
// * Filter, 4 consecutive symbols a thread, register-tiled: the 18 even and
//   18 odd samples they need are read as five 16-byte loads per array, the 30
//   taps are held in registers, and the multiply-adds run in ascending tap
//   order as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SPT = 4;                  // output symbols per thread
constexpr int MAX_TILE = THREADS * SPT; // output symbols per block
constexpr int NTAPS = 30;
constexpr int HALF = NTAPS / 2;
constexpr int NV = 5;                   // 16-byte loads a thread's 18 samples span
// even (or odd) samples a tile holds, tile + 14, and what the last thread's
// five 16-byte loads reach
constexpr int NE = MAX_TILE + 4 * NV - SPT;

// 4 consecutive floats at row[m..m+3]; elements at m >= n read as zero.
// width: kernels/recover.py `load_width` of the row's address
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int m,
                                        int n, int width) {
  if (m + 3 < n) {
    if (width == 16) return *reinterpret_cast<const float4*>(row + m);
    if (width == 8) {
      const float2 a = *reinterpret_cast<const float2*>(row + m);
      const float2 b = *reinterpret_cast<const float2*>(row + m + 2);
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(row[m], row[m + 1], row[m + 2], row[m + 3]);
  }
  return make_float4(m < n ? row[m] : 0.f, m + 1 < n ? row[m + 1] : 0.f,
                     m + 2 < n ? row[m + 2] : 0.f, 0.f);
}

// y[u] += sum_j e[u + j] * t[2 j] + q[u + j] * t[2 j + 1], ascending taps
__device__ __forceinline__ void filter4(const float* __restrict__ se,
                                        const float* __restrict__ sq,
                                        const float (&t)[NTAPS], float (&y)[SPT]) {
  float e[4 * NV], q[4 * NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 a = reinterpret_cast<const float4*>(se)[v];
    const float4 b = reinterpret_cast<const float4*>(sq)[v];
    e[4 * v] = a.x; e[4 * v + 1] = a.y; e[4 * v + 2] = a.z; e[4 * v + 3] = a.w;
    q[4 * v] = b.x; q[4 * v + 1] = b.y; q[4 * v + 2] = b.z; q[4 * v + 3] = b.w;
  }
#pragma unroll
  for (int u = 0; u < SPT; ++u) y[u] = 0.f;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      y[u] = fmaf(e[u + j], t[2 * j], y[u]);
      y[u] = fmaf(q[u + j], t[2 * j + 1], y[u]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
recover_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
               const float* __restrict__ dphi, const float* __restrict__ phi,
               const float* __restrict__ gamma, const float* __restrict__ taps,
               float2* __restrict__ y, long long* stamps, int n, int n_syms,
               int tile) {
  __shared__ __align__(16) float er[NE], ei[NE];  // even samples
  __shared__ __align__(16) float qr[NE], qi[NE];  // odd samples
  __shared__ __align__(16) float tp[32];

  const int tid = threadIdx.x;
  const int c = blockIdx.x;  // candidates on x: no 65535 limit
  const int s0 = blockIdx.y * tile;
  const int ns = min(tile, n_syms - s0);  // symbols of this tile
  long long* stamp = stamps == nullptr
      ? nullptr : stamps + 3 * ((size_t)c * gridDim.y + blockIdx.y);
  if (stamp != nullptr && tid == 0) stamp[0] = clock64();

  const float dp = dphi[c], ph = phi[c];
  const float ig = 1.0f / fmaxf(gamma[c], 1e-9f);
  if (tid < NTAPS) tp[tid] = taps[(size_t)c * NTAPS + tid];
  const float* pr = wr + (size_t)c * n;
  const float* pi = wi + (size_t)c * n;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(pr) | reinterpret_cast<uintptr_t>(pi);
  const int width = (addr & 15) == 0 ? 16 : (addr & 7) == 0 ? 8 : 4;
  float sd, cd;
  sincosf(dp, &sd, &cd);

  // the tile's 2 * ns + 28 samples in quads, from sample 2 * s0
  const int nquad = (2 * ns + NTAPS - 2 + 3) / 4;
  for (int j = tid; j < nquad; j += THREADS) {
    const int m = 2 * s0 + 4 * j;
    const float4 a = load4(pr, m, n, width);
    const float4 b = load4(pi, m, n, width);
    const float th = dp * (float)m + ph;
    float sn, cs;
    sincosf(th, &sn, &cs);
    const float r0 = (a.x * cs + b.x * sn) * ig, i0 = (b.x * cs - a.x * sn) * ig;
    const float c1 = cs * cd - sn * sd, s1 = sn * cd + cs * sd;
    const float r1 = (a.y * c1 + b.y * s1) * ig, i1 = (b.y * c1 - a.y * s1) * ig;
    const float c2 = c1 * cd - s1 * sd, s2 = s1 * cd + c1 * sd;
    const float r2 = (a.z * c2 + b.z * s2) * ig, i2 = (b.z * c2 - a.z * s2) * ig;
    const float c3 = c2 * cd - s2 * sd, s3 = s2 * cd + c2 * sd;
    const float r3 = (a.w * c3 + b.w * s3) * ig, i3 = (b.w * c3 - a.w * s3) * ig;
    reinterpret_cast<float2*>(er)[j] = make_float2(r0, r2);
    reinterpret_cast<float2*>(ei)[j] = make_float2(i0, i2);
    reinterpret_cast<float2*>(qr)[j] = make_float2(r1, r3);
    reinterpret_cast<float2*>(qi)[j] = make_float2(i1, i3);
  }
  __syncthreads();
  if (stamp != nullptr && tid == 0) stamp[1] = clock64();

  const int sl = SPT * tid;  // first of this thread's symbols within the tile
  if (sl < ns) {
    float t[NTAPS];
#pragma unroll
    for (int v = 0; v < NTAPS / 2; ++v) {
      const float2 p = reinterpret_cast<const float2*>(tp)[v];
      t[2 * v] = p.x; t[2 * v + 1] = p.y;
    }
    float yr[SPT], yi[SPT];
    filter4(er + sl, qr + sl, t, yr);
    filter4(ei + sl, qi + sl, t, yi);
    float2* out = y + (size_t)c * n_syms + s0 + sl;
    if (sl + SPT <= ns && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      reinterpret_cast<float4*>(out)[0] = make_float4(yr[0], yi[0], yr[1], yi[1]);
      reinterpret_cast<float4*>(out)[1] = make_float4(yr[2], yi[2], yr[3], yi[3]);
    } else {
#pragma unroll
      for (int u = 0; u < SPT; ++u)
        if (sl + u < ns) out[u] = make_float2(yr[u], yi[u]);
    }
  }
  if (stamp != nullptr) {
    __syncthreads();
    if (tid == 0) stamp[2] = clock64();
  }
}

}  // namespace

// wr, wi [C, n] float32; dphi, phi, gamma [C]; taps [C, 30];
// y [C, n_syms] complex64 (C = rows x candidates); stamps
// [C * blocks, 3] int64 or NULL; tile from `recover_tile`.
extern "C" int lq_recover_symbols(const void* wr, const void* wi,
                                  const void* dphi, const void* phi,
                                  const void* gamma, const void* taps, void* y,
                                  void* stamps, int C, int n, int n_syms,
                                  int tile, void* stream) {
  if (tile < SPT || tile > MAX_TILE || tile % SPT != 0 || n_syms < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(C, (n_syms + tile - 1) / tile);
  recover_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const float*>(dphi), static_cast<const float*>(phi),
      static_cast<const float*>(gamma), static_cast<const float*>(taps),
      static_cast<float2*>(y), static_cast<long long*>(stamps), n, n_syms, tile);
  return static_cast<int>(cudaGetLastError());
}
