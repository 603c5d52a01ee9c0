// Batched variable-offset window extraction.
//
// Replaces the TPU kernel liquiddsp_tpu/kernels/extract.py `_extract_kernel`
// (entry `extract_windows`): K windows of n samples per stream row, each at
// its own start, written as separate float32 real and imaginary planes.
// Samples outside [0, T) read as zero. Exact: it only moves data.
//
// Bound on this card: bytes (8 read and 8 written per sample, no arithmetic).
// The TPU kernel had to fetch 128-aligned supersets by DMA and rotate them in
// fast memory; a GPU thread block simply reads from any offset, so this is one
// block per (row, candidate) doing a coalesced strided copy: neighbouring
// threads read neighbouring complex samples and write neighbouring floats.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
extract_kernel(const float2* __restrict__ x, const int* __restrict__ starts,
               float* __restrict__ wr, float* __restrict__ wi, int T, int K,
               int n) {
  const int c = blockIdx.x;  // row * K + candidate
  const int b = c / K;
  const int s = starts[c];
  const float2* row = x + (size_t)b * T;
  const size_t o = (size_t)c * n;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const long long t = (long long)s + i;
    float2 v = make_float2(0.f, 0.f);
    if (t >= 0 && t < T) v = row[t];
    wr[o + i] = v.x;
    wi[o + i] = v.y;
  }
}

}  // namespace

// x [B, T] complex64, starts [B, K] int32 -> wr, wi [B, K, n] float32.
extern "C" int lq_extract_windows(const void* x, const void* starts, void* wr,
                                  void* wi, int B, int T, int K, int n,
                                  void* stream) {
  dim3 grid(B * K);
  extract_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const int*>(starts),
      static_cast<float*>(wr), static_cast<float*>(wi), T, K, n);
  return static_cast<int>(cudaGetLastError());
}
