// Exact soft-decision Viterbi decoder, K = 7, rate 1/2, 64 states, start and
// end state 0, with the traceback in the kernel.
//
// Replaces the TPU kernel liquiddsp_tpu/kernels/viterbi.py `_kernel` (entry
// `viterbi_pallas`). Input: depunctured LLR pairs lam [B, steps, 2] float32
// (positive = bit 0). Output: decoded bits [B, steps] int8. It repeats the
// float32 operations of ops/fec/conv.py `_viterbi_run` one for one:
//   cand_i = (m[pred_i] + l0 * e0_i) + l1 * e1_i,  take1 = cand1 > cand0
// (a tie keeps the low-MSB predecessor), and the maximum over the 64 states is
// subtracted at every step. The branch signs e are +-1, so a fused
// multiply-add rounds exactly as the separate operations do, and the two
// decoders agree bit for bit, ties on erasures included.
//
// Bound on this card: neither bytes nor operations but latency: the trellis
// is a chain of `steps` dependent add-compare-selects per frame. Parallelism
// comes from the frames (one block each, all resident at once) and the 64
// states (one thread each). The TPU kernel routed predecessors through 64x64
// matrix products because its vector unit cannot gather; here a thread reads
// its two predecessors' metrics from shared memory. Metrics and the step's
// maximum are double-buffered, and the subtraction of the maximum is applied
// where the next step reads the metric, so a step needs one __syncthreads.
// The 64 decisions of a step are packed by two warp ballots into one 64-bit
// word of a [B, steps] scratch in device memory (long trellises do not fit in
// shared memory); thread 0 then walks the traceback from state 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 64;        // trellis states = threads per block
constexpr int CHUNK = 128;    // trellis steps staged in shared memory at a time

__global__ void __launch_bounds__(NS)
viterbi_kernel(const float* __restrict__ lam, const float* __restrict__ signs,
               uint32_t* __restrict__ dec, int8_t* __restrict__ bits,
               int steps) {
  __shared__ float metric[2][NS];
  __shared__ float wmax[2][2];
  __shared__ float sl[2 * CHUNK];

  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5;
  const int b = blockIdx.x;
  const int p0 = s >> 1, p1 = (s >> 1) | (NS / 2);
  const float e00 = signs[4 * s], e10 = signs[4 * s + 1];
  const float e01 = signs[4 * s + 2], e11 = signs[4 * s + 3];
  const float* lrow = lam + (size_t)b * steps * 2;
  uint32_t* drow = dec + (size_t)b * steps * 2;

  metric[0][s] = (s == 0) ? 0.0f : -1e9f;
  if (s < 2) wmax[0][s] = 0.0f;
  int cur = 0;

  for (int c0 = 0; c0 < steps; c0 += CHUNK) {
    const int nc = min(CHUNK, steps - c0);
    __syncthreads();  // previous chunk fully consumed; first pass: init visible
    for (int i = s; i < 2 * nc; i += NS) sl[i] = lrow[2 * c0 + i];
    __syncthreads();
    for (int t = 0; t < nc; ++t) {
      const float l0 = sl[2 * t], l1 = sl[2 * t + 1];
      const float mx = fmaxf(wmax[cur][0], wmax[cur][1]);
      float cand0 = (metric[cur][p0] - mx) + l0 * e00;
      cand0 = cand0 + l1 * e10;
      float cand1 = (metric[cur][p1] - mx) + l0 * e01;
      cand1 = cand1 + l1 * e11;
      const bool take1 = cand1 > cand0;
      const float m = take1 ? cand1 : cand0;
      float wm = m;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
      const uint32_t word = __ballot_sync(0xffffffffu, take1);
      const int nxt = cur ^ 1;
      metric[nxt][s] = m;
      if (lane == 0) {
        wmax[nxt][warp] = wm;
        drow[2 * (c0 + t) + warp] = word;  // low word: states 0-31
      }
      __syncthreads();
      cur = nxt;
    }
  }

  if (s == 0) {
    int state = 0;
    int8_t* brow = bits + (size_t)b * steps;
    for (int t = steps - 1; t >= 0; --t) {
      const uint32_t w = drow[2 * t + (state >> 5)];
      const int d = (w >> (state & 31)) & 1;
      brow[t] = (int8_t)(state & 1);
      state = (state >> 1) | (d << 5);
    }
  }
}

}  // namespace

// lam [B, steps, 2] float32, signs [64, 4] float32, dec [B, steps] int64
// scratch, bits [B, steps] int8.
extern "C" int lq_viterbi(const void* lam, const void* signs, void* dec,
                          void* bits, int B, int steps, void* stream) {
  viterbi_kernel<<<B, NS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lam), static_cast<const float*>(signs),
      static_cast<uint32_t*>(dec), static_cast<int8_t*>(bits), steps);
  return static_cast<int>(cudaGetLastError());
}
