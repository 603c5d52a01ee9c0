// Exact soft-decision Viterbi decoder, K = 7, rate 1/2, 64 states, start and
// end state 0, with the traceback in the kernel.
//
// Replaces the TPU kernel liquiddsp_tpu/kernels/viterbi.py `_kernel` (entry
// `viterbi_pallas`). Input: depunctured LLR pairs lam [B, steps, 2] float32
// (positive = bit 0). Output: decoded bits [B, steps] int8. It repeats the
// float32 operations of ops/fec/conv.py `_viterbi_run` one for one:
//   n = m[pred] - max,  cand_i = (n_i + l0 * e0_i) + l1 * e1_i,
//   take1 = cand1 > cand0   (a tie keeps the low-MSB predecessor),
// with the maximum over the 64 states subtracted at every step. The branch
// signs e are +-1, so a fused multiply-add rounds exactly as the separate
// operations do, and the two decoders agree bit for bit, ties on erasures
// included.
//
// Bound on this card: neither bytes nor operations but latency: the trellis
// is a chain of `steps` dependent add-compare-selects per frame, so the design
// shortens the chain's step. One warp owns a frame and keeps the 64 path
// metrics in registers, two per lane; the forward pass has no shared-memory
// exchange of metrics and no barrier.
//
// * Layout (kernels/viterbi.py `warp_state`): before a step of phase
//   k = t mod 5, lane l holds the states q and q + 32, q = l's 5 bits rotated
//   left by k. They are the two predecessors of 2q and 2q + 1 (mod 64), so the
//   lane computes both new states alone. One __shfl_xor_sync with the lane
//   mask 16 >> k (`exchange_mask`) pairs the new states up again as the
//   layout of phase k + 1. The step loop is unrolled by 5 with the phase a
//   compile-time constant, and each lane keeps its branch signs of the 5
//   phases in registers (`warp_signs`, built by the wrapper).
// * The maximum of the 64 metrics is one integer redux.sync: a float maximum
//   is a selection, so it is exact through the order-preserving map
//   `float_to_ordered`. The map puts -0.0 below +0.0, where torch.max may
//   return either zero; likewise fmaxf(cand0, cand1) can differ from the
//   reference's select in the sign of a zero only. A zero's sign never changes
//   a comparison, and x - (+-0) and (+-0) + y differ only where the result is
//   again a zero, so no decision differs.
// * lam goes through a per-warp shared buffer of 160 steps that the lanes
//   load coalesced one chunk ahead; a step reads its pair with one broadcast
//   load that is off the dependent chain. Steps past the end of the frame see
//   lam = 0 and store their decisions into the padding of the scratch row, so
//   the loop has no remainder code.
// * Decisions: two ballots a step give one 64-bit word (low word: the lanes'
//   even new states, bit = lane, `decision_bit`), stored by lane 0 into the
//   [B, dec_stride] scratch in device memory (it stays in L2; a 4166-step
//   trellis does not fit in shared memory). The whole warp walks the traceback
//   in lockstep, 30 steps a block: the block's words are loaded coalesced (the
//   next block's are in flight meanwhile) and fetched by shuffle, so no
//   dependent load from memory is on the walk. It tracks the lane index of
//   `decision_bit` instead of the state: stepping back replaces one bit of it
//   (`traceback_pos`), a chain of a shift, a shift and a bit merge. Words past
//   the end of the frame read as 0 and keep the walk in state 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;     // frames per block
constexpr int PHASES = 5;     // period of the layout in steps
constexpr int CHUNK = 160;    // steps of lam in shared memory: 5 float2 per lane
constexpr int TB = 30;        // traceback block: a multiple of PHASES, <= 32
constexpr unsigned FULL = 0xffffffffu;

// kernels/viterbi.py `float_to_ordered`; its own inverse
__device__ __forceinline__ int ordered(int u) {
  return u ^ ((u >> 31) & 0x7fffffff);
}

// One add-compare-select of all 64 states at phase K, then the exchange.
template <int K>
__device__ __forceinline__ void acs(float& mA, float& mB, float& mx,
                                    const float2 l, const float (&e)[PHASES][8],
                                    const int lane, uint2* dst) {
  const float nA = mA - mx, nB = mB - mx;
  // new state 2q from q (slot A, MSB 0) and q + 32 (slot B, MSB 1)
  const float ce0 = fmaf(l.y, e[K][1], fmaf(l.x, e[K][0], nA));
  const float ce1 = fmaf(l.y, e[K][3], fmaf(l.x, e[K][2], nB));
  // new state 2q + 1
  const float co0 = fmaf(l.y, e[K][5], fmaf(l.x, e[K][4], nA));
  const float co1 = fmaf(l.y, e[K][7], fmaf(l.x, e[K][6], nB));
  const unsigned be = __ballot_sync(FULL, ce1 > ce0);
  const unsigned bo = __ballot_sync(FULL, co1 > co0);
  if (lane == 0) *dst = make_uint2(be, bo);
  const float me = fmaxf(ce0, ce1), mo = fmaxf(co0, co1);
  const int key = __reduce_max_sync(FULL, ordered(__float_as_int(fmaxf(me, mo))));
  mx = __int_as_float(ordered(key));
  const bool hi = (lane & (16 >> K)) != 0;
  const float recv = __shfl_xor_sync(FULL, hi ? me : mo, 16 >> K);
  mA = hi ? recv : me;
  mB = hi ? mo : recv;
}

__device__ __forceinline__ void load_chunk(float2 (&pre)[CHUNK / 32],
                                           const float2* __restrict__ lrow,
                                           int c0, int steps, int lane) {
#pragma unroll
  for (int j = 0; j < CHUNK / 32; ++j) {
    const int t = c0 + 32 * j + lane;
    pre[j] = t < steps ? lrow[t] : make_float2(0.f, 0.f);
  }
}

__device__ __forceinline__ uint2 load_words(const uint2* drow, int t, int steps,
                                            int lane) {
  return (lane < TB && t >= 0 && t < steps) ? __ldcg(drow + t) : make_uint2(0u, 0u);
}

__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float2* __restrict__ lam, const float* __restrict__ wsigns,
               uint2* dec, int8_t* __restrict__ bits, long long* stamps,
               int B, int steps, int dec_stride) {
  __shared__ float2 sl[WARPS][CHUNK];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warps leave: there is no block-wide barrier
  if (stamps != nullptr && lane == 0) stamps[3 * b] = clock64();

  const float2* lrow = lam + (size_t)b * steps;
  uint2* drow = dec + (size_t)b * dec_stride;
  float2* buf = sl[warp];

  float e[PHASES][8];
#pragma unroll
  for (int k = 0; k < PHASES; ++k) {
    const float4* p = reinterpret_cast<const float4*>(wsigns + (k * 32 + lane) * 8);
    const float4 u = p[0], v = p[1];
    e[k][0] = u.x; e[k][1] = u.y; e[k][2] = u.z; e[k][3] = u.w;
    e[k][4] = v.x; e[k][5] = v.y; e[k][6] = v.z; e[k][7] = v.w;
  }

  // phase 0: lane l holds states l and l + 32; the trellis starts in state 0
  float mA = lane == 0 ? 0.0f : -1e9f, mB = -1e9f, mx = 0.0f;

  float2 pre[CHUNK / 32];
  load_chunk(pre, lrow, 0, steps, lane);
  for (int c0 = 0; c0 < steps; c0 += CHUNK) {
    __syncwarp();  // the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < CHUNK / 32; ++j) buf[32 * j + lane] = pre[j];
    __syncwarp();
    if (c0 + CHUNK < steps) load_chunk(pre, lrow, c0 + CHUNK, steps, lane);
    const int n_it = (min(CHUNK, steps - c0) + PHASES - 1) / PHASES;
    const float2* lp = buf;
    uint2* dp = drow + c0;
    for (int it = 0; it < n_it; ++it, lp += PHASES, dp += PHASES) {
      acs<0>(mA, mB, mx, lp[0], e, lane, dp + 0);
      acs<1>(mA, mB, mx, lp[1], e, lane, dp + 1);
      acs<2>(mA, mB, mx, lp[2], e, lane, dp + 2);
      acs<3>(mA, mB, mx, lp[3], e, lane, dp + 3);
      acs<4>(mA, mB, mx, lp[4], e, lane, dp + 4);
    }
  }

  __syncwarp();  // lane 0's decision words are visible to the warp
  if (stamps != nullptr && lane == 0) stamps[3 * b + 1] = clock64();

  // traceback from state 0: L is the lane index of `decision_bit`, bit the
  // word index, which is the decoded bit of the step
  int8_t* brow = bits + (size_t)b * steps;
  unsigned L = 0u, bit = 0u;
  const int nblk = (steps + TB - 1) / TB;
  uint2 w = load_words(drow, (nblk - 1) * TB + lane, steps, lane);
  for (int j = nblk - 1; j >= 0; --j) {
    const uint2 wn = load_words(drow, (j - 1) * TB + lane, steps, lane);
    unsigned out = 0u;
    unsigned we = __shfl_sync(FULL, w.x, TB - 1), wo = __shfl_sync(FULL, w.y, TB - 1);
#pragma unroll
    for (int i = TB - 1; i >= 0; --i) {
      const unsigned word = bit ? wo : we;
      if (i > 0) {  // the next step's words: off the chain
        we = __shfl_sync(FULL, w.x, i - 1);
        wo = __shfl_sync(FULL, w.y, i - 1);
      }
      const int pos = (PHASES - i % PHASES) % PHASES;  // `traceback_pos`
      out |= bit << i;
      const unsigned d = (word >> L) & 1u;
      bit = (L >> pos) & 1u;
      L = (L & ~(1u << pos)) | (d << pos);
    }
    const int t = j * TB + lane;
    if (lane < TB && t < steps) brow[t] = (int8_t)((out >> lane) & 1u);
    w = wn;
  }
  if (stamps != nullptr && lane == 0) stamps[3 * b + 2] = clock64();
}

}  // namespace

// lam [B, steps, 2] float32; wsigns [5, 32, 8] float32 (`warp_signs`); dec
// [B, dec_stride] int64 scratch, dec_stride = steps rounded up to a multiple
// of 5; bits [B, steps] int8; stamps [B, 3] int64 or NULL.
extern "C" int lq_viterbi(const void* lam, const void* wsigns, void* dec,
                          void* bits, void* stamps, int B, int steps,
                          int dec_stride, void* stream) {
  if (B < 1 || steps < 1 || dec_stride < (steps + PHASES - 1) / PHASES * PHASES)
    return static_cast<int>(cudaErrorInvalidValue);
  viterbi_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(lam), static_cast<const float*>(wsigns),
      static_cast<uint2*>(dec), static_cast<int8_t*>(bits),
      static_cast<long long*>(stamps), B, steps, dec_stride);
  return static_cast<int>(cudaGetLastError());
}
