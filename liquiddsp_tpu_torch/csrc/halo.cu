// Halo windows of a time-sharded stream.
//
// Replaces the TPU kernel liquiddsp_tpu/parallel/halo.py `_halo_dma_kernel`
// (entry `_window_with_halo_dma`), both halves: the shards of one card and the
// push across a process (or card) boundary. A stream row of n_time * T_local
// samples is cut into n_time time shards; shard s needs the window
//   [ its own T_local samples | the first ov samples of shard s + 1 ]
// so that a frame that starts in its block and runs into the next one can be
// decoded where it starts. The global last shard's tail is zero (end of
// stream).
//
// It is written as the TPU kernel is: the thread block that owns (shard s,
// row b) copies its own samples into its own window and PUSHES its head, the
// first ov of them, into the tail of the left neighbour's window. Local shards
// 1..n_time-1 push into this buffer; local shard 0 pushes into `peer`, the
// window buffer of the rank that holds the time block to the left (its last
// local window), mapped into this process by CUDA IPC, or nowhere when `peer`
// is NULL (global shard 0: the JAX ring's wrap-around tail is masked there).
// The owner of the global last shard (`zero_last`) zeroes its tail; a rank
// that is not last leaves its last tail to the push of the rank to its right.
// Each input sample is read once and each output sample written once. Exact:
// it only moves data.
//
// Bound on this card: bytes (8 read and 8 written per local sample, 8 more
// written per tail sample, no arithmetic). What the TPU kernel needed and
// this one does not: separate real and imaginary planes, ov rounded up to
// 128 and rows up to 8, DMA semaphores (across processes the caller orders
// the push: stream synchronise, then a barrier, before anyone decodes;
// parallel/peer.py), and the wrap-around copy of shard 0's head into the
// last shard that the caller then masked. Complex samples move as float2, or
// as float4 (16 bytes a thread) where source and destination share their
// 16-byte phase; a window row starts at a multiple of T_local + ov samples
// and its tail at column T_local, so either may sit on an odd sample, and the
// edges and the out-of-phase case take the 8-byte path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8192;  // samples of a row per thread block

// Copy n complex samples with all threads of the block.
__device__ __forceinline__ void copy_span(float2* __restrict__ dst,
                                          const float2* __restrict__ src,
                                          int n) {
  const int tid = threadIdx.x;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  if (((d ^ s) & 15) != 0) {  // out of phase: 8 bytes a thread
    for (int i = tid; i < n; i += THREADS) dst[i] = src[i];
    return;
  }
  const int head = ((s & 15) != 0 && n > 0) ? 1 : 0;  // up to a 16-byte edge
  const int nv = (n - head) / 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = tid; i < nv; i += THREADS) d4[i] = s4[i];
  if (tid == 0) {
    if (head) dst[0] = src[0];
    const int done = head + 2 * nv;
    if (done < n) dst[done] = src[done];
  }
}

__global__ void __launch_bounds__(THREADS)
halo_kernel(const float2* __restrict__ x, float2* win, float2* peer, int B,
            int n_time, int t_local, int ov, long long row_stride,
            int zero_last) {
  const int sb = blockIdx.x;  // shard * B + row
  const int s = sb / B;
  const int b = sb - s * B;
  const int j0 = blockIdx.y * CHUNK;
  const int n = min(CHUNK, t_local - j0);
  const size_t w = (size_t)t_local + ov;
  const float2* src = x + (size_t)b * row_stride + (size_t)s * t_local + j0;

  // the local copy: my samples into my window
  copy_span(win + (size_t)sb * w + j0, src, n);

  const int nh = min(n, ov - j0);  // samples of this chunk that lie in the head
  if (nh <= 0) return;
  // the push: my head into the tail of the left neighbour's window, on this
  // rank or, for my first shard, in the left rank's buffer
  if (s > 0)
    copy_span(win + (size_t)(sb - B) * w + t_local + j0, src, nh);
  else if (peer != nullptr)
    copy_span(peer + ((size_t)(n_time - 1) * B + b) * w + t_local + j0, src, nh);
  // nobody pushes into the global last shard: its owner zeroes the tail
  if (zero_last && s == n_time - 1) {
    float2* tail = win + (size_t)sb * w + t_local + j0;
    for (int i = threadIdx.x; i < nh; i += THREADS)
      tail[i] = make_float2(0.f, 0.f);
  }
}

}  // namespace

// x [B, >= n_time * t_local] complex64 with rows row_stride samples apart ->
// win [n_time, B, t_local + ov] complex64. `peer` is the base of the left
// rank's window buffer in the same layout (NULL: no rank to the left, as in
// one process); `zero_last` says that this rank holds the global last shard.
// Needs 0 <= ov <= t_local.
extern "C" int lq_halo_windows(const void* x, void* win, void* peer, int B,
                               int n_time, int t_local, int ov,
                               long long row_stride, int zero_last,
                               void* stream) {
  dim3 grid(n_time * B, (t_local + CHUNK - 1) / CHUNK);
  halo_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(win),
      static_cast<float2*>(peer), B, n_time, t_local, ov, row_stride,
      zero_last);
  return static_cast<int>(cudaGetLastError());
}
