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
// 128 and rows up to 8, and the wrap-around copy of shard 0's head into the
// last shard that the caller then masked. Each thread issues 4 loads of 16
// bytes before their stores, and a block takes 2,048 samples of a row:
// [8, 262144] in 4 shards, a rank's block across two processes, is 1,024
// blocks of 256 threads, enough to fill the 132 SMs. At these sizes (tens of
// MB) the kernel moves its bytes about as fast as the card copies a tensor
// of that size (profile_halo.py), near half of the memory's peak rate: a
// launch, its ramp-up and its tail take a few microseconds whatever the
// loop. A window row starts at a multiple of T_local + ov samples and its
// tail at column T_local, so either may sit on an odd sample: loads are 16
// bytes past an odd first sample, stores 16 bytes where source and
// destination share their 16-byte phase and two of 8 bytes where not.
//
// Across processes the TPU kernel's DMA semaphores become flags on the card
// (the order of a step is in parallel/peer.py): monotone 64-bit counters in
// the memory of the rank that receives, `arrived[i]` and `free[i]` for each
// of its two window buffers. lq_halo_windows_signal is the halo kernel that,
// once its push has landed, sets the left rank's `arrived[i]`: every block
// that pushes fences its writes (fence.acq_rel.sys) and counts itself in a
// per-launch counter, and the last of them fences again, resets the
// counter for the next launch and stores the flag with st.release.sys.
// lq_halo_order is the receive semaphore's wait: one thread that first
// stores a flag (a rank's own `free[i]`, releasing a buffer) and then polls
// another with ld.acquire.sys and __nanosleep until it reaches a value. Its
// stream holds every later launch until then; the host is not involved.
// Why in a kernel and not by CUDA's stream memory operations
// (cuStreamWaitValue64 / cuStreamWriteValue64): on the H100 this was built
// for, CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1 (92) reads 0 (driver
// 13000), so the flags are written and read by kernels alone, and the
// library needs no driver entry point. A polling thread holds one warp of
// one SM while it waits; where two processes time-slice one card, it also
// holds its process's slice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                    // 16-byte loads in flight a thread
constexpr int CHUNK = 2 * UNROLL * THREADS;  // samples of a row per thread block

// Copy n complex samples with all threads of the block. The loads are 16
// bytes from src (past an odd first sample), UNROLL of them issued a thread
// before their stores; a store is 16 bytes where dst shares src's 16-byte
// phase, else two of 8 bytes.
__device__ __forceinline__ void copy_span(float2* __restrict__ dst,
                                          const float2* __restrict__ src,
                                          int n) {
  const int tid = threadIdx.x;
  const int head =
      ((reinterpret_cast<uintptr_t>(src) & 15) != 0 && n > 0) ? 1 : 0;
  const int nv = (n - head) / 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float2* d = dst + head;
  const bool wide = (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  for (int base = 0; base < nv; base += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + tid;
      if (i < nv) v[u] = s4[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + tid;
      if (i < nv) {
        if (wide) {
          reinterpret_cast<float4*>(d)[i] = v[u];
        } else {
          d[2 * i] = make_float2(v[u].x, v[u].y);
          d[2 * i + 1] = make_float2(v[u].z, v[u].w);
        }
      }
    }
  }
  if (tid == 0) {
    if (head) dst[0] = src[0];
    const int done = head + 2 * nv;
    if (done < n) dst[done] = src[done];
  }
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p,
                                                  unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

// SIGNAL: once every pushing block's writes are fenced, the last of them
// stores `value` into `signal` (the left rank's arrived flag) and resets
// `count`. The local copy is read only by this rank's later launches.
template <bool SIGNAL>
__global__ void __launch_bounds__(THREADS)
halo_kernel(const float2* __restrict__ x, float2* win, float2* peer, int B,
            int n_time, int t_local, int ov, long long row_stride,
            int zero_last, unsigned long long* signal,
            unsigned long long value, unsigned long long* count) {
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
  if (nh > 0) {
    // the push: my head into the tail of the left neighbour's window, on
    // this rank or, for my first shard, in the left rank's buffer
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
  // the blocks that push into `peer` (shard 0's chunks of the head; at
  // least its first chunk, so that a push of nothing still signals)
  const int head_chunks = max(1, (ov + CHUNK - 1) / CHUNK);
  if (SIGNAL && s == 0 && (int)blockIdx.y < head_chunks) {
    __syncthreads();  // the block's writes, then one thread fences them
    if (threadIdx.x == 0) {
      fence_sys();
      if (atomicAdd(count, 1ull) == (unsigned long long)B * head_chunks - 1) {
        fence_sys();  // every block's fenced writes before the flag
        atomicExch(count, 0ull);
        store_release_sys(signal, value);
      }
    }
  }
}

__global__ void halo_order_kernel(unsigned long long* signal,
                                  unsigned long long signal_value,
                                  const unsigned long long* wait,
                                  unsigned long long wait_value) {
  if (signal != nullptr) store_release_sys(signal, signal_value);
  if (wait != nullptr) {
    unsigned ns = 64;
    while (load_acquire_sys(wait) < wait_value) {
      __nanosleep(ns);
      ns = min(2 * ns, 1024u);
    }
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
  halo_kernel<false><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(win),
      static_cast<float2*>(peer), B, n_time, t_local, ov, row_stride,
      zero_last, nullptr, 0, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// lq_halo_windows, then `value` stored into the 64-bit flag `signal` once
// every write of the launch is visible to the whole system. `count` is a
// 64-bit word on this card that is 0 before the launch and is 0 again after
// it; launches that share it must share a stream.
extern "C" int lq_halo_windows_signal(const void* x, void* win, void* peer,
                                      int B, int n_time, int t_local, int ov,
                                      long long row_stride, int zero_last,
                                      void* signal, unsigned long long value,
                                      void* count, void* stream) {
  dim3 grid(n_time * B, (t_local + CHUNK - 1) / CHUNK);
  halo_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(win),
      static_cast<float2*>(peer), B, n_time, t_local, ov, row_stride,
      zero_last, static_cast<unsigned long long*>(signal), value,
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// Store `signal_value` into the 64-bit flag `signal` (skipped when NULL),
// then hold the stream until the flag `wait` reaches `wait_value` (no wait
// when NULL). Either flag may lie in another process's memory, mapped by
// CUDA IPC.
extern "C" int lq_halo_order(void* signal, unsigned long long signal_value,
                             const void* wait, unsigned long long wait_value,
                             void* stream) {
  halo_order_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(signal), signal_value,
      static_cast<const unsigned long long*>(wait), wait_value);
  return static_cast<int>(cudaGetLastError());
}
