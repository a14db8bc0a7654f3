// The time-sharded channelizer front end with its halo exchange fused in,
// for Hopper (sm_90a): K9.
//
// Replaces solid_dsp_tpu/parallel/pallas_halo.py::make_fused_channelizer_frontend
// (kernel body _fused_kernel).  Each time shard holds U frame rows of its slab
// x (U, 2M) (complex64 read as interleaved floats) and computes K5's branch
// products (csrc/channelizer.cu)
//
//   z[u, l] = sum_{k=0..K} h[k, l] * row(u - k)[l]
//
// where row(r) for r < 0 is row K + r of the halo: the left neighbour's last
// K rows, or, on shard 0, the carried tail rows.  On the TPU one kernel
// starts an RDMA of its last K rows to the right neighbour, computes the
// interior rows meanwhile and finishes rows [0, K) once its own halo has
// arrived.  Here the halo moves inside one kernel launch the same way:
//
//   * block 0 first stores this shard's last K rows into the right
//     neighbour's halo slot and publishes the block's epoch in the
//     neighbour's flag word (__threadfence_system, then a release store at
//     system scope): the remote copy's start;
//   * blocks 1 .. n_tiles compute the interior rows [K, U) from local x
//     while the copy is in flight;
//   * the last block waits, with acquire loads of its own flag word, until
//     the flag holds this block's epoch, computes rows [0, K) from
//     [halo | x[:K]], and acknowledges the slot in its own ack word.  Shard 0
//     reads the carried tail rows and never waits; the last shard sends
//     nothing (the TPU kernel's wrap-around send only keeps its ring matched).
//
// Each shard owns one region (cudaMalloc'd once at setup, never a tensor of
// PyTorch's caching allocator): a header of flag[2] and ack[2] words and two
// halo slots of K x 2M floats, by block parity.  The right neighbour's region
// is a plain pointer when shards share a card, or one opened through CUDA IPC
// when it lives in another process.  The epoch is the stream's block counter
// (1, 2, ...), so a shard never reads an earlier block's halo, and no host
// barrier is needed between blocks.  A sender overwrites slot e & 1 only once
// the neighbour has acknowledged epoch e - 2 from it, so a shard that runs
// ahead of its right neighbour waits instead of overwriting a halo not yet
// read.
//
// Forward progress: only block 0 (the sender, which waits at most for a
// neighbour's earlier epoch) and the last block spin, and the waiting block
// is the highest index, so every other block of the grid has been scheduled
// before it; the sender's store and publish are the first thing block 0 does.
// Shards that share a card must launch on different streams.  A wait that
// outlasts kTimeoutNs (a lost neighbour) traps, which fails the launch's
// stream with an error instead of hanging the card.
//
// Bound: memory, as K5.  Each sample is read once and each output written
// once (16 bytes a complex sample in and out) against 2 (K + 1) FLOPs a real
// lane; the halo adds K x 2M floats (16 KiB at M = 256, K = 8).  The
// arithmetic is K5's: one thread a real lane and 32 rows, the taps and the
// row window in registers, FP32 FMA in the TPU kernel's tap order, so K9's z
// equals K5's on the same [halo | x] bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;              // K <= 8, as K5's fast path
constexpr int kRows = 32;                // interior rows a thread
constexpr int kThreads = 128;
constexpr long long kHeaderBytes = 256;  // flag[2], ack[2], padding
constexpr unsigned long long kTimeoutNs = 60ull * 1000 * 1000 * 1000;

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin (one thread) until *p >= want; trap after kTimeoutNs.
__device__ void wait_at_least(const unsigned long long* p,
                              unsigned long long want) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire_sys(p) < want) {
    __nanosleep(128);
    if (now_ns() - t0 > kTimeoutNs) __trap();
  }
  __threadfence_system();
}

// Outputs of rows u0 .. u0+R-1 of lane l: rows of `lanes` floats; rows >= U
// read as 0, rows in [-nt, 0) from the nt halo rows (read through L2: another
// kernel or card wrote them during this launch), rows before those as 0
// (their taps are 0).  h[0..8] are lane l's taps, zero past K.  Sums in the
// TPU kernel's order, tap 0 first (csrc/channelizer.cu::branch_rows).
template <int R>
__device__ __forceinline__ void branch_rows(
    const float* __restrict__ x, const float* halo, int nt, int lanes,
    long long U, const float (&h)[kMaxTaps + 1], long long u0, int l,
    float (&out)[R]) {
  float win[R + kMaxTaps];
#pragma unroll
  for (int j = 0; j < R + kMaxTaps; ++j) {
    const long long r = u0 - kMaxTaps + j;
    float v = 0.f;
    if (r >= 0) {
      if (r < U) v = __ldg(x + r * lanes + l);
    } else if (r >= -nt) {
      v = __ldcg(halo + (nt + r) * lanes + l);
    }
    win[j] = v;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k <= kMaxTaps; ++k) acc = fmaf(h[k], win[kMaxTaps + i - k], acc);
    out[i] = acc;
  }
}

__device__ __forceinline__ void lane_taps(const float* __restrict__ h,
                                          int lanes, int K, int l,
                                          float (&hl)[kMaxTaps + 1]) {
#pragma unroll
  for (int k = 0; k <= kMaxTaps; ++k) hl[k] = k <= K ? __ldg(h + k * lanes + l) : 0.f;
}

// Grid: block 0 sends, blocks 1 .. n_tiles compute the interior (tile t - 1
// is lane group (t - 1) % groups, row tile (t - 1) / groups), block
// n_tiles + 1 waits for the halo and computes rows [0, K).
__global__ void __launch_bounds__(kThreads)
halo_frontend_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                     const float* __restrict__ h, float* __restrict__ z,
                     long long U, int lanes, int K, unsigned char* mine,
                     unsigned char* right, unsigned long long epoch, int first,
                     long long n_tiles, int groups) {
  const long long b = blockIdx.x;
  const int slot = (int)(epoch & 1);
  const long long slot_floats = (long long)K * lanes;

  if (b == 0) {                              // the remote copy's start
    if (right == nullptr) return;
    auto* rw = reinterpret_cast<unsigned long long*>(right);
    if (threadIdx.x == 0 && epoch > 2) wait_at_least(rw + 2 + slot, epoch - 2);
    __syncthreads();
    float* dst = reinterpret_cast<float*>(right + kHeaderBytes) + slot * slot_floats;
    const float* src = x + (U - K) * lanes;
    for (long long i = threadIdx.x; i < slot_floats; i += kThreads) dst[i] = __ldg(src + i);
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) st_release_sys(rw + slot, epoch);
    return;
  }

  if (b <= n_tiles) {                        // interior rows, local x only
    const long long t = b - 1;
    const int l = (int)(t % groups) * kThreads + threadIdx.x;
    if (l >= lanes) return;
    float hl[kMaxTaps + 1];
    lane_taps(h, lanes, K, l, hl);
    const long long u0 = K + (t / groups) * kRows;
    float out[kRows];
    branch_rows<kRows>(x, nullptr, 0, lanes, U, hl, u0, l, out);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (u0 + i < U) z[(u0 + i) * lanes + l] = out[i];
    return;
  }

  // rows [0, K): the halo, or shard 0's carried tail
  auto* mw = reinterpret_cast<unsigned long long*>(mine);
  const float* halo = tail;
  if (!first) {
    if (threadIdx.x == 0) wait_at_least(mw + slot, epoch);
    __syncthreads();
    halo = reinterpret_cast<const float*>(mine + kHeaderBytes) + slot * slot_floats;
  }
  for (int l = threadIdx.x; l < lanes; l += kThreads) {
    float hl[kMaxTaps + 1];
    lane_taps(h, lanes, K, l, hl);
    float out[kMaxTaps];
    branch_rows<kMaxTaps>(x, halo, K, lanes, U, hl, 0, l, out);
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i)
      if (i < K) z[(long long)i * lanes + l] = out[i];
  }
  if (!first) {                              // the slot may be reused
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      st_release_sys(mw + 2 + slot, epoch);
    }
  }
}

}  // namespace

// A zeroed region of `bytes` on card `device` (header and two halo slots).
extern "C" int halo_region_alloc(long long bytes, int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(out, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*out, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

extern "C" int halo_region_free(void* p, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(p);
  return (int)err;
}

// The region's CUDA IPC handle (64 bytes) into `handle`.
extern "C" int halo_ipc_handle(void* p, int device, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(reinterpret_cast<cudaIpcMemHandle_t*>(handle), p);
  return (int)err;
}

// Open another process's region from its handle, on card `device`.
extern "C" int halo_ipc_open(const void* handle, int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(out, *reinterpret_cast<const cudaIpcMemHandle_t*>(handle),
                               cudaIpcMemLazyEnablePeerAccess);
  return (int)err;
}

extern "C" int halo_ipc_close(void* p, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(p);
  return (int)err;
}

// K9.  x (U, 2M) complex64 rows read as interleaved f32, tail (K, 2M) the
// carried rows (read on shard 0 only), h (K+1, 2M) f32 (pfb_frontend_taps),
// z (U, 2M) f32; 1 <= K <= 8 and U > K.  mine: this shard's region;
// right: the right neighbour's region, or null on the last shard; epoch:
// this block's number, from 1; first: 1 on shard 0.  Contiguous, on card
// `device`.  Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int halo_frontend_launch(const float* x, const float* tail,
                                    const float* h, float* z, long long U,
                                    int M, int K, void* mine, void* right,
                                    unsigned long long epoch, int first,
                                    int device, cudaStream_t stream) {
  if (M <= 0 || K < 1 || K > kMaxTaps || U <= K || epoch == 0 || mine == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int lanes = 2 * M;
  const int groups = (lanes + kThreads - 1) / kThreads;
  const long long n_tiles = (long long)groups * ((U - K + kRows - 1) / kRows);
  halo_frontend_kernel<<<(unsigned)(n_tiles + 2), kThreads, 0, stream>>>(
      x, tail, h, z, U, lanes, K, static_cast<unsigned char*>(mine),
      static_cast<unsigned char*>(right), epoch, first, n_tiles, groups);
  return (int)cudaGetLastError();
}
