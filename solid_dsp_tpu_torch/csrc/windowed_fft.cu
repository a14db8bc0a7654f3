// Windowed 4096-point FFT for Hopper (sm_90a): K7.
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_fft.py::
// make_fused_windowed_fft (kernel body _make_fft_kernel): each frame of F
// frames is multiplied by an analysis window and transformed,
//
//   Y[f, k] = sum_n w[n] x[f, n] e^{sign 2 pi i n k / 4096},
//
// unnormalized, in natural bin order.  Two layouts, a template parameter:
// planar (2, F, N) f32 planes in, (F, 2N) [Re | Im] rows out (the contract of
// windowed_fft_planar), or complex64 (F, N) in and out (windowed_fft).
//
// Bound: memory.  A frame is 32 KB in and 32 KB out against 5 N log2 N =
// 246 kFLOP, about 3.8 FLOP a byte, far below the card's FP32 ridge.  So the
// frame is read once, with the window applied at the first pass, and written
// once, and the design keeps the memory system busy while blocks compute.
//
// Design: persistent blocks of 256 threads, three an SM (the grid is what
// the SMs hold), each walking frames f = blockIdx.x, += gridDim.x.  A block
// owns a 32 KB input slot and a 32 KB work buffer in dynamic shared memory.
// One thread fills the slot with TMA bulk copies (cp.async.bulk, completion
// on an mbarrier): one 32 KB copy for a complex frame, two 16 KB copies for
// the planar re and im rows.  Three radix-16 Stockham passes (N = 16^3)
// transform the frame: thread j owns butterfly j of each pass, reads the 16
// points j + 256 r, applies the pass's twiddles (the window, kept in
// registers, in pass 1), takes a 16-point DFT in registers (4 x 4 with the
// internal W16 twiddles, in place) and writes its outputs at the Stockham
// positions.  Pass 1 reads the slot, so the next frame's copy into it
// starts right after and lands while passes 2 and 3 run in the work
// buffer; pass 3 writes natural order, in the output row's own layout, and
// one thread stores the buffer with one 32 KB bulk copy (after
// fence.proxy.async) that drains while the block starts the next frame.
// Between passes the frame sits in the buffer with an XOR swizzle,
// i ^ ((i >> 4) & 15), so pass 1's stride-16 stores and every other access
// are free of bank conflicts in exactly 32 KB.  Shared memory (64 KB a
// block) and registers (at most 80 a thread) are sized for three blocks an
// SM.  The TPU kernel's 32 x 128 four-step, its block-diagonal stage-A bank
// and the transpose outside the kernel exist only for Mosaic's 128-lane
// rule and have no counterpart here.
//
// Accuracy: every twiddle comes from the table tw[m] = e^{sign 2 pi i m /
// 4096} that the host builds in float64 and rounds to f32: the internal
// W16 ones directly, the passes' W^m as tw[64 (m / 64)] tw[m % 64], two
// exact table entries kept in shared memory (1 KB) and multiplied in f32
// (about one rounding more).  The kernel forms each table index as an
// exact integer below 4096; no sin/cos runs on the device.  "x3" and
// "fast" both run this FP32 arithmetic: the transform is bound by bytes, so
// a bf16 pass buys nothing.  Bulk copies need 16-byte-aligned addresses;
// the launcher refuses others.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kN = 4096;
constexpr int kThreads = kN / 16;          // butterflies a pass
constexpr int kBlocksPerSm = 3;
constexpr unsigned kFrameBytes = kN * 8;   // one complex frame, 32 KB
constexpr int kTwLo = 64;                  // twiddles W^m = hi[m / 64] lo[m % 64]
constexpr int kSmemBytes = 2 * kFrameBytes + 2 * kTwLo * 8 + 8;  // slot, buffer,
                                                             // tables, barrier

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (S i): the 4-point DFT's W4 = e^{S 2 pi i / 4}
template <int S>
__device__ __forceinline__ float2 rot(float2 a) {
  return S < 0 ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
}

template <int S>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = rot<S>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// In-place 16-point DFT of v in natural order: n = 4 n1 + n2, k = k1 + 4 k2,
// w16[m] = W16^m for the products m = n2 k1 in 1..9.  X[k] lands in
// v[out16(k)] (no copy back: the callers' unrolled loops index through it).
__host__ __device__ constexpr int out16(int k) { return 4 * (k & 3) + (k >> 2); }

template <int S>
__device__ __forceinline__ void dft16(float2 (&v)[16], const float2 (&w16)[10]) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4<S>(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
  // v[4 k1 + n2] now holds the k1-th output of column n2
#pragma unroll
  for (int k1 = 1; k1 < 4; ++k1)
#pragma unroll
    for (int n2 = 1; n2 < 4; ++n2) v[4 * k1 + n2] = cmul(v[4 * k1 + n2], w16[n2 * k1]);
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
    dft4<S>(v[4 * k1], v[4 * k1 + 1], v[4 * k1 + 2], v[4 * k1 + 3]);
  // v[4 k1 + k2] = X[k1 + 4 k2]
}

// One Stockham pass over the swizzled buffer with sub-transform size Ns (16
// or 256): twiddle W^m, m = step r < 4096, from the two shared tables
// (tw_hi[m / 64] tw_lo[m % 64], both exact entries of the float64-built
// table), then the 16-point DFT; the results stay in v.
template <int S, int Ns>
__device__ __forceinline__ void pass_from_shared(const float2* buf, int j,
                                                 const float2* tw_lo,
                                                 const float2* tw_hi,
                                                 const float2 (&w16)[10],
                                                 float2 (&v)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = buf[swz(j + r * kThreads)];
  const int step = (j % Ns) * (kN / (16 * Ns));
#pragma unroll
  for (int r = 1; r < 16; ++r) {
    const int m = step * r;
    v[r] = cmul(v[r], cmul(tw_hi[m >> 6], tw_lo[m & (kTwLo - 1)]));
  }
  dft16<S>(v, w16);
}

// Thread 0: start frame f's copy into slot s (completion on bar).
template <bool kPlanar>
__device__ __forceinline__ void issue_frame(const float* x, long long F,
                                            long long f, unsigned slot,
                                            unsigned bar) {
  mbar_expect_tx(bar, kFrameBytes);
  if (kPlanar) {
    bulk_load(slot, x + f * kN, kFrameBytes / 2, bar);
    bulk_load(slot + kFrameBytes / 2, x + (F + f) * kN, kFrameBytes / 2, bar);
  } else {
    bulk_load(slot, x + 2 * f * kN, kFrameBytes, bar);
  }
}

// x: planar (2, F, N) or complex (F, N) as float pairs; w (N,) window; tw
// (N,) float2 table; y: planar (F, 2N) [Re | Im] or complex (F, N).
template <int S, bool kPlanar>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
windowed_fft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float2* __restrict__ tw, float* __restrict__ y,
                    long long F) {
  extern __shared__ __align__(128) unsigned char smem[];
  float2* slot = reinterpret_cast<float2*>(smem);            // staged input
  float2* buf = slot + kN;                                    // the passes
  float2* tw_lo = buf + kN;
  float2* tw_hi = tw_lo + kTwLo;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(tw_hi + kTwLo);
  const int j = threadIdx.x;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long n_local = first < F ? (F - 1 - first) / stride + 1 : 0;

  if (j == 0) {
    mbar_init(smem_addr(bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (n_local > 0)
      issue_frame<kPlanar>(x, F, first, smem_addr(slot), smem_addr(bar));
  }
  if (j < kTwLo) {
    tw_lo[j] = __ldg(tw + j);
    tw_hi[j] = __ldg(tw + kTwLo * j);
  }
  __syncthreads();

  float2 w16[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) w16[m] = __ldg(tw + m * (kN / 16));
  float wn[16];                              // this thread's window points
#pragma unroll
  for (int r = 0; r < 16; ++r) wn[r] = __ldg(w + j + r * kThreads);

  for (long long t = 0; t < n_local; ++t) {
    const long long f = first + t * stride;
    // the previous frame's store must have read buf before pass 1 writes it
    if (j == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    mbar_wait(smem_addr(bar), static_cast<unsigned>(t & 1));

    // pass 1 (Ns = 1): the staged frame with the window, no twiddle
    float2 v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int n = j + r * kThreads;
      float2 a;
      if (kPlanar) {
        const float* p = reinterpret_cast<const float*>(slot);
        a = make_float2(p[n], p[kN + n]);
      } else {
        a = slot[n];
      }
      v[r] = make_float2(a.x * wn[r], a.y * wn[r]);
    }
    dft16<S>(v, w16);
    __syncthreads();                   // the slot is read, buf is free
    if (j == 0 && t + 1 < n_local)     // the next frame lands meanwhile
      issue_frame<kPlanar>(x, F, f + stride, smem_addr(slot), smem_addr(bar));
#pragma unroll
    for (int r = 0; r < 16; ++r) buf[swz(16 * j + r)] = v[out16(r)];
    __syncthreads();

    // pass 2 (Ns = 16), in place: every read before any write
    pass_from_shared<S, 16>(buf, j, tw_lo, tw_hi, w16, v);
    __syncthreads();
    const int d = (j / 16) * 256 + (j % 16);
#pragma unroll
    for (int r = 0; r < 16; ++r) buf[swz(d + 16 * r)] = v[out16(r)];
    __syncthreads();

    // pass 3 (Ns = 256): natural order, in the output row's layout
    pass_from_shared<S, 256>(buf, j, tw_lo, tw_hi, w16, v);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int k = j + r * kThreads;
      if (kPlanar) {
        float* p = reinterpret_cast<float*>(buf);
        p[k] = v[out16(r)].x;
        p[kN + k] = v[out16(r)].y;
      } else {
        buf[k] = v[out16(r)];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (j == 0) bulk_store(y + 2 * f * kN, smem_addr(buf), kFrameBytes);
  }
  if (j == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int S, bool kPlanar>
int launch_one(const float* x, const float* w, const float2* tw, float* y,
               long long F, int device, cudaStream_t stream) {
  auto kernel = windowed_fft_kernel<S, kPlanar>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = F < (long long)sms * per_sm ? F : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, kThreads, kSmemBytes, stream>>>(x, w, tw, y, F);
  return (int)cudaGetLastError();
}

template <int S>
int launch(const float* x, const float* w, const float2* tw, float* y,
           long long F, int planar, int device, cudaStream_t stream) {
  return planar ? launch_one<S, true>(x, w, tw, y, F, device, stream)
                : launch_one<S, false>(x, w, tw, y, F, device, stream);
}

}  // namespace

// K7.  x: planar (2, F, 4096) f32 (planar = 1) or complex64 (F, 4096) read
// as f32 pairs (planar = 0); w (4096,) f32; tw (4096, 2) f32, the table
// e^{sign 2 pi i m / 4096}; y: (F, 8192) f32 [Re | Im] (planar) or complex64
// (F, 4096).  sign is -1 (forward) or +1.  Contiguous, on card `device`; x
// and y 16-byte aligned (the bulk copies' rule).  Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t.
extern "C" int windowed_fft_launch(const float* x, const float* w,
                                   const float* tw, float* y, long long F,
                                   int planar, int sign, int device,
                                   cudaStream_t stream) {
  if (F <= 0 || F > 0x7fffffffLL || (sign != 1 && sign != -1) ||
      (reinterpret_cast<unsigned long long>(x) & 15) ||
      (reinterpret_cast<unsigned long long>(y) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  return sign < 0 ? launch<-1>(x, w, tw2, y, F, planar, device, stream)
                  : launch<1>(x, w, tw2, y, F, planar, device, stream);
}
