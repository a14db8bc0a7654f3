// Unrotated DDC body for Hopper (sm_90a): K2 and K3 on the tensor cores, in
// TF32 x3 or in the TPU kernels' single bf16 pass ("fast").
//
// Replaces two TPU kernels of solid_dsp_tpu/ops/pallas_ddc.py:
//   * make_pallas_ddc_full (K2, kernel body _make_kernel_full): the body of
//     a block whose length is a multiple of 64*M, tail row included;
//   * make_pallas_ddc_body (K3, kernel body _make_kernel): the same body
//     over the interior of any other block.  K3 exists on the TPU because
//     a sliced Pallas operand costs a full copy there; this kernel reads
//     any block length and the carried tail in place, so K3's counterpart
//     is this kernel launched on an unaligned block (ops/cuda_ddc.py counts
//     the two routes apart).
//
// For the planar (2, L) f32 block x, the carried tail x[-D .. -1]
// (D = n - M, none when n <= M) and the complex NCO-folded bandpass taps h
// it computes, for
// every decimated output t = 0 .. T-1 (T = L / M, any L that M divides),
//
//   z[t] = sum_i h[i] * x[t*M - D + i]
//
// and writes z as (2, T) f32 [re row; im row].  The caller rotates z at
// the decimated rate, or feeds it to a rotation-invariant epilogue; energy
// and the last sample are torch reductions in the glue (ops/ddc.py).
//
// The block is float32 planes, or the raw interleaved int16 (L, 2) of a
// ci16 recording (the *_i16 entry points: ddc_tc.cuh's kI16 stages and
// ddc_direct.cuh's int16 words, converted in registers to the planes'
// values bit for bit).
//
// Bound: bytes (8 a sample in, 8 an output out: 0.050 ms at L = 2^24 on an
// H100 SXM; int16 in, 4 a sample: 0.030 ms).  The earlier design (FP32 FMA fed from shared memory, two
// shared loads for four FMAs) ran at 30 % of it, held by shared-memory
// bandwidth.  Design: the banded-Toeplitz frame product on the tensor cores
// of ddc_tc.cuh (shared with the fused DDC + FM kernel, ddc_fm.cu), in
// either mode (fast: the pallas kernels' mode="fast", samples and bank in
// bf16 with f32 sums, one wgmma a 16-sample k-step, the bank a quarter of
// x3's shared memory), with an epilogue that stores the sums: the bank's columns are
// [re | im] of the P outputs of a frame, and outputs past T are not stored,
// so any L that M divides works, L shorter than the filter included.  P is
// the smallest power of two >= 4 with hop = P*M >= 64, or less where the
// bank and stages do not fit shared memory: fewer outputs a frame cost
// fewer FLOPs a sample (24 P KP / hop: 768 at n = 64, M = 4, 0.026 ms of
// TF32 at 2^24).
// What holds it (PERF.md): the tensor cores' TF32 rate at N = 32, about a
// third of the peak; P = 8 (N = 16) and one warpgroup a block are slower
// (torch_kernel_sweep.py), and so were a double-width hi.[hi | lo]
// product, a third fragment set in flight and paired 8-byte stores.  The
// banded bank's zero column blocks are a quarter of the products at
// n = 64, M = 4; skipping them by branching at run time to half-width
// products was slower, so the skip has to be fixed at compile time.
// Large decimations (M >~ 100 at 64 taps and more: the bank and the spans of
// 64 frames no longer fit one block's shared memory) take the "direct"
// route (ops/cuda_ddc.py::body_geometry): a warp an output at a time, the
// warp dot of ddc_direct.cuh (lane l summing taps l, l + 32, ... of the
// output's window in FP32 FMA, fast: every sample and tap rounded to bf16
// first, products exact, f32 sums; the 32 partial sums added by a butterfly
// of shuffles), which K1's direct route (ddc_fm.cu) shares.  A warp's lanes
// read consecutive samples, straight from device memory (the windows'
// overlap, n - M samples, comes from L2); no shared memory, so the route
// takes every (n, M) the JAX package's predicates give K2/K3.  A first
// design (the block's span staged as M polyphase rows, 32 threads a block
// at M ~ 128-200 to fit them) took 1.9-2.5 ms at 2^24 samples: one warp an
// SM, each staged load's latency exposed (PERF.md).

#include <cuda_runtime.h>

#include <type_traits>

#include "ddc_direct.cuh"
#include "ddc_tc.cuh"

namespace {

// Stores the tile's sums as z (2, T): columns [0, P) the real parts of the
// frame's outputs, [P, 2P) the imaginary parts.
template <int P>
struct StoreZ {
  static constexpr bool kPre = false;
  float* z;

  template <class Span>
  __device__ __forceinline__ void from_span(const Geom&, long long,
                                            const Span&, int, int) {}

  __device__ __forceinline__ void tile(const Geom& g, long long tau,
                                       float (&acc)[P], int w, int lane) {
    const int r = lane >> 2, c = lane & 3;
    // acc[4 j + 2 h + e]: frame row 16 w + r + 8 h, column 8 j + 2 c + e
#pragma unroll
    for (int j = 0; j < P / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          const int plane = col >= P;
          const long long t =
              (tau * kFrames + 16 * w + r + 8 * h) * P + (col - plane * P);
          if (t < g.T) z[plane * g.T + t] = acc[4 * j + 2 * h + e];
        }
  }
};

template <int P, bool kFast, bool kI16>
__global__ void __launch_bounds__(256, 1)
ddc_body_tc_kernel(const void* __restrict__ x, const float* __restrict__ tail,
                   const float* __restrict__ bank, float* __restrict__ z,
                   const Geom g, long long n_tiles, int wgs, int stages,
                   unsigned bank_bytes) {
  StoreZ<P> epi{z};
  ddc_tc_run<P, kFast, kI16>(x, tail, bank, g, n_tiles, wgs, stages,
                             bank_bytes, epi);
}

template <int P, bool kI16>
int launch(const void* x, const float* tail, const float* bank, float* z,
           const Geom& g, int wgs, int stages, unsigned bank_bytes, size_t smem,
           bool fast, int device, cudaStream_t stream) {
  auto kernel = fast ? ddc_body_tc_kernel<P, true, kI16>
                     : ddc_body_tc_kernel<P, false, kI16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long frames = (g.T + P - 1) / P;
  const long long n_tiles = (frames + kFrames - 1) / kFrames;
  long long blocks = (n_tiles + wgs - 1) / wgs;
  if (blocks > sm_count(device)) blocks = sm_count(device);
  kernel<<<(unsigned)blocks, 128 * wgs, smem, stream>>>(x, tail, bank, z, g,
                                                         n_tiles, wgs, stages,
                                                         bank_bytes);
  return (int)cudaGetLastError();
}

constexpr int kDirectThreads = 256;   // threads a block, direct route

// The direct route: z[t] for t = warp, warp + warps, ..., each the warp
// dot of ddc_direct.cuh over the window x[t M + M - n + i]; X is float
// (planes) or unsigned (int16 words).
template <class X>
__global__ void __launch_bounds__(kDirectThreads)
ddc_body_direct_kernel(const X* __restrict__ x, const float* __restrict__ tail,
                       const float* __restrict__ taps, float* __restrict__ z,
                       long long L, long long T, int n, int M, int fast) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int D = n > M ? n - M : 0;
  for (long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       t < T; t += warps) {
    float zr, zi;
    warp_dot(x, tail, taps, L, D, n, t * M + M - n, lane, fast != 0, zr, zi);
    if (lane == 0) {
      z[t] = zr;
      z[T + t] = zi;
    }
  }
}

template <bool kI16>
int direct_launch(const void* x, const float* tail, const float* taps, float* z,
                  long long L, int n, int M, int fast, int device,
                  cudaStream_t stream) {
  if (M <= 0 || n < 1 || L <= 0 || L % M != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long T = L / M;
  const long long per_block = kDirectThreads / 32;
  long long blocks = (T + per_block - 1) / per_block;
  const long long most = 16LL * sm_count(device);   // 64 warps an SM
  if (blocks > most) blocks = most;
  using X = std::conditional_t<kI16, unsigned, float>;
  ddc_body_direct_kernel<X><<<(unsigned)blocks, kDirectThreads, 0, stream>>>(
      static_cast<const X*>(x), tail, taps, z, L, T, n, M, fast);
  return (int)cudaGetLastError();
}

template <bool kI16>
int tc_launch(const void* x, const float* tail, const float* bank, float* z,
              long long L, int n, int M, int P, int hpad, int KP, int wgs,
              int stages, int smem, int fast, int device, cudaStream_t stream) {
  if (M <= 0 || n < 1 || L <= 0 || L % M != 0 || hpad < n - M || hpad < 0 ||
      hpad % 4 ||
      KP % 32 || KP < hpad + P * M || (wgs != 1 && wgs != 2) ||
      (stages != 1 && stages != 2) ||
      (reinterpret_cast<unsigned long long>(bank) & 15) ||
      (reinterpret_cast<unsigned long long>(x) & 3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geom g = make_geom(x, L, n, M, P, hpad, KP, 0, kI16);
  const unsigned bank_bytes = tc_bank_bytes(P, KP, fast != 0);
  if ((size_t)smem < tc_smem_bytes(g, P, wgs, stages, 0, fast != 0, kI16))
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 4: return launch<4, kI16>(x, tail, bank, z, g, wgs, stages, bank_bytes,
                                   smem, fast != 0, device, stream);
    case 8: return launch<8, kI16>(x, tail, bank, z, g, wgs, stages, bank_bytes,
                                   smem, fast != 0, device, stream);
    case 16: return launch<16, kI16>(x, tail, bank, z, g, wgs, stages,
                                     bank_bytes, smem, fast != 0, device, stream);
    case 32: return launch<32, kI16>(x, tail, bank, z, g, wgs, stages,
                                     bank_bytes, smem, fast != 0, device, stream);
    case 64: return launch<64, kI16>(x, tail, bank, z, g, wgs, stages,
                                     bank_bytes, smem, fast != 0, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The direct route: x (2, L), tail (2, max(n - M, 0)), taps (2, n) [re row;
// im row] f32, z (2, L / M); fast: operands rounded to bf16.  On card
// `device`; launches on `stream`, does not synchronise, returns the
// launch's cudaError_t.
extern "C" int ddc_body_direct_launch(const float* x, const float* tail,
                                      const float* taps, float* z, long long L,
                                      int n, int M, int fast, int device,
                                      cudaStream_t stream) {
  return direct_launch<false>(x, tail, taps, z, L, n, M, fast, device, stream);
}

// The tensor-core route.  x (2, L), tail (2, max(n - M, 0)), z (2, L / M)
// [re row; im row] f32; bank: the packed bank of ops/cuda_ddc.py::body_tc_bank for frames of P
// outputs, 16-byte aligned (fast = 0: the hi and lo banks, 2 * KP / 4
// k-steps of 8 * 2P f32; fast = 1: KP / 8 k-steps of 16 * 2P bf16), with
// hpad and KP of ops/cuda_ddc.py::body_tc_geometry; wgs warpgroups a block,
// stages span buffers a warpgroup and smem bytes of shared memory a block
// (the same function).  x and z
// 4-byte aligned, contiguous, on card `device`.  Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t.
extern "C" int ddc_body_launch(const float* x, const float* tail,
                               const float* bank, float* z, long long L, int n,
                               int M, int P, int hpad, int KP, int wgs,
                               int stages, int smem, int fast, int device,
                               cudaStream_t stream) {
  return tc_launch<false>(x, tail, bank, z, L, n, M, P, hpad, KP, wgs, stages,
                          smem, fast, device, stream);
}

// ddc_body_direct_launch on the raw int16 block x (L, 2), 4-byte aligned.
extern "C" int ddc_body_direct_launch_i16(const void* x, const float* tail,
                                          const float* taps, float* z,
                                          long long L, int n, int M, int fast,
                                          int device, cudaStream_t stream) {
  return direct_launch<true>(x, tail, taps, z, L, n, M, fast, device, stream);
}

// ddc_body_launch on the raw int16 block x (L, 2), 4-byte aligned; smem
// from body_tc_geometry(..., ci16=True) (a stage holds the span's words).
extern "C" int ddc_body_launch_i16(const void* x, const float* tail,
                                   const float* bank, float* z, long long L,
                                   int n, int M, int P, int hpad, int KP,
                                   int wgs, int stages, int smem, int fast,
                                   int device, cudaStream_t stream) {
  return tc_launch<true>(x, tail, bank, z, L, n, M, P, hpad, KP, wgs, stages,
                         smem, fast, device, stream);
}
