// Unrotated DDC body for Hopper (sm_90a): K2 and K3 on TF32 tensor cores.
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
// (D = n - M) and the complex NCO-folded bandpass taps h it computes, for
// every decimated output t = 0 .. T-1 (T = L / M, any L that M divides),
//
//   z[t] = sum_i h[i] * x[t*M - D + i]
//
// and writes z as (2, T) f32 [re row; im row].  The caller rotates z at
// the decimated rate, or feeds it to a rotation-invariant epilogue; energy
// and the last sample are torch reductions in the glue (ops/ddc.py).
//
// Bound: bytes (8 a sample in, 8 an output out: 0.050 ms at L = 2^24 on an
// H100 SXM).  The earlier design (FP32 FMA fed from shared memory, two
// shared loads for four FMAs) ran at 30 % of it, held by shared-memory
// bandwidth.  Design: the banded-Toeplitz frame product on the tensor cores
// in TF32 x3 of ddc_tc.cuh (shared with the fused DDC + FM kernel,
// ddc_fm.cu), with an epilogue that stores the sums: the bank's columns are
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

#include <cuda_runtime.h>

#include "ddc_tc.cuh"

namespace {

// Stores the tile's sums as z (2, T): columns [0, P) the real parts of the
// frame's outputs, [P, 2P) the imaginary parts.
template <int P>
struct StoreZ {
  static constexpr bool kPre = false;
  float* z;

  __device__ __forceinline__ void from_span(const Geom&, const float*, const float*,
                                         int, int) {}

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

template <int P>
__global__ void __launch_bounds__(256, 1)
ddc_body_tc_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                   const float* __restrict__ bank, float* __restrict__ z,
                   const Geom g, long long n_tiles, int wgs, int stages,
                   unsigned bank_bytes) {
  StoreZ<P> epi{z};
  ddc_tc_run<P>(x, tail, bank, g, n_tiles, wgs, stages, bank_bytes, epi);
}

template <int P>
int launch(const float* x, const float* tail, const float* bank, float* z,
           const Geom& g, int wgs, int stages, unsigned bank_bytes, size_t smem,
           int device, cudaStream_t stream) {
  auto kernel = ddc_body_tc_kernel<P>;
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

}  // namespace

// x (2, L), tail (2, n - M), z (2, L / M) [re row; im row] f32; bank: the
// packed hi and lo banks of ops/cuda_ddc.py::body_tc_bank for frames of P
// outputs (2 * KP / 4 k-steps of 8 * 2P f32 each, 16-byte aligned), with
// hpad and KP of ops/cuda_ddc.py::body_tc_geometry; wgs warpgroups a block,
// stages span buffers a warpgroup and smem bytes of shared memory a block
// (the same function).  x and z
// 4-byte aligned, contiguous, on card `device`.  Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t.
extern "C" int ddc_body_launch(const float* x, const float* tail,
                               const float* bank, float* z, long long L, int n,
                               int M, int P, int hpad, int KP, int wgs,
                               int stages, int smem, int device,
                               cudaStream_t stream) {
  if (M <= 0 || n <= M || L <= 0 || L % M != 0 || hpad < n - M || hpad % 4 ||
      KP % 32 || KP < hpad + P * M || (wgs != 1 && wgs != 2) ||
      (stages != 1 && stages != 2) ||
      (reinterpret_cast<unsigned long long>(bank) & 15) ||
      (reinterpret_cast<unsigned long long>(x) & 3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geom g = make_geom(x, L, n, M, P, hpad, KP, 0);
  const unsigned bank_bytes = tc_bank_bytes(P, KP);
  if ((size_t)smem < tc_smem_bytes(g, P, wgs, stages, 0))
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 4: return launch<4>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 8: return launch<8>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 16: return launch<16>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 32: return launch<32>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 64: return launch<64>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
