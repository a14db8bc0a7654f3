// Unrotated DDC body for Hopper (sm_90a).
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
// Bound: device-memory reads of the input (8 bytes a sample) against
// 4 n / M FP32 FMAs a sample and the shared-memory reads that feed them.
// Design, simple first, as csrc/ddc_fm.cu without its epilogue:
//   * one thread block stages its input span once in shared memory as M
//     polyphase rows xs[r][u] = x[b0 + u*M + r], so that threads computing
//     neighbouring outputs read neighbouring words for every tap;
//   * each thread computes R outputs strided by blockDim, so every tap read
//     from shared memory (a broadcast) feeds R outputs;
//   * the sums run in FP32 FMA, the Hopper meaning of the x3 contract;
//   * reads past the block's end are 0 and stores past T are skipped, so
//     the last thread block may be partial and L may be shorter than the
//     filter (a short block reads mostly the tail).
// A banded-Toeplitz form on tensor cores (wgmma, TMA) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kOutputsPerThread = 4;

__global__ void ddc_body_kernel(const float* __restrict__ x,
                                const float* __restrict__ tail,
                                const float* __restrict__ taps,
                                float* __restrict__ z,
                                long long L, long long T, int n, int M, int U) {
  constexpr int R = kOutputsPerThread;
  extern __shared__ float smem[];
  const int nthr = blockDim.x;
  const int tbo = nthr * R;
  float* xs_r = smem;               // [M][U] polyphase rows, real plane
  float* xs_i = xs_r + M * U;       // [M][U] imaginary plane
  float* h_r = xs_i + M * U;        // [n]
  float* h_i = h_r + n;             // [n]

  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * tbo;
  const int D = n - M;
  const long long b0 = t0 * M - D;  // first sample of z[t0]

  for (int i = tid; i < n; i += nthr) {
    h_r[i] = taps[i];
    h_i[i] = taps[n + i];
  }
  for (int k = tid; k < M * U; k += nthr) {
    const long long s = b0 + k;
    float vr = 0.f, vi = 0.f;
    if (s >= 0) {
      if (s < L) {
        vr = x[s];
        vi = x[L + s];
      }
    } else if (s >= -D) {
      vr = tail[s + D];
      vi = tail[D + s + D];
    }
    const int u = k / M;
    const int r = k - u * M;
    xs_r[r * U + u] = vr;
    xs_i[r * U + u] = vi;
  }
  __syncthreads();

  // Local output j reads xs[r][j + q] for tap i = q*M + r.
  const int nq = (n + M - 1) / M;
  float zr[R], zi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) zr[k] = zi[k] = 0.f;
  for (int q = 0; q < nq; ++q) {
    for (int r = 0; r < M; ++r) {
      const int i = q * M + r;
      if (i >= n) break;
      const float hr = h_r[i], hi = h_i[i];
      const float* ar = xs_r + r * U + q + tid;
      const float* ai = xs_i + r * U + q + tid;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float a = ar[k * nthr], b = ai[k * nthr];
        zr[k] = fmaf(hr, a, zr[k]);
        zr[k] = fmaf(-hi, b, zr[k]);
        zi[k] = fmaf(hr, b, zi[k]);
        zi[k] = fmaf(hi, a, zi[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long t = t0 + tid + k * nthr;
    if (t < T) {
      z[t] = zr[k];
      z[T + t] = zi[k];
    }
  }
}

}  // namespace

// Shared-memory bytes of one thread block: the staged span and the taps.
static size_t ddc_body_smem_bytes(int n, int M, int threads) {
  const int tbo = threads * kOutputsPerThread;
  const int U = tbo + (n + M - 1) / M;
  return sizeof(float) * (2 * (size_t)M * U + 2 * (size_t)n);
}

// x (2, L), tail (2, n - M), taps (2, n) [re row; im row], z (2, L / M):
// f32, contiguous, on the device.  Launches on `stream` of card `device`,
// does not synchronise, returns the launch's cudaError_t.
extern "C" int ddc_body_launch(const float* x, const float* tail, const float* taps,
                               float* z, long long L, int n, int M, int threads,
                               int device, cudaStream_t stream) {
  if (M <= 0 || n <= M || L % M != 0 || L / M <= 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long T = L / M;
  const int tbo = threads * kOutputsPerThread;
  const int U = tbo + (n + M - 1) / M;
  const size_t smem = ddc_body_smem_bytes(n, M, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ddc_body_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (T + tbo - 1) / tbo;
  ddc_body_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      x, tail, taps, z, L, T, n, M, U);
  return (int)cudaGetLastError();
}
