// Fused DDC + FM discriminator for Hopper (sm_90a).
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_ddc.py::make_pallas_ddc_fm
// (K1, kernel body _make_kernel_fm).  One pass over the planar (2, L) f32
// input block computes, for every decimated output t = 0 .. T-1 (T = L / M),
//
//   z[t]     = sum_i h[i] * x[t*M - D + i],        D = n - M,
//   audio[t] = atan2(Im d, Re d) * scale,  d = z[t] conj(z[t-1]) e^{-j drad},
//
// with h the complex NCO-folded bandpass taps, x[-D .. -1] the carried tail,
// (cd, sd) = (cos drad, -sin drad) and scale = 1 / (2 pi kf).  It also emits
// one partial sum of |z|^2 per thread block and z[0], z[T-1], so the
// decimated-rate complex signal never reaches device memory.
//
// Bound: device-memory reads of the input (8 bytes a sample) against
// 4 n / M FP32 FMAs a sample (64 per sample at n = 64, M = 4) and the
// shared-memory reads that feed them.  Design, simple first:
//   * one thread block stages its input span once in shared memory, split
//     into M polyphase rows xs[r][u] = x[b0 + u*M + r], so that threads
//     computing neighbouring outputs read neighbouring words (no bank
//     conflicts) for every tap;
//   * each thread computes R outputs strided by blockDim, so every tap read
//     from shared memory (a broadcast) feeds R outputs;
//   * the FIR sums run in FP32 FMA: the Hopper meaning of the x3 contract;
//   * each block also computes z[t0 - 1], the output just before its range,
//     so the discriminator of its first output needs no other block.  For
//     block 0 that window starts M samples before the D tail samples it is
//     given; they are read as 0, exactly as K1's tile-0 seam reads them, and
//     the caller overwrites audio[0] from its carried state.
// A banded-Toeplitz form on tensor cores (wgmma, TMA) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kOutputsPerThread = 4;

__global__ void ddc_fm_kernel(const float* __restrict__ x,
                              const float* __restrict__ tail,
                              const float* __restrict__ taps,
                              float* __restrict__ audio,
                              float* __restrict__ energy,
                              float* __restrict__ edges,
                              long long L, long long T, int n, int M, int U,
                              float cd, float sd, float scale) {
  constexpr int R = kOutputsPerThread;
  extern __shared__ float smem[];
  const int nthr = blockDim.x;
  const int tbo = nthr * R;
  float* xs_r = smem;               // [M][U] polyphase rows, real plane
  float* xs_i = xs_r + M * U;       // [M][U] imaginary plane
  float* h_r = xs_i + M * U;        // [n]
  float* h_i = h_r + n;             // [n]
  float* z_r = h_i + n;             // [tbo + 1]: z[t0 - 1 + j]
  float* z_i = z_r + tbo + 1;
  float* red = z_i + tbo + 1;       // [nthr / 32]

  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * tbo;
  const int D = n - M;
  const long long b0 = (t0 - 1) * M - D;  // first sample of z[t0 - 1]

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

  // Local output j reads xs[r][j + 1 + q] for tap i = q*M + r; the seam
  // output j = -1 reads xs[r][q].
  const int nq = (n + M - 1) / M;
  float zr[R], zi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) zr[k] = zi[k] = 0.f;
  float sr = 0.f, si = 0.f;
  for (int q = 0; q < nq; ++q) {
    for (int r = 0; r < M; ++r) {
      const int i = q * M + r;
      if (i >= n) break;
      const float hr = h_r[i], hi = h_i[i];
      const float* ar = xs_r + r * U + q + 1 + tid;
      const float* ai = xs_i + r * U + q + 1 + tid;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float a = ar[k * nthr], b = ai[k * nthr];
        zr[k] = fmaf(hr, a, zr[k]);
        zr[k] = fmaf(-hi, b, zr[k]);
        zi[k] = fmaf(hr, b, zi[k]);
        zi[k] = fmaf(hi, a, zi[k]);
      }
      if (tid == 0) {
        const float a = xs_r[r * U + q], b = xs_i[r * U + q];
        sr = fmaf(hr, a, sr);
        sr = fmaf(-hi, b, sr);
        si = fmaf(hr, b, si);
        si = fmaf(hi, a, si);
      }
    }
  }
  if (tid == 0) {
    z_r[0] = sr;
    z_i[0] = si;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    z_r[1 + tid + k * nthr] = zr[k];
    z_i[1 + tid + k * nthr] = zi[k];
  }
  __syncthreads();

  float e = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = tid + k * nthr;
    const long long t = t0 + j;
    if (t < T) {
      const float cr = z_r[j + 1], ci = z_i[j + 1];
      const float pr = z_r[j], pi = z_i[j];
      const float ure = cr * pr + ci * pi;
      const float uim = ci * pr - cr * pi;
      const float dre = ure * cd - uim * sd;
      const float dim = uim * cd + ure * sd;
      audio[t] = atan2f(dim, dre) * scale;
      e += cr * cr + ci * ci;
      if (t == T - 1) {
        edges[0] = cr;
        edges[1] = ci;
      }
      if (t == 0) {
        edges[2] = cr;
        edges[3] = ci;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) e += __shfl_down_sync(0xffffffffu, e, off);
  if ((tid & 31) == 0) red[tid >> 5] = e;
  __syncthreads();
  if (tid < 32) {
    float v = tid < (nthr >> 5) ? red[tid] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (tid == 0) energy[blockIdx.x] = v;
  }
}

}  // namespace

// Shared-memory bytes of one thread block; the wrapper sizes its launch with
// the same formula (ops/cuda_ddc.py::launch_geometry).
static size_t ddc_fm_smem_bytes(int n, int M, int threads) {
  const int tbo = threads * kOutputsPerThread;
  const int U = tbo + (n + M - 1) / M;
  return sizeof(float) *
         (2 * (size_t)M * U + 2 * (size_t)n + 2 * (size_t)(tbo + 1) + threads / 32);
}

// x (2, L), tail (2, n - M), taps (2, n) [re row; im row]: f32, contiguous,
// on the device.  audio (L / M,), energy (blocks,), edges (4,) =
// [z_last re, z_last im, z_first re, z_first im].  Launches on `stream` of
// card `device`, does not synchronise, returns the launch's cudaError_t.
extern "C" int ddc_fm_launch(const float* x, const float* tail, const float* taps,
                             float* audio, float* energy, float* edges,
                             long long L, int n, int M, int threads,
                             float cd, float sd, float scale, int device,
                             cudaStream_t stream) {
  if (M <= 0 || n <= M || L % M != 0 || L / M <= 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long T = L / M;
  const int tbo = threads * kOutputsPerThread;
  const int U = tbo + (n + M - 1) / M;
  const size_t smem = ddc_fm_smem_bytes(n, M, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ddc_fm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (T + tbo - 1) / tbo;
  ddc_fm_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      x, tail, taps, audio, energy, edges, L, T, n, M, U, cd, sd, scale);
  return (int)cudaGetLastError();
}
