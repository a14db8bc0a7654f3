// Farrow arbitrary-ratio resampler on the exact int32 grid, for Hopper
// (sm_90a): K8.
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_resample.py::
// make_farrow_kernel_resampler (kernel body _make_kernel, pallas_call in
// _build_call): cubic-Lagrange resampling of one block x (L,) complex64 with
// the carried state (tail (3,) complex64, t0 int32) onto the grid of
// ops/gridresample.py, y (n_pad,) complex64 with y[k] = 0 for k >= n_valid.
//
// Bound: memory.  Each output reads a 4-point stencil (consecutive outputs
// share most of it, through L1) and writes 8 bytes; ~30 FLOP an output.
//
// Design: one thread an output k.  The thread computes base and mu with the
// int32 digit arithmetic of gridresample.grid_positions (k split into 10-bit
// digits against the plan's carry/residue pairs C, D of R << 10 l), so the
// positions are bit-equal to the JAX package's; it clamps base to [0, L-1],
// reads the stencil of ext = [tail, x] without building ext (an index below 3
// reads the tail), evaluates the Lagrange basis in f32 registers and writes
// y[k].  The TPU kernel's scalar-prefetched group starts, per-group DMA spans,
// one-hot x taps matrices and its coefficient array in HBM are TPU mechanics
// and have no counterpart.  t0 is read from device memory, and thread 0
// writes n_valid and the next t0 to `meta` and threads 0-2 the next tail, so
// a block needs no host sync and no other launch.

#include <cuda_runtime.h>

namespace {

constexpr int kFB = 20;
constexpr unsigned kMask = (1u << kFB) - 1u;

struct Plan {
  int L, n_pad, R, q0, r0;
  unsigned C0, C1, C2, D0, D1, D2;
};

__device__ __forceinline__ float2 ext_at(const float2* __restrict__ x,
                                         const float2* __restrict__ tail,
                                         int m) {
  return m < 3 ? __ldg(tail + m) : __ldg(x + (m - 3));
}

__global__ void farrow_grid_kernel(const float2* __restrict__ x,
                                   const float2* __restrict__ tail,
                                   const int* __restrict__ t0p,
                                   float2* __restrict__ y,
                                   float2* __restrict__ tail_out,
                                   int* __restrict__ meta, Plan p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int t0 = __ldg(t0p);
  const int n_valid = p.q0 + (t0 < p.r0 ? 1 : 0);
  if (k < p.n_pad) {
    float2 out = make_float2(0.f, 0.f);
    if (k < n_valid) {
      // int32 wrap-around semantics, as the JAX package's int32 arrays
      const unsigned uk = (unsigned)k, ut = (unsigned)t0;
      const unsigned k0 = uk & 1023u, k1 = (uk >> 10) & 1023u, k2 = uk >> 20;
      const unsigned e0 = k0 * p.D0, e1 = k1 * p.D1, e2 = k2 * p.D2;
      const unsigned lo = (ut & kMask) + (e0 & kMask) + (e1 & kMask) + (e2 & kMask);
      int base = (int)((ut >> kFB) + k0 * p.C0 + k1 * p.C1 + k2 * p.C2 +
                       (e0 >> kFB) + (e1 >> kFB) + (e2 >> kFB) + (lo >> kFB));
      const float m = (float)(lo & kMask) * (1.0f / (float)(1 << kFB));
      base = base < 0 ? 0 : (base > p.L - 1 ? p.L - 1 : base);
      // lagrange_coeffs in the JAX package's order of operations
      const float c0 = -m * (m - 1.0f) * (m - 2.0f) / 6.0f;
      const float c1 = (m + 1.0f) * (m - 1.0f) * (m - 2.0f) / 2.0f;
      const float c2 = -(m + 1.0f) * m * (m - 2.0f) / 2.0f;
      const float c3 = (m + 1.0f) * m * (m - 1.0f) / 6.0f;
      const float2 a = ext_at(x, tail, base), b = ext_at(x, tail, base + 1);
      const float2 c = ext_at(x, tail, base + 2), d = ext_at(x, tail, base + 3);
      out.x = a.x * c0 + b.x * c1 + c.x * c2 + d.x * c3;
      out.y = a.y * c0 + b.y * c1 + c.y * c2 + d.y * c3;
    }
    y[k] = out;
  }
  if (k < 3) tail_out[k] = ext_at(x, tail, p.L + k);
  if (k == 0) {
    meta[0] = n_valid;
    meta[1] = t0 - p.r0 + (t0 < p.r0 ? p.R : 0);
  }
}

}  // namespace

// K8.  x (L,) and tail (3,) complex64 read as float2; t0 one int32 on the
// card; y (n_pad,) complex64; tail_out (3,) complex64; meta (2,) int32 =
// [n_valid, next t0].  The plan's R, q0, r0 and digit constants C, D as
// gridresample.plan_ratio builds them (L <= 2^24).  Outputs must not alias
// inputs.  Contiguous, on card `device`.  Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" int farrow_grid_launch(const float* x, const float* tail,
                                  const int* t0, float* y, float* tail_out,
                                  int* meta, int L, int n_pad, int R, int q0,
                                  int r0, int C0, int C1, int C2, int D0,
                                  int D1, int D2, int device,
                                  cudaStream_t stream) {
  if (L <= 0 || n_pad <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Plan p{L, n_pad, R, q0, r0, (unsigned)C0, (unsigned)C1, (unsigned)C2,
               (unsigned)D0, (unsigned)D1, (unsigned)D2};
  const int threads = 256;
  const int n = n_pad > 3 ? n_pad : 3;
  farrow_grid_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<const float2*>(tail),
      t0, reinterpret_cast<float2*>(y), reinterpret_cast<float2*>(tail_out),
      meta, p);
  return (int)cudaGetLastError();
}
