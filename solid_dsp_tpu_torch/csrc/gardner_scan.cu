// S9: the Gardner timing loop for Hopper (sm_90a): the decision-free
// Gardner timing-error detector with a proportional-integral loop and cubic
// (Farrow, Lagrange) interpolation at the strobe and at the midpoint, over
// one complex64 stream (models/timing.py::gardner_scan).
//
// It replaces no TPU kernel: in the JAX package the loop is a lax.scan over
// symbols, solid_dsp_tpu/models/timing.py:124 (gardner_scan).  PyTorch has
// no scan, and one symbol in eager torch ops costs some forty launches (the
// plain version, models/timing.py::gardner_walk_plain), so the loop is one
// kernel here.
//
// Bound: latency.  The fractional delay mu of symbol k + 1 depends on the
// error of symbol k, and it chooses where the next symbol's samples are
// read, so a stream is one dependent chain a symbol: floor(mu), the sample
// index, a shared-memory read, the Farrow coefficients and Horner's three
// steps, the error and the loop filter.  The bytes (each sample read once,
// each symbol written once) would take 3.35 TB/s far less time.
//
// F8, a fault of the reference that S9 and the plain version meet: JAX
// forms the strobe position k * sps + mu as one float32, whose fraction
// keeps 3 bits from 2^20 samples on and none from 2^24.  Here the whole
// part k * sps stays an integer and mu is carried apart: base = k * sps +
// floor(mu), frac = mu - floor(mu) (rounded once at most); the midpoint k * sps - sps / 2
// + mu the same way, with an odd sps's half sample taken off mu (mu - 0.5).
// JAX's clip of the index to [1, n - 3] and its - 1 are kept.
//
// Design: one block of two warps a stream.  Lane 0 of warp 0 walks the
// symbols; warp 1 stages x through shared memory as a sliding window ahead
// of it.  The walk goes in chunks of SYMS symbols; while the walker works
// through chunk c from one buffer, warp 1 loads chunk c + 1's window into
// the other, coalesced, placed by mu at the start of chunk c (published by
// the walker) with MARGIN samples either side for mu's drift over a chunk;
// a block barrier a chunk swaps them.  A read outside the window (a drift
// beyond the margin, or the clipped ends) falls back to device memory, so
// the result never depends on the prediction; only its speed does.  The
// window's loads are off the step's chain: only the shared read stays on it.
//
// Arithmetic: the plain version's real operations on the re/im rails in its
// order, with the _rn intrinsics so that nvcc contracts none into an FMA:
// c0 = s1, c1 = 0.5 (s2 - s0), c2 = ((s0 - 2.5 s1) + 2 s2) - 0.5 s3, c3 =
// 0.5 (s3 - s0) + 1.5 (s1 - s2), v = ((c3 t + c2) t + c1) t + c0; the error
// e = mid.re d.re + mid.im d.im with d = previous symbol - symbol; rate +=
// beta e; mu = (mu + alpha e) + rate.  So S9 is bit-equal to the plain
// version.
//
// Entry point (returns the launch's cudaError_t):
//   gardner_scan_c64: x (n,) complex64 -> symbols (n_sym,) complex64 and
//                     the final mu (float32, one value)

#include <cuda_runtime.h>

namespace {

constexpr int SYMS = 32;     // symbols a chunk
constexpr int MARGIN = 32;   // samples either side of the predicted window
constexpr int THREADS = 64;  // warp 0: the walker's lane 0; warp 1: loads

__device__ __forceinline__ float2 farrow(const float2 s[4], float t) {
  float2 v;
  const float* sx = &s[0].x;
  // the two rails, each the same real operations
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float a0 = sx[0 + r], a1 = sx[2 + r], a2 = sx[4 + r],
                a3 = sx[6 + r];
    const float c1 = __fmul_rn(0.5f, __fsub_rn(a2, a0));
    const float c2 = __fsub_rn(
        __fadd_rn(__fsub_rn(a0, __fmul_rn(2.5f, a1)), __fmul_rn(2.0f, a2)),
        __fmul_rn(0.5f, a3));
    const float c3 = __fadd_rn(__fmul_rn(0.5f, __fsub_rn(a3, a0)),
                               __fmul_rn(1.5f, __fsub_rn(a1, a2)));
    const float h = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(c3, t), c2), t),
                            c1),
                  t),
        a1);
    if (r == 0) v.x = h; else v.y = h;
  }
  return v;
}

struct Window {
  const float2* buf;    // shared
  int w0;               // x index of buf[0]
  int win;
  const float2* x;      // device memory: the fall-back
  __device__ __forceinline__ float2 at(int i) const {
    const unsigned j = (unsigned)(i - w0);
    return j < (unsigned)win ? buf[j] : x[i];
  }
};

// JAX's clip of a strobe's whole part to [1, n - 3], then its - 1
__device__ __forceinline__ int clip_index(int i, int n) {
  return min(max(i, 1), n - 3) - 1;
}

// n < 2^31 samples (the wrapper's limit): indices are 32-bit; a float's
// whole part converts with saturation, and the clip holds it in range.
__global__ void __launch_bounds__(THREADS)
gardner_kernel(const float2* __restrict__ x, int n, int sps, int n_sym,
               float mu0, float alpha, float beta, int win,
               float2* __restrict__ syms, float* __restrict__ mu_out) {
  extern __shared__ float2 buf[];            // two windows of win samples
  __shared__ int anchor[2];
  __shared__ float mu_pub[2];
  const int tid = threadIdx.x;
  const int half = sps / 2;
  const int n_chunks = (n_sym + SYMS - 1) / SYMS;

  // the window of chunk c (symbols 1 + c SYMS ...) around mu = m
  auto window_start = [&](int c, float m) {
    return (1 + c * SYMS) * sps + __float2int_rd(m) - half - 3 - MARGIN;
  };
  auto fill = [&](int slot, int w0, int first, int stride) {
    float2* b = buf + slot * win;
    for (int j = first; j < win; j += stride) {
      const int i = w0 + j;
      b[j] = (i >= 0 && i < n) ? x[i] : make_float2(0.0f, 0.0f);
    }
  };

  if (tid == 0) {
    anchor[0] = window_start(0, mu0);
    mu_pub[0] = mu0;
  }
  __syncthreads();
  fill(0, anchor[0], tid, THREADS);
  __syncthreads();

  float mu = mu0, rate = 0.0f;
  float2 prev = make_float2(0.0f, 0.0f);
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1, nxt = cur ^ 1;
    if (tid >= 32) {
      if (c + 1 < n_chunks) {
        const int w0 = window_start(c + 1, mu_pub[cur]);
        if (tid == 32) anchor[nxt] = w0;
        fill(nxt, w0, tid - 32, 32);
      }
    } else if (tid == 0) {
      const Window w{buf + cur * win, anchor[cur], win, x};
      const int k_end = min(n_sym, (c + 1) * SYMS);
      for (int k = 1 + c * SYMS; k <= k_end; ++k) {
        const float fl = floorf(mu);
        const float frac = __fsub_rn(mu, fl);
        const int ip = k * sps + (int)fl;
        int mip;
        float mfrac;
        if (sps & 1) {
          const float m2 = __fsub_rn(mu, 0.5f);
          const float fl2 = floorf(m2);
          mfrac = __fsub_rn(m2, fl2);
          mip = k * sps - half + (int)fl2;
        } else {
          mfrac = frac;
          mip = ip - half;
        }
        const int b = clip_index(ip, n), mb = clip_index(mip, n);
        const unsigned jb = (unsigned)(b - w.w0), jm = (unsigned)(mb - w.w0);
        float2 s[4], m[4];
        if (jb <= (unsigned)(win - 4) && jm <= (unsigned)(win - 4)) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {     // both windows staged: the rule
            s[i] = w.buf[jb + i];
            m[i] = w.buf[jm + i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i] = w.at(b + i);
            m[i] = w.at(mb + i);
          }
        }
        const float2 sym = farrow(s, frac);
        const float2 mid = farrow(m, mfrac);
        const float e = __fadd_rn(__fmul_rn(mid.x, __fsub_rn(prev.x, sym.x)),
                                  __fmul_rn(mid.y, __fsub_rn(prev.y, sym.y)));
        rate = __fadd_rn(rate, __fmul_rn(beta, e));
        mu = __fadd_rn(__fadd_rn(mu, __fmul_rn(alpha, e)), rate);
        prev = sym;
        syms[k - 1] = sym;
      }
      mu_pub[nxt] = mu;
    }
    __syncthreads();
  }
  if (tid == 0) mu_out[0] = mu;
}

}  // namespace

extern "C" int gardner_scan_c64(const void* x, int n, int sps, int n_sym,
                                float mu0, float alpha,
                                float beta, void* syms, void* mu_out,
                                void* stream) {
  const int win = SYMS * sps + 2 * MARGIN + sps + 8;
  const size_t smem = 2 * (size_t)win * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gardner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gardner_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), n, sps, n_sym, mu0, alpha, beta, win,
      static_cast<float2*>(syms), static_cast<float*>(mu_out));
  return (int)cudaGetLastError();
}
