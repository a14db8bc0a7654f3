// S5, the all-pole (synthesis) lattice of the port, for Hopper (sm_90a).
// S4's entries, the Kalman recursions, are time-parallel chunk-and-join
// kernels: the filter's forward walk in track_forward.cu, the
// Rauch-Tung-Striebel smoother's backward walk and the steady-state filter
// x = F x + b in track_chunks.cu.  The forward walk was this file's one
// thread a sequence until the filtering elements of track_forward.cu made it
// time-parallel: the Riccati recursion does not depend on z and composes.
//
// S5 replaces no TPU kernel: in the JAX package it is a lax.scan,
// solid_dsp_tpu/analysis/lpc.py::lattice_iir (:233-262).  PyTorch has no
// scan, and a per-sample recurrence in eager torch ops costs ~4 launches a
// lattice stage a sample, so the recurrence is one kernel here.
//
// Bound: issue, one thread a sequence.  The lattice's descent f <- f - k_m
// b_m is not a chain of p a sample: stage m of sample t + 1 needs only b_m,
// which stage m - 1 of sample t wrote, so samples overlap as a wavefront (~3
// dependent multiply-adds a sample) and its 2p multiply-adds a sample are
// issue-bound (torch_kernel_sweep.py latency has the floor).
//
// Design: one thread a sequence (a leading index), its state in registers,
// time walked in order, the inputs loaded into registers a chunk of steps
// ahead (`chunked`) so that a load's latency hides behind a chunk of
// dependent steps.  The order is a compile-time bucket so that the stages
// live in registers with their loops unrolled: the wrapper
// (ops/cuda_track.py) pads the order to 4, 8, 16, 32 or 64 (a padded stage
// has k = 0 and leaves g as it is).  Orders above 64 take a generic loop with
// the backward errors in a scratch array (device memory).
//
// Entry points (each returns the launch's cudaError_t; B sequences, one
// thread each):
//   lattice_iir_f32 / _f64 / _c64 / _c128: y (B, N), k (B, p) -> x (B, N);
//                           p a register bucket (4 .. 64) or above 64

#include <cuda_runtime.h>

// a complex sample as torch lays it out (complex64 / complex128)
template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R x, y;
};

namespace {

constexpr int THREADS = 32;

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

// Walk steps s = 0 .. S-1: load(s, buf) fetches step s's inputs, step(s,
// buf) runs it.  Full chunks of K steps are loaded into registers a chunk
// ahead (the next chunk's loads started before this chunk's steps, so their
// latency hides behind K dependent steps, as seq_scan.cu's walk).  The
// ragged end takes one step at a time.
template <int K, typename Buf, typename Load, typename Step>
__device__ __forceinline__ void chunked(long long S, Load load, Step step) {
  const long long full = S - S % K;
  Buf cur[K], nxt[K];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) load(i, cur[i]);
  }
  for (long long s0 = 0; s0 < full; s0 += K) {
    if (s0 + K < full) {
#pragma unroll
      for (int i = 0; i < K; ++i) load(s0 + K + i, nxt[i]);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) step(s0 + i, cur[i]);
#pragma unroll
    for (int i = 0; i < K; ++i) cur[i] = nxt[i];
  }
  for (long long s = full; s < S; ++s) {
    Buf one;
    load(s, one);
    step(s, one);
  }
}

constexpr int LATTICE_CHUNK = 8;

template <typename F, typename... Args>
int launch(F kernel, int B, int device, cudaStream_t stream, Args... args) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S5: the all-pole lattice
// ---------------------------------------------------------------------------

template <typename R> __device__ __forceinline__ R conj_(R v) { return v; }
template <typename R> __device__ __forceinline__ Cx<R> conj_(Cx<R> v) {
  return {v.x, -v.y};
}
// g - k b
template <typename R> __device__ __forceinline__ R msub(R g, R k, R b) {
  return g - k * b;
}
template <typename R>
__device__ __forceinline__ Cx<R> msub(Cx<R> g, Cx<R> k, Cx<R> b) {
  return {g.x - (k.x * b.x - k.y * b.y), g.y - (k.x * b.y + k.y * b.x)};
}
// b + c g (c = conj(k))
template <typename R> __device__ __forceinline__ R madd(R b, R c, R g) {
  return b + c * g;
}
template <typename R>
__device__ __forceinline__ Cx<R> madd(Cx<R> b, Cx<R> c, Cx<R> g) {
  return {b.x + (c.x * g.x - c.y * g.y), b.y + (c.x * g.y + c.y * g.x)};
}
template <typename V> __device__ __forceinline__ V zero_() { return V{}; }

// One lane's walk: g = y[n]; for m = p-1 .. 0: g <- g - k_m b_m (the old
// b_m), and b_{m+1} <- b_m + conj(k_m) g where m + 1 < p; b_0 <- g = x[n].
// PMAX > 0: p = PMAX (the wrapper pads k with zeros), b and k in registers,
// stages unrolled; PMAX == 0: the generic loop with b in `scratch` (B x p).
// y is loaded a chunk of LATTICE_CHUNK samples ahead.
template <typename V, int PMAX>
__global__ void __launch_bounds__(THREADS)
lattice_iir_kernel(const V* __restrict__ y, const V* __restrict__ kk,
                   V* __restrict__ out, V* __restrict__ scratch, int B,
                   long long N, int p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const V* yl = y + (long long)lane * N;
  V* xl = out + (long long)lane * N;
  const V* kl = kk + (long long)lane * p;
  const auto load = [&](long long t, V& v) { v = yl[t]; };
  if constexpr (PMAX > 0) {
    V k[PMAX], b[PMAX];
#pragma unroll
    for (int m = 0; m < PMAX; ++m) {
      k[m] = kl[m];
      b[m] = zero_<V>();
    }
    chunked<LATTICE_CHUNK, V>(N, load, [&](long long t, const V& yt) {
      V g = yt;
#pragma unroll
      for (int m = PMAX - 1; m >= 0; --m) {
        const V old = b[m];
        g = msub(g, k[m], old);
        if (m + 1 < PMAX) b[m + 1] = madd(old, conj_(k[m]), g);
      }
      b[0] = g;
      xl[t] = g;
    });
  } else {
    V* b = scratch + (long long)lane * p;
    for (int m = 0; m < p; ++m) b[m] = zero_<V>();
    chunked<LATTICE_CHUNK, V>(N, load, [&](long long t, const V& yt) {
      V g = yt;
      for (int m = p - 1; m >= 0; --m) {
        const V km = kl[m];
        const V old = b[m];
        g = msub(g, km, old);
        if (m + 1 < p) b[m + 1] = madd(old, conj_(km), g);
      }
      b[0] = g;
      xl[t] = g;
    });
  }
}

template <typename V>
int lattice_iir(const V* y, const V* k, V* x, V* scratch, int B, long long N,
                int p, int device, cudaStream_t stream) {
  if (p < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (p) {
    case 4: return launch(lattice_iir_kernel<V, 4>, B, device, stream, y, k, x, scratch, B, N, p);
    case 8: return launch(lattice_iir_kernel<V, 8>, B, device, stream, y, k, x, scratch, B, N, p);
    case 16: return launch(lattice_iir_kernel<V, 16>, B, device, stream, y, k, x, scratch, B, N, p);
    case 32: return launch(lattice_iir_kernel<V, 32>, B, device, stream, y, k, x, scratch, B, N, p);
    case 64: return launch(lattice_iir_kernel<V, 64>, B, device, stream, y, k, x, scratch, B, N, p);
    default:
      if (p < 64 || scratch == nullptr) return (int)cudaErrorInvalidValue;
      return launch(lattice_iir_kernel<V, 0>, B, device, stream, y, k, x,
                    scratch, B, N, p);
  }
}

}  // namespace

#define LATTICE_ENTRY(SUF, V)                                                 \
  extern "C" int lattice_iir_##SUF(const V* y, const V* k, V* x, V* scratch,  \
                                   int B, long long N, int p, int device,     \
                                   cudaStream_t stream) {                     \
    return lattice_iir<V>(y, k, x, scratch, B, N, p, device, stream);         \
  }

LATTICE_ENTRY(f32, float)
LATTICE_ENTRY(f64, double)
LATTICE_ENTRY(c64, Cx<float>)
LATTICE_ENTRY(c128, Cx<double>)
