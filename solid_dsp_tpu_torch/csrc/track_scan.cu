// The tracking and prediction recurrences of the port, for Hopper (sm_90a):
// S4's forward entry, the Kalman filter's predict/update walk with the
// Riccati recursion carried, and S5, the all-pole (synthesis) lattice.
// S4's other two entries, the Rauch-Tung-Striebel smoother's backward walk
// and the steady-state filter x = F x + b, are time-parallel chunk-and-join
// kernels in track_chunks.cu.
//
// Neither replaces a TPU kernel: in the JAX package each is a lax.scan,
// solid_dsp_tpu/ops/kalman.py::kalman_apply and rts_smooth's forward pass
// (:43-105, the step _kf_predict_update :66-79) and
// solid_dsp_tpu/analysis/lpc.py::lattice_iir (:233-262).  PyTorch has no
// scan, and a per-sample recurrence in eager torch ops costs tens of
// launches a sample (the Kalman step's n x n algebra and solve ~30, a
// lattice stage ~4), so each recurrence is one kernel here.
//
// Bound: latency or issue, one thread a sequence.  Each Kalman step depends
// on the one before through the whole state (x and P: ~15 dependent
// operations and a division a step at n = 2, m = 1), so one sequence runs
// at a step per that chain however many SMs the card has; the bytes (each
// input read once, each output written once) would take 3.35 TB/s far less
// time.  The lattice's descent f <- f - k_m b_m is not a chain of p a
// sample: stage m of sample t + 1 needs only b_m, which stage m - 1 of
// sample t wrote, so samples overlap as a wavefront (~3 dependent
// multiply-adds a sample) and its 2p multiply-adds a sample are issue-bound
// (torch_kernel_sweep.py latency has both floors).
//
// Design: one thread a sequence (a leading index), its state in registers,
// time walked in order, the inputs loaded into registers a chunk of steps
// ahead (`chunked`: 1-8 steps, by the step's size) so that a load's latency
// hides behind a chunk of dependent steps.  The model sizes are
// compile-time buckets so that every matrix lives in registers with its
// loops unrolled and every row has a fixed stride (no guards, no index
// arithmetic a step): the wrapper (ops/cuda_track.py) pads n and m to 1, 2,
// 4 or 8 and the lattice's order to 4, 8, 16, 32 or 64.  The padding is
// exact: padded states and measurements enter as zero rows and columns (R
// with 1 on its padded diagonal), so every real entry sees the same
// arithmetic as without padding and every padded one stays 0; a padded
// lattice stage has k = 0 and leaves g as it is.  The gain's solve (S = C
// P- C' + R) is Gaussian elimination without pivoting: S is symmetric
// positive definite.  Orders above 64 take a generic lattice loop with the
// backward errors in a scratch array (device memory, cached).
//
// Later work: the Kalman gain sequence (the Riccati recursion) does not
// depend on the measurements z, so it can be computed once, and the state
// update x_t = (I - K_t C) A x_{t-1} + K_t z_t is then an affine recurrence
// that runs time-parallel, as track_chunks.cu runs the LTI and backward
// walks; the Riccati recursion itself is a Mobius map of P, which composes
// too.
//
// Entry points (each returns the launch's cudaError_t; B sequences, one
// thread each; n and m are the padded sizes, 1, 2, 4 or 8):
//   kf_forward_f32 / _f64:  Z (B, T, m) -> X (B, T, n); x (B, n), P (B, n, n)
//                           in place; optional Pf (B, T, n, n), Xp (B, T, n),
//                           Pp (B, T, n, n)
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
// the walk and the small dense algebra
// ---------------------------------------------------------------------------

// A step's inputs: W values.
template <typename R, int W>
struct Row {
  R v[W];
};

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

// Steps a chunk: enough that a chunk's steps outlast a load from device
// memory, few enough that the buffers and the unrolled steps stay small.
__host__ __device__ constexpr int kf_chunk(int np, int mp) {
  return (np <= 2 && mp <= 2) ? 8 : (np <= 4 && mp <= 4) ? 2 : 1;
}
constexpr int LATTICE_CHUNK = 8;

template <typename R, int W>
__device__ __forceinline__ void load_row(R (&v)[W], const R* src) {
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = src[i];
}

template <typename R, int RP, int CP>
__device__ __forceinline__ void load_rows(R (&M)[RP][CP], const R* src) {
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) M[i][j] = src[i * CP + j];
}

template <typename R, int W>
__device__ __forceinline__ void store_row(R* dst, const R (&v)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) dst[i] = v[i];
}

template <typename R, int RP, int CP>
__device__ __forceinline__ void store_rows(R* dst, const R (&M)[RP][CP]) {
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) dst[i * CP + j] = M[i][j];
}

// Y <- M^-1 Y for M (MP x MP) symmetric positive definite and Y (MP x NP):
// forward elimination without pivoting, then back substitution.  M is
// overwritten.
template <typename R, int MP, int NP>
__device__ __forceinline__ void spd_solve(R (&M)[MP][MP], R (&Y)[MP][NP]) {
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    const R inv = R(1) / M[k][k];
#pragma unroll
    for (int i = k + 1; i < MP; ++i) {
      const R f = M[i][k] * inv;
#pragma unroll
      for (int j = k; j < MP; ++j) M[i][j] -= f * M[k][j];
#pragma unroll
      for (int j = 0; j < NP; ++j) Y[i][j] -= f * Y[k][j];
    }
  }
#pragma unroll
  for (int k = MP - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      R s = Y[k][j];
#pragma unroll
      for (int l = k + 1; l < MP; ++l) s -= M[k][l] * Y[l][j];
      Y[k][j] = s / M[k][k];
    }
  }
}

// ---------------------------------------------------------------------------
// S4: the Kalman recursions
// ---------------------------------------------------------------------------

template <typename R>
struct KfArgs {
  const R* Z; const R* A; const R* C; const R* Q; const R* Rm;
  R* x; R* P; R* X; R* Pf; R* Xp; R* Pp;
  int B; long long T;
};

// One predict/update a step (JAX's _kf_predict_update): xp = A x, Pp = A P
// A' + Q, S = C Pp C' + R, K = solve(S', (Pp C')')', x = xp + K (z - C xp),
// P = (I - K C) Pp.
template <typename R, int NP, int MP>
__global__ void __launch_bounds__(THREADS) kf_forward_kernel(KfArgs<R> a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const long long T = a.T;
  R A[NP][NP], C[MP][NP], Q[NP][NP], Rr[MP][MP], x[NP], P[NP][NP];
  load_rows(A, a.A);
  load_rows(C, a.C);
  load_rows(Q, a.Q);
  load_rows(Rr, a.Rm);
  load_row(x, a.x + (long long)b * NP);
  load_rows(P, a.P + (long long)b * NP * NP);
  const R* Z = a.Z + (long long)b * T * MP;
  const bool keep = a.Pf != nullptr;
  chunked<kf_chunk(NP, MP), Row<R, MP>>(T, [&](long long t, Row<R, MP>& r) {
    load_row(r.v, Z + t * MP);
  }, [&](long long t, const Row<R, MP>& r) {
    R xp[NP], AP[NP][NP], Pp[NP][NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      R s = R(0);
#pragma unroll
      for (int j = 0; j < NP; ++j) s += A[i][j] * x[j];
      xp[i] = s;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NP; ++k) s += A[i][k] * P[k][j];
        AP[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NP; ++k) s += AP[i][k] * A[j][k];
        Pp[i][j] = s + Q[i][j];
      }
    // Y = (Pp C')' (MP x NP), S' = (C Pp C' + R)'
    R Y[MP][NP], St[MP][MP];
#pragma unroll
    for (int j = 0; j < MP; ++j)
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NP; ++k) s += Pp[i][k] * C[j][k];
        Y[j][i] = s;
      }
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < MP; ++j) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NP; ++k) s += C[i][k] * Y[j][k];
        St[j][i] = s + Rr[i][j];
      }
    spd_solve(St, Y);                         // Y = K' (MP x NP)
    R v[MP];
#pragma unroll
    for (int i = 0; i < MP; ++i) {
      R s = R(0);
#pragma unroll
      for (int k = 0; k < NP; ++k) s += C[i][k] * xp[k];
      v[i] = r.v[i] - s;
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      R s = R(0);
#pragma unroll
      for (int j = 0; j < MP; ++j) s += Y[j][i] * v[j];
      x[i] = xp[i] + s;
    }
    R IKC[NP][NP];
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        R s = R(0);
#pragma unroll
        for (int l = 0; l < MP; ++l) s += Y[l][i] * C[l][j];
        IKC[i][j] = (i == j ? R(1) : R(0)) - s;
      }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        R s = R(0);
#pragma unroll
        for (int k = 0; k < NP; ++k) s += IKC[i][k] * Pp[k][j];
        P[i][j] = s;
      }
    const long long row = (long long)b * T + t;
    store_row(a.X + row * NP, x);
    if (keep) {
      store_rows(a.Pf + row * NP * NP, P);
      store_row(a.Xp + row * NP, xp);
      store_rows(a.Pp + row * NP * NP, Pp);
    }
  });
  store_row(a.x + (long long)b * NP, x);
  store_rows(a.P + (long long)b * NP * NP, P);
}

template <typename F, typename... Args>
int launch(F kernel, int B, int device, cudaStream_t stream, Args... args) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename R, int NP>
int kf_forward_m(const KfArgs<R>& a, int mp, int device, cudaStream_t stream) {
  switch (mp) {
    case 1: return launch(kf_forward_kernel<R, NP, 1>, a.B, device, stream, a);
    case 2: return launch(kf_forward_kernel<R, NP, 2>, a.B, device, stream, a);
    case 4: return launch(kf_forward_kernel<R, NP, 4>, a.B, device, stream, a);
    case 8: return launch(kf_forward_kernel<R, NP, 8>, a.B, device, stream, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename R>
int kf_forward(const KfArgs<R>& a, int np, int mp, int device,
               cudaStream_t stream) {
  if (a.T < 1) return (int)cudaErrorInvalidValue;
  switch (np) {
    case 1: return kf_forward_m<R, 1>(a, mp, device, stream);
    case 2: return kf_forward_m<R, 2>(a, mp, device, stream);
    case 4: return kf_forward_m<R, 4>(a, mp, device, stream);
    case 8: return kf_forward_m<R, 8>(a, mp, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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

#define KF_ENTRIES(SUF, R)                                                    \
  extern "C" int kf_forward_##SUF(                                            \
      const R* Z, const R* A, const R* C, const R* Q, const R* Rm, R* x,      \
      R* P, R* X, R* Pf, R* Xp, R* Pp, int B, long long T, int n, int m,      \
      int device, cudaStream_t stream) {                                      \
    const KfArgs<R> a{Z, A, C, Q, Rm, x, P, X, Pf, Xp, Pp, B, T};             \
    return kf_forward<R>(a, n, m, device, stream);                            \
  }

#define LATTICE_ENTRY(SUF, V)                                                 \
  extern "C" int lattice_iir_##SUF(const V* y, const V* k, V* x, V* scratch,  \
                                   int B, long long N, int p, int device,     \
                                   cudaStream_t stream) {                     \
    return lattice_iir<V>(y, k, x, scratch, B, N, p, device, stream);         \
  }

KF_ENTRIES(f32, float)
KF_ENTRIES(f64, double)
LATTICE_ENTRY(f32, float)
LATTICE_ENTRY(f64, double)
LATTICE_ENTRY(c64, Cx<float>)
LATTICE_ENTRY(c128, Cx<double>)
