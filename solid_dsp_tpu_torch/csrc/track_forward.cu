// S4's forward entry, for Hopper (sm_90a): the Kalman filter's
// predict/update walk with its Riccati recursion, as a time-parallel
// chunk-and-join kernel.
//
// It replaces no TPU kernel: in the JAX package it is a lax.scan,
// solid_dsp_tpu/ops/kalman.py::kalman_apply and rts_smooth's forward pass
// (:43-105, the step _kf_predict_update :66-79).  For each lane l (a
// leading index), from the carried (x, P), for t = 0 .. T-1:
//
//   x- = A x,  P- = A P A' + Q,  S = C P- C' + R,  K = P- C' S^-1,
//   x = x- + K (z_t - C x-),  P = (I - K C) P-,
//
// writing X (x at every step), the final (x, P) and, where asked (rts_smooth),
// Pf, Xp and Pp (P, x- and P- at every step).  n <= 8 states and m <= 8
// measurements are padded to N, M = 1, 2, 4 or 8 by the wrapper
// (ops/cuda_track.py; exact: padded states enter as zero rows and columns,
// padded measurements as zero rows of C with 1 on R's padded diagonal, so
// every real entry's arithmetic is as without padding).
//
// Bound: bytes.  The first design (track_scan.cu) walked each sequence on
// one thread: one SM of 132 busy, 107.4 ns a step on an H100, held by the
// step's chain (a division and ~15 dependent operations); 113 ms for
// kalman_apply over 2^20 steps, whose bytes take ~4 us at 3.35 TB/s.  This
// design takes ~0.05 ms there (n = 2, m = 1, float32), its three passes
// each a latency chain: a chunk's walk, and ~0.45 us a round of the float64
// joins (torch_kernel_sweep.py s4 has the passes' times).
//
// Design.  K_t depends on the true P at step t, so the state map x -> (I -
// K_t C) A x + K_t z_t is not known before the walk, and the Riccati map of
// P is linear-fractional.  Sarkka and Garcia-Fernandez's filtering elements
// ("Temporal Parallelization of Bayesian Smoothers", IEEE TAC 66(1), 2021)
// carry x and P together: a step is (A, b, C, eta, J), the conditional x_t
// | x_{t-1}, z_t = N(A x_{t-1} + b, C) and the likelihood of z_t as an
// information pair (eta, J) over x_{t-1}; two elements combine with one
// solve of (I + C_i J_j), whose eigenvalues are at least 1 (no inverse of
// the model's A, no assumption that P converges).  The model is
// time-invariant, so only (b, eta) depend on z: a full chunk's (A, C, J) and
// the coefficients of its (b, eta) in its measurements, b = sum_i Wb[i] z_i
// and eta = sum_i We[i] z_i, are built once per model on the host in float64
// (ops/cuda_track.py::forward_tables).  Three launches, as the backward
// entry's (track_chunks.cu):
//   1. kf_chunk_elems: every (lane, chunk) sums its (b, eta) in float64 (2NM
//      multiply-adds a step), then the chunks of a block (a group) are joined
//      left to right by a Kogge-Stone scan of their elements in shared
//      memory (float64);
//   2. kf_group_starts: the groups' starts (x, P) in float64 from the carried
//      state: a block a lane, each thread a run of R groups' elements
//      composed, a Kogge-Stone scan of the runs, each run's groups again from
//      its true start;
//   3. kf_chunk_run: every chunk from its start (the joined element of the
//      chunks before it in its group applied to its group's start, rounded
//      once into the working type; the first chunk from the carried state
//      itself), walking the plain step and writing X (with Pf, Xp, Pp).
// Only full chunks' elements enter a join (the last chunk's never does).
// The solve in the join pivots (I + C J is not symmetric); the walk's solve
// is the first design's (S symmetric positive definite, no pivoting).  A
// chunk's measurements are staged through shared memory with cp.async, a
// sub-batch of SB steps (~384 bytes of inputs and outputs a chunk) ahead,
// and pass 3's outputs leave through the tile, consecutive threads on
// consecutive values (track_chunks.cu's staging).
//
// Serial depth: Lc + log2 CB + 2 R + log2(pass 2's threads) steps, not T.
// Inside a chunk the order and rounding of every operation are the plain
// version's (ops/kalman.py::kalman_forward_chunked_torch, _kf_step), with
// the _rn intrinsics: only the chunk starts differ, by the order of the
// float64 sums.  Tolerance against it: 1e-5 (float32) and 1e-11 (float64) x
// max of each output.
//
// Entry points (each returns the first failed launch's cudaError_t or 0; L
// lanes; N, M the padded sizes, 1, 2, 4 or 8):
//   kf_forward_chunked_f32 / _f64:  Z (L, T, M) -> X (L, T, N); x0, P0 ->
//                                   xo (L, N), Po (L, N, N); optional Pf (L,
//                                   T, N, N), Xp (L, T, N), Pp (L, T, N, N);
//                                   tabs, elems, starts float64

#include <cuda_runtime.h>

#include "track_chunks.cuh"

namespace {

// Every loop over the state's or the measurements' size is unrolled up to
// N = 4 (`#pragma unroll (N <= 4 ? 8 : 1)`) and rolled at N = 8, whose
// unrolled float64 algebra held 255 registers, spilled anyway and kept the
// build for minutes.
//
// chunks a block of passes 1 and 3, and pass 2's threads at most: an element
// is 3N^2 + 2N float64 values, and a block's elements stay within ~57 KB of
// shared memory (pass 2's within 48 KB)
__host__ __device__ constexpr int fwd_threads(int N) { return N <= 4 ? 128 : 32; }
__host__ __device__ constexpr int fwd_join(int N) { return N <= 2 ? 256 : N == 4 ? 64 : 16; }
__host__ __device__ constexpr int elem_size(int N) { return 3 * N * N + 2 * N; }

__host__ __device__ constexpr int pow2_at_most_32(int v) {
  return v >= 32 ? 32 : v >= 16 ? 16 : v >= 8 ? 8 : v >= 4 ? 4 : v >= 2 ? 2 : 1;
}

// Steps a sub-batch: two buffers of M measurements a step and, in pass 3,
// the step's outputs (x, and with kKeep P, x-, P-) fill ~384 bytes a chunk.
// Pass 1 takes kKeep = false, so a chunk is a multiple of both passes'.
template <typename R, int N, int M, bool kKeep>
__host__ __device__ constexpr int fwd_sub() {
  return pow2_at_most_32((384 / (int)sizeof(R)) / (2 * M + N + (kKeep ? 2 * N * N + N : 0)));
}

// A chunk's tile: two input buffers of SB rows of z, with kOut SB rows of
// x (then, with kKeep, of P, x- and P-), and one pad value.
template <typename R, int N, int M, bool kOut, bool kKeep>
struct FTile {
  static constexpr int SB = fwd_sub<R, N, M, kKeep>();
  static constexpr int IN = SB * M;
  static constexpr int XO = 2 * IN, PF = XO + SB * N, XP = PF + SB * N * N, PP = XP + SB * N;
  static constexpr int OUT = kOut ? SB * (N + (kKeep ? 2 * N * N + N : 0)) : 0;
  static constexpr int STRIDE = 2 * IN + OUT + 1;
};

template <typename R>
struct FwdArgs {
  const R* Z; const R* A; const R* C; const R* Q; const R* Rm; const R* x0; const R* P0;
  R* X; R* xo; R* Po; R* Pf; R* Xp; R* Pp;
};

// Thread tid's share of the block's CB chunks x WS values (WS = SB W, a
// sub-batch of SB rows of W values a chunk): values tid, tid + CB, ...,
// value k of chunk qc each, visited by stepping (qc, k) rather than
// dividing.  fn(qc, k, row) for each, row the value's row in the chunk's
// sub-batch.  The loop is not unrolled: unrolled, each value's 64-bit
// address was kept live across the walk (255 registers, spilled).
template <int W, int SB, int CB, typename Fn>
__device__ __forceinline__ void block_values(Fn fn) {
  constexpr int WS = SB * W;
  int qc = CB >= WS ? threadIdx.x / WS : 0;
  int k = CB >= WS ? threadIdx.x % WS : threadIdx.x;
#pragma unroll 1
  for (int it = 0; it < WS; ++it) {
    fn(qc, k);
    if (CB >= WS) {
      qc += CB / WS;
    } else {
      k += CB;
      if (k >= WS) {
        k -= WS;
        ++qc;
      }
    }
  }
}

// Start copying sub-batch sb of each of the block's CB chunks' measurements
// (rows (c0 + qc) Lc + sb SB .. + SB - 1 of the lane's Zl) into dst + qc
// STRIDE, as one copy group, consecutive threads on consecutive values;
// rows past T are left out.
template <typename R, int M, int SB, int CB, int STRIDE>
__device__ __forceinline__ void stage_z(R* dst, const R* __restrict__ Zl, const Geo& g,
                                        long long c0, int sb) {
  const long long r0 = c0 * g.Lc + (long long)sb * SB;
  block_values<M, SB, CB>([&](int qc, int k) {
    const long long t = r0 + (long long)qc * g.Lc;
    if (t + k / M < g.T) copy_async(dst + qc * STRIDE + k, Zl + t * M + k);
  });
  copy_commit();
}

// The walk over this thread's chunk, staged: step(k, z) for each of its
// steps k = 0 .. Lc-1 that lies before T, z its M measurements in shared
// memory; after(sb) once a sub-batch's steps are done (every thread of the
// block calls walk_z; after(sb) runs after a barrier, and the next
// sub-batch's steps after another).
template <typename R, int M, int SB, int CB, int STRIDE, typename StepFn, typename After>
__device__ __forceinline__ void walk_z(R* tile, const R* __restrict__ Zl, const Geo& g,
                                       long long c0, bool live, StepFn step, After after) {
  constexpr int IN = SB * M;
  const R* mine = tile + threadIdx.x * STRIDE;
  const int nsb = g.Lc / SB;
  const long long s0 = (c0 + threadIdx.x) * g.Lc;
  stage_z<R, M, SB, CB, STRIDE>(tile, Zl, g, c0, 0);
  for (int sb = 0; sb < nsb; ++sb) {
    if (sb + 1 < nsb) {
      stage_z<R, M, SB, CB, STRIDE>(tile + ((sb + 1) & 1) * IN, Zl, g, c0, sb + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (live) {
      // not unrolled: a step is a long dependent chain, and SB copies of it
      // held 255 registers and spilled
#pragma unroll 1
      for (int i = 0; i < SB; ++i) {
        if (s0 + (long long)sb * SB + i < g.T) step(sb * SB + i, mine + (sb & 1) * IN + i * M);
      }
    }
    __syncthreads();
    after(sb);
  }
}

// One predict/update in the plain version's order (ops/kalman.py::_kf_step:
// each sum left to right, every operation rounded): (x, P) <- the step,
// xp, Pp the prediction.
template <typename R, int N, int M>
__device__ __forceinline__ void kf_step(const R (&A)[N][N], const R (&C)[M][N], const R (&Q)[N][N],
                                        const R (&Rr)[M][M], const R* z, R (&x)[N], R (&P)[N][N],
                                        R (&xp)[N], R (&Pp)[N][N]) {
  R AP[N][N];
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    R s = mul(A[i][0], x[0]);
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 1; j < N; ++j) s = add(s, mul(A[i][j], x[j]));
    xp[i] = s;
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      R u = mul(A[i][0], P[0][j]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 1; k < N; ++k) u = add(u, mul(A[i][k], P[k][j]));
      AP[i][j] = u;
    }
  }
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      R s = mul(AP[i][0], A[j][0]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 1; k < N; ++k) s = add(s, mul(AP[i][k], A[j][k]));
      Pp[i][j] = add(s, Q[i][j]);
    }
  // Y = (Pp C')' (M x N), St = (C Pp C' + R)'
  R Y[M][N], St[M][M];
#pragma unroll (N <= 4 ? 8 : 1)
  for (int j = 0; j < M; ++j)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = 0; i < N; ++i) {
      R s = mul(Pp[i][0], C[j][0]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 1; k < N; ++k) s = add(s, mul(Pp[i][k], C[j][k]));
      Y[j][i] = s;
    }
#pragma unroll (N <= 4 ? 8 : 1)
  for (int j = 0; j < M; ++j)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = 0; i < M; ++i) {
      R s = mul(C[i][0], Y[j][0]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 1; k < N; ++k) s = add(s, mul(C[i][k], Y[j][k]));
      St[j][i] = add(s, Rr[i][j]);
    }
  spd_solve(St, Y);                           // Y = K' (M x N)
  R v[M];
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < M; ++i) {
    R s = mul(C[i][0], xp[0]);
#pragma unroll (N <= 4 ? 8 : 1)
    for (int k = 1; k < N; ++k) s = add(s, mul(C[i][k], xp[k]));
    v[i] = sub(z[i], s);
  }
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    R s = mul(Y[0][i], v[0]);
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 1; j < M; ++j) s = add(s, mul(Y[j][i], v[j]));
    x[i] = add(xp[i], s);
  }
  R IKC[N][N];
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      R s = mul(Y[0][i], C[0][j]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int l = 1; l < M; ++l) s = add(s, mul(Y[l][i], C[l][j]));
      IKC[i][j] = sub(i == j ? R(1) : R(0), s);
    }
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      R s = mul(IKC[i][0], Pp[0][j]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 1; k < N; ++k) s = add(s, mul(IKC[i][k], Pp[k][j]));
      P[i][j] = s;
    }
}

// ---------------------------------------------------------------------------
// The filtering elements, in float64
// ---------------------------------------------------------------------------

template <int N>
struct Elem {
  double A[N][N], b[N], C[N][N], e[N], J[N][N];
};

// An element's values at p[w * stride]: A, b, C, eta, J
template <int N>
__device__ __forceinline__ void elem_store(const Elem<N>& m, double* p, int stride) {
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    p[(N * N + i) * stride] = m.b[i];
    p[(2 * N * N + N + i) * stride] = m.e[i];
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      p[(i * N + j) * stride] = m.A[i][j];
      p[(N * N + N + i * N + j) * stride] = m.C[i][j];
      p[(2 * N * N + 2 * N + i * N + j) * stride] = m.J[i][j];
    }
  }
}

template <int N>
__device__ __forceinline__ void elem_load(Elem<N>& m, const double* p, int stride) {
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    m.b[i] = p[(N * N + i) * stride];
    m.e[i] = p[(2 * N * N + N + i) * stride];
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      m.A[i][j] = p[(i * N + j) * stride];
      m.C[i][j] = p[(N * N + N + i * N + j) * stride];
      m.J[i][j] = p[(2 * N * N + 2 * N + i * N + j) * stride];
    }
  }
}

// The element that changes nothing: A = I, the rest 0.
template <int N>
__device__ __forceinline__ void elem_identity(Elem<N>& m) {
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    m.b[i] = 0.0;
    m.e[i] = 0.0;
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      m.A[i][j] = i == j ? 1.0 : 0.0;
      m.C[i][j] = 0.0;
      m.J[i][j] = 0.0;
    }
  }
}

// W <- (I + X Y)^-1 by elimination with partial pivoting (row swaps by
// compare-and-select, so the matrices stay in registers), then back
// substitution, one division a pivot.  I + X Y has eigenvalues >= 1 for X,
// Y positive semidefinite, but a leading pivot can still vanish.
template <int N>
__device__ __forceinline__ void inv_i_plus(const double (&X)[N][N], const double (&Y)[N][N],
                                           double (&W)[N][N]) {
  double M[N][N], inv[N];
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      double s = i == j ? 1.0 : 0.0;
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 0; k < N; ++k) s = fma(X[i][k], Y[k][j], s);
      M[i][j] = s;
      W[i][j] = i == j ? 1.0 : 0.0;
    }
#pragma unroll (N <= 4 ? 8 : 1)
  for (int k = 0; k < N; ++k) {
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = k + 1; i < N; ++i) {
      const bool swap = fabs(M[i][k]) > fabs(M[k][k]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = 0; j < N; ++j) {
        const double mk = M[k][j], mi = M[i][j], wk = W[k][j], wi = W[i][j];
        M[k][j] = swap ? mi : mk;
        M[i][j] = swap ? mk : mi;
        W[k][j] = swap ? wi : wk;
        W[i][j] = swap ? wk : wi;
      }
    }
    inv[k] = 1.0 / M[k][k];
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = k + 1; i < N; ++i) {
      const double f = M[i][k] * inv[k];
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = k; j < N; ++j) M[i][j] = fma(-f, M[k][j], M[i][j]);
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = 0; j < N; ++j) W[i][j] = fma(-f, W[k][j], W[i][j]);
    }
  }
#pragma unroll (N <= 4 ? 8 : 1)
  for (int k = N - 1; k >= 0; --k) {
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      double s = W[k][j];
#pragma unroll (N <= 4 ? 8 : 1)
      for (int l = k + 1; l < N; ++l) s = fma(-M[k][l], W[l][j], s);
      W[k][j] = s * inv[k];
    }
  }
}

// D <- X Y (T: Y transposed)
template <int N, bool kT = false>
__device__ __forceinline__ void mat_mul(const double (&X)[N][N], const double (&Y)[N][N],
                                        double (&D)[N][N]) {
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      double s = 0.0;
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 0; k < N; ++k) s = fma(X[i][k], kT ? Y[j][k] : Y[k][j], s);
      D[i][j] = s;
    }
}

template <int N>
__device__ __forceinline__ void mat_vec(const double (&X)[N][N], const double (&v)[N],
                                        double (&d)[N]) {
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    double s = 0.0;
#pragma unroll (N <= 4 ? 8 : 1)
    for (int k = 0; k < N; ++k) s = fma(X[i][k], v[k], s);
    d[i] = s;
  }
}

// later <- later o earlier (earlier applied first): W = (I + C1 J2)^-1,
// A = A2 W A1, b = A2 W (b1 + C1 eta2) + b2, C = A2 W C1 A2' + C2,
// eta = A1' W' (eta2 - J2 b1) + eta1, J = A1' W' J2 A1 + J1.
template <int N>
__device__ __forceinline__ void elem_after_body(Elem<N>& later, const Elem<N>& earlier) {
  double W[N][N], T1[N][N], U[N][N], D[N][N], v[N], u[N];
  inv_i_plus(earlier.C, later.J, W);
  mat_mul(later.A, W, T1);
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      double s = 0.0;
#pragma unroll (N <= 4 ? 8 : 1)
      for (int k = 0; k < N; ++k) s = fma(earlier.A[k][i], W[j][k], s);
      U[i][j] = s;                               // A1' W'
    }
  // b and eta first: they read b1, eta2 and J2 before J is replaced
  mat_vec(earlier.C, later.e, v);
  mat_vec(later.J, earlier.b, u);
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    v[i] += earlier.b[i];
    u[i] = later.e[i] - u[i];
  }
  double nb[N], ne[N];
  mat_vec(T1, v, nb);
  mat_vec(U, u, ne);
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    later.b[i] += nb[i];
    later.e[i] = ne[i] + earlier.e[i];
  }
  // C = T1 C1 A2' + C2 (A2 still the later's own)
  mat_mul(T1, earlier.C, D);
  double NC[N][N];
  mat_mul<N, true>(D, later.A, NC);
  // J = U J2 A1 + J1
  mat_mul(U, later.J, D);
  double NJ[N][N];
  mat_mul(D, earlier.A, NJ);
  mat_mul(T1, earlier.A, D);                     // A = T1 A1
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      later.C[i][j] += NC[i][j];
      later.J[i][j] = NJ[i][j] + earlier.J[i][j];
      later.A[i][j] = D[i][j];
    }
}

// (x, P) <- the state before the element's first step carried through it:
// W = (I + P J)^-1, x = A W (x + P eta) + b, P = A W P A' + C.
template <int N>
__device__ __forceinline__ void elem_apply_body(const Elem<N>& m, double (&x)[N],
                                                double (&P)[N][N]) {
  double W[N][N], T1[N][N], D[N][N], v[N];
  inv_i_plus(P, m.J, W);
  mat_mul(m.A, W, T1);
  mat_vec(P, m.e, v);
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) v[i] += x[i];
  mat_vec(T1, v, x);
  mat_mul(T1, P, D);
  mat_mul<N, true>(D, m.A, P);
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    x[i] += m.b[i];
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) P[i][j] += m.C[i][j];
  }
}

// From N = 4 the element algebra (thousands of float64 operations) is one
// function of its own, called from every kernel of that N, rather than
// inlined into each (M, kKeep) instance: the inlined copies spilled and
// held the build for minutes.
template <int N>
__device__ __noinline__ void elem_after_call(Elem<N>& later, const Elem<N>& earlier) {
  elem_after_body(later, earlier);
}
template <int N>
__device__ __noinline__ void elem_apply_call(const Elem<N>& m, double (&x)[N], double (&P)[N][N]) {
  elem_apply_body(m, x, P);
}
template <int N>
__device__ __forceinline__ void elem_after(Elem<N>& later, const Elem<N>& earlier) {
  if constexpr (N >= 4) {
    elem_after_call(later, earlier);
  } else {
    elem_after_body(later, earlier);
  }
}
template <int N>
__device__ __forceinline__ void elem_apply(const Elem<N>& m, double (&x)[N], double (&P)[N][N]) {
  if constexpr (N >= 4) {
    elem_apply_call(m, x, P);
  } else {
    elem_apply_body(m, x, P);
  }
}

// The carried state of lane l, widened.
template <typename R, int N>
__device__ __forceinline__ void carried(const FwdArgs<R>& a, long long l, double (&x)[N],
                                        double (&P)[N][N]) {
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    x[i] = (double)a.x0[l * N + i];
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) P[i][j] = (double)a.P0[(l * N + i) * N + j];
  }
}

// ---------------------------------------------------------------------------
// The three passes
// ---------------------------------------------------------------------------

// Pass 1's and pass 3's dynamic shared memory: the tiles, and pass 1's
// elements for the join after the walk.
template <typename R, int N, int M, bool kOut, bool kKeep>
__host__ __device__ constexpr size_t fwd_smem() {
  return (size_t)fwd_threads(N) * FTile<R, N, M, kOut, kKeep>::STRIDE * sizeof(R) >
                 (kOut ? 0 : (size_t)fwd_threads(N) * elem_size(N) * sizeof(double))
             ? (size_t)fwd_threads(N) * FTile<R, N, M, kOut, kKeep>::STRIDE * sizeof(R)
             : (size_t)fwd_threads(N) * elem_size(N) * sizeof(double);
}

// Pass 1: each chunk's element from its measurements, joined within each
// group.  tabs: Ac, Cc, Jc (N x N), then Wb, We (Lc x N x M).
template <typename R, int N, int M>
__global__ void __launch_bounds__(fwd_threads(N))
kf_chunk_elems(const R* __restrict__ Z, const double* __restrict__ tabs,
               double* __restrict__ elems, const Geo g) {
  using Tl = FTile<R, N, M, false, false>;
  constexpr int CB = fwd_threads(N), EW = elem_size(N);
  extern __shared__ __align__(16) unsigned char dsm[];
  const int tid = threadIdx.x;
  const long long l = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * CB;
  const long long c = c0 + tid;
  const double* Wb = tabs + 3 * N * N;
  const double* We = Wb + (size_t)g.Lc * N * M;
  Elem<N> el;
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i) {
    el.b[i] = 0.0;
    el.e[i] = 0.0;
  }
  walk_z<R, M, Tl::SB, CB, Tl::STRIDE>(
      reinterpret_cast<R*>(dsm), Z + l * g.T * M, g, c0, c < g.nc,
      [&](int k, const R* z) {
        const double* wb = Wb + (size_t)k * N * M;
        const double* we = We + (size_t)k * N * M;
#pragma unroll (N <= 4 ? 8 : 1)
        for (int j = 0; j < M; ++j) {
          const double zj = (double)z[j];
#pragma unroll (N <= 4 ? 8 : 1)
          for (int i = 0; i < N; ++i) {
            el.b[i] = fma(__ldg(wb + i * M + j), zj, el.b[i]);
            el.e[i] = fma(__ldg(we + i * M + j), zj, el.e[i]);
          }
        }
      },
      [](int) {});
#pragma unroll (N <= 4 ? 8 : 1)
  for (int i = 0; i < N; ++i)
#pragma unroll (N <= 4 ? 8 : 1)
    for (int j = 0; j < N; ++j) {
      el.A[i][j] = __ldg(tabs + i * N + j);
      el.C[i][j] = __ldg(tabs + N * N + i * N + j);
      el.J[i][j] = __ldg(tabs + 2 * N * N + i * N + j);
    }
  // the group's chunks joined: chunk j's element after those of the chunks
  // before it
  double* sh = reinterpret_cast<double*>(dsm);      // [value][thread]
  elem_store(el, sh + tid, CB);
  __syncthreads();
  for (int off = 1; off < CB; off <<= 1) {
    const bool has = tid >= off;
    if (has) {
      Elem<N> earlier;
      elem_load(earlier, sh + tid - off, CB);
      elem_after(el, earlier);
    }
    __syncthreads();
    if (has) elem_store(el, sh + tid, CB);
    __syncthreads();
  }
  if (c < g.nc) elem_store(el, elems + (l * g.nc + c) * EW, 1);
}

// Pass 2: the groups' starts 1 .. ng-1 of each lane (x, P in float64) into
// starts (L, ng - 1, N + N^2); a block a lane, 2^tl threads, each a run of
// 2^rl groups.
template <typename R, int N>
__global__ void __launch_bounds__(fwd_join(N))
kf_group_starts(const FwdArgs<R> a, const double* __restrict__ elems,
                double* __restrict__ starts, const Geo g) {
  constexpr int CB = fwd_threads(N), EW = elem_size(N), SW = state_size(N);
  __shared__ double sh[EW * fwd_join(N)];            // [value][thread]
  const int J = 1 << g.tl, RG = 1 << g.rl;
  const int tid = threadIdx.x;
  const long long l = blockIdx.x;
  const int nj = g.ng - 1;
  const int m0 = tid * RG;
  const int m1 = m0 + RG < nj ? m0 + RG : nj;
  auto group_elem = [&](Elem<N>& ge, int m) {
    elem_load(ge, elems + (l * g.nc + (long long)m * CB + CB - 1) * EW, 1);
  };
  Elem<N> run;
  elem_identity(run);
  for (int m = m0; m < m1; ++m) {
    Elem<N> ge;
    group_elem(ge, m);
    elem_after(ge, run);
    run = ge;
  }
  elem_store(run, sh + tid, J);
  __syncthreads();
  for (int off = 1; off < J; off <<= 1) {
    const bool has = tid >= off;
    if (has) {
      Elem<N> earlier;
      elem_load(earlier, sh + tid - off, J);
      elem_after(run, earlier);
    }
    __syncthreads();
    if (has) elem_store(run, sh + tid, J);
    __syncthreads();
  }
  // this run's true start: the carried state, after the runs before
  double x[N], P[N][N];
  carried(a, l, x, P);
  if (tid > 0) {
    Elem<N> before;
    elem_load(before, sh + tid - 1, J);
    elem_apply(before, x, P);
  }
  for (int m = m0; m < m1; ++m) {
    Elem<N> ge;
    group_elem(ge, m);
    elem_apply(ge, x, P);
    double* o = starts + (l * nj + m) * SW;
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = 0; i < N; ++i) {
      o[i] = x[i];
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = 0; j < N; ++j) o[N + i * N + j] = P[i][j];
    }
  }
}

// Copy W values a row of each of the block's CB chunks' sub-batch sb of
// output rows from the tiles (src + qc STRIDE) to the lane's rows of dst,
// consecutive threads on consecutive values; rows past T are left out.
template <int W, int SB, int CB, int STRIDE, typename R>
__device__ __forceinline__ void unstage_rows(R* __restrict__ dst, const R* src, const Geo& g,
                                             long long c0, int sb) {
  const long long r0 = c0 * g.Lc + (long long)sb * SB;
  block_values<W, SB, CB>([&](int qc, int w) {
    const long long t = r0 + (long long)qc * g.Lc;
    if (t + w / W < g.T) dst[t * W + w] = src[qc * STRIDE + w];
  });
}

// Pass 3: every chunk from its true start, writing X (Pf, Xp, Pp with
// kKeep) and the last chunk the final state.
template <typename R, int N, int M, bool kKeep>
__global__ void __launch_bounds__(fwd_threads(N))
kf_chunk_run(const FwdArgs<R> a, const double* __restrict__ elems,
             const double* __restrict__ starts, const Geo g) {
  using Tl = FTile<R, N, M, true, kKeep>;
  constexpr int CB = fwd_threads(N), EW = elem_size(N), SW = state_size(N);
  constexpr int SB = Tl::SB, ST = Tl::STRIDE;
  extern __shared__ __align__(16) unsigned char dsm[];
  R* tile = reinterpret_cast<R*>(dsm);
  const int tid = threadIdx.x;
  const long long l = blockIdx.y;
  const int m = blockIdx.x;
  const long long c0 = (long long)m * CB;
  const long long c = c0 + tid;
  const bool live = c < g.nc;
  R A[N][N], C[M][N], Q[N][N], Rr[M][M], x[N], P[N][N];
  load_f(A, a.A);
  load_f(C, a.C);
  load_f(Q, a.Q);
  load_f(Rr, a.Rm);
  if (c == 0) {
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = 0; i < N; ++i) {
      x[i] = a.x0[l * N + i];
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = 0; j < N; ++j) P[i][j] = a.P0[(l * N + i) * N + j];
    }
  } else if (live) {
    double xd[N], Pd[N][N];
    if (m == 0) {
      carried(a, l, xd, Pd);
    } else {
      const double* st = starts + (l * (g.ng - 1) + m - 1) * SW;
#pragma unroll (N <= 4 ? 8 : 1)
      for (int i = 0; i < N; ++i) {
        xd[i] = st[i];
#pragma unroll (N <= 4 ? 8 : 1)
        for (int j = 0; j < N; ++j) Pd[i][j] = st[N + i * N + j];
      }
    }
    if (tid > 0) {
      Elem<N> before;
      elem_load(before, elems + (l * g.nc + c - 1) * EW, 1);
      elem_apply(before, xd, Pd);
    }
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = 0; i < N; ++i) {
      x[i] = (R)xd[i];
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = 0; j < N; ++j) P[i][j] = (R)Pd[i][j];
    }
  }
  R* mine = tile + tid * ST;
  const long long lT = l * g.T;
  walk_z<R, M, SB, CB, ST>(
      tile, a.Z + lT * M, g, c0, live,
      [&](int k, const R* z) {
        R xp[N], Pp[N][N];
        kf_step(A, C, Q, Rr, z, x, P, xp, Pp);
        const int i = k % SB;                        // the row in the sub-batch
#pragma unroll (N <= 4 ? 8 : 1)
        for (int r = 0; r < N; ++r) {
          mine[Tl::XO + i * N + r] = x[r];
          if (kKeep) {
            mine[Tl::XP + i * N + r] = xp[r];
#pragma unroll (N <= 4 ? 8 : 1)
            for (int q = 0; q < N; ++q) {
              mine[Tl::PF + (i * N + r) * N + q] = P[r][q];
              mine[Tl::PP + (i * N + r) * N + q] = Pp[r][q];
            }
          }
        }
      },
      [&](int sb) {
        unstage_rows<N, SB, CB, ST>(a.X + lT * N, tile + Tl::XO, g, c0, sb);
        if (kKeep) {
          unstage_rows<N * N, SB, CB, ST>(a.Pf + lT * N * N, tile + Tl::PF, g, c0, sb);
          unstage_rows<N, SB, CB, ST>(a.Xp + lT * N, tile + Tl::XP, g, c0, sb);
          unstage_rows<N * N, SB, CB, ST>(a.Pp + lT * N * N, tile + Tl::PP, g, c0, sb);
        }
      });
  if (c == g.nc - 1) {
#pragma unroll (N <= 4 ? 8 : 1)
    for (int i = 0; i < N; ++i) {
      a.xo[l * N + i] = x[i];
#pragma unroll (N <= 4 ? 8 : 1)
      for (int j = 0; j < N; ++j) a.Po[(l * N + i) * N + j] = P[i][j];
    }
  }
}

template <typename R, int N, int M, bool kKeep>
int run_launch(const FwdArgs<R>& a, const double* elems, const double* starts, const Geo& g,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<R, N, M, true, kKeep>();
  const int e = allow_smem(kf_chunk_run<R, N, M, kKeep>, smem);
  if (e != 0) return e;
  kf_chunk_run<R, N, M, kKeep><<<dim3((unsigned)g.ng, (unsigned)g.L), fwd_threads(N), smem, stream>>>(a, elems, starts, g);
  return (int)cudaGetLastError();
}

template <typename R, int N, int M>
int fwd_launch(const FwdArgs<R>& a, const double* tabs, double* elems, double* starts,
               const Geo& g, cudaStream_t stream) {
  if (g.Lc % FTile<R, N, M, false, false>::SB) return (int)cudaErrorInvalidValue;
  if (g.nc > 1) {
    if (tabs == nullptr) return (int)cudaErrorInvalidValue;
    constexpr size_t smem1 = fwd_smem<R, N, M, false, false>();
    const int e1 = allow_smem(kf_chunk_elems<R, N, M>, smem1);
    if (e1 != 0) return e1;
    kf_chunk_elems<R, N, M><<<dim3((unsigned)g.ng, (unsigned)g.L), fwd_threads(N), smem1, stream>>>(a.Z, tabs, elems, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (g.ng > 1) {
      kf_group_starts<R, N><<<(unsigned)g.L, 1u << g.tl, 0, stream>>>(a, elems, starts, g);
      const cudaError_t err2 = cudaGetLastError();
      if (err2 != cudaSuccess) return (int)err2;
    }
  }
  return a.Pf != nullptr ? run_launch<R, N, M, true>(a, elems, starts, g, stream)
                         : run_launch<R, N, M, false>(a, elems, starts, g, stream);
}

template <typename R, int N>
int fwd_launch_m(const FwdArgs<R>& a, int mp, const double* tabs, double* elems, double* starts,
                 const Geo& g, cudaStream_t stream) {
  switch (mp) {
    case 1: return fwd_launch<R, N, 1>(a, tabs, elems, starts, g, stream);
    case 2: return fwd_launch<R, N, 2>(a, tabs, elems, starts, g, stream);
    case 4: return fwd_launch<R, N, 4>(a, tabs, elems, starts, g, stream);
    case 8: return fwd_launch<R, N, 8>(a, tabs, elems, starts, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename R>
int fwd_entry(const FwdArgs<R>& a, const void* tabs, void* elems, void* starts, int L,
              long long T, int N, int M, int Lc, int tl, int rl, int device,
              cudaStream_t stream) {
  if ((a.Pf == nullptr) != (a.Xp == nullptr) || (a.Pf == nullptr) != (a.Pp == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nc = Lc > 0 && T > 0 ? (T + Lc - 1) / Lc : 0;
  if (N != 1 && N != 2 && N != 4 && N != 8) return (int)cudaErrorInvalidValue;
  const int cb = fwd_threads(N);
  const long long ng = (nc + cb - 1) / cb;
  if (nc > 0x7fffffffLL || bad_geometry(T, L, Lc, (int)nc, (int)ng, cb, tl, rl, fwd_join(N)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geo g{T, L, Lc, (int)nc, (int)ng, tl, rl};
  const double* tb = static_cast<const double*>(tabs);
  double* el = static_cast<double*>(elems);
  double* st = static_cast<double*>(starts);
  switch (N) {
    case 1: return fwd_launch_m<R, 1>(a, M, tb, el, st, g, stream);
    case 2: return fwd_launch_m<R, 2>(a, M, tb, el, st, g, stream);
    case 4: return fwd_launch_m<R, 4>(a, M, tb, el, st, g, stream);
    case 8: return fwd_launch_m<R, 8>(a, M, tb, el, st, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The forward entry: Z (L, T, M), A (N, N), C (M, N), Q (N, N), Rm (M, M)
// (1 on its padded diagonal), x0 (L, N), P0 (L, N, N), of the entry's type
// -> X (L, T, N), xo (L, N), Po (L, N, N), and where Pf is not null Pf (L,
// T, N, N), Xp (L, T, N), Pp (L, T, N, N); tabs the model's tables of
// ops/cuda_track.py::forward_tables for Lc, padded (3 N^2 + 2 Lc N M
// float64; null where T <= Lc), elems (L, nc, 3N^2 + 2N) and starts (L,
// max(ng - 1, 1), N + N^2) float64 scratch; Lc a power of two and a
// multiple of pass 1's sub-batch (fwd_sub without kKeep), nc = ceil(T /
// Lc), ng = ceil(nc / CB) (CB 128 for N <= 4, 32 for N = 8); tl and rl from
// ops/cuda_track.py::fwd_geometry.  T >= 1.  On card `device`; launches up
// to three kernels on `stream`, does not synchronise, returns the first
// failed launch's cudaError_t or 0.
#define FWD_ENTRY(SUF, R)                                                              \
  extern "C" int kf_forward_chunked_##SUF(                                             \
      const void* Z, const void* A, const void* C, const void* Q, const void* Rm,      \
      const void* x0, const void* P0, void* X, void* xo, void* Po, void* Pf, void* Xp, \
      void* Pp, const void* tabs, void* elems, void* starts, int L, long long T, int N, \
      int M, int Lc, int tl, int rl, int device, cudaStream_t stream) {                \
    const FwdArgs<R> a{static_cast<const R*>(Z),  static_cast<const R*>(A),            \
                       static_cast<const R*>(C),  static_cast<const R*>(Q),            \
                       static_cast<const R*>(Rm), static_cast<const R*>(x0),           \
                       static_cast<const R*>(P0), static_cast<R*>(X),                  \
                       static_cast<R*>(xo),       static_cast<R*>(Po),                 \
                       static_cast<R*>(Pf),       static_cast<R*>(Xp),                 \
                       static_cast<R*>(Pp)};                                           \
    return fwd_entry<R>(a, tabs, elems, starts, L, T, N, M, Lc, tl, rl, device, stream); \
  }

FWD_ENTRY(f32, float)
FWD_ENTRY(f64, double)
