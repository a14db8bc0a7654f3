// S4's steady-state (LTI) walk and the Rauch-Tung-Striebel smoother's
// backward walk, for Hopper (sm_90a): time-parallel chunk-and-join
// recurrences.  S4's third entry, the filter's forward walk, is
// track_forward.cu, of the same three-pass shape and the backward entry's
// staging; track_chunks.cuh holds what the two files share.
//
// Neither replaces a TPU kernel: in the JAX package each is a lax.scan or an
// associative scan, solid_dsp_tpu/ops/kalman.py::kalman_apply's RTS pass in
// rts_smooth (:110-121, the reversed lax.scan) and kalman_lti_apply (:172-183,
// "scan" and "parallel").  For each lane l (a leading index), with n <= 8
// states padded to N = 1, 2, 4 or 8 by the wrapper (ops/cuda_track.py; the
// padding is exact: padded rows and columns are zero, the backward entry's
// P- has 1 on its padded diagonal, so every real entry's arithmetic is as
// without padding and every padded one stays 0):
//
//   LTI:      x_t = F x_{t-1} + b_t,            t = 0 .. T-1, x_{-1} carried in
//   backward: G_t = P_t A' (P-_{t+1})^-1,       t = T-2 .. 0, from the filter's
//             x^_t = x_t + G_t (x^_{t+1} - x-_{t+1}),     last step
//             P^_t = P_t + G_t (P^_{t+1} - P-_{t+1}) G_t'
//
// Bound: bytes.  The first design walked each sequence on one thread (one
// thread a lane, every call one lane: one SM of 132 busy), held by its
// chain (LTI, 22.4 ns a step) or by issue (backward, 224.4 ns a step: the
// gain's solve and three n x n products a step, none of which depends on
// the carry).  Both recurrences are affine, so both run as chunk-and-join
// (iir_scan.cu's design, S3):
//
// LTI.  The state after a chunk of Lc steps is Phi (state before) + (the
// chunk walked from a zero state), Phi = F^Lc, the same for every chunk.
// Three launches, as S3's:
//   1. lti_chunk_ends: every (lane, chunk) from a zero state to its end,
//      then the kLtiThreads chunks of a block (a group) joined from a zero
//      start by a Kogge-Stone scan in shared memory through Phi^(2^d);
//   2. lti_group_starts: the groups' starts G_{m+1} = Phi^CB G_m + (group m's
//      last joined chunk), G_0 the carried state: a block a lane, each
//      thread a run of R groups from a zero start, a Kogge-Stone scan over
//      the runs through Phi^(CB R 2^d), each run again from its true start;
//   3. lti_chunk_run: every chunk from its start Phi^j G_m + loc_{j-1},
//      writing X; the last chunk also x_T.
// The tables Phi^j (j = 1 .. CB) and Phi^(CB 2^d) are built once per F on
// the host in extended precision and rounded once to float64
// (ops/linrec.py::join_tables); the join runs in float64, so each chunk
// start is rounded once into the working type.  A chunk's rows are staged
// through shared memory in sub-batches of 32 values a chunk (32 / N rows, so
// Lc is a multiple of 32 / N), loaded by the whole block a warp a chunk's 32
// values so that the loads coalesce on one lane, the next sub-batch in
// registers while the current one is walked; pass 3's rows leave through
// the tile the same way.  The index of each of a thread's 32 values is a
// compile-time stride from its first (an index computed per value held
// ~250 registers a thread and ran at 14 % of the bound on an H100).
//
// Backward.  A chunk's steps compose into one map of the same form,
// x -> M x + e and P -> M P M' + E (maps P -> G P G' + D compose into maps of
// that form): M = G_{t0} ... G_{t1-1}, and (e, E) is the chunk walked from a
// zero state, since the step is x -> G x + (x_t - G x-_{t+1}) and P -> G P G'
// + (P_t - G P-_{t+1} G'), c_t and D_t being what the step gives from zero.
// Unlike S3's and the LTI's, these maps depend on the data (the filter's
// covariances), so they are built on the card, like K6's per-lane tables
// (iir_bank.cu).  Three launches:
//   1. rts_chunk_maps: every (lane, chunk) computes its steps' gains G_t (in
//      the working type, the plain version's solve) and composes them in
//      float64 into (M, e, E), from the last step backward; then the
//      chunks of a block (a group) are joined right to left by a
//      Kogge-Stone scan of the maps in shared memory (float64);
//   2. rts_group_starts: the groups' starts (x^, P^) in float64, from the
//      filter's last step: a block a lane, each thread a run of R groups'
//      maps composed, a Kogge-Stone scan of the runs' maps, each run's
//      groups again from its true start;
//   3. rts_chunk_run: every chunk from its start, the joined map of the
//      chunks before it in its group applied to its group's start and
//      rounded once into the working type, walking the plain version's step
//      (its gain recomputed) and writing X^ and P^; the first chunk starts
//      from the filter's last step itself and writes it, bit for bit.
// The gains are recomputed in pass 3 rather than kept: a kept G_t (N^2
// values a step, written in pass 1 and read in pass 3) costs more bytes
// than reading the step's inputs again (2N + 2N^2 values, which pass 3 reads
// anyway for the step) and the solve is a few dozen operations on data
// already on chip.  A block's chunks are adjacent in time, so each chunk's
// steps of a sub-batch (SB steps, ~192 bytes of inputs) are contiguous rows
// of each input: passes 1 and 3 copy them into shared memory with cp.async,
// consecutive threads on consecutive values, into one of two buffers while
// the other sub-batch is walked, and pass 3's outputs leave through the tile
// the same way.  (Each thread loading and storing its own chunk's rows, a
// chunk apart across a warp, ran the entry at 0.22 ms at 2^20 on an H100;
// staging only the stores, at 0.29.)
//
// Serial depth: Lc + log2 CB + 2 R + log2(pass 2's threads) steps, not T.
// Inside a chunk the order and rounding of every operation are the plain
// versions' (ops/kalman.py::lti_chunked_torch, rts_backward_chunked_torch),
// with the _rn intrinsics so that nvcc contracts nothing into an FMA: only
// the chunk starts differ, by the order of the float64 join's sums.
// Tolerance against them: LTI 1e-6 x max|X| (float32) and 1e-12 (float64),
// times max(1, g / 16) for F's transient gain g (ops/linrec.py::
// transient_gain), as S3's; backward 1e-5 (float32) and 1e-11 (float64) x
// max of each output (its maps are applied as M P M', whose N^3 float64
// sums differ in order from the plain version's products).
//
// Entry points (each returns the first failed launch's cudaError_t or 0;
// L lanes; N the padded size, 1, 2, 4 or 8):
//   kf_lti_chunked_f32 / _f64:  Bin (L, T, N) -> X (L, T, N); st_in, st_out
//                               (L, N); tables, loc, G float64 scratch
//   rts_chunked_f32 / _f64:     Xf, Pf, Xp, Pp (L, T, ...), A (N, N) -> Xs
//                               (L, T, N), Ps (L, T, N, N); maps, starts
//                               float64 scratch

#include <cuda_runtime.h>

#include "track_chunks.cuh"

namespace {

// ---------------------------------------------------------------------------
// LTI
// ---------------------------------------------------------------------------

constexpr int kLtiThreads = 128;   // chunks a block of passes 1 and 3 (CB)
constexpr int kSub = 32;           // elements a chunk a sub-batch
constexpr int kJoin = 256;         // threads a block of pass 2, at most

template <typename R, int N>
__host__ __device__ constexpr size_t lti_smem() {
  return kLtiThreads * (kSub + 1) * sizeof(R) > kLtiThreads * N * sizeof(double)
             ? kLtiThreads * (kSub + 1) * sizeof(R)
             : kLtiThreads * N * sizeof(double);
}

// x <- F x + b, each row's sum left to right, every operation rounded
template <typename R, int N>
__device__ __forceinline__ void lti_step(const R (&F)[N][N], R (&x)[N], const R* b) {
  R xn[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    R s = mul(F[i][0], x[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) s = add(s, mul(F[i][j], x[j]));
    xn[i] = add(s, b[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xn[i];
}

// Walk this thread's chunk c0 + threadIdx.x of one lane (in, out: the
// lane's (T, N) rows) from x, staged as the note above says: a sub-batch is
// SB = 32 / N rows (kSub values) of each of the block's chunks, and thread
// (warp, lane) moves value `lane` of chunks warp, warp + 4, ... (Lc is a
// multiple of SB); kWrite: the states go to out.  Every thread of the block
// calls it; it ends with a __syncthreads, the tile free again.
template <typename R, int N, bool kWrite>
__device__ __forceinline__ void lti_walk(const R (&F)[N][N], R (&x)[N], const R* __restrict__ in,
                                         R* __restrict__ out, const Geo& g, long long c0,
                                         R* tile) {
  constexpr int SB = kSub / N;
  constexpr int kWarps = kLtiThreads / 32;
  constexpr int kSlotStride = kWarps * (kSub + 1);
  const int nsb = g.Lc / SB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long TN = g.T * N;
  const long long chunk_values = (long long)g.Lc * N;
  const long long first = (c0 + warp) * chunk_values + lane;
  const long long stride = kWarps * chunk_values;
  const int slot0 = warp * (kSub + 1) + lane;
  const long long c = c0 + tid;
  const bool live = c < g.nc;
  R reg[kSub];
  auto fetch = [&](int sb) {
    const long long g0 = first + (long long)sb * kSub;
#pragma unroll
    for (int it = 0; it < kSub; ++it) {
      const long long gi = g0 + it * stride;
      reg[it] = gi < TN ? in[gi] : R(0);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int it = 0; it < kSub; ++it) tile[slot0 + it * kSlotStride] = reg[it];
  };
  fetch(0);
  put();
  __syncthreads();
  for (int sb = 0; sb < nsb; ++sb) {
    if (sb + 1 < nsb) fetch(sb + 1);
    if (live) {
      const long long row0 = c * g.Lc + (long long)sb * SB;
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        if (row0 + i < g.T) {
          R* row = tile + tid * (kSub + 1) + i * N;
          lti_step(F, x, row);
          if (kWrite) {
#pragma unroll
            for (int j = 0; j < N; ++j) row[j] = x[j];
          }
        }
      }
    }
    __syncthreads();
    if (kWrite) {
      const long long g0 = first + (long long)sb * kSub;
#pragma unroll
      for (int it = 0; it < kSub; ++it) {
        const long long gi = g0 + it * stride;
        if (gi < TN) out[gi] = tile[slot0 + it * kSlotStride];
      }
    }
    if (sb + 1 < nsb) put();
    __syncthreads();
  }
}

// Pass 1: chunk ends from a zero state, joined within each group.
template <typename R, int N>
__global__ void __launch_bounds__(kLtiThreads)
lti_chunk_ends(const R* __restrict__ Bin, const R* __restrict__ Fm,
               const double* __restrict__ tabs, double* __restrict__ loc, const Geo g) {
  __shared__ __align__(16) unsigned char smem[lti_smem<R, N>()];
  const int tid = threadIdx.x;
  const long long l = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * kLtiThreads;
  R F[N][N], x[N];
  load_f(F, Fm);
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = R(0);
  lti_walk<R, N, false>(F, x, Bin + l * g.T * N, nullptr, g, c0, reinterpret_cast<R*>(smem));
  double* sh = reinterpret_cast<double*>(smem);     // [r][thread]
  double v[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    v[r] = (double)x[r];
    sh[r * kLtiThreads + tid] = v[r];
  }
  __syncthreads();
  for (int off = 1; off < kLtiThreads; off <<= 1) {
    const bool has = tid >= off;
    double u[N];
    if (has) {
      const double* P = tabs + (size_t)(off - 1) * N * N;     // Phi^off
#pragma unroll
      for (int r = 0; r < N; ++r) {
        double a = 0.0;
#pragma unroll
        for (int q = 0; q < N; ++q) a = fma(__ldg(P + r * N + q), sh[q * kLtiThreads + tid - off], a);
        u[r] = a;
      }
    }
    __syncthreads();
    if (has) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        v[r] += u[r];
        sh[r * kLtiThreads + tid] = v[r];
      }
    }
    __syncthreads();
  }
  const long long c = c0 + tid;
  if (c < g.nc) {
#pragma unroll
    for (int r = 0; r < N; ++r) loc[(l * g.nc + c) * N + r] = v[r];
  }
}

// Pass 2: the groups' starts G_1 .. G_{ng-1} of each lane into G (L, ng - 1,
// N); a block a lane, 2^tl threads, each a run of 2^rl groups.
template <typename R, int N>
__global__ void __launch_bounds__(kJoin)
lti_group_starts(const R* __restrict__ st_in, const double* __restrict__ loc,
                 const double* __restrict__ tabs, double* __restrict__ G, const Geo g) {
  __shared__ double sh[N * kJoin];                   // [r][thread]
  const int J = 1 << g.tl, RG = 1 << g.rl;
  const int tid = threadIdx.x;
  const long long l = blockIdx.x;
  const int nj = g.ng - 1;
  const int m0 = tid * RG;
  const int m1 = m0 + RG < nj ? m0 + RG : nj;
  const double* P1 = tabs + (size_t)kLtiThreads * N * N;     // Phi^CB
  double v[N];
  // v <- Phi^CB v + (group m's last joined chunk)
  auto advance = [&](int m) {
    const long long ce = (long long)m * kLtiThreads + kLtiThreads - 1;
    double u[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      double a = loc[(l * g.nc + ce) * N + r];
#pragma unroll
      for (int q = 0; q < N; ++q) a = fma(__ldg(P1 + r * N + q), v[q], a);
      u[r] = a;
    }
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = u[r];
  };
  auto carried = [&](int r) { return (double)st_in[l * N + r]; };
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] = tid == 0 ? carried(r) : 0.0;
  for (int m = m0; m < m1; ++m) advance(m);
#pragma unroll
  for (int r = 0; r < N; ++r) sh[r * J + tid] = v[r];
  __syncthreads();
  for (int d = 0, off = 1; off < J; ++d, off <<= 1) {
    const bool has = tid >= off;
    double u[N];
    if (has) {
      const double* P = tabs + (size_t)(kLtiThreads + g.rl + d) * N * N;   // Phi^(CB R off)
#pragma unroll
      for (int r = 0; r < N; ++r) {
        double a = 0.0;
#pragma unroll
        for (int q = 0; q < N; ++q) a = fma(__ldg(P + r * N + q), sh[q * J + tid - off], a);
        u[r] = a;
      }
    }
    __syncthreads();
    if (has) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        v[r] += u[r];
        sh[r * J + tid] = v[r];
      }
    }
    __syncthreads();
  }
  // this run's true start: the carried state, or the run before it's end
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] = tid == 0 ? carried(r) : sh[r * J + tid - 1];
  for (int m = m0; m < m1; ++m) {
    advance(m);
#pragma unroll
    for (int r = 0; r < N; ++r) G[(l * nj + m) * N + r] = v[r];
  }
}

// Pass 3: every chunk from its true start, writing X and the final state.
template <typename R, int N>
__global__ void __launch_bounds__(kLtiThreads)
lti_chunk_run(const R* __restrict__ Bin, R* __restrict__ X, const R* __restrict__ Fm,
              const R* __restrict__ st_in, R* __restrict__ st_out,
              const double* __restrict__ tabs, const double* __restrict__ loc,
              const double* __restrict__ G, const Geo g) {
  __shared__ __align__(16) unsigned char smem[lti_smem<R, N>()];
  const int tid = threadIdx.x;
  const long long l = blockIdx.y;
  const int m = blockIdx.x;
  const long long c = (long long)m * kLtiThreads + tid;
  R F[N][N], x[N];
  load_f(F, Fm);
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = R(0);
  if (c < g.nc) {
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < N; ++r) x[r] = st_in[l * N + r];
    } else {
      double gm[N];
#pragma unroll
      for (int r = 0; r < N; ++r)
        gm[r] = m == 0 ? (double)st_in[l * N + r]
                       : G[(l * (g.ng - 1) + m - 1) * N + r];
      if (tid == 0) {
#pragma unroll
        for (int r = 0; r < N; ++r) x[r] = (R)gm[r];
      } else {
        const double* P = tabs + (size_t)(tid - 1) * N * N;   // Phi^tid
#pragma unroll
        for (int r = 0; r < N; ++r) {
          double a = loc[(l * g.nc + c - 1) * N + r];
#pragma unroll
          for (int q = 0; q < N; ++q) a = fma(__ldg(P + r * N + q), gm[q], a);
          x[r] = (R)a;
        }
      }
    }
  }
  lti_walk<R, N, true>(F, x, Bin + l * g.T * N, X + l * g.T * N, g,
                       (long long)m * kLtiThreads, reinterpret_cast<R*>(smem));
  if (c == g.nc - 1) {
#pragma unroll
    for (int r = 0; r < N; ++r) st_out[l * N + r] = x[r];
  }
}

template <typename R, int N>
int lti_launch(const R* Bin, R* X, const R* F, const R* st_in, R* st_out,
               const double* tabs, double* loc, double* G, const Geo& g,
               cudaStream_t stream) {
  const dim3 grid((unsigned)g.ng, (unsigned)g.L);
  if (g.nc > 1) {
    lti_chunk_ends<R, N><<<grid, kLtiThreads, 0, stream>>>(Bin, F, tabs, loc, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (g.ng > 1) {
      lti_group_starts<R, N><<<(unsigned)g.L, 1u << g.tl, 0, stream>>>(st_in, loc, tabs, G, g);
      const cudaError_t err2 = cudaGetLastError();
      if (err2 != cudaSuccess) return (int)err2;
    }
  }
  lti_chunk_run<R, N><<<grid, kLtiThreads, 0, stream>>>(Bin, X, F, st_in, st_out, tabs, loc,
                                                         G, g);
  return (int)cudaGetLastError();
}

template <typename R>
int lti_entry(const void* Bin, void* X, const void* F, const void* st_in, void* st_out,
              const void* tabs, void* loc, void* G, int L, long long T, int N, int Lc,
              int tl, int rl, int device, cudaStream_t stream) {
  const long long nc = T > 0 && Lc > 0 ? (T + Lc - 1) / Lc : 0;
  const long long ng = (nc + kLtiThreads - 1) / kLtiThreads;
  if (nc > 0x7fffffffLL ||
      bad_geometry(T, L, Lc, (int)nc, (int)ng, kLtiThreads, tl, rl, kJoin))
    return (int)cudaErrorInvalidValue;
  if (N < 1 || N > kSub || Lc % (kSub / N)) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geo g{T, L, Lc, (int)nc, (int)ng, tl, rl};
  const R* b = static_cast<const R*>(Bin);
  R* x = static_cast<R*>(X);
  const R* f = static_cast<const R*>(F);
  const R* si = static_cast<const R*>(st_in);
  R* so = static_cast<R*>(st_out);
  const double* tb = static_cast<const double*>(tabs);
  double* lc = static_cast<double*>(loc);
  double* gs = static_cast<double*>(G);
  switch (N) {
    case 1: return lti_launch<R, 1>(b, x, f, si, so, tb, lc, gs, g, stream);
    case 2: return lti_launch<R, 2>(b, x, f, si, so, tb, lc, gs, g, stream);
    case 4: return lti_launch<R, 4>(b, x, f, si, so, tb, lc, gs, g, stream);
    case 8: return lti_launch<R, 8>(b, x, f, si, so, tb, lc, gs, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The RTS backward walk
// ---------------------------------------------------------------------------

// chunks a block of passes 1 and 3, and pass 2's threads at most: a map is
// 2N^2 + N float64 values, and a block's maps stay within 48 KB of shared
// memory
__host__ __device__ constexpr int rts_threads(int N) { return N <= 4 ? 128 : 32; }
__host__ __device__ constexpr int rts_join(int N) {
  return N <= 2 ? 256 : N == 4 ? 128 : 32;
}
__host__ __device__ constexpr int map_size(int N) { return 2 * N * N + N; }

template <typename R>
struct RtsArgs {
  const R* Xf; const R* Pf; const R* Xp; const R* Pp; const R* A;
  R* Xs; R* Ps;
};

// A step's inputs: the filter's x and P at t, the prediction at t + 1.
template <typename T, int N>
struct Step {
  T xf[N], Pf[N][N], xp[N], Pp[N][N];
};

// The walks' staging: a sub-batch is SB steps of each of the block's
// chunks.  Its inputs (x_t and P_t at rows t, x-_{t+1} and P-_{t+1} at rows
// t + 1; a chunk's SB rows of each are contiguous) are copied into shared
// memory by the whole block, consecutive threads on consecutive values, with
// cp.async into one of two buffers while the other sub-batch is walked;
// pass 3's outputs go to the tile and leave the same way.  SB steps of
// inputs fill ~192 bytes a chunk.
template <typename R, int N>
__host__ __device__ constexpr int rts_sub() {
  return (192 / (int)sizeof(R)) / (2 * N + 2 * N * N) >= 32   ? 32
         : (192 / (int)sizeof(R)) / (2 * N + 2 * N * N) >= 16 ? 16
         : (192 / (int)sizeof(R)) / (2 * N + 2 * N * N) >= 8  ? 8
         : (192 / (int)sizeof(R)) / (2 * N + 2 * N * N) >= 4  ? 4
         : (192 / (int)sizeof(R)) / (2 * N + 2 * N * N) >= 2  ? 2
                                                               : 1;
}

// A chunk's tile: two input buffers of SB rows each of x_t, P_t, x-_{t+1},
// P-_{t+1} (memory order: row k is step SB-1-k of the sub-batch), with
// kOut SB rows of x^ and P^, and one pad value (an odd stride in words, so
// that threads reading their own chunks hit distinct banks).
template <typename R, int N, bool kOut>
struct Tile {
  static constexpr int SB = rts_sub<R, N>();
  static constexpr int XF = 0, PF = SB * N, XP = SB * (N + N * N), PP = SB * (2 * N + N * N);
  static constexpr int IN = SB * (2 * N + 2 * N * N);
  static constexpr int XS = 2 * IN, PS = 2 * IN + SB * N;
  static constexpr int STRIDE = 2 * IN + (kOut ? SB * (N + N * N) : 0) + 1;
};

// Copy W values a row of rows t_lo(qc) + o .. + SB - 1 of src (the lane's
// rows from lrow) for each of the block's CB chunks qc into dst + qc
// STRIDE; a row whose step lies past the walk (t < 0) is left out.
template <int W, int SB, int CB, int STRIDE, typename R, typename Rows>
__device__ __forceinline__ void stage_rows(R* dst, const R* __restrict__ src, long long lrow,
                                           int o, Rows t_lo) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < SB * W; ++it) {
    const int e = it * CB + tid, qc = e / (SB * W), k = e % (SB * W);
    const long long t = t_lo(qc);
    if (t + k / W >= 0) copy_async(dst + qc * STRIDE + k, src + (lrow + t + o) * W + k);
  }
}

// Start copying sub-batch sb of the block's chunks (from chunk c0, lane l)
// into buffer buf of the tiles, as one copy group.
template <typename R, int N, bool kOut, int CB>
__device__ __forceinline__ void rts_stage(const RtsArgs<R>& a, R* tile, int buf, long long l,
                                          long long c0, int sb, const Geo& g) {
  using Tl = Tile<R, N, kOut>;
  constexpr int SB = Tl::SB, ST = Tl::STRIDE;
  const auto t_lo = [&](int qc) {
    return g.T - 2 - ((c0 + qc) * g.Lc + (long long)sb * SB) - (SB - 1);
  };
  R* b = tile + buf * Tl::IN;
  const long long lrow = l * g.T;
  stage_rows<N, SB, CB, ST>(b + Tl::XF, a.Xf, lrow, 0, t_lo);
  stage_rows<N * N, SB, CB, ST>(b + Tl::PF, a.Pf, lrow, 0, t_lo);
  stage_rows<N, SB, CB, ST>(b + Tl::XP, a.Xp, lrow, 1, t_lo);
  stage_rows<N * N, SB, CB, ST>(b + Tl::PP, a.Pp, lrow, 1, t_lo);
  copy_commit();
}

// Step SB-1-k of a sub-batch from buffer buf of this thread's tile.
template <typename R, int N, bool kOut>
__device__ __forceinline__ void tile_step(Step<R, N>& s, const R* mine, int buf, int k) {
  using Tl = Tile<R, N, kOut>;
  const R* b = mine + buf * Tl::IN;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.xf[i] = b[Tl::XF + k * N + i];
    s.xp[i] = b[Tl::XP + k * N + i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s.Pf[i][j] = b[Tl::PF + (k * N + i) * N + j];
      s.Pp[i][j] = b[Tl::PP + (k * N + i) * N + j];
    }
  }
}

// The walk over this thread's chunk, staged: step(cur) for each of its
// steps in order, after(sb) once a sub-batch's steps are done (every thread
// of the block calls walk_staged; after(sb) runs between two barriers).
template <typename R, int N, bool kOut, int CB, typename StepFn, typename After>
__device__ __forceinline__ void walk_staged(const RtsArgs<R>& a, R* tile, long long l,
                                            long long c0, bool live, long long s0,
                                            long long s1, const Geo& g, StepFn step,
                                            After after) {
  using Tl = Tile<R, N, kOut>;
  constexpr int SB = Tl::SB;
  const R* mine = tile + threadIdx.x * Tl::STRIDE;
  const int nsb = g.Lc / SB;
  rts_stage<R, N, kOut, CB>(a, tile, 0, l, c0, 0, g);
  for (int sb = 0; sb < nsb; ++sb) {
    if (sb + 1 < nsb) {
      rts_stage<R, N, kOut, CB>(a, tile, (sb + 1) & 1, l, c0, sb + 1, g);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        if (s0 + (long long)sb * SB + i < s1) {
          Step<R, N> cur;
          tile_step<R, N, kOut>(cur, mine, sb & 1, SB - 1 - i);
          step(i, cur);
        }
      }
    }
    __syncthreads();
    after(sb);
  }
}

// The step's gain as Y = G' (Y[j][c] = G[c][j]): Y = (P_t A')', solved
// against (P-_{t+1})'.
template <typename R, int N>
__device__ __forceinline__ void rts_gain(const Step<R, N>& s, const R (&A)[N][N], R (&Y)[N][N]) {
  R M[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      R v = mul(s.Pf[c][0], A[j][0]);
#pragma unroll
      for (int k = 1; k < N; ++k) v = add(v, mul(s.Pf[c][k], A[j][k]));
      Y[j][c] = v;
      M[j][c] = s.Pp[c][j];
    }
  spd_solve(M, Y);
}

// The plain version's step with the gain Y = G': x <- x_t + G (x - x-),
// P <- P_t + (G (P - P-)) G'.
template <typename T, int N>
__device__ __forceinline__ void rts_apply(const T (&Y)[N][N], const Step<T, N>& s, T (&x)[N],
                                          T (&P)[N][N]) {
  T d[N], GD[N][N];
#pragma unroll
  for (int c = 0; c < N; ++c) d[c] = sub(x[c], s.xp[c]);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    T v = mul(Y[0][c], d[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) v = add(v, mul(Y[j][c], d[j]));
    x[c] = add(s.xf[c], v);
  }
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int l = 0; l < N; ++l) {
      T v = mul(Y[0][c], sub(P[0][l], s.Pp[0][l]));
#pragma unroll
      for (int k = 1; k < N; ++k) v = add(v, mul(Y[k][c], sub(P[k][l], s.Pp[k][l])));
      GD[c][l] = v;
    }
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T v = mul(GD[c][0], Y[0][j]);
#pragma unroll
      for (int l = 1; l < N; ++l) v = add(v, mul(GD[c][l], Y[l][j]));
      P[c][j] = add(s.Pf[c][j], v);
    }
}

// A map x -> M x + e, P -> M P M' + E in float64.
template <int N>
struct Map {
  double M[N][N], e[N], E[N][N];
};

template <int N>
__device__ __forceinline__ void map_identity(Map<N>& m) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m.e[i] = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      m.M[i][j] = i == j ? 1.0 : 0.0;
      m.E[i][j] = 0.0;
    }
  }
}

// A map's values in shared memory or device memory: value w at p[w * stride]
template <int N>
__device__ __forceinline__ void map_store(const Map<N>& m, double* p, int stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[(N * N + i) * stride] = m.e[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      p[(i * N + j) * stride] = m.M[i][j];
      p[(N * N + N + i * N + j) * stride] = m.E[i][j];
    }
  }
}

template <int N>
__device__ __forceinline__ void map_load(Map<N>& m, const double* p, int stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m.e[i] = p[(N * N + i) * stride];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      m.M[i][j] = p[(i * N + j) * stride];
      m.E[i][j] = p[(N * N + N + i * N + j) * stride];
    }
  }
}

// later <- later o earlier (earlier applied first): M = Ml Me, e = Ml ee +
// el, E = Ml Ee Ml' + El.
template <int N>
__device__ __forceinline__ void map_after(Map<N>& later, const Map<N>& earlier) {
  double M[N][N], e[N], ME[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double a = later.e[i];
#pragma unroll
    for (int k = 0; k < N; ++k) a = fma(later.M[i][k], earlier.e[k], a);
    e[i] = a;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double b = 0.0, c = 0.0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        b = fma(later.M[i][k], earlier.M[k][j], b);
        c = fma(later.M[i][k], earlier.E[k][j], c);
      }
      M[i][j] = b;
      ME[i][j] = c;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double a = later.E[i][j];
#pragma unroll
      for (int k = 0; k < N; ++k) a = fma(ME[i][k], later.M[j][k], a);
      later.E[i][j] = a;
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    later.e[i] = e[i];
#pragma unroll
    for (int j = 0; j < N; ++j) later.M[i][j] = M[i][j];
  }
}

// (x, P) <- the map applied: M x + e, M P M' + E.
template <int N>
__device__ __forceinline__ void map_apply(const Map<N>& m, double (&x)[N], double (&P)[N][N]) {
  double xn[N], MP[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double a = m.e[i];
#pragma unroll
    for (int k = 0; k < N; ++k) a = fma(m.M[i][k], x[k], a);
    xn[i] = a;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double b = 0.0;
#pragma unroll
      for (int k = 0; k < N; ++k) b = fma(m.M[i][k], P[k][j], b);
      MP[i][j] = b;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = xn[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double a = m.E[i][j];
#pragma unroll
      for (int k = 0; k < N; ++k) a = fma(MP[i][k], m.M[j][k], a);
      P[i][j] = a;
    }
  }
}

// The filter's last step of lane l, widened.
template <typename R, int N>
__device__ __forceinline__ void last_state(const RtsArgs<R>& a, long long l, long long T,
                                           double (&x)[N], double (&P)[N][N]) {
  const long long row = l * T + T - 1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = (double)a.Xf[row * N + i];
#pragma unroll
    for (int j = 0; j < N; ++j) P[i][j] = (double)a.Pf[(row * N + i) * N + j];
  }
}

// Pass 1's and pass 3's dynamic shared memory: the tiles, and pass 1's
// maps for the join after the walk.
template <typename R, int N, bool kOut>
__host__ __device__ constexpr size_t rts_smem() {
  return (size_t)rts_threads(N) * Tile<R, N, kOut>::STRIDE * sizeof(R) >
                 (kOut ? 0 : (size_t)rts_threads(N) * map_size(N) * sizeof(double))
             ? (size_t)rts_threads(N) * Tile<R, N, kOut>::STRIDE * sizeof(R)
             : (size_t)rts_threads(N) * map_size(N) * sizeof(double);
}

// Pass 1: each chunk's map from its steps, joined within each group.
template <typename R, int N>
__global__ void __launch_bounds__(rts_threads(N))
rts_chunk_maps(const RtsArgs<R> a, double* __restrict__ maps, const Geo g) {
  constexpr int CB = rts_threads(N), MW = map_size(N);
  extern __shared__ __align__(16) unsigned char dsm[];
  const int tid = threadIdx.x;
  const long long l = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * CB;
  const long long c = c0 + tid;
  const long long S = g.T - 1;                       // steps
  // step s walks t = T-2-s; the chunk's steps s0 .. s1-1
  const long long s0 = c * g.Lc;
  const long long s1 = s0 + g.Lc < S ? s0 + g.Lc : S;
  R A[N][N];
  load_f(A, a.A);
  Map<N> mp;
  map_identity(mp);
  walk_staged<R, N, false, CB>(
      a, reinterpret_cast<R*>(dsm), l, c0, c < g.nc, s0, s1, g,
      [&](int, const Step<R, N>& cur) {
        R Y[N][N];
        rts_gain(cur, A, Y);
        // in float64: (e, E) walked by the step from zero, M <- G M
        double Yd[N][N], Mn[N][N];
        Step<double, N> w;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          w.xf[i] = cur.xf[i];
          w.xp[i] = cur.xp[i];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            Yd[i][j] = Y[i][j];
            w.Pf[i][j] = cur.Pf[i][j];
            w.Pp[i][j] = cur.Pp[i][j];
          }
        }
        rts_apply(Yd, w, mp.e, mp.E);
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; j < N; ++j) {
            double v = 0.0;
#pragma unroll
            for (int k = 0; k < N; ++k) v = fma(Yd[k][i], mp.M[k][j], v);
            Mn[i][j] = v;
          }
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; j < N; ++j) mp.M[i][j] = Mn[i][j];
      },
      [](int) {});
  // the group's chunks joined: chunk j's map after those of the chunks
  // before it (a Kogge-Stone scan, later maps composed after earlier ones)
  double* sh = reinterpret_cast<double*>(dsm);      // [value][thread]
  map_store(mp, sh + tid, CB);
  __syncthreads();
  for (int off = 1; off < CB; off <<= 1) {
    const bool has = tid >= off;
    if (has) {
      Map<N> earlier;
      map_load(earlier, sh + tid - off, CB);
      map_after(mp, earlier);
    }
    __syncthreads();
    if (has) map_store(mp, sh + tid, CB);
    __syncthreads();
  }
  if (c < g.nc) map_store(mp, maps + (l * g.nc + c) * MW, 1);
}

// Pass 2: the groups' starts 1 .. ng-1 of each lane (x^, P^ in float64) into
// starts (L, ng - 1, N + N^2); a block a lane, 2^tl threads, each a run of
// 2^rl groups.
template <typename R, int N>
__global__ void __launch_bounds__(rts_join(N))
rts_group_starts(const RtsArgs<R> a, const double* __restrict__ maps,
                 double* __restrict__ starts, const Geo g) {
  constexpr int CB = rts_threads(N), MW = map_size(N), SW = state_size(N);
  __shared__ double sh[MW * rts_join(N)];            // [value][thread]
  const int J = 1 << g.tl, RG = 1 << g.rl;
  const int tid = threadIdx.x;
  const long long l = blockIdx.x;
  const int nj = g.ng - 1;
  const int m0 = tid * RG;
  const int m1 = m0 + RG < nj ? m0 + RG : nj;
  auto group_map = [&](Map<N>& gm, int m) {
    map_load(gm, maps + (l * g.nc + (long long)m * CB + CB - 1) * MW, 1);
  };
  Map<N> run;
  map_identity(run);
  for (int m = m0; m < m1; ++m) {
    Map<N> gm;
    group_map(gm, m);
    map_after(gm, run);
    run = gm;
  }
  map_store(run, sh + tid, J);
  __syncthreads();
  for (int off = 1; off < J; off <<= 1) {
    const bool has = tid >= off;
    if (has) {
      Map<N> earlier;
      map_load(earlier, sh + tid - off, J);
      map_after(run, earlier);
    }
    __syncthreads();
    if (has) map_store(run, sh + tid, J);
    __syncthreads();
  }
  // this run's true start: the filter's last step, after the runs before
  double x[N], P[N][N];
  last_state(a, l, g.T, x, P);
  if (tid > 0) {
    Map<N> before;
    map_load(before, sh + tid - 1, J);
    map_apply(before, x, P);
  }
  for (int m = m0; m < m1; ++m) {
    Map<N> gm;
    group_map(gm, m);
    map_apply(gm, x, P);
    double* o = starts + (l * nj + m) * SW;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      o[i] = x[i];
#pragma unroll
      for (int j = 0; j < N; ++j) o[N + i * N + j] = P[i][j];
    }
  }
}

// Pass 3: every chunk from its true start, writing Xs and Ps.
template <typename R, int N>
__global__ void __launch_bounds__(rts_threads(N))
rts_chunk_run(const RtsArgs<R> a, const double* __restrict__ maps,
              const double* __restrict__ starts, const Geo g) {
  using Tl = Tile<R, N, true>;
  constexpr int CB = rts_threads(N), MW = map_size(N), SW = state_size(N);
  constexpr int SB = Tl::SB, XW = SB * N, PW = SB * N * N;
  extern __shared__ __align__(16) unsigned char dsm[];
  R* tile = reinterpret_cast<R*>(dsm);
  const int tid = threadIdx.x;
  const long long l = blockIdx.y;
  const int m = blockIdx.x;
  const long long c0 = (long long)m * CB;
  const long long c = c0 + tid;
  const bool live = c < g.nc;
  const long long S = g.T - 1;
  const long long last = l * g.T + g.T - 1;
  R A[N][N], x[N], P[N][N];
  load_f(A, a.A);
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = a.Xf[last * N + i];
      a.Xs[last * N + i] = x[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        P[i][j] = a.Pf[(last * N + i) * N + j];
        a.Ps[(last * N + i) * N + j] = P[i][j];
      }
    }
  } else if (live) {
    double xd[N], Pd[N][N];
    if (m == 0) {
      last_state(a, l, g.T, xd, Pd);
    } else {
      const double* st = starts + (l * (g.ng - 1) + m - 1) * SW;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        xd[i] = st[i];
#pragma unroll
        for (int j = 0; j < N; ++j) Pd[i][j] = st[N + i * N + j];
      }
    }
    if (tid > 0) {
      Map<N> before;
      map_load(before, maps + (l * g.nc + c - 1) * MW, 1);
      map_apply(before, xd, Pd);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = (R)xd[i];
#pragma unroll
      for (int j = 0; j < N; ++j) P[i][j] = (R)Pd[i][j];
    }
  }
  const long long s0 = c * g.Lc;
  const long long s1 = s0 + g.Lc < S ? s0 + g.Lc : S;
  R* mine = tile + tid * Tl::STRIDE;
  walk_staged<R, N, true, CB>(
      a, tile, l, c0, live, s0, s1, g,
      [&](int i, const Step<R, N>& cur) {
        R Y[N][N];
        rts_gain(cur, A, Y);
        rts_apply(Y, cur, x, P);
        // row t = T-2-s lies SB-1-i rows into the sub-batch's rows
#pragma unroll
        for (int r = 0; r < N; ++r) {
          mine[Tl::XS + (SB - 1 - i) * N + r] = x[r];
#pragma unroll
          for (int q = 0; q < N; ++q) mine[Tl::PS + ((SB - 1 - i) * N + r) * N + q] = P[r][q];
        }
      },
      [&](int sb) {
        // the sub-batch's rows t_lo .. t_lo + SB - 1 of each chunk, those
        // whose steps lie in the walk (t >= 0)
        const auto t_lo = [&](int qc) {
          return g.T - 2 - ((c0 + qc) * g.Lc + (long long)sb * SB) - (SB - 1);
        };
#pragma unroll
        for (int it = 0; it < XW; ++it) {
          const int e = it * CB + tid, qc = e / XW, w = e % XW;
          const long long t = t_lo(qc);
          if (t + w / N >= 0) a.Xs[(l * g.T + t) * N + w] = tile[qc * Tl::STRIDE + Tl::XS + w];
        }
#pragma unroll
        for (int it = 0; it < PW; ++it) {
          const int e = it * CB + tid, qc = e / PW, w = e % PW;
          const long long t = t_lo(qc);
          if (t + w / (N * N) >= 0)
            a.Ps[(l * g.T + t) * N * N + w] = tile[qc * Tl::STRIDE + Tl::PS + w];
        }
      });
}

template <typename R, int N>
int rts_launch(const RtsArgs<R>& a, double* maps, double* starts, const Geo& g,
               cudaStream_t stream) {
  if (g.Lc % rts_sub<R, N>()) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)g.ng, (unsigned)g.L);
  constexpr size_t smem1 = rts_smem<R, N, false>(), smem3 = rts_smem<R, N, true>();
  if (g.nc > 1) {
    const int e1 = allow_smem(rts_chunk_maps<R, N>, smem1);
    if (e1 != 0) return e1;
    rts_chunk_maps<R, N><<<grid, rts_threads(N), smem1, stream>>>(a, maps, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (g.ng > 1) {
      rts_group_starts<R, N><<<(unsigned)g.L, 1u << g.tl, 0, stream>>>(a, maps, starts, g);
      const cudaError_t err2 = cudaGetLastError();
      if (err2 != cudaSuccess) return (int)err2;
    }
  }
  const int e3 = allow_smem(rts_chunk_run<R, N>, smem3);
  if (e3 != 0) return e3;
  rts_chunk_run<R, N><<<grid, rts_threads(N), smem3, stream>>>(a, maps, starts, g);
  return (int)cudaGetLastError();
}

template <typename R>
int rts_entry(const RtsArgs<R>& a, void* maps, void* starts, int L, long long T, int N,
              int Lc, int tl, int rl, int device, cudaStream_t stream) {
  if (N != 1 && N != 2 && N != 4 && N != 8) return (int)cudaErrorInvalidValue;
  const long long steps = T - 1;
  const long long nc = Lc > 0 ? (steps > 0 ? (steps + Lc - 1) / Lc : 1) : 0;
  const int cb = rts_threads(N);
  const long long ng = (nc + cb - 1) / cb;
  if (nc > 0x7fffffffLL ||
      bad_geometry(T, L, Lc, (int)nc, (int)ng, cb, tl, rl, rts_join(N)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geo g{T, L, Lc, (int)nc, (int)ng, tl, rl};
  double* mp = static_cast<double*>(maps);
  double* st = static_cast<double*>(starts);
  switch (N) {
    case 1: return rts_launch<R, 1>(a, mp, st, g, stream);
    case 2: return rts_launch<R, 2>(a, mp, st, g, stream);
    case 4: return rts_launch<R, 4>(a, mp, st, g, stream);
    default: return rts_launch<R, 8>(a, mp, st, g, stream);
  }
}

}  // namespace

// The LTI entry: Bin and X (L, T, N) contiguous, of the entry's type; F (N,
// N) of that type; st_in and st_out (L, N), the state before and after the
// block; Lc a multiple of 32 / N; tabs the join tables of
// ops/linrec.py::join_tables for F, Lc and CB = 128 ((128 + D) N x N
// float64: Phi^1 .. Phi^128, then Phi^(128 2^d)); loc (L, nc, N) and G (L,
// max(ng - 1, 1), N) float64 scratch, nc = ceil(T / Lc), ng = ceil(nc /
// 128); pass 2's 2^tl threads a lane and 2^rl
// groups a run from ops/cuda_track.py::lti_geometry.  T >= 1.  On card
// `device`; launches up to three kernels on `stream`, does not synchronise,
// returns the first failed launch's cudaError_t or 0.
#define LTI_ENTRY(SUF, R)                                                           \
  extern "C" int kf_lti_chunked_##SUF(const void* Bin, void* X, const void* F,      \
                                      const void* st_in, void* st_out,              \
                                      const void* tabs, void* loc, void* G, int L,  \
                                      long long T, int N, int Lc, int tl, int rl,   \
                                      int device, cudaStream_t stream) {            \
    return lti_entry<R>(Bin, X, F, st_in, st_out, tabs, loc, G, L, T, N, Lc, tl,    \
                        rl, device, stream);                                        \
  }

// The backward entry: Xf, Xp (L, T, N), Pf, Pp (L, T, N, N) from the forward
// entry (Pp with 1 on its padded diagonal), A (N, N), of the entry's type ->
// Xs (L, T, N), Ps (L, T, N, N); maps (L, nc, 2N^2 + N) and starts (L,
// max(ng - 1, 1), N + N^2) float64 scratch, Lc a power of two and a
// multiple of pass 3's sub-batch (rts_sub: 1 to 32 steps, by N and the
// type), nc = max(1, ceil((T - 1) / Lc)), ng = ceil(nc / CB) (CB 128 for N
// <= 4, 32 for N = 8); tl and rl from
// ops/cuda_track.py::rts_geometry.  T >= 1; otherwise as the LTI entry.
#define RTS_ENTRY(SUF, R)                                                           \
  extern "C" int rts_chunked_##SUF(const void* Xf, const void* Pf, const void* Xp,  \
                                   const void* Pp, const void* A, void* Xs,         \
                                   void* Ps, void* maps, void* starts, int L,       \
                                   long long T, int N, int Lc, int tl, int rl,      \
                                   int device, cudaStream_t stream) {               \
    const RtsArgs<R> a{static_cast<const R*>(Xf), static_cast<const R*>(Pf),        \
                       static_cast<const R*>(Xp), static_cast<const R*>(Pp),        \
                       static_cast<const R*>(A),  static_cast<R*>(Xs),              \
                       static_cast<R*>(Ps)};                                        \
    return rts_entry<R>(a, maps, starts, L, T, N, Lc, tl, rl, device, stream);      \
  }

LTI_ENTRY(f32, float)
LTI_ENTRY(f64, double)
RTS_ENTRY(f32, float)
RTS_ENTRY(f64, double)
