// S6: turbo decoding's max-log BCJR walk for Hopper (sm_90a), as a
// time-parallel chunk-and-join in the max-plus semiring: one terminated RSC
// constituent's a-posteriori LLRs (bcjr_maxlog_f32, one launch a
// half-iteration) and the whole iterative decode of
// models/turbo.py::turbo_decode in one launch (turbo_decode_f32).
//
// Replaces no TPU kernel: in the JAX package the walk is two lax.scans,
// solid_dsp_tpu/models/turbo.py::_bcjr_extrinsic (:195-324): the forward
// (alpha) scan at :276, the backward (beta) scan at :312 and the
// a-posteriori step at :318-324, as radix-8 blocked max-plus products; the
// decode is _turbo_decode_perm's loop (:326-344), which JAX jits into one
// program.  PyTorch has no scan, and that formulation in eager torch ops is
// some 19k launches a decode.
//
// The algebra.  With (A (x) x)[n] = max_j (A[n, j] + x[j]) the walks are
//   forward:  alpha_{t+1} = M_t (x) alpha_t,  M_t[n, s] = gamma(t, s -> n)
//   backward: beta_t = N_t (x) beta_{t+1},    N_t[s, n] = gamma(t, s -> n)
//   LLR_t = max_s ((alpha_t[s] + gamma(t, s, 0)) + beta_{t+1}[ns[s][0]])
//         - max_s ((alpha_t[s] + gamma(t, s, 1)) + beta_{t+1}[ns[s][1]])
// with gamma = 0.5 (su ls_t + sp lp_t), su, sp = +-1 the branch's input and
// parity signs (models/turbo.py::_walk_tables).  Max-plus products are
// associative, so the T + m steps are cut into chunks of LC steps (the last
// one ragged, 1 .. LC) and walked in three passes, each thread block one
// codeword row (THREADS lanes, SLOTS tasks of eight lanes at a time):
//   1. matrices: per (row, chunk) the product of the chunk's step matrices,
//      P = M_last (x) .. (x) M_first for every chunk but the last (forward)
//      and Q = N_first (x) .. (x) N_last for every chunk but the first
//      (backward), from the identity, a step X'[x, j] = max_k (g(x, k) +
//      X[src[x][k], j]); eight lanes a task, in one of two layouts
//      (chunk_matrices);
//   2. join: one warp, lanes 0-15 alpha from state 0 over the chunks'
//      starts, lanes 16-31 beta, terminated in state 0 after the tail's m
//      steps, over their ends, in float64, v_{r+1} = P_r (x) v_r, two lanes
//      a state (half a row each); meanwhile the other warps stage pass 3's
//      inputs;
//   3. walks: per (row, chunk) the forward walk from the chunk's alpha, a
//      lane a state, its alphas kept in registers (the loop is unrolled over
//      LC), then the backward walk from its beta with the LLRs, their two
//      maxima over the states reduced four steps at a time (llr_of_group).
// No walk of T + m dependent steps is left: the serial depth is LC steps of
// pass 1, C - 1 float64 join steps and 2 LC steps of pass 3.  It is exact
// max-log BCJR (no sliding window or guard interval); against the plain
// version (models/turbo.py::bcjr_maxlog_plain, JAX's radix-8 order) only
// float32 association and where the renormalisations fall differ, within
// S6's gate |dLLR| <= 1e-4 max(1, max|LLR|).
//
// What bounds it (chip_smoke.py phase 40 and torch_kernel_sweep.py s6 on an
// H100 at 128 rows of 1027 steps, a block a row on 128 SMs): not bytes nor
// the function's operations (some 28 a state a step; the bound phase 40
// prints is a few per cent of the time), but the block's issue and latency:
// pass 1 does 8 times the two walks' work (8 columns a direction) and
// its staging waits on device memory; the join is C - 1 dependent float64
// steps of one warp (shuffles, adds, maxima: ~240 cycles each); pass 3 is
// 2 LC dependent steps with shuffles.  The design keeps the chunk matrices
// off the shuffle network where the trellis allows (the shift-register
// layout), the join's matrices loaded a round ahead, pass 3's inputs staged
// during the join, and its LLR maxima off the beta chain.
//
// Precision of pass 1.  A column j of a chunk's product is the walk from
// state j; unrenormalised its entries would grow by up to LC max|gamma|.
// After RN - 1 steps (k = RN - 1, 2 RN - 1, .., before the last step) the
// matrix drops its largest entry, a constant over the whole matrix that
// the join's renormalisation cancels.  Every state reaches every other in
// m = 3 steps, so two columns' maxima differ by at most the gammas of the
// chunk's first three steps (6 max|gamma|) and a column's entries by those
// of its last three: the finite entries stay within (12 + RN) max|gamma| of
// 0, the range of the walk itself when it is renormalised every RN steps
// (JAX's blocked scan renormalises every 8).  NEG = -1e9 marks
// unreachable states: a chunk of fewer than m steps keeps NEG entries
// (sums near NEG), which the join's maxima pass over (every row of a
// product has a finite entry, and only the last chunk can be short).
//
// Order of operations, bit-equal to models/turbo.py::
// bcjr_maxlog_chunked_torch: each gamma 0.5f * (su l + sp p) (the products
// exact, the sum rounded once; in the shift-register layout su h with h =
// 0.5f * (l + p) or 0.5f * (l - p), the same value, and g + X as one FFMA
// of the exact product; contracting 0.5f * s + X into an FFMA changes
// nothing either, the half being exact); each branch g + x, then fmaxf of
// the two; pass 1 from the identity, step k at position k (forward) or
// LC - 1 - k (backward), positions past the chunk skipped, the matrix less
// its largest entry after step k when (k + 1) % RN == 0 and k + 1 < LC;
// the join's sums in float64 from e_0, each boundary (v - max v) rounded
// to float32; pass 3's alpha renormalised after the update giving position
// i + 1 when (i + 1) % RN == 0, beta after the one giving position i when
// i % RN == 0 (i > 0).  The maxima are exact, so the order in which a max
// meets its operands does not matter.  In pass 3 the steps past a ragged
// chunk run with their results discarded by selects, so every shuffle is
// executed by the whole warp (a shuffle under a branch costs a
// reconvergence a step); pass 1's ragged task runs its own loop, its
// shuffles and barriers on its own eight lanes.
//
// The fused decode (turbo_decode_f32): one thread block a codeword runs
// every iteration of both constituents, the three passes of each
// half-iteration separated by __syncthreads.  The codeword's systematic
// row and one extrinsic row E stay in shared memory: constituent 1 reads E
// as its a-priori row and writes its extrinsic (llr - l_sys) - l_apr over
// it in place; constituent 2 reads l_sys and E through the QPP interleaver
// (perm, a device int32 row) and writes its extrinsic back at perm[t],
// which is ext2[inv] (the a-priori row of the next iteration) without inv;
// the last half-iteration writes the final LLRs and bits at perm[t].  Each
// position is read and written by the one task whose chunk holds it.  The
// parity rows and perm are read from device memory (L2).  Shared memory
// (4-byte words): the chunk matrices 2 (C - 1) 64, the float64 boundaries
// 4 C 8, the slots SLOTS SLOT_FLOATS and the two rows 2 K, C = ceil((K +
// 3) / LC): 204,928 bytes at K = 6144 (LTE's largest block) of the H100's
// 232,448, and K up to 7,133 fits (turbo_decode_smem); a longer codeword
// takes the walk entry, two launches an iteration (models/turbo.py routes
// by shape).
//
// Entry points (each returns the launch's cudaError_t):
//   bcjr_maxlog_f32: ls, lp (B, Tm) float32 (ls = l_sys + l_apr, the tails
//     appended) -> llr (B, T), T <= Tm; scratch (B, bcjr_scratch_floats)
//     float32 (the chunk matrices and boundaries of pass 1 and the join);
//     tables on the host, 5 x (8, 2) ints: ns, p, prev, prev_u, prev_p.
//   turbo_decode_f32: rx (B, 3K + 12) float32 codewords, perm (K) int32
//     -> llr (B, K) float32, bits (B, K) int32; the same tables.

#include <cuda_runtime.h>

namespace {

constexpr int S = 8;                  // trellis states, m = 3
constexpr int M = 3;                  // tail steps
constexpr int LC = 32;                // steps a chunk
constexpr int RN = 16;                // renormalisation period in a chunk
constexpr int THREADS = 512;          // a thread block (a codeword row)
constexpr int SLOTS = THREADS / S;    // tasks at a time, eight lanes each
constexpr int HGROUP = 8;             // steps of h staged at a time (pass 1)
// a task's staged ls and lp, then its LLRs and emit indices (pass 3) or a
// group's h values (pass 1's shift-register layout)
constexpr int SLOT_FLOATS =
    2 * LC + (2 * LC > HGROUP * S ? 2 * LC : HGROUP * S);
constexpr int JOIN_PREFETCH = 8;      // chunk matrices loaded ahead
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e9f;          // log-metric of an unreachable state
static_assert(LC % S == 0 && LC % RN == 0 && LC % 4 == 0 &&
                  LC % HGROUP == 0 && HGROUP == S,
              "chunk geometry");

struct Trellis {
  int src[2][S][2];    // [forward 0 / backward 1][state][branch]: the
  float su[2][S][2];   // state whose metric the branch reads, its input
  float sp[2][S][2];   // sign and its parity sign
  // A shift-register trellis (every one of models/turbo.py::_rsc_tables):
  // state n's forward branches read states ((n & 3) << 1) | k, state s's
  // backward branches states (k << 2) | (s >> 1), k = 0, 1, which in
  // bit-reversed labels (rev(s)) is the forward pattern again.  A branch's
  // gamma is su h with h = a = 0.5 (l + p) where su sp = 1 and b = 0.5 (l -
  // p) where su sp = -1; both branches of a row take the same h (where the
  // code has the D^m taps; else the generic layout).  eb: h is b, cs: the
  // branch's su, [direction][row, bit-reversed for the backward][branch].
  int shift;
  int eb[2][S];
  float cs[2][S][2];
};

__host__ __device__ __forceinline__ int rev3(int s) {
  return ((s & 1) << 2) | (s & 2) | (s >> 2);
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = S / 2; o >= 1; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o, S));
  return v;
}

__device__ __forceinline__ float branch_gamma(float su, float sp, float l,
                                              float p) {
  return 0.5f * __fadd_rn(su * l, sp * p);
}

__host__ __device__ __forceinline__ int chunks(int Tm) {
  return (Tm + LC - 1) / LC;
}

// A task's LC steps from t0 (len of them real) into its slot: ls at st[i],
// lp at st[LC + i], zeros past len, and the position's index for emit (as
// src.load gives it) at st[3 LC + i].  The slot's eight lanes share the
// loads; a lane group of an idle slot (st null) only keeps the warp's
// barriers.
template <typename Src>
__device__ __forceinline__ void stage(const Src& src, float* st, int x,
                                      int t0, int len) {
  __syncwarp();
  if (st) {
#pragma unroll
    for (int k = 0; k < LC / S; ++k) {
      const int i = x + S * k;
      float l = 0.f, p = 0.f;
      int q = 0;
      if (i < len) src.load(t0 + i, l, p, q);
      st[i] = l;
      st[LC + i] = p;
      reinterpret_cast<int*>(st)[3 * LC + i] = q;
    }
  }
  __syncwarp();
}

// Pass 1: the forward products of chunks 0 .. n - 1 (n = C - 1) as tasks
// q < n4, the backward products of chunks 1 .. n as tasks q >= n4 (n4 = n
// rounded up to a warp's four slots, so that a warp's tasks share a
// direction); a chunk's matrix at mats + 64 (c forward, n + c - 1
// backward), row-major.  Two layouts of a task's eight lanes:
//   * any trellis: lane x holds row x, the two source rows by 16 shuffles a
//     step (the shuffles bound the pass: ~2 cycles of the SM each);
//   * a shift-register trellis (kShift): lane x holds column x (backward
//     tasks in bit-reversed labels, where their pattern is the forward
//     one), the source rows' indices are compile-time, and a step is an
//     FFMA a branch, FFMA(su, h, X) = fl(g + X) (the product exact), and 8
//     maxima, on the lane's own registers; the rows' h (a or b) are staged
//     HGROUP steps at a time, each lane computing one step's.
// The two give the same values (a max of the same two sums).
template <typename Src, bool kShift>
__device__ void chunk_matrices(const Src& src, float* mats, float* slots,
                               const Trellis& tr, int C, int last) {
  const int x = threadIdx.x % S, slot = threadIdx.x / S;
  const int warp_first = (threadIdx.x / 32) * (32 / S);
  float* st = slots + slot * SLOT_FLOATS;
  const int n = C - 1, n4 = (n + 3) / 4 * 4, ntasks = 2 * n4;
  for (int base = 0; base + warp_first < ntasks; base += SLOTS) {
    const int q = base + slot;
    const int dir = q >= n4 ? 1 : 0;
    const int c = dir == 0 ? q : q - n4 + 1;
    const bool active = dir == 0 ? c < n : c <= n;
    const int len = active && c == C - 1 ? last : LC;
    stage(src, st, x, c * LC, active ? len : 0);
    float X[S];
#pragma unroll
    for (int j = 0; j < S; ++j) X[j] = j == x ? 0.f : NEG;
    if (!kShift) {
      const int s0 = tr.src[dir][x][0], s1 = tr.src[dir][x][1];
      const float u0 = tr.su[dir][x][0], u1 = tr.su[dir][x][1];
      const float q0 = tr.sp[dir][x][0], q1 = tr.sp[dir][x][1];
#pragma unroll
      for (int k = 0; k < LC; ++k) {
        const int i = dir == 0 ? k : LC - 1 - k;
        const bool valid = i < len;
        const float l = st[i], p = st[LC + i];
        const float g0 = branch_gamma(u0, q0, l, p);
        const float g1 = branch_gamma(u1, q1, l, p);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const float a = __shfl_sync(FULL, X[j], s0, S);
          const float b = __shfl_sync(FULL, X[j], s1, S);
          const float y = fmaxf(g0 + a, g1 + b);
          X[j] = valid ? y : X[j];
        }
        if ((k + 1) % RN == 0 && k + 1 < LC) {
          float mx = X[0];
#pragma unroll
          for (int j = 1; j < S; ++j) mx = fmaxf(mx, X[j]);
          mx = group_max(mx);
#pragma unroll
          for (int j = 0; j < S; ++j) X[j] = valid ? X[j] - mx : X[j];
        }
      }
    } else {
      const unsigned group = 0xffu << (threadIdx.x & 24);
      float cs[S][2];
      bool eb[S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        cs[r][0] = tr.cs[dir][r][0];
        cs[r][1] = tr.cs[dir][r][1];
        eb[r] = tr.eb[dir][r];
      }
      // step i's h of row r: a or b by the row's eb
      const auto h_of = [&](int i, int r) {
        const float l = st[i], p = st[LC + i];
        return eb[r] ? 0.5f * __fsub_rn(l, p) : 0.5f * __fadd_rn(l, p);
      };
      const auto step = [&](const float (&h)[S]) {
        float Y[S];
#pragma unroll
        for (int r = 0; r < S; ++r) {
          const int s0 = (r & 3) << 1;
          Y[r] = fmaxf(fmaf(cs[r][0], h[r], X[s0]),
                       fmaf(cs[r][1], h[r], X[s0 | 1]));
        }
#pragma unroll
        for (int r = 0; r < S; ++r) X[r] = Y[r];
      };
      const auto renorm = [&] {
        float mx = X[0];
#pragma unroll
        for (int r = 1; r < S; ++r) mx = fmaxf(mx, X[r]);
#pragma unroll
        for (int o = S / 2; o >= 1; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(group, mx, o, S));
#pragma unroll
        for (int r = 0; r < S; ++r) X[r] -= mx;
      };
      // a full chunk unrolled, the rows' h of HGROUP steps staged at a time
      // in the slot (lane x the step k0 + x); the ragged last chunk
      // (backward, len < LC: steps k = LC - len .. LC - 1, position LC - 1
      // - k) a step at a time; each task alone in its branch, its shuffles
      // and barriers on its own eight lanes
      float* hb = st + 2 * LC;
      if (len == LC) {
#pragma unroll
        for (int k0 = 0; k0 < LC; k0 += HGROUP) {
          {
            const int i = dir == 0 ? k0 + x : LC - 1 - (k0 + x);
            float hv[S];
#pragma unroll
            for (int r = 0; r < S; ++r) hv[r] = h_of(i, r);
            float4* w = reinterpret_cast<float4*>(hb + x * S);
            w[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
            w[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
          }
          __syncwarp(group);
#pragma unroll
          for (int k1 = 0; k1 < HGROUP; ++k1) {
            const float4* rd = reinterpret_cast<const float4*>(hb + k1 * S);
            const float4 h0 = rd[0], h1 = rd[1];
            const float h[S] = {h0.x, h0.y, h0.z, h0.w,
                                h1.x, h1.y, h1.z, h1.w};
            step(h);
            const int k = k0 + k1;
            if ((k + 1) % RN == 0 && k + 1 < LC) renorm();
          }
          __syncwarp(group);
        }
      } else {
        for (int k = LC - len; k < LC; ++k) {
          float h[S];
#pragma unroll
          for (int r = 0; r < S; ++r) h[r] = h_of(LC - 1 - k, r);
          step(h);
          if ((k + 1) % RN == 0 && k + 1 < LC) renorm();
        }
      }
    }
    if (active) {
      const int m = dir == 0 ? c : n + c - 1;
      if (!kShift) {
        float4* out = reinterpret_cast<float4*>(mats + (m * S + x) * S);
        out[0] = make_float4(X[0], X[1], X[2], X[3]);
        out[1] = make_float4(X[4], X[5], X[6], X[7]);
      } else {
        const int col = dir == 0 ? x : rev3(x);
#pragma unroll
        for (int r = 0; r < S; ++r)
          mats[(m * S + (dir == 0 ? r : rev3(r))) * S + col] = X[r];
      }
    }
  }
}

__device__ __forceinline__ double dmax(double a, double b) {
  return a > b ? a : b;      // no NaN reaches the join: fmax's checks go
}

// The join (warp 0): the float64 metrics at the starts of the C chunks at
// bnd[c 8 ..], at their ends at bnd[(C + c) 8 ..], not renormalised (their
// growth, C LC max|gamma|, costs float64 nothing that matters; pass 3
// renormalises and rounds each one).  Lanes 0-15 carry alpha, 16-31 beta;
// lane (h, x) takes columns 4 h .. 4 h + 3 of row x, so a step is four
// shuffles, four adds and two levels of maxima, then one shuffle and a max
// between the two halves.  The matrices' rows are loaded JOIN_PREFETCH
// steps ahead.
__device__ void join(const float* mats, double* bnd, int C) {
  const int lane = threadIdx.x, x = lane % S;
  const int h = (lane / S) & 1, dir = lane / (2 * S);
  const int n = C - 1;
  double* out = bnd + dir * C * S;
  double a = x == 0 ? 0.0 : (double)NEG;
  out[(dir == 0 ? 0 : n) * S + x] = a;       // both halves: the same value
  const auto row = [&](int r) {
    r = r < n ? r : n - 1;
    const int q = dir == 0 ? r : 2 * n - 1 - r;   // backward: chunk n - r
    return reinterpret_cast<const float4*>(mats + (q * S + x) * S)[h];
  };
  const auto step = [&](int r, const float4 m) {
    const float e[4] = {m.x, m.y, m.z, m.w};
    double v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (double)e[j] + __shfl_sync(FULL, a, 2 * S * dir + 4 * h + j);
    const double part = dmax(dmax(v[0], v[1]), dmax(v[2], v[3]));
    a = dmax(part, __shfl_xor_sync(FULL, part, S));
    out[(dir == 0 ? r + 1 : n - 1 - r) * S + x] = a;
  };
  // full rounds of JOIN_PREFETCH steps from a ring of rows loaded a round
  // ahead (every load unconditional), then the rest a step at a time
  float4 ring[JOIN_PREFETCH];
#pragma unroll
  for (int k = 0; k < JOIN_PREFETCH; ++k) ring[k] = row(k);
  int r0 = 0;
  for (; r0 + JOIN_PREFETCH <= n; r0 += JOIN_PREFETCH) {
#pragma unroll
    for (int k = 0; k < JOIN_PREFETCH; ++k) {
      const float4 m = ring[k];
      ring[k] = row(r0 + JOIN_PREFETCH + k);
      step(r0 + k, m);
    }
  }
  for (int r = r0; r < n; ++r) step(r, row(r));
}

// A boundary's float64 metric (this lane's state) renormalised by the max
// over the task's eight lanes and rounded to float32 once.
__device__ __forceinline__ float boundary(double m) {
  double mx = m;
#pragma unroll
  for (int o = S / 2; o >= 1; o >>= 1)
    mx = dmax(mx, __shfl_xor_sync(FULL, mx, o, S));
  return (float)(m - mx);
}

// The maxima over the eight lanes of a task of eight values a lane, v[2 j]
// and v[2 j + 1] the two branches' metrics of step j of a group of four:
// a reduce-scatter by halves (4 + 2 + 1 shuffles), after which lane x holds
// the maximum of value x, then lane 2 j takes its pair's: LLR_j = M[2 j] -
// M[2 j + 1] on even lanes (7 + 1 shuffles for four LLRs, not 24).
__device__ __forceinline__ float llr_of_group(const float (&v)[8], int x) {
  const bool b2 = x & 4, b1 = x & 2, b0 = x & 1;
  float w[4], u[2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = fmaxf(b2 ? v[4 + q] : v[q],
                 __shfl_xor_sync(FULL, b2 ? v[q] : v[4 + q], 4, S));
#pragma unroll
  for (int q = 0; q < 2; ++q)
    u[q] = fmaxf(b1 ? w[2 + q] : w[q],
                 __shfl_xor_sync(FULL, b1 ? w[q] : w[2 + q], 2, S));
  const float z = fmaxf(b0 ? u[1] : u[0],
                        __shfl_xor_sync(FULL, b0 ? u[0] : u[1], 1, S));
  return z - __shfl_xor_sync(FULL, z, 1, S);
}

// Pass 3: each chunk walked from its boundaries; the LLRs staged in the
// slot, then handed to src.emit(t, q, llr) for t < T, the slot's lanes
// sharing the positions.
template <typename Src>
__device__ void chunk_llrs(const Src& src, const double* bnd, float* slots,
                           const Trellis& tr, int C, int last, int T) {
  // the first round's tasks were staged during the join (stage_first)
  const int x = threadIdx.x % S, slot = threadIdx.x / S;
  const int warp_first = (threadIdx.x / 32) * (32 / S);
  float* st = slots + slot * SLOT_FLOATS;
  const int p0 = tr.src[0][x][0], p1 = tr.src[0][x][1];
  const float fu0 = tr.su[0][x][0], fu1 = tr.su[0][x][1];
  const float fq0 = tr.sp[0][x][0], fq1 = tr.sp[0][x][1];
  const int n0 = tr.src[1][x][0], n1 = tr.src[1][x][1];
  const float bu0 = tr.su[1][x][0], bu1 = tr.su[1][x][1];
  const float bq0 = tr.sp[1][x][0], bq1 = tr.sp[1][x][1];
  for (int base = 0; base + warp_first < C; base += SLOTS) {
    const int c0 = base + slot;
    const bool active = c0 < C;
    const int c = active ? c0 : C - 1;
    const int len = c == C - 1 ? last : LC;
    const int t0 = c * LC;
    const double va = bnd[c * S + x], vb = bnd[(C + c) * S + x];
    if (base > 0) stage(src, st, x, t0, active ? len : 0);
    float alpha = boundary(va), beta = boundary(vb);
    float A[LC];
#pragma unroll
    for (int i = 0; i < LC; ++i) {
      A[i] = alpha;
      if (i + 1 < LC) {
        const bool upd = i + 1 < len;
        const float l = st[i], p = st[LC + i];
        const float g0 = branch_gamma(fu0, fq0, l, p);
        const float g1 = branch_gamma(fu1, fq1, l, p);
        const float a0 = __shfl_sync(FULL, alpha, p0, S);
        const float a1 = __shfl_sync(FULL, alpha, p1, S);
        const float y = fmaxf(g0 + a0, g1 + a1);
        alpha = upd ? y : alpha;
        if ((i + 1) % RN == 0) {
          const float mx = group_max(alpha);
          alpha = upd ? alpha - mx : alpha;
        }
      }
    }
    float v[8];                   // a group's branch metrics, this lane
#pragma unroll
    for (int i = LC - 1; i >= 0; --i) {
      const bool valid = i < len;
      const float l = st[i], p = st[LC + i];
      const float g0 = branch_gamma(bu0, bq0, l, p);
      const float g1 = branch_gamma(bu1, bq1, l, p);
      const float b0 = __shfl_sync(FULL, beta, n0, S);
      const float b1 = __shfl_sync(FULL, beta, n1, S);
      const int j = (LC - 1 - i) % 4;      // positions i + j .. i of a group
      v[2 * j] = (A[i] + g0) + b0;
      v[2 * j + 1] = (A[i] + g1) + b1;
      if (j == 3) {
        const float llr = llr_of_group(v, x);
        const int at = i + 3 - (x >> 1);   // lane 2 j's step
        if ((x & 1) == 0 && at < len) st[2 * LC + at] = llr;
      }
      if (i > 0) {
        const float y = fmaxf(g0 + b0, g1 + b1);
        beta = valid ? y : beta;
        if (i % RN == 0) {
          const float mx = group_max(beta);
          beta = valid ? beta - mx : beta;
        }
      }
    }
    __syncwarp();
    if (active) {
#pragma unroll
      for (int k = 0; k < LC / S; ++k) {
        const int i = x + S * k, t = t0 + i;
        if (i < len && t < T)
          src.emit(t, reinterpret_cast<const int*>(st)[3 * LC + i],
                   st[2 * LC + i]);
      }
    }
  }
}

// Pass 3's first round staged by warps 1 .. THREADS / 32 - 1 while warp 0
// joins: task c (< SLOTS) into slot c.
template <typename Src>
__device__ void stage_first(const Src& src, float* slots, int C, int last) {
  const int x = threadIdx.x % S, g = threadIdx.x / S - 32 / S;
  const int tasks = C < SLOTS ? C : SLOTS, groups = SLOTS - 32 / S;
  for (int base = 0; base < tasks; base += groups) {
    const int c = base + g;
    const bool active = c < tasks;
    stage(src, active ? slots + c * SLOT_FLOATS : nullptr, x, c * LC,
          c == C - 1 ? last : LC);
  }
}

// One constituent's walk over Tm steps (LLRs for t < T) by the whole block;
// mats and bnd in shared or device memory.  Ends with __syncthreads.
template <typename Src>
__device__ void half_iteration(const Src& src, float* mats, double* bnd,
                               float* slots, const Trellis& tr, int Tm,
                               int T) {
  const int C = chunks(Tm), last = Tm - (C - 1) * LC;
  if (C > 1) {
    if (tr.shift)
      chunk_matrices<Src, true>(src, mats, slots, tr, C, last);
    else
      chunk_matrices<Src, false>(src, mats, slots, tr, C, last);
    __syncthreads();
    if (threadIdx.x < 32)
      join(mats, bnd, C);
    else
      stage_first(src, slots, C, last);
  } else {
    if (threadIdx.x < 2 * S)
      bnd[threadIdx.x] = threadIdx.x % S == 0 ? 0.0 : (double)NEG;
    else if (threadIdx.x >= 32)
      stage_first(src, slots, C, last);
  }
  __syncthreads();
  chunk_llrs(src, bnd, slots, tr, C, last, T);
  __syncthreads();
}

// The half-iteration entry's rows in device memory.
struct RowSrc {
  const float* ls;
  const float* lp;
  float* out;
  __device__ void load(int t, float& l, float& p, int& q) const {
    l = ls[t];
    p = lp[t];
    q = t;
  }
  __device__ void emit(int t, int, float v) const { out[t] = v; }
};

__host__ __device__ __forceinline__ long long scratch_floats(int Tm) {
  const int C = chunks(Tm);
  return 2LL * (C - 1) * S * S + 4LL * C * S;   // boundaries in float64
}

__global__ void __launch_bounds__(THREADS)
bcjr_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
            float* __restrict__ llr, float* __restrict__ scratch,
            const __grid_constant__ Trellis tr, int Tm, int T) {
  extern __shared__ __align__(16) float slots[];     // SLOTS SLOT_FLOATS
  const long long b = blockIdx.x;
  const int C = chunks(Tm);
  float* mats = scratch + b * scratch_floats(Tm);
  double* bnd = reinterpret_cast<double*>(mats + 2 * (C - 1) * S * S);
  const RowSrc src{ls + b * Tm, lp + b * Tm, llr + b * T};
  half_iteration(src, mats, bnd, slots, tr, Tm, T);
}

// A constituent of the fused decode: t < K reads l_sys and the a-priori
// row E at q = t (constituent 1) or perm[t] (constituent 2), the tails
// after; emit (given q, as staged) writes the extrinsic over E[q] and, in
// the last half-iteration, the final LLR and bit at q.
struct CodeSrc {
  const float* sys;
  float* E;
  const float* par;     // the parity row in device memory
  const float* tail;    // tail_sys then tail_par of this constituent
  const int* perm;      // null for constituent 1
  float* llr;           // null before the last half-iteration
  int* bits;
  int K;
  __device__ void load(int t, float& l, float& p, int& q) const {
    if (t < K) {
      q = perm ? perm[t] : t;
      l = __fadd_rn(sys[q], E[q]);
      p = par[t];
    } else {
      l = tail[t - K];
      p = tail[M + t - K];
    }
  }
  __device__ void emit(int, int q, float v) const {
    E[q] = __fsub_rn(__fsub_rn(v, sys[q]), E[q]);
    if (llr) {
      llr[q] = v;
      bits[q] = v < 0.f ? 1 : 0;
    }
  }
};

__host__ __device__ __forceinline__ long long fused_floats(int K) {
  return scratch_floats(K + M) + (long long)SLOTS * SLOT_FLOATS + 2LL * K;
}

__global__ void __launch_bounds__(THREADS)
turbo_kernel(const float* __restrict__ rx, const int* __restrict__ perm,
             float* __restrict__ llr, int* __restrict__ bits,
             const __grid_constant__ Trellis tr, int K, int n_iter) {
  extern __shared__ __align__(16) float sm[];
  const long long b = blockIdx.x;
  const int Tm = K + M, C = chunks(Tm);
  float* mats = sm;                               // 2 (C - 1) 64
  double* bnd = reinterpret_cast<double*>(         // 2 C 8 doubles
      mats + 2 * (C - 1) * S * S);
  float* slots = reinterpret_cast<float*>(bnd + 2 * C * S);  // SLOTS 3 LC
  float* sys = slots + SLOTS * SLOT_FLOATS;       // K
  float* E = sys + K;                             // K
  const float* row = rx + b * (3LL * K + 4 * M);
  for (int t = threadIdx.x; t < K; t += THREADS) {
    sys[t] = row[t];
    E[t] = 0.f;
  }
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    const bool last = it == n_iter - 1;
    const CodeSrc one{sys, E, row + K, row + 3 * K, nullptr, nullptr,
                      nullptr, K};
    half_iteration(one, mats, bnd, slots, tr, Tm, K);
    const CodeSrc two{sys, E, row + 2 * K, row + 3 * K + 2 * M, perm,
                      last ? llr + b * K : nullptr,
                      last ? bits + b * K : nullptr, K};
    half_iteration(two, mats, bnd, slots, tr, Tm, K);
  }
}

int trellis_from(const int* tables, Trellis& tr) {
  const int* ns = tables;
  const int* p = tables + 2 * S;
  const int* prev = tables + 4 * S;
  const int* prev_u = tables + 6 * S;
  const int* prev_p = tables + 8 * S;
  for (int s = 0; s < S; ++s) {
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * s + c;
      if (ns[i] < 0 || ns[i] >= S || prev[i] < 0 || prev[i] >= S)
        return (int)cudaErrorInvalidValue;
      tr.src[0][s][c] = prev[i];
      tr.su[0][s][c] = 1.f - 2.f * prev_u[i];
      tr.sp[0][s][c] = 1.f - 2.f * prev_p[i];
      tr.src[1][s][c] = ns[i];
      tr.su[1][s][c] = 1.f - 2.f * c;
      tr.sp[1][s][c] = 1.f - 2.f * p[i];
    }
  }
  tr.shift = 1;
  for (int s = 0; s < S; ++s) {
    // forward row s; backward row rev(s), state s
    int eb[2][2];
    for (int k = 0; k < 2; ++k) {
      const int u = tr.src[1][s][0] == ((k << 2) | (s >> 1)) ? 0 : 1;
      tr.shift &= tr.src[0][s][k] == (((s & 3) << 1) | k) &&
                  tr.src[1][s][u] == ((k << 2) | (s >> 1));
      tr.cs[0][s][k] = tr.su[0][s][k];
      eb[0][k] = tr.su[0][s][k] * tr.sp[0][s][k] < 0.f;
      tr.cs[1][rev3(s)][k] = tr.su[1][s][u];
      eb[1][k] = tr.su[1][s][u] * tr.sp[1][s][u] < 0.f;
    }
    tr.shift &= eb[0][0] == eb[0][1] && eb[1][0] == eb[1][1];
    tr.eb[0][s] = eb[0][0];
    tr.eb[1][rev3(s)] = eb[1][0];
  }
  return 0;
}

}  // namespace

extern "C" int bcjr_chunk() { return LC; }

// Pass 1's layout for the host tables (as bcjr_maxlog_f32 takes them): 1
// the shift-register layout, 0 the generic one, -1 tables out of range.
extern "C" int bcjr_trellis_shift(const int* tables) {
  Trellis tr;
  return trellis_from(tables, tr) ? -1 : tr.shift;
}

extern "C" long long bcjr_scratch_floats(int Tm) {
  return Tm < 1 ? 0 : scratch_floats(Tm);
}

// Shared memory of the fused decode of a K-bit codeword, bytes.
extern "C" long long turbo_decode_smem(int K) {
  return 4 * fused_floats(K);
}

// The most dynamic shared memory a block of `device` may take, bytes.
extern "C" int turbo_decode_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

extern "C" int bcjr_maxlog_f32(const float* ls, const float* lp, float* llr,
                               float* scratch, const int* tables, int B,
                               int Tm, int T, int device,
                               cudaStream_t stream) {
  if (B < 1 || Tm < 1 || T < 0 || T > Tm) return (int)cudaErrorInvalidValue;
  Trellis tr;
  const int bad = trellis_from(tables, tr);
  if (bad) return bad;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  constexpr int bytes = SLOTS * SLOT_FLOATS * 4;
  const cudaError_t attr = cudaFuncSetAttribute(
      bcjr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  bcjr_kernel<<<B, THREADS, bytes, stream>>>(ls, lp, llr, scratch, tr, Tm,
                                             T);
  return (int)cudaGetLastError();
}

extern "C" int turbo_decode_f32(const float* rx, const int* perm, float* llr,
                                int* bits, const int* tables, int B, int K,
                                int n_iter, int device,
                                cudaStream_t stream) {
  if (B < 1 || K < 1 || n_iter < 1) return (int)cudaErrorInvalidValue;
  Trellis tr;
  const int bad = trellis_from(tables, tr);
  if (bad) return bad;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long bytes = turbo_decode_smem(K);
  if (bytes > turbo_decode_max_smem(device))
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      turbo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  turbo_kernel<<<B, THREADS, bytes, stream>>>(rx, perm, llr, bits, tr, K,
                                              n_iter);
  return (int)cudaGetLastError();
}
