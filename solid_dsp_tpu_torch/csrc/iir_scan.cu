// S3, the IIR filters' direct-form-II w-recurrence, and the fused biquad
// cascade, for Hopper (sm_90a): a time-parallel chunk-and-join recurrence.
//
// Replaces no TPU kernel: in the JAX package both are a lax.scan or an
// associative scan, solid_dsp_tpu/ops/iir.py::_w_recurrence_scan (:117-126)
// and ::_w_recurrence_parallel (:129-153), one section at a time in
// sos_cascade_apply (:219-234).  For each lane b of x (T, B), time along
// axis 0, with the history carried in and out:
//
//   S3:       w[n] = x[n] - (a[0] w[n-1] + a[1] w[n-2] + ... + a[k-1] w[n-k])
//   cascade:  per section s in order (K6's step, csrc/iir_bank.cu):
//             fb = a1 w1 + a2 w2,  ff = b1 w1 + b2 w2,  w0 = v - fb,
//             v = b0 w0 + ff,  (w2, w1) <- (w1, w0);  y[n] = v after the last
//
// S3 takes float32, float64, complex64 and complex128 with coefficients of
// the same type (complex ones allowed), any k >= 1; the cascade real
// coefficients [b0 b1 b2 a1 a2] a section, 1 <= S <= 8, on real lanes (a
// complex lane is two real lanes: real coefficients act on both alike).
//
// Bound: bytes.  The earlier S3, one thread a lane walking T in order, was
// held by the latency of one dependent step: ~30 ns a sample on one lane, 3 %
// of the bytes bound over (2^16, 256) lanes.  Design (K6's, generalised to a
// coefficient set shared by all lanes and to any lane count): both
// recurrences are linear, so the N-vector state after a chunk of Lc rows is
// Phi (state before) + (the chunk run from a zero state), Phi = A^Lc with A
// the one-step map (S3: the companion matrix of a, N = k, state [w[n-1] ..
// w[n-k]]; the cascade: its 2S x 2S map, state [w1_0, w2_0, w1_1, ...]).
// Three launches:
//   1. chunk_ends: every (lane, chunk) from a zero state to its end e_c,
//      then the CB chunks of a block (a group) joined from a zero start by a
//      Kogge-Stone scan in shared memory, loc_j = Phi loc_{j-1} + e_j,
//      through Phi^(2^d);
//   2. group_starts: the groups' starts G_{m+1} = Phi^CB G_m + loc of group
//      m's last chunk, G_0 the carried state; a block holds a few lanes,
//      each thread a run of R groups (a walk from a zero start), then a
//      Kogge-Stone scan over the threads through Phi^(CB R 2^d), then the
//      walk again from the run's true start (the N-vectors in registers
//      where N is fixed at compile time, group_starts_n: with N in a
//      run-time loop and in shared memory it took 0.08-0.10 ms of the
//      elliptic cascade's 0.22);
//   3. chunk_run: chunk j of group m from its start Phi^j G_m + loc_{j-1},
//      writing w (or y), the last chunk also the state.
// The tables Phi^j (j = 1 .. CB) and Phi^(CB 2^d) are built once per
// coefficient set on the host in float64 (complex128) and the join runs in
// float64, so a chunk's start is rounded once, into the working type
// (ops/linrec.py::join_tables; the tables are shared by all lanes, so
// unlike K6's per-lane tables they cost nothing to keep in float64).  Inside
// a chunk the order and rounding of every operation are the plain version's
// (ops/iir.py::iir_scan_torch, K6's cascade step), with the _rn intrinsics
// so that nvcc contracts nothing into an FMA: only the chunk starts differ
// from the sequential walk.  The serial depth is Lc + log2 CB + 2 R +
// log2(join threads) steps, not T.
// Layout: a block of 128 threads holds LB lanes x CB chunks (LB the lane
// count rounded up to a power of two, at most 32; CB = 128 / LB), so with
// few lanes a warp's threads take consecutive chunks of one lane.  Rows are
// staged through shared memory in sub-batches of SB rows a chunk: the
// block's whole tile of a sub-batch is loaded by all its threads in address
// order, so the loads coalesce whatever the lane count; the next
// sub-batch's loads are in flight (in registers) while the current one is
// walked, and pass 3's outputs leave through the tile the same way.  Each
// chunk's run of rows is padded by one row, so the walk's reads of
// consecutive chunks fall in distinct banks.  x is read twice and w written
// once.  Orders k > 8: one thread a (lane, chunk), the history read back
// from w, no staging, groups of one chunk (CB = 1).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // threads a block of passes 1 and 3
constexpr int kMaxJoin = 256;      // threads a block of pass 2, at most

template <typename R> struct C2;
template <> struct C2<float> { using T = float2; };
template <> struct C2<double> { using T = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The join's float64 arithmetic: acc + m v, real or complex.
__device__ __forceinline__ double madd(double m, double v, double acc) {
  return fma(m, v, acc);
}
__device__ __forceinline__ double2 madd(double2 m, double2 v, double2 acc) {
  return make_double2(fma(m.x, v.x, fma(-m.y, v.y, acc.x)),
                      fma(m.x, v.y, fma(m.y, v.x, acc.y)));
}
__device__ __forceinline__ double plus_acc(double a, double b) { return a + b; }
__device__ __forceinline__ double2 plus_acc(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

// A value of the working type: the plain version's products, sums and
// differences, each rounded on its own (a complex product as ar wr - ai wi,
// ar wi + ai wr), and the conversions to and from the join's float64.
template <typename R> struct Real {
  using T = R;
  using Acc = double;
  static __device__ __forceinline__ T prod(T a, T w) { return mul(a, w); }
  static __device__ __forceinline__ T plus(T a, T b) { return add(a, b); }
  static __device__ __forceinline__ T minus(T a, T b) { return sub(a, b); }
  static __device__ __forceinline__ T zero() { return T(0); }
  static __device__ __forceinline__ Acc zero_acc() { return 0.0; }
  static __device__ __forceinline__ Acc widen(T v) { return (double)v; }
  static __device__ __forceinline__ T narrow(Acc v) { return (T)v; }
};
template <typename R> struct Cplx {
  using T = typename C2<R>::T;
  using Acc = double2;
  static __device__ __forceinline__ T prod(T a, T w) {
    T p;
    p.x = sub(mul(a.x, w.x), mul(a.y, w.y));
    p.y = add(mul(a.x, w.y), mul(a.y, w.x));
    return p;
  }
  static __device__ __forceinline__ T plus(T a, T b) {
    T p;
    p.x = add(a.x, b.x);
    p.y = add(a.y, b.y);
    return p;
  }
  static __device__ __forceinline__ T minus(T a, T b) {
    T p;
    p.x = sub(a.x, b.x);
    p.y = sub(a.y, b.y);
    return p;
  }
  static __device__ __forceinline__ T zero() {
    T p;
    p.x = R(0);
    p.y = R(0);
    return p;
  }
  static __device__ __forceinline__ Acc zero_acc() { return make_double2(0.0, 0.0); }
  static __device__ __forceinline__ Acc widen(T v) { return make_double2(v.x, v.y); }
  static __device__ __forceinline__ T narrow(Acc v) {
    T p;
    p.x = (R)v.x;
    p.y = (R)v.y;
    return p;
  }
};

// S3 of order K (1 .. 8): coefficients and history in registers.
template <typename V, int K>
struct S3Walk {
  using Vp = V;
  using E = typename V::T;
  using Acc = typename V::Acc;
  static constexpr int N = K;
  E a[K];
  E st[K];                         // [w[n-1], ..., w[n-K]]

  __device__ __forceinline__ void load(const E* __restrict__ coef) {
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = coef[i];
  }
  __device__ __forceinline__ E step(E xv) {
    E acc = V::prod(a[0], st[0]);
#pragma unroll
    for (int i = 1; i < K; ++i) acc = V::plus(acc, V::prod(a[i], st[i]));
    const E wn = V::minus(xv, acc);
#pragma unroll
    for (int i = K - 1; i > 0; --i) st[i] = st[i - 1];
    st[0] = wn;
    return wn;
  }
};

// The biquad cascade of S (1 .. 8) sections on a real lane.
template <typename R, int S>
struct CascadeWalk {
  using Vp = Real<R>;
  using E = R;
  using Acc = double;
  static constexpr int N = 2 * S;
  R b0[S], b1[S], b2[S], a1[S], a2[S];
  R st[N];                         // [w1_0, w2_0, w1_1, w2_1, ...]

  __device__ __forceinline__ void load(const R* __restrict__ coef) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      b0[s] = coef[5 * s];
      b1[s] = coef[5 * s + 1];
      b2[s] = coef[5 * s + 2];
      a1[s] = coef[5 * s + 3];
      a2[s] = coef[5 * s + 4];
    }
  }
  __device__ __forceinline__ R step(R v) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const R w1 = st[2 * s], w2 = st[2 * s + 1];
      const R fb = add(mul(a1[s], w1), mul(a2[s], w2));
      const R ff = add(mul(b1[s], w1), mul(b2[s], w2));
      const R w0 = sub(v, fb);
      v = add(mul(b0[s], w0), ff);
      st[2 * s + 1] = w1;
      st[2 * s] = w0;
    }
    return v;
  }
};

// One launch's shape: T rows of B lanes, chunks of Lc rows (nc of them),
// blocks of LB = 2^lb lanes, groups of cb chunks.
struct Geo {
  long long T;
  int B, Lc, lb, nc, cb;
};

template <typename E> __host__ __device__ constexpr int sub_rows() {
  return sizeof(E) > 8 ? 8 : 16;   // SB: rows a chunk a sub-batch
}
template <typename E> __host__ __device__ constexpr int sub_rows_log2() {
  return sizeof(E) > 8 ? 3 : 4;
}
template <class W> __host__ __device__ constexpr size_t pass_smem() {
  return 2 * kThreads * (sub_rows<typename W::E>() + 1) * sizeof(typename W::E) >
                 kThreads * W::N * sizeof(typename W::Acc)
             ? 2 * kThreads * (sub_rows<typename W::E>() + 1) * sizeof(typename W::E)
             : kThreads * W::N * sizeof(typename W::Acc);
}

// Walk this thread's chunk (rows c Lc .. of lane l; block tile (blockIdx.x:
// group, blockIdx.y: lane tile)) with w, staged as the note above says;
// kWrite: the outputs go to y.  Every thread of the block calls it; it ends
// with a __syncthreads, the tile free again.
template <class W, bool kWrite>
__device__ __forceinline__ void walk_staged(W& w, const typename W::E* __restrict__ x,
                                            typename W::E* __restrict__ y,
                                            const Geo& g, typename W::E* tile) {
  using E = typename W::E;
  constexpr int SB = sub_rows<E>();
  constexpr int SBL = sub_rows_log2<E>();
  constexpr int kTile = kThreads * (SB + 1);
  const int LB = 1 << g.lb;
  const int tid = threadIdx.x;
  const int ll = tid & (LB - 1), cc = tid >> g.lb;
  const long long l0 = (long long)blockIdx.y * LB;
  const long long row0 = (long long)blockIdx.x * g.cb * g.Lc;
  const long long my0 = row0 + (long long)cc * g.Lc;
  const bool live = l0 + ll < g.B;
  const int nsb = g.Lc >> SBL;
  // element `it` of this thread's share of a sub-batch: its global index
  // and its slot in the tile; false where it lies past T or the lanes
  auto index = [&](int it, int sb, long long& gi, int& si) -> bool {
    const int q = it * kThreads + tid;
    const int ql = q & (LB - 1);
    const int qi = (q >> g.lb) & (SB - 1);
    const int qc = q >> (g.lb + SBL);
    const long long row = row0 + (long long)qc * g.Lc + sb * SB + qi;
    si = (qc * (SB + 1) + qi) * LB + ql;
    gi = row * g.B + l0 + ql;
    return row < g.T && l0 + ql < g.B;
  };
  E reg[SB];
  auto fetch = [&](int sb) {
#pragma unroll
    for (int it = 0; it < SB; ++it) {
      long long gi;
      int si;
      reg[it] = index(it, sb, gi, si) ? x[gi] : W::Vp::zero();
    }
  };
  auto put = [&](E* buf, int sb) {
#pragma unroll
    for (int it = 0; it < SB; ++it) {
      long long gi;
      int si;
      index(it, sb, gi, si);
      buf[si] = reg[it];
    }
  };
  fetch(0);
  put(tile, 0);
  __syncthreads();
  for (int sb = 0; sb < nsb; ++sb) {
    E* cur = tile + (sb & 1) * kTile;
    if (sb + 1 < nsb) fetch(sb + 1);
    if (live) {
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        if (my0 + sb * SB + i < g.T) {
          const int si = (cc * (SB + 1) + i) * LB + ll;
          const E o = w.step(cur[si]);
          if (kWrite) cur[si] = o;
        }
      }
    }
    __syncthreads();
    if (kWrite) {
#pragma unroll
      for (int it = 0; it < SB; ++it) {
        long long gi;
        int si;
        if (index(it, sb, gi, si)) y[gi] = cur[si];
      }
    }
    if (sb + 1 < nsb) put(tile + ((sb + 1) & 1) * kTile, sb + 1);
    __syncthreads();
  }
}

// Pass 1: chunk ends from a zero state, joined within each group.
template <class W>
__global__ void __launch_bounds__(kThreads)
chunk_ends(const typename W::E* __restrict__ x, const typename W::E* __restrict__ coef,
           const typename W::Acc* __restrict__ tabs, typename W::Acc* __restrict__ loc,
           const Geo g) {
  using V = typename W::Vp;
  using Acc = typename W::Acc;
  constexpr int N = W::N;
  __shared__ __align__(16) unsigned char smem[pass_smem<W>()];
  W w;
  w.load(coef);
#pragma unroll
  for (int r = 0; r < N; ++r) w.st[r] = V::zero();
  walk_staged<W, false>(w, x, nullptr, g, reinterpret_cast<typename W::E*>(smem));
  Acc* sh = reinterpret_cast<Acc*>(smem);            // [r][thread]
  const int tid = threadIdx.x, LB = 1 << g.lb, cc = tid >> g.lb;
  Acc v[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    v[r] = V::widen(w.st[r]);
    sh[r * kThreads + tid] = v[r];
  }
  __syncthreads();
  for (int off = 1; off < g.cb; off <<= 1) {
    const bool has = cc >= off;
    Acc u[N];
    if (has) {
      const Acc* P = tabs + (size_t)(off - 1) * N * N;   // Phi^off
#pragma unroll
      for (int r = 0; r < N; ++r) {
        Acc a = V::zero_acc();
#pragma unroll
        for (int q = 0; q < N; ++q)
          a = madd(__ldg(P + r * N + q), sh[q * kThreads + tid - off * LB], a);
        u[r] = a;
      }
    }
    __syncthreads();
    if (has) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        v[r] = plus_acc(v[r], u[r]);
        sh[r * kThreads + tid] = v[r];
      }
    }
    __syncthreads();
  }
  const long long l = (long long)blockIdx.y * LB + (tid & (LB - 1));
  const long long c = (long long)blockIdx.x * g.cb + cc;
  if (l < g.B && c < g.nc) {
#pragma unroll
    for (int r = 0; r < N; ++r) loc[(c * N + r) * g.B + l] = v[r];
  }
}

// Pass 2: the groups' starts G_1 .. G_{ng-1} into G (ng - 1, N, B); a block
// of 2^jl threads holds 2^(jl - tl) lanes x 2^tl runs of 2^rl groups.
template <typename V>
__global__ void __launch_bounds__(kMaxJoin)
group_starts(const typename V::T* __restrict__ st_in, const typename V::Acc* __restrict__ loc,
             const typename V::Acc* __restrict__ tabs, typename V::Acc* __restrict__ G,
             const Geo g, int N, int ng, int jl, int tl, int rl) {
  using Acc = typename V::Acc;
  extern __shared__ __align__(16) unsigned char jsmem[];
  const int J = 1 << jl, TJ = 1 << tl, R = 1 << rl;
  const int lbj = jl - tl, LBJ = 1 << lbj;
  Acc* v = reinterpret_cast<Acc*>(jsmem);            // [r][thread]
  Acc* tmp = v + (size_t)N * J;
  const int tid = threadIdx.x;
  const int ll = tid & (LBJ - 1), t = tid >> lbj;
  const long long l = (long long)blockIdx.x * LBJ + ll;
  const bool ok = l < g.B;
  const int nj = ng - 1;
  const int m0 = t * R;
  const int m1 = m0 + R < nj ? m0 + R : nj;
  const Acc* P1 = tabs + (size_t)g.cb * N * N;       // Phi^CB
  // v <- Phi^CB v + (loc of group m's last chunk), kept in tmp then v
  auto advance = [&](int m) {
    const long long ce = (long long)m * g.cb + g.cb - 1;
    for (int r = 0; r < N; ++r) {
      Acc a = ok ? loc[(ce * N + r) * g.B + l] : V::zero_acc();
      for (int q = 0; q < N; ++q) a = madd(__ldg(P1 + r * N + q), v[q * J + tid], a);
      tmp[r * J + tid] = a;
    }
    for (int r = 0; r < N; ++r) v[r * J + tid] = tmp[r * J + tid];
  };
  for (int r = 0; r < N; ++r)
    v[r * J + tid] = (t == 0 && ok) ? V::widen(st_in[r * g.B + l]) : V::zero_acc();
  for (int m = m0; m < m1; ++m) advance(m);
  __syncthreads();
  for (int d = 0, off = 1; off < TJ; ++d, off <<= 1) {
    const bool has = t >= off;
    if (has) {
      const Acc* P = tabs + (size_t)(g.cb + rl + d) * N * N;   // Phi^(CB R off)
      for (int r = 0; r < N; ++r) {
        Acc a = V::zero_acc();
        for (int q = 0; q < N; ++q)
          a = madd(__ldg(P + r * N + q), v[q * J + tid - off * LBJ], a);
        tmp[r * J + tid] = a;
      }
    }
    __syncthreads();
    if (has)
      for (int r = 0; r < N; ++r) v[r * J + tid] = plus_acc(v[r * J + tid], tmp[r * J + tid]);
    __syncthreads();
  }
  // this run's true start: the carried state, or the run before it's end
  for (int r = 0; r < N; ++r)
    tmp[r * J + tid] = t == 0 ? (ok ? V::widen(st_in[r * g.B + l]) : V::zero_acc())
                              : v[r * J + tid - LBJ];
  __syncthreads();
  for (int r = 0; r < N; ++r) v[r * J + tid] = tmp[r * J + tid];
  for (int m = m0; m < m1; ++m) {
    advance(m);
    if (ok)
      for (int r = 0; r < N; ++r) G[((long long)m * N + r) * g.B + l] = v[r * J + tid];
  }
}

// Pass 2 for an N known at compile time (S3 of order <= 8, the cascade):
// the same schedule with each thread's N-vector in registers, shared memory
// only for the Kogge-Stone exchange, so a step's N^2 products interleave.
template <typename V, int N>
__global__ void __launch_bounds__(kMaxJoin)
group_starts_n(const typename V::T* __restrict__ st_in, const typename V::Acc* __restrict__ loc,
               const typename V::Acc* __restrict__ tabs, typename V::Acc* __restrict__ G,
               const Geo g, int ng, int jl, int tl, int rl) {
  using Acc = typename V::Acc;
  extern __shared__ __align__(16) unsigned char jsmem[];
  const int J = 1 << jl, TJ = 1 << tl, R = 1 << rl;
  const int lbj = jl - tl, LBJ = 1 << lbj;
  Acc* sh = reinterpret_cast<Acc*>(jsmem);           // [r][thread]
  const int tid = threadIdx.x;
  const int t = tid >> lbj;
  const long long l = (long long)blockIdx.x * LBJ + (tid & (LBJ - 1));
  const bool ok = l < g.B;
  const int nj = ng - 1;
  const int m0 = t * R;
  const int m1 = m0 + R < nj ? m0 + R : nj;
  const Acc* P1 = tabs + (size_t)g.cb * N * N;       // Phi^CB
  Acc v[N];
  auto advance = [&](int m) {
    const long long ce = (long long)m * g.cb + g.cb - 1;
    Acc u[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      Acc a = ok ? loc[(ce * N + r) * g.B + l] : V::zero_acc();
#pragma unroll
      for (int q = 0; q < N; ++q) a = madd(__ldg(P1 + r * N + q), v[q], a);
      u[r] = a;
    }
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = u[r];
  };
#pragma unroll
  for (int r = 0; r < N; ++r)
    v[r] = (t == 0 && ok) ? V::widen(st_in[r * g.B + l]) : V::zero_acc();
  for (int m = m0; m < m1; ++m) advance(m);
#pragma unroll
  for (int r = 0; r < N; ++r) sh[r * J + tid] = v[r];
  __syncthreads();
  for (int d = 0, off = 1; off < TJ; ++d, off <<= 1) {
    const bool has = t >= off;
    Acc u[N];
    if (has) {
      const Acc* P = tabs + (size_t)(g.cb + rl + d) * N * N;   // Phi^(CB R off)
#pragma unroll
      for (int r = 0; r < N; ++r) {
        Acc a = V::zero_acc();
#pragma unroll
        for (int q = 0; q < N; ++q)
          a = madd(__ldg(P + r * N + q), sh[q * J + tid - off * LBJ], a);
        u[r] = a;
      }
    }
    __syncthreads();
    if (has) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        v[r] = plus_acc(v[r], u[r]);
        sh[r * J + tid] = v[r];
      }
    }
    __syncthreads();
  }
  // this run's true start: the carried state, or the run before it's end
#pragma unroll
  for (int r = 0; r < N; ++r)
    v[r] = t == 0 ? (ok ? V::widen(st_in[r * g.B + l]) : V::zero_acc())
                  : sh[r * J + tid - LBJ];
  for (int m = m0; m < m1; ++m) {
    advance(m);
    if (ok) {
#pragma unroll
      for (int r = 0; r < N; ++r) G[((long long)m * N + r) * g.B + l] = v[r];
    }
  }
}

// Pass 3: every chunk from its true start, writing y and the final state.
template <class W>
__global__ void __launch_bounds__(kThreads)
chunk_run(const typename W::E* __restrict__ x, typename W::E* __restrict__ y,
          const typename W::E* __restrict__ coef, const typename W::E* __restrict__ st_in,
          typename W::E* __restrict__ st_out, const typename W::Acc* __restrict__ tabs,
          const typename W::Acc* __restrict__ loc, const typename W::Acc* __restrict__ G,
          const Geo g) {
  using V = typename W::Vp;
  using Acc = typename W::Acc;
  constexpr int N = W::N;
  __shared__ __align__(16) unsigned char smem[pass_smem<W>()];
  const int tid = threadIdx.x, LB = 1 << g.lb, cc = tid >> g.lb;
  const long long l = (long long)blockIdx.y * LB + (tid & (LB - 1));
  const int m = blockIdx.x;
  const long long c = (long long)m * g.cb + cc;
  const bool live = l < g.B && c < g.nc;
  W w;
  w.load(coef);
#pragma unroll
  for (int r = 0; r < N; ++r) w.st[r] = V::zero();
  if (live) {
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < N; ++r) w.st[r] = st_in[r * g.B + l];
    } else {
      Acc gm[N];
#pragma unroll
      for (int r = 0; r < N; ++r)
        gm[r] = m == 0 ? V::widen(st_in[r * g.B + l]) : G[((long long)(m - 1) * N + r) * g.B + l];
      if (cc == 0) {
#pragma unroll
        for (int r = 0; r < N; ++r) w.st[r] = V::narrow(gm[r]);
      } else {
        const Acc* P = tabs + (size_t)(cc - 1) * N * N;    // Phi^cc
#pragma unroll
        for (int r = 0; r < N; ++r) {
          Acc a = loc[((c - 1) * N + r) * g.B + l];
#pragma unroll
          for (int q = 0; q < N; ++q) a = madd(__ldg(P + r * N + q), gm[q], a);
          w.st[r] = V::narrow(a);
        }
      }
    }
  }
  walk_staged<W, true>(w, x, y, g, reinterpret_cast<typename W::E*>(smem));
  if (live && c == g.nc - 1) {
#pragma unroll
    for (int r = 0; r < N; ++r) st_out[r * g.B + l] = w.st[r];
  }
}

// S3 of any order (the passes 1 and 3 of k > 8): one thread a (lane,
// chunk), each group one chunk, the history read back from w (pass 1
// writes w as scratch, pass 3 over it) and from the chunk's start.
template <typename V, bool kRun>
__global__ void __launch_bounds__(kThreads)
chunk_any(const typename V::T* __restrict__ x, typename V::T* __restrict__ w,
          const typename V::T* __restrict__ a, int K, const typename V::T* __restrict__ st_in,
          typename V::T* __restrict__ st_out, typename V::Acc* __restrict__ loc,
          const typename V::Acc* __restrict__ G, const Geo g) {
  using E = typename V::T;
  const int tid = threadIdx.x, LB = 1 << g.lb;
  const long long l = (long long)blockIdx.y * LB + (tid & (LB - 1));
  const long long c = (long long)blockIdx.x * (kThreads >> g.lb) + (tid >> g.lb);
  if (l >= g.B || c >= g.nc) return;
  const long long t0 = c * g.Lc;
  const long long t1 = t0 + g.Lc < g.T ? t0 + g.Lc : g.T;
  auto start = [&](int i) -> E {
    if (!kRun) return V::zero();
    if (c == 0) return st_in[(long long)i * g.B + l];
    return V::narrow(G[((c - 1) * K + i) * g.B + l]);
  };
  // w[n - 1 - j]: the chunk's own output, or its start
  auto hist = [&](long long n, int j) -> E {
    const long long mm = n - 1 - j;
    return mm >= t0 ? w[mm * g.B + l] : start(j - (int)(n - t0));
  };
  for (long long n = t0; n < t1; ++n) {
    E acc = V::prod(a[0], hist(n, 0));
    for (int i = 1; i < K; ++i) acc = V::plus(acc, V::prod(a[i], hist(n, i)));
    w[n * g.B + l] = V::minus(x[n * g.B + l], acc);
  }
  if (!kRun) {
    for (int i = 0; i < K; ++i) loc[(c * K + i) * g.B + l] = V::widen(hist(t1, i));
  } else if (c == g.nc - 1) {
    for (int i = 0; i < K; ++i) st_out[(long long)i * g.B + l] = hist(t1, i);
  }
}

// Pass 2 for N-vectors of V: group_starts_n<V, NC> where the walker fixes
// N = NC at compile time, else the general kernel.
template <typename V, int NC>
int launch_join(const typename V::T* st_in, const typename V::Acc* loc,
                const typename V::Acc* tabs, typename V::Acc* G, const Geo& g,
                int N, int ng, int jl, int tl, int rl, cudaStream_t stream) {
  const long long lanes_a_block = 1LL << (jl - tl);
  const unsigned blocks = (unsigned)((g.B + lanes_a_block - 1) / lanes_a_block);
  if constexpr (NC > 0) {
    const size_t smem = (size_t)NC * (1u << jl) * sizeof(typename V::Acc);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          group_starts_n<V, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    group_starts_n<V, NC><<<blocks, 1u << jl, smem, stream>>>(st_in, loc, tabs, G, g,
                                                              ng, jl, tl, rl);
  } else {
    const size_t smem = 2 * (size_t)N * (1u << jl) * sizeof(typename V::Acc);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          group_starts<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    group_starts<V><<<blocks, 1u << jl, smem, stream>>>(st_in, loc, tabs, G, g, N, ng,
                                                        jl, tl, rl);
  }
  return (int)cudaGetLastError();
}

// The three passes of a walker W with its coefficients in registers.
template <class W>
int launch_chunked(const typename W::E* x, typename W::E* y, const typename W::E* coef,
                   const typename W::E* st_in, typename W::E* st_out,
                   const typename W::Acc* tabs, typename W::Acc* loc,
                   typename W::Acc* G, const Geo& g, int jl, int tl, int rl,
                   cudaStream_t stream) {
  const int LB = 1 << g.lb;
  const long long ng = (g.nc + g.cb - 1) / g.cb;
  const long long lane_tiles = (g.B + LB - 1) / LB;
  if (lane_tiles > 65535 || ng > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ng, (unsigned)lane_tiles);
  if (g.nc > 1) {
    chunk_ends<W><<<grid, kThreads, 0, stream>>>(x, coef, tabs, loc, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (ng > 1) {
      const int e = launch_join<typename W::Vp, W::N>(st_in, loc, tabs, G, g, W::N,
                                                      (int)ng, jl, tl, rl, stream);
      if (e != 0) return e;
    }
  }
  chunk_run<W><<<grid, kThreads, 0, stream>>>(x, y, coef, st_in, st_out, tabs, loc, G, g);
  return (int)cudaGetLastError();
}

// S3 of any order: passes 1 and 3 of chunk_any, pass 2 over single chunks.
template <typename V>
int launch_any(const typename V::T* x, typename V::T* w, const typename V::T* a, int K,
               const typename V::T* st_in, typename V::T* st_out,
               const typename V::Acc* tabs, typename V::Acc* loc, typename V::Acc* G,
               const Geo& g, int jl, int tl, int rl, cudaStream_t stream) {
  const int LB = 1 << g.lb;
  const long long lane_tiles = (g.B + LB - 1) / LB;
  const long long tiles = (g.nc + (kThreads >> g.lb) - 1) / (kThreads >> g.lb);
  if (lane_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)lane_tiles);
  if (g.nc > 1) {
    chunk_any<V, false><<<grid, kThreads, 0, stream>>>(x, w, a, K, st_in, st_out, loc, G, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int e = launch_join<V, 0>(st_in, loc, tabs, G, g, K, g.nc, jl, tl, rl, stream);
    if (e != 0) return e;
  }
  chunk_any<V, true><<<grid, kThreads, 0, stream>>>(x, w, a, K, st_in, st_out, loc, G, g);
  return (int)cudaGetLastError();
}

// The arguments both entries check: lb in 0 .. 5, cb as the path needs it,
// Lc a positive multiple of 16, 1 <= 2^tl <= 2^jl <= 256, rl >= 0.
bool bad_geometry(long long T, int B, int Lc, int lb, int cb, int want_cb, int jl,
                  int tl, int rl) {
  return T <= 0 || B <= 0 || Lc <= 0 || Lc % 16 || lb < 0 || lb > 5 ||
         cb != want_cb || jl < 0 || jl > 8 || tl < 0 || tl > jl || rl < 0 || rl > 30 ||
         (T + Lc - 1) / Lc > 0x7fffffffLL;
}

template <typename V>
int s3_entry(const void* x, void* w, const void* a, const void* st_in, void* st_out,
             const void* tabs, void* loc, void* G, int B, long long T, int K, int Lc,
             int lb, int cb, int jl, int tl, int rl, int device, cudaStream_t stream) {
  using E = typename V::T;
  using Acc = typename V::Acc;
  if (K < 1 || bad_geometry(T, B, Lc, lb, cb, K <= 8 ? kThreads >> lb : 1, jl, tl, rl))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geo g{T, B, Lc, lb, (int)((T + Lc - 1) / Lc), cb};
  const E* xs = static_cast<const E*>(x);
  E* ws = static_cast<E*>(w);
  const E* as = static_cast<const E*>(a);
  const E* si = static_cast<const E*>(st_in);
  E* so = static_cast<E*>(st_out);
  const Acc* tb = static_cast<const Acc*>(tabs);
  Acc* lc = static_cast<Acc*>(loc);
  Acc* gs = static_cast<Acc*>(G);
  switch (K) {
#define S3_CASE(k)                                                                   \
    case k:                                                                          \
      return launch_chunked<S3Walk<V, k>>(xs, ws, as, si, so, tb, lc, gs, g, jl, tl, \
                                          rl, stream);
    S3_CASE(1) S3_CASE(2) S3_CASE(3) S3_CASE(4)
    S3_CASE(5) S3_CASE(6) S3_CASE(7) S3_CASE(8)
#undef S3_CASE
    default:
      return launch_any<V>(xs, ws, as, K, si, so, tb, lc, gs, g, jl, tl, rl, stream);
  }
}

template <typename R>
int sos_entry(const void* x, void* y, const void* coef, const void* st_in, void* st_out,
              const void* tabs, void* loc, void* G, int B, long long T, int S, int Lc,
              int lb, int cb, int jl, int tl, int rl, int device, cudaStream_t stream) {
  if (S < 1 || S > 8 || bad_geometry(T, B, Lc, lb, cb, kThreads >> lb, jl, tl, rl))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geo g{T, B, Lc, lb, (int)((T + Lc - 1) / Lc), cb};
  const R* xs = static_cast<const R*>(x);
  R* ys = static_cast<R*>(y);
  const R* cs = static_cast<const R*>(coef);
  const R* si = static_cast<const R*>(st_in);
  R* so = static_cast<R*>(st_out);
  const double* tb = static_cast<const double*>(tabs);
  double* lc = static_cast<double*>(loc);
  double* gs = static_cast<double*>(G);
  switch (S) {
#define SOS_CASE(s)                                                                   \
    case s:                                                                           \
      return launch_chunked<CascadeWalk<R, s>>(xs, ys, cs, si, so, tb, lc, gs, g, jl, \
                                               tl, rl, stream);
    SOS_CASE(1) SOS_CASE(2) SOS_CASE(3) SOS_CASE(4)
    SOS_CASE(5) SOS_CASE(6) SOS_CASE(7) SOS_CASE(8)
#undef SOS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// S3: x and w (T, B), time-major, contiguous, of the entry's type; a (K,)
// of that type; st_in and st_out (K, B), row i holding w[-1 - i] of every
// lane before and after the block; tabs the join tables of
// ops/linrec.py::join_tables for this a, Lc and cb ((cb + D) K x K
// float64, complex128 for the complex types: Phi^1 .. Phi^cb, then
// Phi^(cb 2^d)); loc (nc, K, B) and G (max(ng - 1, 1), K, B) scratch of
// float64 (complex128), nc = ceil(T / Lc), ng = ceil(nc / cb); lb, cb and
// the join's 2^jl threads a block, 2^tl runs a lane and 2^rl groups a run
// from ops/cuda_scan.py::chunk_geometry.  T >= 1, any K >= 1.  On card
// `device`; launches up to three kernels on `stream`, does not
// synchronise, returns the first failed launch's cudaError_t or 0.
#define S3_ENTRY(NAME, V)                                                          \
  extern "C" int NAME(const void* x, void* w, const void* a, const void* st_in,    \
                      void* st_out, const void* tabs, void* loc, void* G, int B,   \
                      long long T, int K, int Lc, int lb, int cb, int jl, int tl,  \
                      int rl, int device, cudaStream_t stream) {                   \
    return s3_entry<V>(x, w, a, st_in, st_out, tabs, loc, G, B, T, K, Lc, lb, cb,  \
                       jl, tl, rl, device, stream);                                \
  }

S3_ENTRY(iir_chunked_f32, Real<float>)
S3_ENTRY(iir_chunked_f64, Real<double>)
S3_ENTRY(iir_chunked_c64, Cplx<float>)
S3_ENTRY(iir_chunked_c128, Cplx<double>)

// The cascade: x and y (T, B) real lanes (float32 or float64), coef (S, 5)
// [b0 b1 b2 a1 a2] a section of that type, st_in and st_out (2S, B) rows
// [w1_0, w2_0, w1_1, ...]; tabs, loc, G and the geometry as for S3 with
// N = 2S, float64 throughout.  1 <= S <= 8.
#define SOS_ENTRY(NAME, R)                                                         \
  extern "C" int NAME(const void* x, void* y, const void* coef, const void* st_in, \
                      void* st_out, const void* tabs, void* loc, void* G, int B,   \
                      long long T, int S, int Lc, int lb, int cb, int jl, int tl,  \
                      int rl, int device, cudaStream_t stream) {                   \
    return sos_entry<R>(x, y, coef, st_in, st_out, tabs, loc, G, B, T, S, Lc, lb,  \
                        cb, jl, tl, rl, device, stream);                           \
  }

SOS_ENTRY(sos_chunked_f32, float)
SOS_ENTRY(sos_chunked_f64, double)
