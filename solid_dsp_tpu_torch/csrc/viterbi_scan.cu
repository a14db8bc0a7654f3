// S7: the Viterbi decoder's add-compare-select (ACS) walk and its traceback,
// for models/fec.py::viterbi_decode over a batch of rows.
//
// Replaces no TPU kernel: in the JAX package the walk is two lax.scans,
// solid_dsp_tpu/models/fec.py::viterbi_decode: the ACS scan over all
// 2^(K-1) states at :143 and the traceback scan at :152.  PyTorch has no
// scan: the ACS in eager torch ops is ~7 dependent launches a step, and a
// default packet (550 steps) or a CCSDS frame at interleave depth 4 (8,166
// steps) costs thousands to tens of thousands of launches; here a batch is
// three launches.
//
// Bound: latency.  A row's ACS is a dependent chain of T steps (a step is
// the predecessors' metrics, two adds, a compare and select, and the
// minimum of all states' new metrics, which the next step subtracts), and
// the bytes (the received values in, the bits and final metrics out) bound
// a call far below that chain.  A warp a row leaves the card idle where
// rows are few (64 rows of a CCSDS frame fill 64 of 132 SMs with one warp
// each) and walks T steps in turn where they are long.  So the walk is cut
// in time, and the chunks of every row run side by side.
//
// The design: the path metrics forget where they started.  The carried
// state of the walk is the renormalised metric vector pm = pmn - min(pmn);
// a walk started W steps before a seam from all-zero metrics reaches, for
// W of a few constraint lengths, the very float32 vector the walk from
// step 0 carries there, bit for bit.  Where it does, every later float
// operation of the chunk is the sequential walk's own.  A bitwise compare
// at the seam says exactly when it does not, and such a chunk is walked
// again from the true vector.  The result is bit-equal to the sequential
// walk (models/fec.py::viterbi_plain, JAX's scans) for every input; only
// the time depends on the data.
//
// The rows' chunks: chunk 0 is [0, F), chunk c >= 1 is [t_c, t_c+1) with
// F = L + W and t_c = F + (c - 1) L (the last one ragged), so that every
// chunk walks L + W steps and no warm-up reaches back past step 0;
// ops/cuda_viterbi.py::chunk_plan picks L and W from the code and C from
// the batch, so that the card gets some thousands of warps.
//   Pass 1 (acs_chunks_*, every chunk of every row at once): chunk 0 walks
//     from the exact start (state 0 at 0, the others at BIG); chunk c >= 1
//     from all-zero metrics at t_c - W, without storing decisions up to
//     t_c.  It keeps its vector at the seam (its guess) and at its end in
//     vec (B, C, 2, S) and stores its decision words (dec).
//   Pass 2 (fix_rows, a block a row): every seam's guess against the end
//     vector before it, all S entries as int32 bits, all seams at once;
//     then in order: a chunk whose guess differs, or follows a re-walked
//     chunk and differs from its new end vector, is walked again from the
//     true vector (decisions and end vector rewritten) and counted into
//     fix[0] (on the card; nothing reads it back on the path).  The final
//     metrics are the last chunk's end vector.
//   Pass 3 (trace_chunks): the traceback, with the same speculate-and-
//     check as the walk, over the row cut again into pieces of Lt steps (a
//     thread a piece, a warp a piece in the block form).  Survivor paths
//     merge: a trace started from any state D steps past a piece's end
//     has, nearly always, reached the decoded path by then (fewer steps
//     than the walk's warm-up needs).  Each piece is traced from state 0
//     there (the last piece from state 0 at T, exactly), writing its bits
//     and keeping its state at its end and at its start.  The row's last
//     piece to finish (a ticket in tick (B,)) checks the seams from the
//     last one back: a piece whose state at its end is not the true start
//     state of the piece after it is traced again from that state
//     (fix[1]).  By induction from the last piece every bit is the
//     sequential traceback's.
// A thread a piece walks back with the words of the next 16 steps in
// registers (they do not depend on the state), every step predicated, the
// words loaded and the bits stored 16 bytes at a time: a warp's lanes
// touch 32 lines a load or store, and 4-byte ones a step cost more than
// the walk.  The speculative trace needs no map of a chunk's end states
// (64 walks back a chunk) and no join of them.
//
// Every form makes the plain version's float operations in its order, so
// the metrics and the decisions are bit-equal to it:
//   pm[p] = pmn[p] - min(previous pmn),
//   cand_c = pm[p_c] + bm(p_c, b),  p_0 = ns >> 1, p_1 = p_0 | S/2,
//   choice = cand_1 < cand_0          (JAX's argmin: the first minimum),
//   pmn[ns] = choice ? cand_1 : cand_0,
// with bm the branch metric summed over the n outputs in index order (soft:
// the LLRs of the outputs whose hypothesised bit is 1; hard: the Hamming
// distance as an integer).  A walk that starts from a vector v takes pmn =
// v and a minimum of 0 (v - 0 = v exactly, as pmn - min is on the
// sequential walk).  A step's decisions are packed by __ballot_sync into
// words, stored to global memory (T x S / 8 bytes a row): lane i of a warp
// keeps the word of a round's step i and the warp stores the round's words
// at its end.  The received values are staged a round of steps ahead: each
// thread loads its share of the next round into registers at a round's
// start and stores it to the other shared buffer at its end.
//
// The single-warp form (WarpWalk), S <= 64, K <= 7: a warp a chunk, CPB
// chunks a block; the metrics stay in registers and no barrier is needed.
// At 64 states lane l holds states l and l + 32, the two predecessors of
// next states 2l and 2l + 1, and computes both; four shuffles put the new
// metrics back in that layout while the warp minimum runs.  Below 32
// states lane l holds state l % S and takes its predecessors by two
// shuffles.  Where every lane's four branches use two output masks (the
// generators tap both ends of the register, as in every standard code), a
// lane computes two branch metrics, not four.  A full round of 32 steps is
// unrolled.
//
// The block form (BlockWalk), S >= 128: a block a chunk, one thread a
// state, the metrics exchanged through a double-buffered shared array;
// each thread subtracts the previous minimum as it reads a predecessor, so
// one barrier a step suffices; the block minimum comes from the warps'
// minima at the next step (REDUX on order-preserving integer keys, exact: a
// minimum selects a value).  Its trace is a warp a piece: lane l holds word
// l of TB steps ahead and the walk takes the word of its state by a
// shuffle.
//
// Entry point (returns the first launch error as a cudaError_t):
//   viterbi_acs: rx (B, T, n) float32 LLRs (soft != 0, positive favours 0)
//   or int32 hard bits; masks (S, 2) uint32, bit k = output k of the branch
//   (previous state p, input b); -> bits (B, T) int32, the decoded bit of
//   every step (the caller drops the K - 1 tail bits), pm (B, S) float32,
//   the final renormalised metrics; scratch: dec (B, T, max(1, S / 32))
//   uint32 (at 64 states the single-warp form's two words a step: bit l of
//   word b is state 2l + b), vec (B, C, 2, S) float32, ends (B, Ct, 2) and
//   tick (B,) int32 (Ct = ceil(T / Lt) pieces); fix, two uint64 the
//   re-walked chunks and the re-traced pieces are added to.
//   S a power of two <= 1024, 1 <= n <= 32; L >= 1, W >= 0 and C the
//   chunk count of that layout, Lt >= 1, D >= 0; bits and dec 16-byte
//   aligned.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_S = 1024;
constexpr int MAX_CHUNK = 32;    // staged steps a round (<= 32: a word a lane)
constexpr int PER = 4;           // staged values a thread a round
constexpr int TB = 16;           // block form's steps loaded ahead, walking back
constexpr int CPB = 4;           // chunks (warps) a block in pass 1
constexpr int FIX_THREADS = 256; // pass 2's block in the single-warp form
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;      // start metric of every state but 0

struct Plan {
  int T, n, S, L, W, F, C, cs, Lt, D;
};

// t_c: the first step of chunk c (T for c = C)
__device__ __forceinline__ int seam(const Plan& p, int c) {
  return c == 0 ? 0 : min(p.T, p.F + (c - 1) * p.L);
}

// Shared bytes of the staged values, 2 rounds of cs steps of n values.
__host__ __device__ __forceinline__ size_t staged_bytes(const Plan& p) {
  return (sizeof(float) * 2 * p.cs * p.n + 15) & ~(size_t)15;
}

// float -> int whose signed order is the float order (finite values)
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : (i ^ 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : (k ^ 0x7fffffff));
}

template <bool SOFT>
struct Rx {
  using T = float;
};
template <>
struct Rx<false> {
  using T = int;
};

// Branch metric of output mask m against one step's n received values, in
// index order.  N > 0 fixes n at compile time.
template <int N, bool SOFT>
__device__ __forceinline__ float branch_metric(unsigned m,
                                               const typename Rx<SOFT>::T* r,
                                               int n) {
  constexpr int KMAX = N > 0 ? N : 32;
  if constexpr (SOFT) {
    float bm = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (N == 0 && k >= n) break;
      if ((m >> k) & 1u) bm = __fadd_rn(bm, r[k]);
    }
    return bm;
  } else {
    int bm = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (N == 0 && k >= n) break;
      bm += abs((int)((m >> k) & 1u) - r[k]);
    }
    return __int2float_rn(bm);
  }
}

// The block minimum of the previous step's pmn, from its W warp minima
// (the entries past W hold INT_MAX).
__device__ __forceinline__ int block_min_key(const int* red, int W,
                                             int lane) {
  if (W <= 4) return min(min(red[0], red[1]), min(red[2], red[3]));
  return __reduce_min_sync(FULL, red[lane & (W - 1)]);
}

// The single-warp form's walker: one warp, the metrics in registers (see
// the header).  pa (and pb, PAIRS) hold pmn, g the previous step's minimum.
template <int N, bool SOFT, bool PAIRS>
struct WarpWalk {
  using R = typename Rx<SOFT>::T;
  static constexpr int NK = N > 0 ? N : 1;
  static constexpr int WD = PAIRS ? 2 : 1;   // decision words a step
  int lane, S, ns, p0, p1, src;
  bool odd;
  unsigned ma0, ma1, mb0, mb1, word_mask;
  float fa0[NK], fa1[NK], fb0[NK], fb1[NK];
  float pa = 0.f, pb = 0.f, g = 0.f;
  int nv = 0;                                  // values a step (N = 0)
  bool share;                                  // see rounds()

  // PAIRS: the branches (lane -> 2 lane + b) and (lane + 32 -> 2 lane + b);
  // otherwise (p0 -> ns) and (p1 -> ns)
  __device__ WarpWalk(const unsigned* __restrict__ masks, int S_, int lane_)
      : lane(lane_), S(S_) {
    ns = lane & (S - 1);
    p0 = PAIRS ? lane : ns >> 1;
    p1 = PAIRS ? lane + 32 : (ns >> 1) | (S >> 1);
    ma0 = masks[2 * p0 + (PAIRS ? 0 : (ns & 1))];
    ma1 = masks[2 * p1 + (PAIRS ? 0 : (ns & 1))];
    mb0 = PAIRS ? masks[2 * p0 + 1] : 0u;
    mb1 = PAIRS ? masks[2 * p1 + 1] : 0u;
    src = lane >> 1;                             // PAIRS' shuffles
    odd = lane & 1;
    share = PAIRS && __all_sync(FULL, mb0 == ma1 && mb1 == ma0);
    word_mask = S >= 32 ? FULL : ((1u << S) - 1u);
    // With n fixed (N > 0) a step's n values come a step ahead into
    // registers, and a soft branch metric is an FFMA chain over them with
    // the branch's outputs as 0/1 factors, in index order: fma(o, r, bm) =
    // bm + o r exactly, the plain version's sum.
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      fa0[k] = (float)((ma0 >> k) & 1u);
      fa1[k] = (float)((ma1 >> k) & 1u);
      fb0[k] = (float)((mb0 >> k) & 1u);
      fb1[k] = (float)((mb1 >> k) & 1u);
    }
  }

  // the exact start (state 0 at 0, the others at BIG) or all-zero metrics
  __device__ void start(bool exact) {
    pa = exact ? ((PAIRS ? lane : ns) == 0 ? 0.f : BIG) : 0.f;
    pb = exact ? BIG : 0.f;
    g = 0.f;
  }

  // start from the renormalised vector v (S,)
  __device__ void load(const float* v) {
    pa = v[PAIRS ? lane : ns];
    pb = PAIRS ? v[lane + 32] : 0.f;
    g = 0.f;
  }

  // the renormalised vector pmn - g into v (S,)
  __device__ void save(float* v) const {
    if (PAIRS) {
      v[lane] = __fsub_rn(pa, g);
      v[lane + 32] = __fsub_rn(pb, g);
    } else if (lane < S) {
      v[ns] = __fsub_rn(pa, g);
    }
  }

  __device__ float metric(unsigned m, const float (&f)[NK], const R* rs,
                          const R (&rv)[NK]) const {
    if constexpr (N > 0 && SOFT) {
      float bm = __fmaf_rn(f[0], rv[0], 0.f);
#pragma unroll
      for (int k = 1; k < N; ++k) bm = __fmaf_rn(f[k], rv[k], bm);
      return bm;
    } else if constexpr (N > 0) {
      int bm = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) bm += abs((int)((m >> k) & 1u) - rv[k]);
      return __int2float_rn(bm);
    } else {
      return branch_metric<N, SOFT>(m, rs, nv);
    }
  }

  // Steps [t_from, t_to) of row rrow (n values a step), staged through rb
  // (2 cs n values); the decision words into drow unless it is null.
  __device__ void walk(const R* __restrict__ rrow, int n, int cs, int t_from,
                       int t_to, unsigned* __restrict__ drow, R* rb) {
    if (share)
      rounds<true>(rrow, n, cs, t_from, t_to, drow, rb);
    else
      rounds<false>(rrow, n, cs, t_from, t_to, drow, rb);
  }

  // SHARE (PAIRS): every lane's branches (p0, 1) and (p1, 1) have the
  // outputs of (p1, 0) and (p0, 0), as in every code whose generators all
  // tap both ends of the register: two branch metrics a lane, not four.
  // A round of 32 steps is unrolled (its step index known at compile time).
  template <bool SHARE>
  __device__ void rounds(const R* __restrict__ rrow, int n, int cs,
                         int t_from, int t_to, unsigned* __restrict__ drow,
                         R* rb) {
    if (t_from >= t_to) return;
    nv = n;
    const int cn = cs * n;
    const long long lim = (long long)t_to * n;
    const long long first = (long long)t_from * n;
    __syncwarp();
    for (int j = lane; j < cn; j += 32)
      rb[j] = first + j < lim ? rrow[first + j] : R(0);
    __syncwarp();
    int rbuf = 0;
    for (int t0 = t_from; t0 < t_to; t0 += cs) {
      R pre[PER];
      const long long base = (long long)(t0 + cs) * n;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = lane + k * 32;
        pre[k] = (j < cn && base + j < lim) ? rrow[base + j] : R(0);
      }
      const int steps = min(cs, t_to - t0);
      const R* rc = rb + rbuf * cn;
      R rv[NK];
#pragma unroll
      for (int k = 0; k < NK; ++k) rv[k] = rc[k];
      unsigned wra = 0, wrb = 0;
      const auto step = [&](int i) {
        const R* rs = rc + i * n;
        R rn[NK];                        // the next step's values
        const int inext = min(i + 1, steps - 1) * n;
#pragma unroll
        for (int k = 0; k < NK; ++k) rn[k] = rc[inext + k];
        float a0, a1;
        if (PAIRS) {
          a0 = pa;
          a1 = pb;
        } else {
          a0 = __shfl_sync(FULL, pa, p0);
          a1 = __shfl_sync(FULL, pa, p1);
        }
        const float x0 = __fsub_rn(a0, g);
        const float x1 = __fsub_rn(a1, g);
        const float bm0 = metric(ma0, fa0, rs, rv);
        const float bm1 = metric(ma1, fa1, rs, rv);
        const float ca0 = __fadd_rn(x0, bm0);
        const float ca1 = __fadd_rn(x1, bm1);
        const bool cha = ca1 < ca0;
        const float va = cha ? ca1 : ca0;
        const unsigned wa = __ballot_sync(FULL, cha);
        if (lane == i) wra = wa & word_mask;
        float vmin = va;
        if (PAIRS) {
          const float cb0 = __fadd_rn(x0, SHARE ? bm1
                                                : metric(mb0, fb0, rs, rv));
          const float cb1 = __fadd_rn(x1, SHARE ? bm0
                                                : metric(mb1, fb1, rs, rv));
          const bool chb = cb1 < cb0;
          const float vb = chb ? cb1 : cb0;
          const unsigned wb = __ballot_sync(FULL, chb);
          if (lane == i) wrb = wb;
          vmin = fminf(va, vb);
          // back to the layout (state m, state m + 32) at lane m
          const float sa0 = __shfl_sync(FULL, va, src);
          const float sa1 = __shfl_sync(FULL, vb, src);
          const float sb0 = __shfl_sync(FULL, va, src + 16);
          const float sb1 = __shfl_sync(FULL, vb, src + 16);
          pa = odd ? sa1 : sa0;
          pb = odd ? sb1 : sb0;
        } else {
          pa = va;
        }
        g = from_key(__reduce_min_sync(FULL, order_key(vmin)));
#pragma unroll
        for (int k = 0; k < NK; ++k) rv[k] = rn[k];
      };
      if (steps == 32) {
#pragma unroll
        for (int i = 0; i < 32; ++i) step(i);
      } else {
        for (int i = 0; i < steps; ++i) step(i);
      }
      if (drow && lane < steps) {
        drow[(long long)(t0 + lane) * WD] = wra;
        if (PAIRS) drow[(long long)(t0 + lane) * WD + 1] = wrb;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = lane + k * 32;
        if (j < cn) rb[(rbuf ^ 1) * cn + j] = pre[k];
      }
      __syncwarp();
      rbuf ^= 1;
    }
  }
};

// The block form's walker: a block of S threads, one a state; pmn [2][S],
// red [2][32] (the warps' minima as keys) and rb in shared memory.
template <int N, bool SOFT>
struct BlockWalk {
  using R = typename Rx<SOFT>::T;
  int tid, lane, warp, S, W, ns, p0, p1, cur;
  unsigned m0, m1;
  float* pmn;
  int* red;
  R* rb;

  __device__ BlockWalk(const unsigned* __restrict__ masks, int S_, float* pmn_,
                       int* red_, R* rb_)
      : S(S_), pmn(pmn_), red(red_), rb(rb_) {
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    W = S >> 5;
    ns = tid;
    p0 = ns >> 1;
    p1 = p0 | (S >> 1);
    m0 = masks[2 * p0 + (ns & 1)];
    m1 = masks[2 * p1 + (ns & 1)];
    cur = 0;
  }

  // the start's minimum is 0 (x - 0 = x)
  __device__ void reset_min() {
    for (int j = tid; j < 64; j += S) red[j] = (j & 31) < W ? 0 : INT_MAX;
    cur = 0;
    __syncthreads();
  }

  __device__ void start(bool exact) {
    __syncthreads();
    pmn[ns] = exact ? (ns == 0 ? 0.f : BIG) : 0.f;
    reset_min();
  }

  __device__ void load(const float* v) {
    __syncthreads();
    pmn[ns] = v[ns];
    reset_min();
  }

  __device__ void save(float* v) const {
    const float g = from_key(block_min_key(red + cur * 32, W, lane));
    v[ns] = __fsub_rn(pmn[cur * S + ns], g);
  }

  __device__ void walk(const R* __restrict__ rrow, int n, int cs, int t_from,
                       int t_to, unsigned* __restrict__ drow) {
    if (t_from >= t_to) return;
    const int cn = cs * n;
    const long long lim = (long long)t_to * n;
    const long long first = (long long)t_from * n;
    __syncthreads();
    for (int j = tid; j < cn; j += S)
      rb[j] = first + j < lim ? rrow[first + j] : R(0);
    __syncthreads();
    int rbuf = 0;
    for (int t0 = t_from; t0 < t_to; t0 += cs) {
      R pre[PER];
      const long long base = (long long)(t0 + cs) * n;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = tid + k * S;
        pre[k] = (j < cn && base + j < lim) ? rrow[base + j] : R(0);
      }
      const int steps = min(cs, t_to - t0);
      const R* rc = rb + rbuf * cn;
      unsigned wreg = 0;   // lane i keeps step t0 + i's decision word
      for (int i = 0; i < steps; ++i) {
        const float a0 = pmn[cur * S + p0];
        const float a1 = pmn[cur * S + p1];
        const int gk = block_min_key(red + cur * 32, W, lane);
        const float bm0 = branch_metric<N, SOFT>(m0, rc + i * n, n);
        const float bm1 = branch_metric<N, SOFT>(m1, rc + i * n, n);
        const float g = from_key(gk);
        const float c0 = __fadd_rn(__fsub_rn(a0, g), bm0);
        const float c1 = __fadd_rn(__fsub_rn(a1, g), bm1);
        const bool choice = c1 < c0;
        const float v = choice ? c1 : c0;
        const unsigned word = __ballot_sync(FULL, choice);
        if (lane == i) wreg = word;
        const int wk = __reduce_min_sync(FULL, order_key(v));
        const int nxt = cur ^ 1;
        pmn[nxt * S + ns] = v;
        if (lane == 0) red[nxt * 32 + warp] = wk;
        __syncthreads();
        cur = nxt;
      }
      // the round's decision words, one a lane; the next round's values
      if (drow && lane < steps) drow[(long long)(t0 + lane) * W + warp] = wreg;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = tid + k * S;
        if (j < cn) rb[(rbuf ^ 1) * cn + j] = pre[k];
      }
      __syncthreads();
      rbuf ^= 1;
    }
  }
};

// One step back from state s over its step's decision words (wa, wb): the
// single-warp form's layout (FORM 1, PAIRS: bit s >> 1 of word s & 1; FORM
// 0: bit s of wa) or the block form's (FORM 2: bit s & 31 of the word s >>
// 5, given in wa).
template <int FORM>
__device__ __forceinline__ int back(int s, unsigned wa, unsigned wb, int half) {
  const unsigned w = FORM == 1 ? ((s & 1) ? wb : wa) : wa;
  const int bit = FORM == 1 ? s >> 1 : (FORM == 0 ? s : s & 31);
  return (s >> 1) | (((w >> bit) & 1u) ? half : 0);
}

// One thread traces a row's decision words back (the single-warp form's
// layouts, FORM 0 or 1) over steps hi - 1 down to lo from state s, writing
// the bit s & 1 of every step below te into brow; s_te gets the state at
// seam te (after step te - 1), and the state after step lo - 1 is
// returned.  The steps go in rounds of 16 aligned on the bits' flat index
// (brow + t, 16-byte aligned where it is a multiple of 4), each step
// predicated and not branched: a round's words are loaded while the round
// before is walked (they do not depend on the state), its bits kept in
// registers and stored four at a time where four steps of a group are in
// range (a scattered store a step cost more than the walk).
constexpr int TA = 16;
template <int FORM>
__device__ __forceinline__ int thread_trace(const unsigned* __restrict__ drow,
                                            int lo, int hi, int te, int T,
                                            int S, int s,
                                            int* __restrict__ brow,
                                            int& s_te) {
  constexpr int WD = FORM == 1 ? 2 : 1;
  const int half = S >> 1;
  s_te = s;
  if (hi <= lo) return s;
  // brow's flat offset modulo TA: rounds cover t with (t + phase) in
  // [k TA, (k + 1) TA).  bits and dec are 16-byte aligned and hold a step
  // at the same flat index, so a group of 4 steps from a multiple of 4 is
  // one 16-byte store of bits and 16 WD bytes of words.
  const int phase = (int)((reinterpret_cast<unsigned long long>(brow)
                           / sizeof(int)) & (TA - 1));
  unsigned ca[TA], cb[TA], na[TA], nb[TA];
  // A lane's loads go to its own row: 16 bytes a load, 4 / WD steps (a
  // warp load touches 32 lines whatever its width).
  const auto load = [&](int top, unsigned (&a)[TA], unsigned (&b)[TA]) {
#pragma unroll
    for (int g = 0; g < TA / 4; ++g) {
      const int t0 = top - 4 * g - 3;
      const unsigned* w = drow + (long long)t0 * WD;
      if (t0 >= 0 && t0 + 3 < T) {
        const uint4 q0 = *reinterpret_cast<const uint4*>(w);
        if (FORM == 1) {
          const uint4 q1 = *reinterpret_cast<const uint4*>(w + 4);
          a[4 * g + 3] = q0.x; b[4 * g + 3] = q0.y;
          a[4 * g + 2] = q0.z; b[4 * g + 2] = q0.w;
          a[4 * g + 1] = q1.x; b[4 * g + 1] = q1.y;
          a[4 * g] = q1.z; b[4 * g] = q1.w;
        } else {
          a[4 * g + 3] = q0.x;
          a[4 * g + 2] = q0.y;
          a[4 * g + 1] = q0.z;
          a[4 * g] = q0.w;
          b[4 * g + 3] = b[4 * g + 2] = b[4 * g + 1] = b[4 * g] = 0u;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + k;
          const bool in = t >= lo && t < hi;
          a[4 * g + 3 - k] = in ? w[k * WD] : 0u;
          b[4 * g + 3 - k] = FORM == 1 && in ? w[k * WD + 1] : 0u;
        }
      }
    }
  };
  // a round of TA steps from step top down, its words in (a, b)
  int top = ((hi - 1 + phase) | (TA - 1)) - phase;   // the first round's
  const auto round = [&](const unsigned (&a)[TA], const unsigned (&b)[TA]) {
    int bv[TA];
#pragma unroll
    for (int i = 0; i < TA; ++i) {
      const int t = top - i;
      bv[i] = s & 1;
      s_te = t == te - 1 ? s : s_te;
      const int sn = back<FORM>(s, a[i], b[i], half);
      s = t >= lo && t < hi ? sn : s;
    }
    // group g of the round: steps top - 4 g - 3 .. top - 4 g, ascending
#pragma unroll
    for (int g = 0; g < TA / 4; ++g) {
      const int t0 = top - 4 * g - 3;
      if (t0 >= lo && t0 + 3 < te) {
        *reinterpret_cast<int4*>(brow + t0) =
            make_int4(bv[4 * g + 3], bv[4 * g + 2], bv[4 * g + 1], bv[4 * g]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (t0 + k >= lo && t0 + k < te) brow[t0 + k] = bv[4 * g + 3 - k];
      }
    }
    top -= TA;
  };
  // two buffers in turn: the next round's words load while one is walked
  load(top, ca, cb);
  while (top >= lo) {
    load(top - TA, na, nb);
    round(ca, cb);
    if (top < lo) break;
    load(top - TA, ca, cb);
    round(na, nb);
  }
  return s;
}

// The block form's trace (FORM 2, S / 32 words a step): one warp, every
// lane on the same state; lane l loads word l of the next TB steps ahead
// and the walk takes the word of its state by a shuffle.  As thread_trace;
// lane 0 writes the bits.
__device__ __forceinline__ int warp_trace(const unsigned* __restrict__ drow,
                                          int lo, int hi, int te, int S,
                                          int lane, int s,
                                          int* __restrict__ brow, int& s_te) {
  const int W = S >> 5;
  const int n = hi - lo;
  s_te = s;
  const auto load = [&](int k) -> unsigned {
    return lane < W ? drow[(long long)(hi - 1 - k) * W + lane] : 0u;
  };
  const auto step = [&](int k, unsigned word) {
    const int t = hi - 1 - k;
    if (t == te - 1) s_te = s;
    if (t < te && lane == 0) brow[t] = s & 1;
    s = back<2>(s, __shfl_sync(FULL, word, s >> 5), 0u, S >> 1);
  };
  const int full = n - n % TB;
  unsigned wcur[TB], wnxt[TB];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < TB; ++i) wcur[i] = load(i);
  }
  for (int k0 = 0; k0 < full; k0 += TB) {
    if (k0 + TB < full) {
#pragma unroll
      for (int i = 0; i < TB; ++i) wnxt[i] = load(k0 + TB + i);
    }
#pragma unroll
    for (int i = 0; i < TB; ++i) step(k0 + i, wcur[i]);
#pragma unroll
    for (int i = 0; i < TB; ++i) wcur[i] = wnxt[i];
  }
  for (int k = full; k < n; ++k) step(k, load(k));
  return s;
}

// Pass 1, the single-warp form: a warp a chunk, CPB chunks a block.
template <int N, bool SOFT, bool PAIRS>
__global__ void __launch_bounds__(32 * CPB)
acs_chunks_warp(const typename Rx<SOFT>::T* __restrict__ rx,
                const unsigned* __restrict__ masks, unsigned* __restrict__ dec,
                float* __restrict__ vec, int B, Plan p) {
  using R = typename Rx<SOFT>::T;
  constexpr int WD = PAIRS ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * CPB + warp;
  if (q >= (long long)B * p.C) return;
  const long long row = q / p.C;
  const int c = (int)(q % p.C);
  R* rb = reinterpret_cast<R*>(smem + warp * staged_bytes(p));
  const int tc = seam(p, c), te = seam(p, c + 1);
  const bool exact = c == 0;
  const R* rrow = rx + row * p.T * p.n;
  unsigned* drow = dec + row * p.T * WD;
  float* v = vec + q * 2 * p.S;
  WarpWalk<N, SOFT, PAIRS> w(masks, p.S, lane);
  w.start(exact);
  w.walk(rrow, p.n, p.cs, exact ? 0 : tc - p.W, tc, nullptr, rb);
  if (c > 0) w.save(v);                 // the guess at the seam
  w.walk(rrow, p.n, p.cs, tc, te, drow, rb);
  w.save(v + p.S);                      // the end
}

// Pass 1, the block form: a block of S threads a chunk.
template <int N, bool SOFT>
__global__ void __launch_bounds__(MAX_S)
acs_chunks_block(const typename Rx<SOFT>::T* __restrict__ rx,
                 const unsigned* __restrict__ masks, unsigned* __restrict__ dec,
                 float* __restrict__ vec, int B, Plan p) {
  using R = typename Rx<SOFT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  float* pmn = reinterpret_cast<float*>(smem);           // [2][S]
  int* red = reinterpret_cast<int*>(pmn + 2 * p.S);      // [2][32]
  R* rb = reinterpret_cast<R*>(red + 64);                // [2][cs * n]
  const long long q = blockIdx.x;
  const long long row = q / p.C;
  const int c = (int)(q % p.C);
  const int tc = seam(p, c), te = seam(p, c + 1);
  const bool exact = c == 0;
  const R* rrow = rx + row * p.T * p.n;
  unsigned* drow = dec + row * p.T * (p.S >> 5);
  float* v = vec + q * 2 * p.S;
  BlockWalk<N, SOFT> b(masks, p.S, pmn, red, rb);
  b.start(exact);
  b.walk(rrow, p.n, p.cs, exact ? 0 : tc - p.W, tc, nullptr);
  if (c > 0) b.save(v);
  b.walk(rrow, p.n, p.cs, tc, te, drow);
  b.save(v + p.S);
}

// The first flagged seam at or after c (C where none is).
__device__ __forceinline__ int next_flag(const unsigned* flag, int c, int C) {
  const int words = (C + 31) >> 5;
  int k = c >> 5;
  unsigned w = flag[k] & (FULL << (c & 31));
  while (!w) {
    if (++k >= words) return C;
    w = flag[k];
  }
  return (k << 5) + __ffs(w) - 1;
}

// Pass 2: a block a row.  FORM 0: single warp, S <= 32; 1: single warp,
// S = 64 (PAIRS); 2: the block form (S threads).  Every seam's guess
// against pass 1's end vector before it, all at once; then in order, a
// chunk whose guess differs from the true end vector before it is walked
// again from that vector (its decisions and end vector rewritten).  Writes
// the final metrics and zeroes the row's ticket for pass 3.
template <int N, bool SOFT, int FORM>
__global__ void __launch_bounds__(FORM == 2 ? MAX_S : FIX_THREADS)
fix_rows(const typename Rx<SOFT>::T* __restrict__ rx,
         const unsigned* __restrict__ masks, unsigned* __restrict__ dec,
         float* __restrict__ vec, int* __restrict__ tick,
         float* __restrict__ pm_out, unsigned long long* __restrict__ fix,
         Plan p) {
  using R = typename Rx<SOFT>::T;
  constexpr bool PAIRS = FORM == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  const int C = p.C, S = p.S;
  const int WD = FORM == 2 ? S >> 5 : (PAIRS ? 2 : 1);
  const int nflag = (C + 31) >> 5;
  unsigned* flag = reinterpret_cast<unsigned*>(smem);         // [nflag]
  unsigned char* area = smem + ((nflag * 4 + 15) & ~15);      // the walk's
  float* pmn = reinterpret_cast<float*>(area);                // block form
  int* red = reinterpret_cast<int*>(pmn + 2 * S);
  R* rb = FORM == 2 ? reinterpret_cast<R*>(red + 64)
                    : reinterpret_cast<R*>(area);
  float* rv = vec + row * C * 2 * S;                 // the row's vectors
  const R* rrow = rx + row * p.T * p.n;
  unsigned* drow = dec + row * p.T * WD;

  if (tid == 0) tick[row] = 0;
  for (int j = tid; j < nflag; j += NT) flag[j] = 0u;
  __syncthreads();
  for (int i = tid; i < (C - 1) * S; i += NT) {
    const int c = 1 + i / S;
    const int e = i & (S - 1);
    if (__float_as_int(rv[(2 * c) * S + e])
        != __float_as_int(rv[(2 * c - 1) * S + e]))
      atomicOr(&flag[c >> 5], 1u << (c & 31));
  }
  __syncthreads();

  // a flagged chunk, or one whose guess differs from the new end vector
  // of a re-walked chunk before it, is walked again
  if (FORM == 2 || warp == 0) {
    int fixes = 0;
    bool chain = false;
    for (int c = 1; c < C; ++c) {
      const float* guess = rv + (2 * c) * S;
      const float* prev = rv + (2 * c - 1) * S;
      if (chain) {
        bool differ = false;
        if (FORM == 2) {
          differ = __syncthreads_or(__float_as_int(guess[tid])
                                    != __float_as_int(prev[tid]));
        } else {
          for (int e = lane; e < S; e += 32)
            differ |= __float_as_int(guess[e]) != __float_as_int(prev[e]);
          differ = __any_sync(FULL, differ);
        }
        if (!differ) {
          chain = false;
          continue;
        }
      } else {
        c = next_flag(flag, c, C);
        if (c >= C) break;
        prev = rv + (2 * c - 1) * S;
      }
      const int tc = seam(p, c), te = seam(p, c + 1);
      if constexpr (FORM == 2) {
        BlockWalk<N, SOFT> b(masks, S, pmn, red, rb);
        b.load(prev);
        b.walk(rrow, p.n, p.cs, tc, te, drow);
        b.save(rv + (2 * c + 1) * S);
        __syncthreads();
      } else {
        WarpWalk<N, SOFT, PAIRS> w(masks, S, lane);
        w.load(prev);
        w.walk(rrow, p.n, p.cs, tc, te, drow, rb);
        w.save(rv + (2 * c + 1) * S);
        __syncwarp();
      }
      ++fixes;
      chain = true;
    }
    if (tid == 0 && fixes) atomicAdd(fix, (unsigned long long)fixes);
  }
  __syncthreads();
  for (int e = tid; e < S; e += NT)
    pm_out[row * S + e] = rv[(2 * C - 1) * S + e];
}

// Pass 3: the row cut again into pieces of Lt steps (the last ragged), a
// thread a piece (FORM 0, 1) or a warp a piece (FORM 2), 128 threads a
// block.  Each piece is traced back from state 0 at D steps past its end
// (the last piece from state 0 at T, exactly), writing its bits, and keeps
// (its state at its end, its state at its start) in ends (B, Ct, 2).  The
// last piece of a row to finish (a ticket) checks the seams from the last
// one back: a piece whose state at its end differs from the true start
// state of the piece after it is traced again from that state, and counted
// into fix[1].  A traced path that reaches the true path's state at a seam
// is the true path from there on, so every bit is exact.  The check reads
// the seams' states RB at a time, all in flight at once.
constexpr int RB = 32;
template <int FORM>
__global__ void __launch_bounds__(128)
trace_chunks(const unsigned* __restrict__ dec, int* __restrict__ ends,
             int* __restrict__ tick, int* __restrict__ bits,
             unsigned long long* __restrict__ fix, int B, Plan p) {
  const int lane = threadIdx.x & 31;
  const int Ct = (p.T + p.Lt - 1) / p.Lt;
  const long long q = FORM == 2
      ? (long long)blockIdx.x * 4 + (threadIdx.x >> 5)
      : (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)B * Ct) return;
  const long long row = q / Ct;
  const int k = (int)(q % Ct);
  const int WD = FORM == 2 ? p.S >> 5 : (FORM == 1 ? 2 : 1);
  const unsigned* drow = dec + row * p.T * WD;
  int* brow = bits + row * p.T;
  const auto trace = [&](int k0, int hi, int s, int& s_te) {
    const int lo = k0 * p.Lt, te = min(p.T, lo + p.Lt);
    if constexpr (FORM == 2)
      return warp_trace(drow, lo, hi, te, p.S, lane, s, brow, s_te);
    else
      return thread_trace<FORM>(drow, lo, hi, te, p.T, p.S, s, brow, s_te);
  };
  int s_te;
  const int s_start = trace(k, k == Ct - 1 ? p.T : min(p.T, (k + 1) * p.Lt
                                                            + p.D), 0, s_te);
  int last = 0;
  if (FORM != 2 || lane == 0) {
    ends[2 * q] = s_te;
    ends[2 * q + 1] = s_start;
    __threadfence();
    last = atomicAdd(&tick[row], 1) == Ct - 1;
  }
  if (FORM == 2) last = __shfl_sync(FULL, last, 0);
  if (!last) return;
  __threadfence();
  const int* re = ends + row * Ct * 2;
  int s_next = __ldcg(re + 2 * (Ct - 1) + 1);   // the last piece's: exact
  int redo = 0;
  for (int top = Ct - 2; top >= 0; top -= RB) {
    int2 at[RB];                      // (state at the end, at the start)
#pragma unroll
    for (int i = 0; i < RB; ++i)
      at[i] = __ldcg(reinterpret_cast<const int2*>(re) + max(top - i, 0));
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int k0 = top - i;
      if (k0 < 0) break;
      if (at[i].x != s_next) {
        int unused;
        s_next = trace(k0, min(p.T, (k0 + 1) * p.Lt), s_next, unused);
        ++redo;
      } else {
        s_next = at[i].y;
      }
    }
  }
  if (FORM != 2 || lane == 0) {
    tick[row] = 0;
    if (redo) atomicAdd(fix + 1, (unsigned long long)redo);
  }
}

template <int N, bool SOFT, int FORM>
cudaError_t launch(const void* rx, const unsigned* masks, int* bits,
                   float* pm, unsigned* dec, float* vec, int* ends, int* tick,
                   unsigned long long* fix, int B, Plan p,
                   cudaStream_t stream) {
  using R = typename Rx<SOFT>::T;
  static_assert(sizeof(R) == sizeof(float), "staged values are 4 bytes");
  const R* r = static_cast<const R*>(rx);
  const int S = p.S;
  const size_t walk_block = sizeof(float) * 2 * S + sizeof(int) * 64
      + staged_bytes(p);
  const size_t walk = FORM == 2 ? walk_block : staged_bytes(p);
  const long long chunks = (long long)B * p.C;
  cudaError_t err = cudaSuccess;
  {  // pass 1
    if (FORM == 2) {
      acs_chunks_block<N, SOFT><<<(unsigned)chunks, S, walk_block, stream>>>(
          r, masks, dec, vec, B, p);
    } else {
      acs_chunks_warp<N, SOFT, FORM == 1><<<(unsigned)((chunks + CPB - 1)
                                                       / CPB),
                                            32 * CPB, CPB * walk, stream>>>(
          r, masks, dec, vec, B, p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  {  // pass 2
    const size_t smem = ((sizeof(unsigned) * ((p.C + 31) / 32) + 15) & ~15)
        + walk;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(fix_rows<N, SOFT, FORM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    fix_rows<N, SOFT, FORM><<<B, FORM == 2 ? S : FIX_THREADS, smem, stream>>>(
        r, masks, dec, vec, tick, pm, fix, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.T > 0) {  // pass 3
    const long long pieces = (long long)B * ((p.T + p.Lt - 1) / p.Lt);
    const long long threads = FORM == 2 ? 32 * pieces : pieces;
    trace_chunks<FORM><<<(unsigned)((threads + 127) / 128), 128, 0, stream>>>(
        dec, ends, tick, bits, fix, B, p);
    err = cudaGetLastError();
  }
  return err;
}

template <int N, bool SOFT>
cudaError_t launch_form(const void* rx, const unsigned* masks, int* bits,
                        float* pm, unsigned* dec, float* vec, int* ends,
                        int* tick, unsigned long long* fix, int B, Plan p,
                        cudaStream_t stream) {
  if (p.S == 64)
    return launch<N, SOFT, 1>(rx, masks, bits, pm, dec, vec, ends, tick, fix,
                              B, p, stream);
  if (p.S <= 32)
    return launch<N, SOFT, 0>(rx, masks, bits, pm, dec, vec, ends, tick, fix,
                              B, p, stream);
  return launch<N, SOFT, 2>(rx, masks, bits, pm, dec, vec, ends, tick, fix,
                            B, p, stream);
}

}  // namespace

extern "C" int viterbi_acs(const void* rx, int soft, const unsigned* masks,
                           int* bits, float* pm, unsigned* dec, float* vec,
                           int* ends, int* tick, unsigned long long* fix,
                           int B, int T, int n, int S, int L, int W, int C,
                           int Lt, int D, int device, cudaStream_t stream) {
  if (B < 1 || T < 0 || n < 1 || n > 32 || S < 1 || S > MAX_S
      || (S & (S - 1)) != 0 || L < 1 || W < 0 || Lt < 1 || D < 0
      || C != (T <= L + W ? 1 : 1 + (T - W - 1) / L)
      || reinterpret_cast<unsigned long long>(bits) % 16
      || reinterpret_cast<unsigned long long>(dec) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int nthreads = S < 32 ? 32 : S;
  Plan p;
  p.T = T;
  p.n = n;
  p.S = S;
  p.L = L;
  p.W = W;
  p.F = L + W;
  p.C = C;
  p.Lt = Lt;
  p.D = D;
  p.cs = max(1, min(MAX_CHUNK, (S <= 64 ? 32 : nthreads) * PER / n));
  const auto go = [&](auto launcher) {
    return (int)launcher(rx, masks, bits, pm, dec, vec, ends, tick, fix, B,
                         p, stream);
  };
  if (soft) {
    if (n == 2) return go(launch_form<2, true>);
    if (n == 3) return go(launch_form<3, true>);
    return go(launch_form<0, true>);
  }
  if (n == 2) return go(launch_form<2, false>);
  if (n == 3) return go(launch_form<3, false>);
  return go(launch_form<0, false>);
}
