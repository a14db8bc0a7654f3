// S8: the CVSD codec's walk (continuously variable slope delta, one bit a
// sample) for Hopper (sm_90a), both directions in one source: cvsd_encode
// (x -> bits) and cvsd_decode (words -> the reference trajectory).
//
// It replaces no TPU kernel: in the JAX package each direction is a
// lax.scan, solid_dsp_tpu/models/cvsd.py:86 (encode) and :119 (decode).
// PyTorch has no scan, and a per-sample recurrence in eager torch ops costs
// about a dozen launches a sample (the plain walk,
// models/cvsd.py::cvsd_walk_plain).
//
// The walk, per sample k with word w_k (decode) or bit w_k = x_k >= ref
// (encode):
//   agree_k = the last n_history words are equal (zeros before the start)
//   step_k  = clip(beta step_{k-1} + (agree_k ? gamma : 0), dmin, dmax)
//   ref_k   = clip(leak ref_{k-1} + (w_k == 1 ? step_k : -step_k), -1, 1)
// in float32, each product and sum rounded once (the _rn intrinsics, so
// that nvcc contracts none into an FMA), the clips as fmaxf then fminf.
//
// ENCODE.  Bound: latency.  Each sample's bit is compared with the ref the
// previous sample left, so a lane is one dependent chain whatever the
// card's width; one thread walks one lane, 32 lanes a block.  The chain is
// cut short by computing both outcomes of the bit before the compare
// resolves: the two history words ((h << 1) | 1 and
// h << 1, under the mask) and their agreement depend on the old history
// only, the two candidate steps on the old step, the two candidate refs on
// the old ref and those steps; the compare then only selects ref, step and
// history.  Each candidate makes the walk's own operations, so encode is
// bit-equal to the plain walk.  Where 0 < beta <= 1, 0 < leak <= 1 and
// 0 <= dmin <= dmax in float32 (the codec's parameters; the wrapper,
// ops/cuda_cvsd.py, checks), clamps that cannot bind are dropped (the
// state keeps dmin <= step <= dmax and -1 <= ref <= 1):
//   * the unboosted step fl(beta step) is <= step <= dmax (beta <= 1,
//     rounding is monotone and step is a float), so only its dmin clamp
//     can bind; the boosted step keeps both (gamma < dmin (1 - beta) makes
//     the lower one bind);
//   * fl(leak ref) lies in [-1, 1] (|leak ref| <= 1); adding s1 >= dmin >= 0
//     cannot go below -1, so ref's candidate for bit 1 keeps only its upper
//     clamp, and the candidate for bit 0 (minus s0 >= 0) only its lower.
// Other parameters take the instantiation that keeps every clamp (ALL).
// The walking warp's instruction stream holds the walk and little else: a
// second warp moves the data (the first design's staging, its 64-bit
// address arithmetic a row, ran in the walker's stream at ~45 cycles a
// step on an H100).  The walker reads a chunk's 32 staged inputs as 8
// LDS.128 (rows of 36 words: 16-byte aligned, and a quarter-warp's 128-bit
// reads fall on 32 distinct banks) and packs its 32 bits in one register
// word; the mover stages the next chunk (its loads issued a chunk earlier,
// so their latency hides behind 32 dependent steps) and expands each row's
// word at the coalesced store (bit t to thread t), double-buffered, one
// barrier a chunk.
//
// DECODE.  Bound: bytes (4 in and 4 out a sample).  The words are the
// input, so every sample's agreement and sign are known before the walk,
// and each update is a clamped affine map x -> clip(fl(fl(a x) + b), lo,
// hi) with known coefficients: the step's (a = beta, b = agree ? gamma :
// 0, [dmin, dmax]) and, once the steps are known, the ref's (a = leak, b =
// +-step, [-1, 1]).  For a > 0 such maps compose into the same form,
// clip(A x + B, L, H): f1 then f2 is clip(a2 a1 x + a2 b1 + b2, L, H), L =
// clip(a2 lo1 + b2, lo2, hi2), H = clip(a2 hi1 + b2, lo2, hi2).  So decode
// is a time-parallel chunk-and-join (iir_scan.cu's shape, S3), chunks of Lc
// = 32 DQ = 64 samples, CB chunks a block, five launches whatever N:
//   1. flags_step_maps: each warp reads a run of the lane's words once,
//      coalesced, and forms each sample's two flags: w == 1 by a ballot,
//      and agreement from one ballot of w_k == w_{k-1} a 32 samples,
//      ANDed over its last n_history - 1 bits by doubling shifts of a
//      64-bit window (the group before is read once a warp; zeros before
//      the start).  The flags go packed to scratch (2 bits a sample, one
//      uint2 a 32 samples, 1/16 of the words' bytes), and each thread
//      folds its chunk's step maps left to right: the offset B in
//      float64, the bounds L and H by the walk's float32 operations (L
//      and H are the walk from dmin and dmax; where they meet, the chunk
//      forgets its start and the join is exact);
//   2. join (step): one block a lane, T threads each composing a run of R
//      chunk maps left to right in float64, a Kogge-Stone scan of the
//      runs in shared memory, each run walked again from its true start
//      (dmin, or the scan of the runs before it applied to dmin), each
//      chunk's starting step rounded once to float32;
//   3. ref_maps: each chunk's steps walked from its start (flags read
//      packed, coalesced) and its ref maps folded as in 1;
//   4. join (ref), the same from 0;
//   5. walk: each chunk from its (step, ref) start, y staged through
//      shared memory 32 samples a chunk at a time and written coalesced.
// A map's slope A = a^len is the same for every full chunk: the wrapper
// passes a^Lc and the last chunk's a^len, each a float64 product taken a
// factor at a time.  The joins never compose with an identity (a run
// starts from its first map, the scan leaves the first 2^d runs alone), so
// no infinity meets a slope that underflowed to 0.  Serial depth: 3 Lc +
// 2 (R + log2 T) steps, not N.  Inside a chunk every operation is the
// plain version's (models/cvsd.py::cvsd_decode_chunked_torch, the same
// joins' tree), so the kernel is bit-equal to it; against the sequential
// walk only the chunk starts differ (the join's float64 against the walk's
// float32 roundings), within models/cvsd.py::CHUNKED_ATOL.
//
// Entry points (each returns the first failed launch's cudaError_t or 0):
//   cvsd_encode_f32: x (B, N) float32 -> bits (B, N) int32 (all_clamps:
//     keep every clamp, for parameters outside the range above)
//   cvsd_decode_f32: words (B, N) int32 -> y (B, N) float32; scratch:
//     flags (B, C DQ) uint2, step and ref maps (B, C) {double b; float lo,
//     hi}, step and ref starts (B, C) float32

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// ---------------------------------------------------------------------------
// Encode
// ---------------------------------------------------------------------------

constexpr int LANES = 32;   // lanes a block: a walking thread each
constexpr int CH = 32;      // samples a chunk: one register word of bits
constexpr int ROW = CH + 4; // a staged row, 16-byte aligned

struct EncParams {
  float beta, gamma, dmin, dmax, leak;
  unsigned mask;            // (1 << n_history) - 1
};

// One step of the walk on lane state (ref, step, hist) for sample xv;
// returns the bit.  Both outcomes first, then the compare selects.  ALL
// keeps every clamp of the walk (any parameters).
template <bool ALL>
__device__ __forceinline__ unsigned enc_step(float xv, float& ref,
                                             float& step, unsigned& hist,
                                             const EncParams& p) {
  const unsigned h1 = ((hist << 1) | 1u) & p.mask;
  const unsigned h0 = (hist << 1) & p.mask;
  const bool a1 = h1 == p.mask, a0 = h0 == 0u;       // all ones, all zeros
  const float bs = __fmul_rn(p.beta, step);
  const float boosted = clampf(__fadd_rn(bs, p.gamma), p.dmin, p.dmax);
  const float plain = ALL ? clampf(__fadd_rn(bs, 0.0f), p.dmin, p.dmax)
                          : fmaxf(bs, p.dmin);       // bs <= dmax already
  const float s1 = a1 ? boosted : plain, s0 = a0 ? boosted : plain;
  const float lr = __fmul_rn(p.leak, ref);
  const float r1 = ALL ? clampf(__fadd_rn(lr, s1), -1.0f, 1.0f)
                       : fminf(__fadd_rn(lr, s1), 1.0f);   // >= -1 already
  const float r0 = ALL ? clampf(__fadd_rn(lr, -s0), -1.0f, 1.0f)
                       : fmaxf(__fadd_rn(lr, -s0), -1.0f); // <= 1 already
  const bool bit = xv >= ref;
  ref = bit ? r1 : r0;
  step = bit ? s1 : s0;
  hist = bit ? h1 : h0;
  return bit ? 1u : 0u;
}

// Block: 32 lanes, two warps.  Warp 0 walks its lanes a chunk at a time
// from shared memory; warp 1 moves the data: it stages chunk k + 1 (loaded
// into registers a chunk earlier) while chunk k is walked, issues the loads
// of chunk k + 2, and writes chunk k - 1's bits.  One barrier a chunk.
template <bool ALL>
__global__ void __launch_bounds__(2 * LANES)
cvsd_encode_kernel(const float* __restrict__ x, int* __restrict__ bits,
                   int B, long long N, EncParams p) {
  __shared__ __align__(16) float s_in[2][LANES][ROW];
  __shared__ unsigned s_bits[2][LANES];
  const int t = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;
  const int lane0 = blockIdx.x * LANES;
  const int nl = min(LANES, B - lane0);
  const long long nch = (N + CH - 1) / CH;
  float nxt[LANES];
  // the mover's parts: chunk k's sample k CH + t of every row into
  // registers; those registers into a buffer; chunk k's bits out, row r's
  // word read by every thread and bit t written by thread t
  auto load = [&](long long k) {
    const long long j = k * CH + t;
    const float* q = x + (long long)lane0 * N + j;
#pragma unroll
    for (int r = 0; r < LANES; ++r) {
      nxt[r] = (r < nl && j < N) ? *q : 0.0f;
      q += N;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < LANES; ++r) s_in[buf][r][t] = nxt[r];
  };
  auto expand = [&](long long k) {
    const long long j = k * CH + t;
    if (j >= N) return;
    int* q = bits + (long long)lane0 * N + j;
    const unsigned* w = s_bits[k & 1];
#pragma unroll 8
    for (int r = 0; r < nl; ++r) {
      *q = (int)((w[r] >> t) & 1u);
      q += N;
    }
  };
  float ref = 0.0f, step = p.dmin;
  unsigned hist = 0u;
  if (!walker) {
    load(0);
    stage(0);
    if (nch > 1) load(1);
  }
  __syncthreads();
  for (long long k = 0; k < nch; ++k) {
    const int buf = (int)(k & 1);
    if (walker) {
      unsigned word = 0u;
      if (t < nl) {
        const float* row = s_in[buf][t];
        if ((k + 1) * CH <= N) {
          // the chunk's inputs into registers first: a shared read issued
          // between two steps would sit on the chain
          float v[CH];
#pragma unroll
          for (int q = 0; q < CH / 4; ++q) {
            const float4 f = *reinterpret_cast<const float4*>(row + 4 * q);
            v[4 * q] = f.x;
            v[4 * q + 1] = f.y;
            v[4 * q + 2] = f.z;
            v[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int j = 0; j < CH; ++j)
            word |= enc_step<ALL>(v[j], ref, step, hist, p) << j;
        } else {
          const int len = (int)(N - k * CH);
          for (int j = 0; j < len; ++j)
            word |= enc_step<ALL>(row[j], ref, step, hist, p) << j;
        }
      }
      s_bits[buf][t] = word;
    } else {
      if (k + 1 < nch) {
        stage(buf ^ 1);
        if (k + 2 < nch) load(k + 2);
      }
      if (k > 0) expand(k - 1);
    }
    __syncthreads();
  }
  if (!walker) expand(nch - 1);
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

constexpr int DQ = 2;        // 32-sample groups a chunk: Lc = 64 samples
constexpr int LC = 32 * DQ;
constexpr int CB = 128;      // chunks a block of passes 1, 3 and 5
constexpr int WARPS = CB / 32;
constexpr int BATCH = 8;     // 32-word groups a warp of pass 1 loads at once
constexpr int JOIN_MAX = 256;

struct DecParams {
  float beta, gamma, dmin, dmax, leak;
  double sa_full, sa_tail;   // the step maps' slopes: beta^Lc, beta^len
  double ra_full, ra_tail;   // the ref maps': leak^Lc, leak^len
  int m;                     // n_history - 1: equal neighbours to agree
};

// A chunk's map as stored: its offset, its float32 bounds (16 bytes).
struct __align__(16) ChunkMap {
  double b;
  float lo, hi;
};

struct Map {
  double a, b, lo, hi;
};

// f then g
__device__ __forceinline__ Map map_after(const Map& f, const Map& g) {
  Map r;
  r.a = __dmul_rn(g.a, f.a);
  r.b = __dadd_rn(__dmul_rn(g.a, f.b), g.b);
  r.lo = fmin(fmax(__dadd_rn(__dmul_rn(g.a, f.lo), g.b), g.lo), g.hi);
  r.hi = fmin(fmax(__dadd_rn(__dmul_rn(g.a, f.hi), g.b), g.lo), g.hi);
  return r;
}

__device__ __forceinline__ double map_apply(const Map& f, double x) {
  return fmin(fmax(__dadd_rn(__dmul_rn(f.a, x), f.b), f.lo), f.hi);
}

// Agreement of the 32 samples of a group from the equality bits of the
// group (eq, bit i: w_i == w_{i-1}) and of the group before (prev): the AND
// of each sample's last m bits, m <= 31.
__device__ __forceinline__ unsigned agree_bits(unsigned eq, unsigned prev,
                                               int m) {
  if (m == 0) return FULL;
  unsigned long long r = ((unsigned long long)eq << 32) | prev;
  int len = 1;
  while (2 * len <= m) {
    r &= r << len;
    len *= 2;
  }
  if (len < m) r &= r << (m - len);
  return (unsigned)(r >> 32);
}

// Sample j's flags from a chunk's packed words.
__device__ __forceinline__ bool flag_one(const uint2 (&f)[DQ], int j) {
  return (f[j >> 5].x >> (j & 31)) & 1u;
}
__device__ __forceinline__ bool flag_agree(const uint2 (&f)[DQ], int j) {
  return (f[j >> 5].y >> (j & 31)) & 1u;
}

// The fold of one sample's map into a chunk's (b, lo, hi).
__device__ __forceinline__ void fold(double& b, float& lo, float& hi, float a,
                                     double a64, float bk, float mn,
                                     float mx) {
  b = __dadd_rn(__dmul_rn(b, a64), (double)bk);
  lo = clampf(__fadd_rn(__fmul_rn(lo, a), bk), mn, mx);
  hi = clampf(__fadd_rn(__fmul_rn(hi, a), bk), mn, mx);
}

// Pass 1.  Block (lane l, chunks cb0 .. cb0 + CB - 1): the flags of its
// span, then each thread its chunk's step map.
__global__ void __launch_bounds__(CB)
cvsd_flags_step_maps(const int* __restrict__ words, uint2* __restrict__ flags,
                     ChunkMap* __restrict__ smap, long long N, int C,
                     int nblk, DecParams p) {
  constexpr int GW = CB * DQ / WARPS;  // 32-sample groups a warp
  __shared__ __align__(16) uint2 s_flags[CB * DQ];
  const int t = threadIdx.x, ln = t & 31, warp = t >> 5;
  const long long l = blockIdx.x / nblk;
  const int cb0 = (blockIdx.x % nblk) * CB;
  const int* w_in = words + l * N;
  const long long p0 = (long long)cb0 * LC + (long long)warp * GW * 32;
  // the group before the warp's first (zeros before the lane's start): its
  // equality bits 2 .. 31 are the ones a window of 31 reaches
  long long i = p0 - 32 + ln;
  int w = (i >= 0 && i < N) ? w_in[i] : 0;
  unsigned prev = __ballot_sync(FULL, w == __shfl_up_sync(FULL, w, 1));
  int last = __shfl_sync(FULL, w, 31);
  for (int g0 = 0; g0 < GW; g0 += BATCH) {
    int wv[BATCH];                 // a batch's loads in flight together
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {   // past N the words read as zeros
      i = p0 + 32 * (g0 + u) + ln;
      wv[u] = (i < N) ? w_in[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      w = wv[u];
      int up = __shfl_up_sync(FULL, w, 1);
      if (ln == 0) up = last;
      const unsigned eq = __ballot_sync(FULL, w == up);
      const unsigned one = __ballot_sync(FULL, w == 1);
      if (ln == 0)
        s_flags[warp * GW + g0 + u] =
            make_uint2(one, agree_bits(eq, prev, p.m));
      prev = eq;
      last = __shfl_sync(FULL, w, 31);
    }
  }
  __syncthreads();
  // the block's flags out, coalesced
  const long long g0 = (long long)cb0 * DQ;
  uint2* f_out = flags + l * (long long)C * DQ;
  for (int k = t; k < CB * DQ; k += CB)
    if (g0 + k < (long long)C * DQ) f_out[g0 + k] = s_flags[k];
  const int c = cb0 + t;
  if (c >= C) return;
  uint2 f[DQ];
#pragma unroll
  for (int q = 0; q < DQ; ++q) f[q] = s_flags[t * DQ + q];
  const float ga = p.gamma;
  const double a64 = (double)p.beta;
  double b = flag_agree(f, 0) ? (double)ga : 0.0;
  float lo = p.dmin, hi = p.dmax;
  const long long len = min((long long)LC, N - (long long)c * LC);
  if (len == LC) {
#pragma unroll
    for (int j = 1; j < LC; ++j)
      fold(b, lo, hi, p.beta, a64, flag_agree(f, j) ? ga : 0.0f, p.dmin,
           p.dmax);
  } else {
    for (int j = 1; j < len; ++j)
      fold(b, lo, hi, p.beta, a64, flag_agree(f, j) ? ga : 0.0f, p.dmin,
           p.dmax);
  }
  smap[l * C + c] = ChunkMap{b, lo, hi};
}

__device__ __forceinline__ Map load_map(const ChunkMap* m, int i, int C,
                                        double a_full, double a_tail) {
  const ChunkMap c = m[i];
  return Map{i == C - 1 ? a_tail : a_full, c.b, (double)c.lo, (double)c.hi};
}

// Passes 2 and 4.  Block l: lane l's chunk starts from its chunk maps.
__global__ void __launch_bounds__(JOIN_MAX)
cvsd_join(const ChunkMap* __restrict__ maps, float* __restrict__ starts,
          int C, int R, double a_full, double a_tail, double x0) {
  __shared__ Map s[JOIN_MAX];
  const int t = threadIdx.x, T = blockDim.x;
  const long long l = blockIdx.x;
  const ChunkMap* m = maps + l * C;
  const int i0 = t * R, i1 = min(i0 + R, C);
  Map run{0.0, 0.0, 0.0, 0.0};
  if (i0 < i1) {
    run = load_map(m, i0, C, a_full, a_tail);
    for (int i = i0 + 1; i < i1; ++i)
      run = map_after(run, load_map(m, i, C, a_full, a_tail));
  }
  s[t] = run;
  __syncthreads();
  for (int o = 1; o < T; o *= 2) {
    Map e{};
    if (t >= o) e = s[t - o];
    __syncthreads();
    if (t >= o) {
      run = map_after(e, run);
      s[t] = run;
    }
    __syncthreads();
  }
  if (i0 >= i1) return;
  double v = t > 0 ? map_apply(s[t - 1], x0) : x0;
  float* out = starts + l * C;
  for (int i = i0; i < i1; ++i) {
    out[i] = (float)v;
    if (i + 1 < i1) v = map_apply(load_map(m, i, C, a_full, a_tail), v);
  }
}

// A chunk's packed flags from scratch, coalesced across the block (DQ
// odd: a side build at Lc = 32 reads them a uint2 at a time).
__device__ __forceinline__ void load_flags(const uint2* fl, uint2 (&f)[DQ]) {
  if constexpr (DQ % 2 == 0) {
#pragma unroll
    for (int q = 0; q < DQ; q += 2) {
      const uint4 v = *reinterpret_cast<const uint4*>(fl + q);
      f[q] = make_uint2(v.x, v.y);
      f[q + 1] = make_uint2(v.z, v.w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < DQ; ++q) f[q] = fl[q];
  }
}

__device__ __forceinline__ float step_next(float step, bool agree,
                                           const DecParams& p) {
  return clampf(__fadd_rn(__fmul_rn(p.beta, step), agree ? p.gamma : 0.0f),
                p.dmin, p.dmax);
}

// Pass 3.  Thread: one chunk's steps from its start, its ref maps folded.
__global__ void __launch_bounds__(CB)
cvsd_ref_maps(const uint2* __restrict__ flags, const float* __restrict__ sstart,
              ChunkMap* __restrict__ rmap, long long N, int C, int nblk,
              DecParams p) {
  const long long l = blockIdx.x / nblk;
  const int c = (blockIdx.x % nblk) * CB + threadIdx.x;
  if (c >= C) return;
  uint2 f[DQ];
  load_flags(flags + (l * C + c) * DQ, f);
  float step = step_next(sstart[l * C + c], flag_agree(f, 0), p);
  const double a64 = (double)p.leak;
  double b = (double)(flag_one(f, 0) ? step : -step);
  float lo = -1.0f, hi = 1.0f;
  const long long len = min((long long)LC, N - (long long)c * LC);
  if (len == LC) {
#pragma unroll
    for (int j = 1; j < LC; ++j) {
      step = step_next(step, flag_agree(f, j), p);
      fold(b, lo, hi, p.leak, a64, flag_one(f, j) ? step : -step, -1.0f,
           1.0f);
    }
  } else {
    for (int j = 1; j < len; ++j) {
      step = step_next(step, flag_agree(f, j), p);
      fold(b, lo, hi, p.leak, a64, flag_one(f, j) ? step : -step, -1.0f,
           1.0f);
    }
  }
  rmap[l * C + c] = ChunkMap{b, lo, hi};
}

// Pass 5.  Thread: one chunk walked from its (step, ref) start; the block's
// outputs leave 32 samples a chunk at a time through shared memory.
__global__ void __launch_bounds__(CB)
cvsd_walk(const uint2* __restrict__ flags, const float* __restrict__ sstart,
          const float* __restrict__ rstart, float* __restrict__ y,
          long long N, int C, int nblk, DecParams p) {
  __shared__ float s_out[CB][33];
  const int t = threadIdx.x, ln = t & 31, warp = t >> 5;
  const long long l = blockIdx.x / nblk;
  const int cb0 = (blockIdx.x % nblk) * CB;
  const int c = cb0 + t;
  const bool live = c < C;
  uint2 f[DQ];
  float step = 0.0f, ref = 0.0f;
  if (live) {
    load_flags(flags + (l * C + c) * DQ, f);
    step = sstart[l * C + c];
    ref = rstart[l * C + c];
  }
  float* y_out = y + l * N;
#pragma unroll
  for (int q = 0; q < DQ; ++q) {
    if (live) {
      // past N the walk runs on and its samples are not written
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        step = clampf(__fadd_rn(__fmul_rn(p.beta, step),
                                (f[q].y >> j) & 1u ? p.gamma : 0.0f),
                      p.dmin, p.dmax);
        ref = clampf(__fadd_rn(__fmul_rn(p.leak, ref),
                               (f[q].x >> j) & 1u ? step : -step),
                     -1.0f, 1.0f);
        s_out[t][j] = ref;
      }
    }
    __syncthreads();
    for (int r = warp; r < CB && cb0 + r < C; r += WARPS) {
      const long long i = (long long)(cb0 + r) * LC + 32 * q + ln;
      if (i < N) y_out[i] = s_out[r][ln];
    }
    __syncthreads();
  }
}

int decode(const int* words, float* y, uint2* flags, ChunkMap* smap,
           float* sstart, ChunkMap* rmap, float* rstart, int B, long long N,
           int T, int R, const DecParams& p, cudaStream_t stream) {
  const int C = (int)((N + LC - 1) / LC);
  const int nblk = (C + CB - 1) / CB;
  const unsigned grid = (unsigned)((long long)B * nblk);
  cvsd_flags_step_maps<<<grid, CB, 0, stream>>>(words, flags, smap, N, C,
                                                nblk, p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cvsd_join<<<B, T, 0, stream>>>(smap, sstart, C, R, p.sa_full, p.sa_tail,
                                 (double)p.dmin);
  if ((err = (int)cudaGetLastError())) return err;
  cvsd_ref_maps<<<grid, CB, 0, stream>>>(flags, sstart, rmap, N, C, nblk, p);
  if ((err = (int)cudaGetLastError())) return err;
  cvsd_join<<<B, T, 0, stream>>>(rmap, rstart, C, R, p.ra_full, p.ra_tail,
                                 0.0);
  if ((err = (int)cudaGetLastError())) return err;
  cvsd_walk<<<grid, CB, 0, stream>>>(flags, sstart, rstart, y, N, C, nblk, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cvsd_encode_f32(const void* x, void* bits, int B,
                               long long N, float beta, float gamma,
                               float dmin, float dmax, float leak,
                               unsigned mask, int all_clamps, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const EncParams p{beta, gamma, dmin, dmax, leak, mask};
  const unsigned grid = (unsigned)((B + LANES - 1) / LANES);
  auto st = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const float*>(x);
  auto out = static_cast<int*>(bits);
  if (all_clamps)
    cvsd_encode_kernel<true><<<grid, 2 * LANES, 0, st>>>(in, out, B, N, p);
  else
    cvsd_encode_kernel<false><<<grid, 2 * LANES, 0, st>>>(in, out, B, N, p);
  return (int)cudaGetLastError();
}

// The decoder's chunk length Lc as built (the wrapper sizes its scratch and
// the maps' slopes by it).
extern "C" int cvsd_decode_chunk() { return LC; }

extern "C" int cvsd_decode_f32(const void* words, void* y, void* flags,
                               void* smap, void* sstart, void* rmap,
                               void* rstart, int B, long long N, int T,
                               int R, float beta, float gamma, float dmin,
                               float dmax, float leak, double sa_full,
                               double sa_tail, double ra_full, double ra_tail,
                               int m, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const DecParams p{beta, gamma, dmin, dmax, leak, sa_full, sa_tail, ra_full,
                    ra_tail, m};
  return decode(static_cast<const int*>(words), static_cast<float*>(y),
                static_cast<uint2*>(flags), static_cast<ChunkMap*>(smap),
                static_cast<float*>(sstart), static_cast<ChunkMap*>(rmap),
                static_cast<float*>(rstart), B, N, T, R, p,
                static_cast<cudaStream_t>(stream));
}
