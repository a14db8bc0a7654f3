// The two nonlinear sequential scans of the port, for Hopper (sm_90a): S1
// (the exact per-sample AGC with its squelch FSM) and S2 (the
// decision-directed QPSK Costas loop).  S3, the IIR filters' linear
// w-recurrence, is time-parallel in iir_scan.cu.
//
// Neither replaces a TPU kernel: in the JAX package each is a lax.scan,
// solid_dsp_tpu/ops/agc.py::_agc_scan (:108-149) and
// solid_dsp_tpu/models/qpsk.py::qpsk_carrier_pll (:101-126).  PyTorch has no
// scan, and a per-sample recurrence in eager torch ops costs ~15-20 launches a
// sample, so each recurrence is one kernel here.
//
// Bound: latency, for S1's main entry and S2.  Each sample depends on the
// one before it through the gain (S1: a logf and an expf on the chain) or
// the phase (S2: sincos and atan2), and neither recurrence is linear, so one
// sequence runs at one dependent step per ~0.1 us (S1) or ~0.2 us (S2) on
// an H100 however many SMs it has; the bytes (each sample read once and
// written once) would take 3.35 TB/s far less time.  A multi-sequence design
// is later work.  S1's FSM entry is different: the FSM's map over a run of
// steps has a finite form, so it is exactly time-parallel and bound by its
// bytes (4 in and 4 out a step): the chunk-and-join design of the fsm
// namespace below.
//
// Design of S1 and S2: one thread per independent sequence (a leading index
// of the block), its state in registers, time walked in order.  Samples are
// loaded a chunk of 8 at a time into registers, the next chunk's loads
// started before the current chunk's steps, so a load's latency is hidden
// behind a chunk of steps.
// The arithmetic is the plain PyTorch version's (ops/agc.py::agc_scan_plain,
// models/qpsk.py::costas_pll_plain), in the same
// order: products and sums with the _rn intrinsics so that nvcc fuses none
// into an FMA the plain version does not have; no fast-math.  The lock and a
// DISABLED squelch are fixed for a block (DISABLED maps to DISABLED, timer
// untouched), so the kernel picks a loop without the FSM, or without the
// gain update, where they cannot run: exact, and the FSM's code left in the
// loop cost ~25 % of a step even untaken (PERF.md).  The FSM entry's modes
// are bit-equal to ops/agc.py::squelch_fsm_plain (and its chunked mirror
// squelch_fsm_chunked_torch): integers and one compare a step.
//
// Entry points (each returns the launch's cudaError_t):
//   agc_scan_f32 / agc_scan_f64:   x (B, T) complex -> y (B, T), state in place
//   squelch_fsm_f32 / _f64:        rssi (B, T) real -> modes (B, T) int32,
//                                  mode/timer in place (three launches)
//   costas_pll_f32 / _f64:         x (B, T) complex -> y (B, T), theta/dtheta
//                                  (B,) in place

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;
constexpr int THREADS = 128;

enum Squelch : int {
  UNKNOWN = 0, ENABLED = 1, RISE = 2, SIGNALHI = 3, FALL = 4, SIGNALLO = 5,
  TIMEOUT = 6, DISABLED = 7
};

template <typename R> struct C2;
template <> struct C2<float> { using T = float2; };
template <> struct C2<double> { using T = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float log_(float a) { return logf(a); }
__device__ __forceinline__ double log_(double a) { return log(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float log10_(float a) { return log10f(a); }
__device__ __forceinline__ double log10_(double a) { return log10(a); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ void sincos_(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sincos_(double a, double* s, double* c) { sincos(a, s, c); }

// One step of the 7-state squelch FSM (ref auto_gain_control/mod.rs:631-677):
// FALL arms the timer, SIGNALLO counts it down before the transition reads it.
template <typename R>
__device__ __forceinline__ void squelch_step(int& mode, int& timer, R rssi,
                                             R thr, int timeout) {
  const bool hi = rssi > thr;
  if (mode == FALL) timer = timeout;
  if (mode == SIGNALLO) timer = timer - 1;
  int m;
  switch (mode) {
    case ENABLED: m = hi ? RISE : ENABLED; break;
    case RISE: m = hi ? SIGNALHI : FALL; break;
    case SIGNALHI: m = hi ? SIGNALHI : FALL; break;
    case FALL: m = hi ? SIGNALHI : SIGNALLO; break;
    case SIGNALLO: m = timer == 0 ? TIMEOUT : (hi ? SIGNALHI : SIGNALLO); break;
    case TIMEOUT: m = ENABLED; break;
    default: m = DISABLED;
  }
  mode = m;
}

// Walk one sequence: step(x[t]) -> y[t] in time order.  Full chunks of
// CHUNK samples are loaded into registers a chunk ahead (the next chunk's
// loads started before this chunk's steps, so their latency hides behind
// CHUNK dependent steps); the ragged end takes one sample at a time.
template <typename In, typename Out, typename Step>
__device__ __forceinline__ void walk(const In* __restrict__ xs,
                                     Out* __restrict__ ys, long long T,
                                     Step step) {
  const long long full = T - T % CHUNK;
  In buf[CHUNK], nxt[CHUNK];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) buf[i] = xs[i];
  }
  for (long long t0 = 0; t0 < full; t0 += CHUNK) {
    if (t0 + CHUNK < full) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) nxt[i] = xs[t0 + CHUNK + i];
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) ys[t0 + i] = step(buf[i]);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) buf[i] = nxt[i];
  }
  for (long long t = full; t < T; ++t) ys[t] = step(xs[t]);
}

// S1 on one sequence: out = x g; E = c1 E + |out|^2 c2; unlocked: g' = E >
// 1e-6 ? g exp(c3 ln E) : g, g' = min(g', 1e6), the FSM on rssi = -20
// log10 g' (FSM only: the mode is not DISABLED), y = x if the new mode is
// ENABLED else out * scale; locked: y = out, g, mode and timer kept.
template <typename R, bool LOCKED, bool FSM>
__device__ __forceinline__ void agc_walk(const typename C2<R>::T* xs,
                                         typename C2<R>::T* ys, long long T,
                                         R& g, R& E, int& md, int& tm, R c1,
                                         R c2, R c3, R scale, R thr,
                                         int timeout) {
  using CT = typename C2<R>::T;
  const R gate = R(1e-6), clamp = R(1e6), m20 = R(-20.0);
  walk(xs, ys, T, [&](CT xv) {
    const R ore = mul(xv.x, g), oim = mul(xv.y, g);
    const R ee = fma_(ore, ore, mul(oim, oim));
    E = add(mul(c1, E), mul(ee, c2));
    CT yv;
    if (LOCKED) {
      yv.x = ore;
      yv.y = oim;
      return yv;
    }
    R gn = E > gate ? mul(g, exp_(mul(c3, log_(E)))) : g;
    gn = gn > clamp ? clamp : gn;
    g = gn;
    if (FSM) {
      squelch_step(md, tm, mul(log10_(gn), m20), thr, timeout);
      if (md == ENABLED) return xv;
    }
    yv.x = mul(ore, scale);
    yv.y = mul(oim, scale);
    return yv;
  });
}

// S1: one thread a sequence; the lock and the FSM's DISABLED state are
// fixed for the block (DISABLED maps to DISABLED), so each picks a loop
// without the code it does not run.
template <typename R>
__global__ void __launch_bounds__(THREADS)
agc_scan_kernel(const typename C2<R>::T* __restrict__ x,
                typename C2<R>::T* __restrict__ y, R* __restrict__ gain,
                R* __restrict__ energy, const unsigned char* __restrict__ lock,
                int* __restrict__ mode, int* __restrict__ timer, int B,
                long long T, R c1, R c2, R c3, R scale, R thr, int timeout) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const auto* xs = x + (long long)b * T;
  auto* ys = y + (long long)b * T;
  R g = gain[b], E = energy[b];
  int md = mode[b], tm = timer[b];
  if (lock[b] != 0)
    agc_walk<R, true, false>(xs, ys, T, g, E, md, tm, c1, c2, c3, scale, thr,
                             timeout);
  else if (md == DISABLED)
    agc_walk<R, false, false>(xs, ys, T, g, E, md, tm, c1, c2, c3, scale, thr,
                              timeout);
  else
    agc_walk<R, false, true>(xs, ys, T, g, E, md, tm, c1, c2, c3, scale, thr,
                             timeout);
  gain[b] = g;
  energy[b] = E;
  mode[b] = md;
  timer[b] = tm;
}

// ---------------------------------------------------------------------------
// S1's second entry: the FSM alone over a given rssi track (the parallel
// AGC's squelch pass, whose gains the Newton solve already has; the
// lax.scan of solid_dsp_tpu/ops/agc.py:333-343), exactly time-parallel.  The FSM's state is (mode, timer).  The timer is read only
// in SIGNALLO and written only in FALL (set to the timeout) and SIGNALLO
// (counted down), and SIGNALLO is entered only from FALL, so the map a run
// of steps makes from its entry state has a finite form, a Summary:
//   * from ENABLED, RISE, SIGNALHI, FALL or TIMEOUT: an exit mode, and an
//     exit timer that is the entry's ("keep": no FALL was passed) or a
//     constant (tracks 0-4);
//   * from SIGNALLO with timer t0, against the run's leading L steps at or
//     below the threshold: t0 in [1, L - 1] times out inside that run and
//     is ENABLED with timer 0 at its end, so it exits as the ENABLED entry
//     with timer 0 does; t0 = L and t0 = L + 1 are walked as they are
//     (tracks 6 and 7); every other t0, t0 <= 0 included, cannot reach 0
//     before the first step above the threshold and exits by track 5: a
//     mode and the timer t0 - (the steps it counted down), or a constant;
//   * from UNKNOWN, DISABLED (or any other value): DISABLED, timer kept.
// A track is (mode, keep, v): the timer is t0 - v where keep, else v.  The
// summary of two runs in a row is computed from theirs (compose: each
// track's entry through the first summary, then the second), and it has
// the same form, so summaries join in any grouping and every result is
// exact.  Three launches:
//   1. each thread summarises a chunk of C steps (its bits from a warp
//      ballot of rssi > thr, so the loads coalesce), and the block's
//      chunks are scanned (Kogge-Stone in shared memory) into inclusive
//      prefixes, kept with the block's total;
//   2. a block a lane joins the lane's block totals: runs of blocks a
//      thread (at most 128 threads, one warp a scheduler: the compositions
//      are the cost), a Kogge-Stone scan over the runs, then each run walked
//      from its entry state, writing each block's entry state;
//   3. each chunk starts from its block's entry state through its prefix,
//      is walked again over pass 1's bits (kept in device memory, 1/32 of
//      the rssi's words) writing its modes into shared memory, and the
//      block stores them coalesced; the lane's last chunk writes the final
//      mode and timer.
namespace fsm {

constexpr int kTracks = 8;

// The entry mode of track j: ENABLED, RISE, SIGNALHI, FALL, TIMEOUT, then
// SIGNALLO three times (generic, t0 = L, t0 = L + 1).
__device__ __forceinline__ constexpr int track_mode(int j) {
  return j < 4 ? ENABLED + j : (j == 4 ? TIMEOUT : SIGNALLO);
}

struct Summary {
  int n, L;          // steps of the run; its leading steps at or below thr
  unsigned code;     // 4 bits a track: exit mode | keep << 3
  int v[kTracks];
};

// The next mode without a timeout, 4 bits a mode: below or at the
// threshold, and above it (UNKNOWN and DISABLED go to DISABLED).
__device__ __forceinline__ int next_mode(int m, bool hi) {
  return (int)(((hi ? 0x71333327u : 0x71554417u) >> (4 * m)) & 7u);
}

// One step of a track (or, keep = 0, of the FSM itself): FALL arms the
// timer, SIGNALLO counts it down, then the transition (squelch_step).
__device__ __forceinline__ void step(int& m, int& keep, int& v, bool hi,
                                     int timeout) {
  const bool fall = m == FALL, low = m == SIGNALLO;
  v = fall ? timeout : (low ? (keep ? v + 1 : (int)((unsigned)v - 1u)) : v);
  keep = fall ? 0 : keep;
  m = low && !keep && v == 0 ? TIMEOUT : next_mode(m, hi);
}

// The track an entry takes: (m, keep, v) through the summary s (n >= 1).
__device__ __forceinline__ void apply(const Summary& s, int& m, int& keep,
                                      int& v) {
  int j;
  if (m == SIGNALLO) {
    if (keep) {
      j = 5;
    } else if (v >= 1 && v <= s.L - 1) {   // timed out in the leading run
      j = 0;
      v = 0;
    } else {
      j = v == s.L ? 6 : (v == s.L + 1 ? 7 : 5);
    }
  } else if (m >= ENABLED && m <= FALL) {
    j = m - ENABLED;
  } else if (m == TIMEOUT) {
    j = 4;
  } else {
    m = DISABLED;
    return;
  }
  const unsigned c = (s.code >> (4 * j)) & 15u;
  int sv = s.v[0];                 // s.v[j] by selects: no local memory
#pragma unroll
  for (int q = 1; q < kTracks; ++q) sv = j == q ? s.v[q] : sv;
  m = (int)(c & 7u);
  if (c & 8u) {
    v = keep ? v + sv : (int)((unsigned)v - (unsigned)sv);
  } else {
    keep = 0;
    v = sv;
  }
}

__device__ __forceinline__ void pack(Summary& s, const int (&m)[kTracks],
                                     const int (&keep)[kTracks],
                                     const int (&v)[kTracks]) {
  s.code = 0u;
#pragma unroll
  for (int j = 0; j < kTracks; ++j) {
    s.code |= (unsigned)(m[j] | (keep[j] << 3)) << (4 * j);
    s.v[j] = v[j];
  }
}

// The summary of the n steps whose bits (1: rssi > thr) are bits[0 ..],
// low bit first; n = 0 gives an empty summary.
__device__ Summary summarize(const unsigned* bits, int n, int timeout) {
  Summary s;
  s.n = n;
  int L = n;
  for (int w = 0; w * 32 < n; ++w) {
    if (bits[w] != 0u) {
      L = min(n, 32 * w + __ffs(bits[w]) - 1);
      break;
    }
  }
  s.L = L;
  int m[kTracks], keep[kTracks], v[kTracks];
#pragma unroll
  for (int j = 0; j < kTracks; ++j) {
    m[j] = track_mode(j);
    keep[j] = j < 6;
    v[j] = j == 6 ? L : (j == 7 ? L + 1 : 0);
  }
  for (int t = 0; t < n; ++t) {
    const bool hi = (bits[t >> 5] >> (t & 31)) & 1u;
#pragma unroll
    for (int j = 0; j < kTracks; ++j) step(m[j], keep[j], v[j], hi, timeout);
  }
  pack(s, m, keep, v);
  return s;
}

constexpr int kLoadsInFlight = 16;   // words a warp loads before its ballots
constexpr int kJoinThreads = 128;    // the join's threads a lane, at most

// The summary of run a, then run b.  Tracks 0-5 enter a as a's own tracks
// do, so they leave a as a's tracks; tracks 6 and 7 enter with the timers
// L and L + 1 of the joined run and are taken through a.
__device__ Summary compose(const Summary& a, const Summary& b) {
  if (b.n == 0) return a;
  if (a.n == 0) return b;
  Summary c;
  c.n = a.n + b.n;
  c.L = a.L == a.n ? a.n + b.L : a.L;
  int m[kTracks], keep[kTracks], v[kTracks];
#pragma unroll
  for (int j = 0; j < kTracks; ++j) {
    if (j < 6) {
      const unsigned code = a.code >> (4 * j);
      m[j] = (int)(code & 7u);
      keep[j] = (int)((code >> 3) & 1u);
      v[j] = a.v[j];
    } else {
      m[j] = SIGNALLO;
      keep[j] = 0;
      v[j] = j == 6 ? c.L : c.L + 1;
      apply(a, m[j], keep[j], v[j]);
    }
    apply(b, m[j], keep[j], v[j]);
  }
  pack(c, m, keep, v);
  return c;
}

// bits[w] = the ballot of rssi[base + 32 w + lane] > thr (0 past T) for the
// block's words: a warp loads kLoadsInFlight words at a time (their loads
// in flight together), then ballots each.
template <typename R>
__device__ __forceinline__ void load_bits(const R* __restrict__ rs,
                                          long long T, long long base,
                                          int words, unsigned* bits, R thr) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int w0 = (threadIdx.x >> 5) * kLoadsInFlight; w0 < words;
       w0 += warps * kLoadsInFlight) {
    bool hi[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const long long t = base + 32LL * (w0 + u) + lane;
      hi[u] = w0 + u < words && t < T && rs[t] > thr;
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const unsigned b = __ballot_sync(0xffffffffu, hi[u]);
      if (lane == 0 && w0 + u < words) bits[w0 + u] = b;
    }
  }
}

// Pass 1: block k (lane k / nb, its block k % nb) of blockDim.x chunks of C
// steps: incl[k][i] = chunks 0 .. i of the block composed, totals[k] all;
// the block's bits kept in gbits[k] for pass 3.
template <typename R>
__global__ void summary_kernel(const R* __restrict__ rssi,
                               Summary* __restrict__ incl,
                               Summary* __restrict__ totals,
                               unsigned* __restrict__ gbits, long long T,
                               int C, long long nb, R thr, int timeout) {
  extern __shared__ unsigned smem_bits[];
  const int NT = blockDim.x, i = threadIdx.x, words = NT * C / 32;
  Summary* sums = reinterpret_cast<Summary*>(smem_bits + words);
  const long long k = blockIdx.x;
  const long long base = (k % nb) * NT * C;
  load_bits(rssi + (k / nb) * T, T, base, words, smem_bits, thr);
  __syncthreads();
  for (int w = i; w < words; w += NT) gbits[k * words + w] = smem_bits[w];
  const long long c0 = base + (long long)i * C;
  const int n = c0 < T ? (int)min((long long)C, T - c0) : 0;
  Summary s = summarize(smem_bits + i * (C / 32), n, timeout);
  sums[i] = s;
  __syncthreads();
  for (int d = 1; d < NT; d <<= 1) {
    Summary left;
    if (i >= d) left = sums[i - d];
    __syncthreads();
    if (i >= d) {
      s = compose(left, s);
      sums[i] = s;
    }
    __syncthreads();
  }
  incl[k * NT + i] = s;
  if (i == NT - 1) totals[k] = s;
}

// Pass 2: block b joins lane b's nb block totals; thread j takes the run of
// blocks [j r, j r + r).  starts[b][blk] = (mode, timer) entering the block.
__global__ void join_kernel(const Summary* __restrict__ totals,
                            int2* __restrict__ starts,
                            const int* __restrict__ mode,
                            const int* __restrict__ timer, long long nb,
                            long long r) {
  extern __shared__ Summary runs[];
  const int J = blockDim.x, j = threadIdx.x;
  const long long b = blockIdx.x;
  const Summary* tot = totals + b * nb;
  const long long k0 = j * r, k1 = min(k0 + r, nb);
  Summary s;
  s.n = 0;
  for (long long q = k0; q < k1; ++q) s = compose(s, tot[q]);
  runs[j] = s;
  __syncthreads();
  for (int d = 1; d < J; d <<= 1) {
    Summary left;
    if (j >= d) left = runs[j - d];
    __syncthreads();
    if (j >= d) {
      s = compose(left, s);
      runs[j] = s;
    }
    __syncthreads();
  }
  if (k0 >= nb) return;
  int m = mode[b], keep = 0, v = timer[b];
  if (j > 0) apply(runs[j - 1], m, keep, v);
  for (long long q = k0; q < k1; ++q) {
    starts[b * nb + q] = make_int2(m, v);
    apply(tot[q], m, keep, v);
  }
}

// Pass 3: each chunk walked from its entry state over pass 1's bits; the
// modes staged in shared memory (a row of C + 1 words a chunk) and stored
// coalesced; the lane's last chunk writes the final mode and timer.
__global__ void output_kernel(const unsigned* __restrict__ gbits,
                              const Summary* __restrict__ incl,
                              const int2* __restrict__ starts,
                              int* __restrict__ modes, int* __restrict__ mode,
                              int* __restrict__ timer, long long T, int C,
                              long long nb, int timeout) {
  extern __shared__ unsigned smem_bits[];
  const int NT = blockDim.x, i = threadIdx.x, words = NT * C / 32;
  int* stage = reinterpret_cast<int*>(smem_bits + words);
  const long long k = blockIdx.x, b = k / nb;
  const long long base = (k % nb) * NT * C;
  for (int w = i; w < words; w += NT) smem_bits[w] = gbits[k * words + w];
  __syncthreads();
  const long long c0 = base + (long long)i * C;
  const int n = c0 < T ? (int)min((long long)C, T - c0) : 0;
  if (n > 0) {
    const int2 st = starts[k];
    int m = st.x, keep = 0, v = st.y;
    if (i > 0) apply(incl[k * NT + i - 1], m, keep, v);
    if ((unsigned)m > (unsigned)DISABLED) m = UNKNOWN;  // maps as UNKNOWN
    const unsigned* bits = smem_bits + i * (C / 32);
    for (int t = 0; t < n; ++t) {
      step(m, keep, v, (bits[t >> 5] >> (t & 31)) & 1u, timeout);
      stage[i * (C + 1) + t] = m;
    }
    if (c0 + n == T) {
      mode[b] = m;
      timer[b] = v;
    }
  }
  __syncthreads();
  int* out = modes + b * T;
  for (int q = i; q < NT * C; q += NT) {
    const long long t = base + q;
    if (t < T) out[t] = stage[(q / C) * (C + 1) + q % C];
  }
}

// The three launches over rssi (B, T): chunks of C steps, NT chunks a block
// (C and NT multiples of 32); scratch incl (B nb NT), totals (B nb), starts
// (B nb), gbits (B nb NT C / 32 words), nb = ceil(T / (NT C)).
template <typename R>
int launch(const R* rssi, int* modes, int* mode, int* timer, int B,
           long long T, R thr, int timeout, int C, int NT, Summary* incl,
           Summary* totals, int2* starts, unsigned* gbits, int device,
           cudaStream_t stream) {
  if (B <= 0 || T <= 0 || C < 32 || C % 32 || NT < 32 || NT > 1024 ||
      NT % 32)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long nb = (T + (long long)NT * C - 1) / ((long long)NT * C);
  const long long grid = nb * B;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bits = (size_t)NT * C / 32 * sizeof(unsigned);
  const size_t smem1 = bits + NT * sizeof(Summary);
  const size_t smem3 = bits + (size_t)NT * (C + 1) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      summary_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return (int)err;
  // the join: at most kJoinThreads threads (one warp a scheduler of the
  // SM), each composing a run of r block totals before the scan over runs
  int J = 32;
  while (J < nb && J < kJoinThreads) J *= 2;
  const long long r = (nb + J - 1) / J;
  summary_kernel<R><<<(unsigned)grid, NT, smem1, stream>>>(
      rssi, incl, totals, gbits, T, C, nb, thr, timeout);
  join_kernel<<<(unsigned)B, J, J * sizeof(Summary), stream>>>(
      totals, starts, mode, timer, nb, r);
  output_kernel<<<(unsigned)grid, NT, smem3, stream>>>(
      gbits, incl, starts, modes, mode, timer, T, C, nb, timeout);
  return (int)cudaGetLastError();
}

}  // namespace fsm

// S2: y = x e^{-j theta}; d = the Gray point of y's quadrant; e = arg(y conj d);
// dtheta += alpha e; theta = (theta + dtheta) + beta e.  theta is not wrapped.
template <typename R>
__global__ void __launch_bounds__(THREADS)
costas_pll_kernel(const typename C2<R>::T* __restrict__ x,
                  typename C2<R>::T* __restrict__ y, R* __restrict__ theta,
                  R* __restrict__ dtheta, int B, long long T, R alpha, R beta,
                  R h) {
  using CT = typename C2<R>::T;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  R th = theta[b], dth = dtheta[b];
  walk(x + (long long)b * T, y + (long long)b * T, T, [&](CT xv) {
    R s, c;
    sincos_(th, &s, &c);
    CT yv;                                   // x (c - j s)
    yv.x = add(mul(xv.x, c), mul(xv.y, s));
    yv.y = sub(mul(xv.y, c), mul(xv.x, s));
    const R dr = yv.x < R(0) ? -h : h;
    const R di = yv.y < R(0) ? -h : h;
    const R pr = add(mul(yv.x, dr), mul(yv.y, di));   // y conj(d)
    const R pi = sub(mul(yv.y, dr), mul(yv.x, di));
    const R e = atan2_(pi, pr);
    dth = add(dth, mul(alpha, e));
    th = add(add(th, dth), mul(beta, e));
    return yv;
  });
  theta[b] = th;
  dtheta[b] = dth;
}

template <typename F, typename... A>
int launch(F kernel, int B, int device, cudaStream_t stream, A... args) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

#define AGC_ENTRY(NAME, R)                                                    \
  extern "C" int NAME(const R* x, R* y, R* gain, R* energy,                   \
                      const unsigned char* lock, int* mode, int* timer,       \
                      int B, long long T, double c1, double c2, double c3,   \
                      double scale, double thr, int timeout, int device,      \
                      cudaStream_t stream) {                                  \
    using CT = C2<R>::T;                                                      \
    if (T <= 0) return (int)cudaErrorInvalidValue;                            \
    return launch(agc_scan_kernel<R>, B, device, stream,                      \
                  reinterpret_cast<const CT*>(x), reinterpret_cast<CT*>(y),   \
                  gain, energy, lock, mode, timer, B, T, (R)c1, (R)c2,        \
                  (R)c3, (R)scale, (R)thr, timeout);                          \
  }

#define FSM_ENTRY(NAME, R)                                                    \
  extern "C" int NAME(const R* rssi, int* modes, int* mode, int* timer,       \
                      int B, long long T, double thr, int timeout, int chunk, \
                      int threads, void* incl, void* totals, void* starts,    \
                      void* bits, int device, cudaStream_t stream) {          \
    return fsm::launch<R>(rssi, modes, mode, timer, B, T, (R)thr, timeout,   \
                          chunk, threads,                                     \
                          reinterpret_cast<fsm::Summary*>(incl),              \
                          reinterpret_cast<fsm::Summary*>(totals),            \
                          reinterpret_cast<int2*>(starts),                    \
                          reinterpret_cast<unsigned*>(bits), device, stream); \
  }

#define PLL_ENTRY(NAME, R)                                                    \
  extern "C" int NAME(const R* x, R* y, R* theta, R* dtheta, int B,           \
                      long long T, double alpha, double beta, double h,       \
                      int device, cudaStream_t stream) {                      \
    using CT = C2<R>::T;                                                      \
    if (T <= 0) return (int)cudaErrorInvalidValue;                            \
    return launch(costas_pll_kernel<R>, B, device, stream,                    \
                  reinterpret_cast<const CT*>(x), reinterpret_cast<CT*>(y),   \
                  theta, dtheta, B, T, (R)alpha, (R)beta, (R)h);              \
  }

AGC_ENTRY(agc_scan_f32, float)
AGC_ENTRY(agc_scan_f64, double)
FSM_ENTRY(squelch_fsm_f32, float)
FSM_ENTRY(squelch_fsm_f64, double)
PLL_ENTRY(costas_pll_f32, float)
PLL_ENTRY(costas_pll_f64, double)
