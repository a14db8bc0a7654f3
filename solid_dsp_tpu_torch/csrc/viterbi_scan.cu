// S7: the Viterbi decoder's add-compare-select (ACS) walk and its traceback,
// for models/fec.py::viterbi_decode over a batch of rows.
//
// Replaces no TPU kernel: in the JAX package the walk is two lax.scans,
// solid_dsp_tpu/models/fec.py::viterbi_decode: the ACS scan over all
// 2^(K-1) states at :143 and the traceback scan at :152.  PyTorch has no
// scan: the ACS in eager torch ops is ~7 dependent launches a step, and a
// default packet (550 steps) or a CCSDS frame at interleave depth 4 (8,166
// steps) costs thousands to tens of thousands of launches; here a batch is
// one launch.
//
// Bound: latency.  A row's ACS is a dependent chain of T steps: a step is
// the predecessors' metrics, two adds, a compare and select, and the
// minimum of all states' new metrics (one REDUX a warp on order-preserving
// integer keys, exact: a minimum selects a value), which the next step
// subtracts.  The bytes (the received values in, the bits and the final
// metrics out) bound a call far below that chain; rows run side by side
// on the SMs, a block a row.
//
// Every form makes the plain version's float operations in its order, so
// the metrics and the decisions are bit-equal to it:
//   pm[p] = pmn[p] - min(previous pmn),
//   cand_c = pm[p_c] + bm(p_c, b),  p_0 = ns >> 1, p_1 = p_0 | S/2,
//   choice = cand_1 < cand_0          (JAX's argmin: the first minimum),
//   pmn[ns] = choice ? cand_1 : cand_0,
// with bm the branch metric summed over the n outputs in index order (soft:
// the LLRs of the outputs whose hypothesised bit is 1; hard: the Hamming
// distance as an integer).  A step's decisions are packed by __ballot_sync
// into words, stored to global memory (T x S / 8 bytes a row): lane i of a
// warp keeps the word of the chunk's step i and the warp stores the
// chunk's words at its end.  The received values are staged a chunk of
// steps ahead: each thread loads its share of the next chunk into
// registers at a chunk's start and stores it to the other shared buffer at
// its end.
//
// The single-warp form (viterbi_warp_kernel), S <= 64, K <= 7: the metrics
// stay in registers and no barrier is needed.  At 64 states lane l holds
// states l and l + 32, the two predecessors of next states 2l and 2l + 1,
// and computes both; four shuffles put the new metrics back in that layout
// while the warp minimum runs.  Below 32 states lane l holds state l % S
// and takes its predecessors by two shuffles.
//
// The block form (viterbi_kernel), S >= 128: one thread a state, the
// metrics exchanged through a double-buffered shared array; each thread
// subtracts the previous minimum as it reads a predecessor, so one barrier
// a step suffices; the block minimum comes from the warps' minima at the
// next step.
//
// Traceback, in the same launch: warp 0 walks back from state 0.  A step's
// decision words do not depend on the state, only the bit chosen within
// them does, so lane l loads word l of the next TB steps into registers
// ahead of the walk and the walk takes the word it needs by a shuffle.
//
// Entry point (returns the launch's cudaError_t):
//   viterbi_acs: rx (B, T, n) float32 LLRs (soft != 0, positive favours 0)
//   or int32 hard bits; masks (S, 2) uint32, bit k = output k of the branch
//   (previous state p, input b); -> bits (B, T) int32, the decoded bit of
//   every step (the caller drops the K - 1 tail bits), pm (B, S) float32,
//   the final renormalised metrics; dec (B, T, max(1, S / 32)) uint32
//   scratch (at 64 states the single-warp form's two words a step: bit l
//   of word b is state 2l + b).  S a power of two <= 1024, 1 <= n <= 32.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_S = 1024;
constexpr int MAX_CHUNK = 32;   // steps a chunk (<= 32: a word a lane)
constexpr int PER = 4;          // staged values a thread a chunk
constexpr int TB = 16;          // traceback steps loaded ahead
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;     // start metric of every state but 0

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

// Traceback from state 0 by one warp, k = 0 .. T - 1 walking t = T - 1 -
// k: the decision of state s at step t is bit (s & 31) of word s >> 5 of
// the step (``pairs``: bit s >> 1 of word s & 1, the single-warp form's
// layout at 64 states).  Lane l loads word l of the next TB steps ahead;
// the walk takes the word it needs by a shuffle.
__device__ __forceinline__ void traceback(const unsigned* __restrict__ drow,
                                          int* __restrict__ brow, int T,
                                          int W, int S, int lane,
                                          bool pairs) {
  int s = 0;
  const auto load = [&](int k) -> unsigned {
    return lane < W ? drow[(long long)(T - 1 - k) * W + lane] : 0u;
  };
  const auto step = [&](int k, unsigned word) {
    const int wi = pairs ? (s & 1) : (s >> 5);
    const int bi = pairs ? (s >> 1) : (s & 31);
    const unsigned w = W == 1 ? word : __shfl_sync(FULL, word, wi);
    const int c = (w >> bi) & 1u;
    if (lane == 0) brow[T - 1 - k] = s & 1;
    s = (s >> 1) | (c ? (S >> 1) : 0);
  };
  const int full = T - T % TB;
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
  for (int k = full; k < T; ++k) step(k, load(k));
}

template <int N, bool SOFT>
__global__ void __launch_bounds__(MAX_S)
viterbi_kernel(const typename Rx<SOFT>::T* __restrict__ rx,
               const unsigned* __restrict__ masks, int* __restrict__ bits,
               float* __restrict__ pm_out, unsigned* __restrict__ dec, int T,
               int n, int S, int cs) {
  using R = typename Rx<SOFT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  float* pmn = reinterpret_cast<float*>(smem);         // [2][S]
  int* red = reinterpret_cast<int*>(pmn + 2 * S);       // [2][32]
  R* rb = reinterpret_cast<R*>(red + 64);               // [2][cs * n]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int W = S >= 32 ? S >> 5 : 1;
  const long long row = blockIdx.x;
  const int ns = tid & (S - 1);
  const int p0 = ns >> 1;
  const int p1 = p0 | (S >> 1);
  const int b = ns & 1;
  const unsigned m0 = masks[2 * p0 + b];
  const unsigned m1 = masks[2 * p1 + b];
  const R* rrow = rx + row * (long long)T * n;
  unsigned* drow = dec + row * (long long)T * W;
  int* brow = bits + row * (long long)T;
  const unsigned word_mask = S >= 32 ? FULL : ((1u << S) - 1u);
  const long long total = (long long)T * n;
  const int cn = cs * n;   // values a chunk

  if (tid < S) pmn[ns] = ns == 0 ? 0.f : BIG;
  // the start's minimum is 0 (x - 0 = x)
  for (int j = tid; j < 64; j += nthreads)
    red[j] = (j & 31) < W ? 0 : INT_MAX;
  for (int j = tid; j < cn; j += nthreads) rb[j] = j < total ? rrow[j] : R(0);
  __syncthreads();

  int cur = 0;
  int rbuf = 0;
  for (int t0 = 0; t0 < T; t0 += cs) {
    R pre[PER];
    const long long base = (long long)(t0 + cs) * n;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * nthreads;
      pre[k] = (j < cn && base + j < total) ? rrow[base + j] : R(0);
    }
    const int steps = min(cs, T - t0);
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
      if (lane == i) wreg = word & word_mask;
      const int wk = __reduce_min_sync(FULL, order_key(v));
      const int nxt = cur ^ 1;
      if (tid < S) pmn[nxt * S + ns] = v;
      if (lane == 0) red[nxt * 32 + warp] = wk;
      __syncthreads();
      cur = nxt;
    }
    // the chunk's decision words, one a lane; the next chunk's values
    if (lane < steps) drow[(long long)(t0 + lane) * W + warp] = wreg;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * nthreads;
      if (j < cn) rb[(rbuf ^ 1) * cn + j] = pre[k];
    }
    __syncthreads();
    rbuf ^= 1;
  }
  {
    const float g = from_key(block_min_key(red + cur * 32, W, lane));
    if (tid < S) pm_out[row * S + ns] = __fsub_rn(pmn[cur * S + ns], g);
  }

  if (warp == 0) traceback(drow, brow, T, W, S, lane, false);
}

// The single-warp form for S <= 64 states: no barrier and no shared
// metrics.  PAIRS (S = 64): lane l holds states l and l + 32, which are the
// two predecessors of next states 2l and 2l + 1, so it computes both with
// no exchange; the new metrics go back to that layout by four shuffles
// (state m from lane m >> 1, state m + 32 from lane (m >> 1) + 16, even or
// odd by m's parity), which overlap the warp minimum.  Otherwise (S <= 32)
// lane l holds state l % S and takes its predecessors by two shuffles.  The
// float operations are the block form's (and the plain version's).
template <int N, bool SOFT, bool PAIRS>
__global__ void __launch_bounds__(32)
viterbi_warp_kernel(const typename Rx<SOFT>::T* __restrict__ rx,
                    const unsigned* __restrict__ masks, int* __restrict__ bits,
                    float* __restrict__ pm_out, unsigned* __restrict__ dec,
                    int T, int n, int S, int cs) {
  using R = typename Rx<SOFT>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  R* rb = reinterpret_cast<R*>(smem);                   // [2][cs * n]

  const int lane = threadIdx.x;
  const int W = PAIRS ? 2 : 1;
  const long long row = blockIdx.x;
  const R* rrow = rx + row * (long long)T * n;
  unsigned* drow = dec + row * (long long)T * W;
  int* brow = bits + row * (long long)T;
  const unsigned word_mask = S >= 32 ? FULL : ((1u << S) - 1u);
  const long long total = (long long)T * n;
  const int cn = cs * n;

  // PAIRS: the branches (lane -> 2 lane + b) and (lane + 32 -> 2 lane + b);
  // otherwise (p0 -> ns) and (p1 -> ns)
  const int ns = lane & (S - 1);
  const int p0 = PAIRS ? lane : ns >> 1;
  const int p1 = PAIRS ? lane + 32 : (ns >> 1) | (S >> 1);
  const unsigned ma0 = masks[2 * p0 + (PAIRS ? 0 : (ns & 1))];
  const unsigned ma1 = masks[2 * p1 + (PAIRS ? 0 : (ns & 1))];
  const unsigned mb0 = PAIRS ? masks[2 * p0 + 1] : 0u;
  const unsigned mb1 = PAIRS ? masks[2 * p1 + 1] : 0u;
  const int src = lane >> 1;                            // PAIRS' shuffles
  const bool odd = lane & 1;
  // With n fixed (N > 0) a step's n values come a step ahead into
  // registers, and a soft branch metric is an FFMA chain over them with
  // the branch's outputs as 0/1 factors, in index order: fma(o, r, bm) =
  // bm + o r exactly, the plain version's sum.
  constexpr int NK = N > 0 ? N : 1;
  float fa0[NK], fa1[NK], fb0[NK], fb1[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    fa0[k] = (float)((ma0 >> k) & 1u);
    fa1[k] = (float)((ma1 >> k) & 1u);
    fb0[k] = (float)((mb0 >> k) & 1u);
    fb1[k] = (float)((mb1 >> k) & 1u);
  }
  const auto metric = [&](unsigned m, const float(&f)[NK], const R* rs,
                          const R(&rv)[NK]) -> float {
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
      return branch_metric<N, SOFT>(m, rs, n);
    }
  };

  float pa = (PAIRS ? lane : ns) == 0 ? 0.f : BIG;      // state l (or ns)
  float pb = BIG;                                       // state l + 32
  float g = 0.f;                                        // previous minimum
  float va = 0.f, vb = 0.f;
  for (int j = lane; j < cn; j += 32) rb[j] = j < total ? rrow[j] : R(0);
  __syncwarp();

  int rbuf = 0;
  for (int t0 = 0; t0 < T; t0 += cs) {
    R pre[PER];
    const long long base = (long long)(t0 + cs) * n;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = lane + k * 32;
      pre[k] = (j < cn && base + j < total) ? rrow[base + j] : R(0);
    }
    const int steps = min(cs, T - t0);
    const R* rc = rb + rbuf * cn;
    R rv[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) rv[k] = rc[k];
    unsigned wra = 0, wrb = 0;
    for (int i = 0; i < steps; ++i) {
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
      const float ca0 = __fadd_rn(x0, metric(ma0, fa0, rs, rv));
      const float ca1 = __fadd_rn(x1, metric(ma1, fa1, rs, rv));
      const bool cha = ca1 < ca0;
      va = cha ? ca1 : ca0;
      const unsigned wa = __ballot_sync(FULL, cha);
      if (lane == i) wra = wa & word_mask;
      float vmin = va;
      if (PAIRS) {
        const float cb0 = __fadd_rn(x0, metric(mb0, fb0, rs, rv));
        const float cb1 = __fadd_rn(x1, metric(mb1, fb1, rs, rv));
        const bool chb = cb1 < cb0;
        vb = chb ? cb1 : cb0;
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
    }
    if (lane < steps) {
      drow[(long long)(t0 + lane) * W] = wra;
      if (PAIRS) drow[(long long)(t0 + lane) * W + 1] = wrb;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = lane + k * 32;
      if (j < cn) rb[(rbuf ^ 1) * cn + j] = pre[k];
    }
    __syncwarp();
    rbuf ^= 1;
  }
  if (PAIRS) {
    pm_out[row * S + 2 * lane] = __fsub_rn(T ? va : pa, g);
    pm_out[row * S + 2 * lane + 1] = __fsub_rn(T ? vb : BIG, g);
  } else if (lane < S) {
    pm_out[row * S + ns] = __fsub_rn(pa, g);
  }
  __syncwarp();
  traceback(drow, brow, T, W, S, lane, PAIRS);
}

template <int N, bool SOFT>
cudaError_t launch(const void* rx, const unsigned* masks, int* bits,
                   float* pm, unsigned* dec, int B, int T, int n, int S,
                   cudaStream_t stream) {
  using R = typename Rx<SOFT>::T;
  const R* r = static_cast<const R*>(rx);
  const int nthreads = S < 32 ? 32 : S;
  const int cs = max(1, min(MAX_CHUNK, (S <= 64 ? 32 : nthreads) * PER / n));
  const size_t staged = sizeof(R) * 2 * cs * n;
  if (S == 64) {
    viterbi_warp_kernel<N, SOFT, true><<<B, 32, staged, stream>>>(
        r, masks, bits, pm, dec, T, n, S, cs);
  } else if (S <= 32) {
    viterbi_warp_kernel<N, SOFT, false><<<B, 32, staged, stream>>>(
        r, masks, bits, pm, dec, T, n, S, cs);
  } else {
    const size_t smem = sizeof(float) * 2 * S + sizeof(int) * 64 + staged;
    viterbi_kernel<N, SOFT><<<B, nthreads, smem, stream>>>(
        r, masks, bits, pm, dec, T, n, S, cs);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int viterbi_acs(const void* rx, int soft, const unsigned* masks,
                           int* bits, float* pm, unsigned* dec, int B, int T,
                           int n, int S, int device, cudaStream_t stream) {
  if (B < 1 || T < 0 || n < 1 || n > 32 || S < 1 || S > MAX_S
      || (S & (S - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (soft) {
    if (n == 2) return launch<2, true>(rx, masks, bits, pm, dec, B, T, n, S,
                                       stream);
    if (n == 3) return launch<3, true>(rx, masks, bits, pm, dec, B, T, n, S,
                                       stream);
    return launch<0, true>(rx, masks, bits, pm, dec, B, T, n, S, stream);
  }
  if (n == 2) return launch<2, false>(rx, masks, bits, pm, dec, B, T, n, S,
                                      stream);
  if (n == 3) return launch<3, false>(rx, masks, bits, pm, dec, B, T, n, S,
                                      stream);
  return launch<0, false>(rx, masks, bits, pm, dec, B, T, n, S, stream);
}
