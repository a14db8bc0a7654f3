// Multi-channel IIR biquad-cascade bank for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_kernels.py::iir_bank_apply
// (K6, kernel body _iir_bank_kernel).  For every real lane l of the
// (T, 2C) block (complex64 channels as interleaved re/im lanes; the real
// coefficients act on both alike) and every section s, direct form II:
//
//   fb = a1[s] w1[s] + a2[s] w2[s],   ff = b1[s] w1[s] + b2[s] w2[s]
//   w0 = v - fb,   v = b0[s] w0 + ff,   (w2[s], w1[s]) <- (w1[s], w0)
//
// with the state (2S, 2C) rows [w1_0, w2_0, w1_1, ...] carried in from the
// previous block and written out after row T-1.  Any T >= 0, 1 <= S <= 8.
//
// Bound: bytes (16 a complex sample in and out; 9 S FLOPs a lane a row are
// far below the card's rate) -- but only if the work is spread: the
// recurrence is serial in time, and one thread per lane (2C = 512 threads at
// C = 256, the earlier design) ran at 3 % of that bound, held by the chain
// of dependent operations and the few loads one lane keeps in flight.
//
// Design: a time-parallel chunked recurrence.  The cascade is linear, so
// its 2S-vector state after a chunk of Lc rows is Phi^Lc (state before) +
// (the chunk run from a zero state), Phi the cascade's 2S x 2S state
// transition.  The wrapper builds the powers Phi^(Lc j), j = 1 .. Q, per
// lane once per set of coefficients (ops/cuda_iir.py::iir_join_tables: the
// plain recurrence from each unit state in float64, its powers in float64,
// each rounded once to f32).  Every (lane, chunk) pair is a thread: the
// chunk's end from a zero state, then the ends joined (below), then the
// chunk again from its true start, writing y.  Inside a chunk the order and
// rounding of every operation are the plain version's (no contracted
// multiply-adds), so a chunk started from the plain version's state
// reproduces it bit for bit; only the chunk starts differ, by the rounding
// of the tables and of the join.  Each thread loads its rows 16 at a time
// into registers, the next 16 while it filters the current ones, so a warp
// keeps 16 to 32 coalesced 128-byte row reads in flight.  x is read twice
// and y written once.  T <= Lc is one chunk (no join).
//
// Form and Lc, from torch_kernel_sweep.py at T = 2^14, C = 256, S = 2 on an
// NVIDIA H100 80GB HBM3 (700 W): three launches (ends, span starts, run)
// rather than one with a decoupled look-back, since with the join cheap the
// two sweeps of x cost 0.018 + 0.023 ms against a 0.020 ms bound for one;
// Lc = 64 (ops/cuda_iir.py::IIR_CHUNK): 0.0449 ms, against 0.0618 at 16,
// 0.0522 at 32 and 0.0453 at 128 (fewer chunks leave the passes too few
// threads, more make the join longer), and it keeps twice the chunks of
// 128 for shorter blocks.  An earlier join, one thread a lane walking all
// T / Lc chunks in order, took about as long as both sweeps together.

#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerBlock = 32;   // one warp of lanes: 128-byte rows
constexpr int kChunksPerBlock = 4;   // blocks of 128 threads
constexpr int kBatch = 16;           // rows a thread loads before filtering

template <int S>
struct Cascade {
  float b0[S], b1[S], b2[S], a1[S], a2[S], w1[S], w2[S];

  __device__ __forceinline__ void load(const float* __restrict__ sos, int l,
                                       int lanes) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      b0[s] = __ldg(sos + (s * 5 + 0) * lanes + l);
      b1[s] = __ldg(sos + (s * 5 + 1) * lanes + l);
      b2[s] = __ldg(sos + (s * 5 + 2) * lanes + l);
      a1[s] = __ldg(sos + (s * 5 + 3) * lanes + l);
      a2[s] = __ldg(sos + (s * 5 + 4) * lanes + l);
    }
  }
  // one row in the plain version's order and rounding
  __device__ __forceinline__ float step(float v) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float fb = __fadd_rn(__fmul_rn(a1[s], w1[s]), __fmul_rn(a2[s], w2[s]));
      const float ff = __fadd_rn(__fmul_rn(b1[s], w1[s]), __fmul_rn(b2[s], w2[s]));
      const float w0 = __fsub_rn(v, fb);
      v = __fadd_rn(__fmul_rn(b0[s], w0), ff);
      w2[s] = w1[s];
      w1[s] = w0;
    }
    return v;
  }
  // rows t0 .. t0+rows-1 of lane l; y written when kWrite.  Whole batches
  // of kBatch rows are loaded one batch ahead of the one being filtered.
  template <bool kWrite>
  __device__ __forceinline__ void run(const float* __restrict__ x,
                                      float* __restrict__ y, long long t0,
                                      int rows, int l, int lanes) {
    const int whole = rows / kBatch;
    float cur[kBatch], nxt[kBatch];
    auto fetch = [&](int b, float (&v)[kBatch]) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        v[i] = b < whole ? __ldg(x + (t0 + b * kBatch + i) * lanes + l) : 0.f;
    };
    fetch(0, cur);
    for (int b = 0; b < whole; ++b) {
      fetch(b + 1, nxt);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float o = step(cur[i]);
        if (kWrite) y[(t0 + b * kBatch + i) * lanes + l] = o;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) cur[i] = nxt[i];
    }
    int r0 = whole * kBatch;
    for (; r0 < rows; ++r0) {
      const float o = step(__ldg(x + (t0 + r0) * lanes + l));
      if (kWrite) y[(t0 + r0) * lanes + l] = o;
    }
  }
};

// The chunks' carries s_{k+1} = Phi s_k + e_k (Phi = Phi^Lc) are joined a
// span of Q = join_span(S) chunks at a time (Q N <= 64 floats), with the
// tables pw[j - 1] = Phi^j, j = 1 .. Q: the start of chunk k = Q m + j + 1
// is Phi^(j+1) S_m + loc_k, S_m the start of span m and loc_k the span's
// chunks m Q .. k - 1 joined from a zero start.  Three kernels:
//   * iir_chunk_ends, one block a span and a warp of lanes: each thread runs
//     its chunk from a zero state (its end e_k into shared memory), then one
//     warp joins the span from a zero start (Q steps in float64) and writes
//     loc_{k+1} into slot k;
//   * iir_span_starts, one thread a lane: the spans' starts in order,
//     S_{m+1} = Phi^Q S_m + loc of the span's last chunk, into ss[m]
//     (ceil((nc - 1) / Q) steps, the loc ends loaded a group ahead);
//   * iir_chunk_run: each chunk's start (st_in for chunk 0, else
//     loc + Phi^(j+1) S_m in float64), then the chunk itself.
// The serial depth is Q + (nc - 1) / Q steps, not nc - 1, each on values
// in registers or shared memory.
__host__ __device__ constexpr int join_span(int S) {
  return 64 / (2 * S) < 2 ? 2 : (64 / (2 * S) > 32 ? 32 : 64 / (2 * S));
}

template <int S>
__global__ void __launch_bounds__(kLanesPerBlock * join_span(S))
iir_chunk_ends(const float* __restrict__ x, const float* __restrict__ sos,
               const float* __restrict__ pw, float* __restrict__ ws, int lanes,
               int Lc, int nc) {
  constexpr int N = 2 * S;
  constexpr int Q = join_span(S);
  __shared__ float es[Q * N * kLanesPerBlock];    // [j][i][lane]
  const int lt = threadIdx.x, j = threadIdx.y;
  const int l = blockIdx.x * kLanesPerBlock + lt;
  const int steps = nc - 1;
  const int k = blockIdx.y * Q + j;
  const bool live = l < lanes && k < steps;
  if (live) {
    Cascade<S> c;
    c.load(sos, l, lanes);
#pragma unroll
    for (int s = 0; s < S; ++s) c.w1[s] = c.w2[s] = 0.f;
    c.template run<false>(x, nullptr, (long long)k * Lc, Lc, l, lanes);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      es[((j * N) + 2 * s) * kLanesPerBlock + lt] = c.w1[s];
      es[((j * N) + 2 * s + 1) * kLanesPerBlock + lt] = c.w2[s];
    }
  }
  __syncthreads();
  if (j != 0 || l >= lanes) return;
  // Phi in registers for small cascades, else read through L1 each step
  constexpr int NR = N <= 4 ? N : 1;
  double ph[NR][NR], v[N];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int q = 0; q < NR; ++q) ph[r][q] = __ldg(pw + (long long)(r * N + q) * lanes + l);
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] = 0.0;
  auto phi = [&](int r, int q) -> double {
    if constexpr (N <= 4) return ph[r][q];
    return (double)__ldg(pw + (long long)(r * N + q) * lanes + l);
  };
  const int k0 = blockIdx.y * Q;
#pragma unroll
  for (int jj = 0; jj < Q; ++jj) {
    if (k0 + jj >= steps) break;
    double t[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      double a = es[(jj * N + r) * kLanesPerBlock + lt];
#pragma unroll
      for (int q = 0; q < N; ++q) a = fma(phi(r, q), v[q], a);
      t[r] = a;
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v[r] = t[r];
      ws[((long long)(k0 + jj) * N + r) * lanes + l] = (float)t[r];
    }
  }
}

// The spans' starts in order, one thread a lane: ss[m] = S_m.
template <int S>
__global__ void __launch_bounds__(128)
iir_span_starts(const float* __restrict__ pw, const float* __restrict__ st_in,
                const float* __restrict__ ws, float* __restrict__ ss,
                int lanes, int nc) {
  constexpr int N = 2 * S;
  constexpr int Q = join_span(S);
  constexpr int G = N >= 32 ? 1 : 32 / N;          // spans a load group
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const int spans = (nc - 1 + Q - 1) / Q;
  const float* pq = pw + (long long)(Q - 1) * N * N * lanes + l;   // Phi^Q
  double v[N];
#pragma unroll
  for (int r = 0; r < N; ++r) v[r] = st_in[r * lanes + l];
  // loc of span m's last chunk: slot m Q + Q - 1 (full spans only)
  auto fetch = [&](int m0, float (&e)[G][N]) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < N; ++r)
        e[g][r] = m0 + g + 1 < spans
                      ? __ldg(ws + ((long long)((m0 + g) * Q + Q - 1) * N + r) * lanes + l)
                      : 0.f;
  };
  float cur[G][N], nxt[G][N];
  fetch(0, cur);
  for (int m0 = 0; m0 < spans; m0 += G) {
    fetch(m0 + G, nxt);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int m = m0 + g;
      if (m >= spans) break;
#pragma unroll
      for (int r = 0; r < N; ++r) ss[((long long)m * N + r) * lanes + l] = (float)v[r];
      double t[N];
#pragma unroll
      for (int r = 0; r < N; ++r) {
        double a = cur[g][r];
#pragma unroll
        for (int q = 0; q < N; ++q) a = fma((double)__ldg(pq + (long long)(r * N + q) * lanes), v[q], a);
        t[r] = a;
      }
#pragma unroll
      for (int r = 0; r < N; ++r) v[r] = t[r];
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < N; ++r) cur[g][r] = nxt[g][r];
  }
}

// Chunk k from its start state (st_in for k = 0, else loc + Phi^(j+1) S_m);
// writes its rows of y, and the last chunk the new state.
template <int S>
__global__ void __launch_bounds__(kLanesPerBlock * kChunksPerBlock)
iir_chunk_run(const float* __restrict__ x, const float* __restrict__ sos,
              const float* __restrict__ pw, const float* __restrict__ st_in,
              const float* __restrict__ ws, const float* __restrict__ ss,
              float* __restrict__ y, float* __restrict__ st_out, long long T,
              int lanes, int Lc, int nc) {
  constexpr int N = 2 * S;
  constexpr int Q = join_span(S);
  const int l = blockIdx.x * kLanesPerBlock + threadIdx.x;
  const int k = blockIdx.y * kChunksPerBlock + threadIdx.y;
  if (l >= lanes || k >= nc) return;
  Cascade<S> c;
  c.load(sos, l, lanes);
  float st[N];
  if (k == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) st[r] = st_in[r * lanes + l];
  } else {
    const int m = (k - 1) / Q, j = (k - 1) - m * Q;
    const float* tab = pw + (long long)j * N * N * lanes + l;      // Phi^(j+1)
    double sm[N];
#pragma unroll
    for (int r = 0; r < N; ++r) sm[r] = ss[((long long)m * N + r) * lanes + l];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      double a = ws[((long long)(k - 1) * N + r) * lanes + l];
#pragma unroll
      for (int q = 0; q < N; ++q) a = fma((double)__ldg(tab + (long long)(r * N + q) * lanes), sm[q], a);
      st[r] = (float)a;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c.w1[s] = st[2 * s];
    c.w2[s] = st[2 * s + 1];
  }
  const long long t0 = (long long)k * Lc;
  const int rows = (int)(T - t0 < Lc ? T - t0 : Lc);
  c.template run<true>(x, y, t0, rows, l, lanes);
  if (k == nc - 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      st_out[(2 * s) * lanes + l] = c.w1[s];
      st_out[(2 * s + 1) * lanes + l] = c.w2[s];
    }
  }
}

template <int S>
int launch(const float* x, const float* sos, const float* pw,
           const float* st_in, float* y, float* st_out, float* ws, long long T,
           int lanes, int Lc, cudaStream_t stream) {
  constexpr int Q = join_span(S);
  const long long nc_ll = T > 0 ? (T + Lc - 1) / Lc : 1;
  if (nc_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nc = (int)nc_ll;
  const int spans = (nc - 1 + Q - 1) / Q;
  float* ss = ws + (long long)(nc - 1) * 2 * S * lanes;
  const unsigned lane_blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  if (nc > 1) {
    iir_chunk_ends<S><<<dim3(lane_blocks, spans), dim3(kLanesPerBlock, Q), 0,
                        stream>>>(x, sos, pw, ws, lanes, Lc, nc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    iir_span_starts<S><<<(lanes + 127) / 128, 128, 0, stream>>>(pw, st_in, ws, ss,
                                                                lanes, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(lane_blocks, (nc + kChunksPerBlock - 1) / kChunksPerBlock);
  iir_chunk_run<S><<<grid, dim3(kLanesPerBlock, kChunksPerBlock), 0, stream>>>(
      x, sos, pw, st_in, ws, ss, y, st_out, T, lanes, Lc, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// x (T, 2C) and y (T, 2C): complex64 (T, C) read and written as interleaved
// f32; sos (5S, 2C) f32, row 5s + k holding coefficient k (b0 b1 b2 a1 a2)
// of section s for every lane; pw (Q 4 S^2, 2C) f32, row (j - 1) 4 S^2 +
// 2S r + c holding entry (r, c) of Phi^(Lc j), j = 1 .. Q = span, for every
// lane (ops/cuda_iir.py::iir_join_tables; span must be join_span(S));
// st_in and st_out (2S, 2C) f32; ws scratch of (nc - 1 + ceil((nc - 1) / Q))
// * 2S * 2C f32, nc = ceil(T / Lc).  1 <= S <= 8, any T >= 0, Lc >= 1.  Contiguous, on card `device`.
// Launches on `stream` (up to three kernels), does not synchronise, returns
// the first failed launch's cudaError_t or 0.
extern "C" int iir_bank_launch(const float* x, const float* sos,
                               const float* pw, const float* st_in, float* y,
                               float* st_out, float* ws, long long T, int C,
                               int S, int Lc, int span, int device,
                               cudaStream_t stream) {
  if (T < 0 || C <= 0 || Lc <= 0 || S < 1 || S > 8 || span != join_span(S))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int lanes = 2 * C;
  switch (S) {
    case 1: return launch<1>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 2: return launch<2>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 3: return launch<3>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 4: return launch<4>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 5: return launch<5>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 6: return launch<6>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 7: return launch<7>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    case 8: return launch<8>(x, sos, pw, st_in, y, st_out, ws, T, lanes, Lc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
