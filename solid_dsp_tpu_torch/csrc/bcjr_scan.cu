// S6: the max-log BCJR walk of one terminated RSC constituent, for turbo
// decoding (models/turbo.py).
//
// Replaces no TPU kernel: in the JAX package the walk is two lax.scans,
// solid_dsp_tpu/models/turbo.py::_bcjr_extrinsic (:195-324): the forward
// (alpha) scan at :276, the backward (beta) scan at :312 and the
// a-posteriori step at :318-324, as radix-8 blocked max-plus products.
// PyTorch has no scan: that formulation in eager torch ops is ~6 launches a
// block step, ~3,100 dependent block steps a decode of 1024 bits over six
// iterations (~19k launches), so the walk is one kernel here, one launch a
// half-iteration.
//
// Bound: latency.  A row's walk is a dependent chain of T + m steps each
// way; a step is a shuffle of the neighbouring states' metrics, an add and a
// max (the renormalisation's three shuffles once a chunk).  The bytes (the
// two LLR rows in, the LLRs out) and the operations (~30 a state a step)
// bound the call at well under a microsecond at 128 rows of 1027 steps
// (chip_smoke.py phase 40 prints the bound); the chain bounds it at some
// 2 x 1027 step latencies.  The design keeps everything off that chain that
// can be: one lane a trellis state (8 lanes a row, 4 rows a warp, a warp a
// block, so the rows spread over the SMs), the state metrics in registers,
// the inputs loaded a chunk of CHUNK steps ahead into registers, the
// gammas from them and the trellis tables (kernel parameters, per lane in
// registers), the LLR's two maxima beside the beta chain, not on it.
//
// Order of operations: step by step, not in JAX's radix-8 blocks, so the
// values differ from the plain version (models/turbo.py::bcjr_maxlog_plain)
// by float32 max/add association and by where the renormalisation falls
// (here after every chunk of CHUNK steps and at each walk's ragged end; the
// backward walk's m tail steps are not renormalised before the first
// chunk); the renormalisation constants cancel in the LLR.
//   forward:  alpha_{t+1}[n] = max_c (gamma_in(t, n, c) + alpha_t[prev[n][c]])
//   backward: beta_t[s] = max_u (gamma(t, s, u) + beta_{t+1}[ns[s][u]])
//   LLR_t = max_s ((alpha_t[s] + gamma(t, s, 0)) + beta_{t+1}[ns[s][0]])
//         - max_s ((alpha_t[s] + gamma(t, s, 1)) + beta_{t+1}[ns[s][1]])
// with gamma = 0.5 (sgn(u) ls_t + sgn(p) lp_t), sgn(b) = 1 - 2b.  The
// forward walk stores alpha_t (before step t) to a (B, T + m, S) scratch in
// device memory (~33 KB a row at 1024 bits, L2-resident at the sweep's 128
// rows), which the backward walk reads back a chunk ahead.
//
// Entry point (returns the launch's cudaError_t):
//   bcjr_maxlog_f32: ls, lp (B, Tm) float32 (ls = l_sys + l_apr, the tails
//   appended) -> llr (B, T), T <= Tm; alphas (B, Tm, 8) scratch; tables on
//   the host, 5 x (8, 2) ints: ns, p, prev, prev_u, prev_p.

#include <cuda_runtime.h>

namespace {

constexpr int S = 8;              // trellis states, m = 3
constexpr int ROWS = 32 / S;      // rows a warp
constexpr int THREADS = 32;       // a warp a block
constexpr int CHUNK = 16;         // steps loaded ahead; renormalised after
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e9f;      // log-metric of an unreachable state

struct Trellis {
  int ns[S][2];       // next state of (s, u)
  float sp[S][2];     // parity sign of (s, u)
  int prev[S][2];     // the two predecessors of state n
  float su_in[S][2];  // input sign of prev[n][c] -> n
  float sp_in[S][2];  // parity sign of prev[n][c] -> n
};

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = S / 2; o >= 1; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o, S));
  return v;
}

// Walk steps k = 0 .. n-1: load(k, buf) fetches step k's inputs, step(k,
// buf) runs it.  Full chunks of CHUNK steps run unrolled with no guard (a
// shuffle under a branch costs the warp a reconvergence each step), their
// inputs loaded into registers a chunk ahead; after each chunk, renorm().
// The ragged end takes one step at a time.
template <typename Buf, typename Load, typename Step, typename Renorm>
__device__ __forceinline__ void chunked(int n, Load load, Step step,
                                        Renorm renorm) {
  const int full = n - n % CHUNK;
  Buf cur[CHUNK], nxt[CHUNK];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) load(i, cur[i]);
  }
  for (int k0 = 0; k0 < full; k0 += CHUNK) {
    if (k0 + CHUNK < full) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) load(k0 + CHUNK + i, nxt[i]);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) step(k0 + i, cur[i]);
    renorm();
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) cur[i] = nxt[i];
  }
  for (int k = full; k < n; ++k) {
    Buf one;
    load(k, one);
    step(k, one);
  }
  renorm();
}

struct Fwd {
  float l, p;
};
struct Bwd {
  float l, p, a;
};

__global__ void __launch_bounds__(THREADS)
bcjr_kernel(const float* __restrict__ ls, const float* __restrict__ lp,
            float* __restrict__ llr, float* __restrict__ alphas, Trellis tr,
            int B, int Tm, int T) {
  const int lane = threadIdx.x;
  const int s = lane % S;
  const int row_raw = blockIdx.x * ROWS + lane / S;
  const bool valid = row_raw < B;
  // a lane past the last row walks the last row (its shuffles keep the
  // warp whole) and stores nothing
  const long long row = valid ? row_raw : B - 1;
  const float* lsr = ls + row * Tm;
  const float* lpr = lp + row * Tm;
  float* ar = alphas + row * Tm * S;
  float* out = llr + row * T;

  // forward walk: step t stores alpha_t, then moves to alpha_{t+1}
  {
    const int p0 = tr.prev[s][0], p1 = tr.prev[s][1];
    const float u0 = tr.su_in[s][0], u1 = tr.su_in[s][1];
    const float q0 = tr.sp_in[s][0], q1 = tr.sp_in[s][1];
    float alpha = s == 0 ? 0.f : NEG;
    chunked<Fwd>(
        Tm, [&](int t, Fwd& b) { b = {lsr[t], lpr[t]}; },
        [&](int t, const Fwd& b) {
          if (valid) ar[(long long)t * S + s] = alpha;
          const float a0 = __shfl_sync(FULL, alpha, p0, S);
          const float a1 = __shfl_sync(FULL, alpha, p1, S);
          const float g0 = 0.5f * (u0 * b.l + q0 * b.p);
          const float g1 = 0.5f * (u1 * b.l + q1 * b.p);
          alpha = fmaxf(g0 + a0, g1 + a1);
        },
        [&] { alpha -= group_max(alpha); });
  }

  // backward walk, t = Tm - 1 down to 0: the tail's m steps first (no
  // LLR), then the T information steps with their LLRs.  The alphas it
  // reads are this lane's own stores of the forward walk.
  const int n0 = tr.ns[s][0], n1 = tr.ns[s][1];
  const float q0 = tr.sp[s][0], q1 = tr.sp[s][1];
  float beta = s == 0 ? 0.f : NEG;
  const auto gammas = [&](const Bwd& b, float& g0, float& g1, float& b0,
                          float& b1) {
    b0 = __shfl_sync(FULL, beta, n0, S);
    b1 = __shfl_sync(FULL, beta, n1, S);
    g0 = 0.5f * (b.l + q0 * b.p);
    g1 = 0.5f * (q1 * b.p - b.l);
  };
  for (int t = Tm - 1; t >= T; --t) {
    float g0, g1, b0, b1;
    gammas(Bwd{lsr[t], lpr[t], 0.f}, g0, g1, b0, b1);
    beta = fmaxf(g0 + b0, g1 + b1);
  }
  chunked<Bwd>(
      T,
      [&](int k, Bwd& b) {
        const int t = T - 1 - k;
        b = {lsr[t], lpr[t], ar[(long long)t * S + s]};
      },
      [&](int k, const Bwd& b) {
        float g0, g1, b0, b1;
        gammas(b, g0, g1, b0, b1);
        const float m0 = group_max((b.a + g0) + b0);
        const float m1 = group_max((b.a + g1) + b1);
        if (valid && s == 0) out[T - 1 - k] = m0 - m1;
        beta = fmaxf(g0 + b0, g1 + b1);
      },
      [&] { beta -= group_max(beta); });
}

}  // namespace

extern "C" int bcjr_maxlog_f32(const float* ls, const float* lp, float* llr,
                               float* alphas, const int* tables, int B,
                               int Tm, int T, int device,
                               cudaStream_t stream) {
  if (B < 1 || Tm < 1 || T < 0 || T > Tm) return (int)cudaErrorInvalidValue;
  Trellis tr;
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
      tr.ns[s][c] = ns[i];
      tr.sp[s][c] = 1.f - 2.f * p[i];
      tr.prev[s][c] = prev[i];
      tr.su_in[s][c] = 1.f - 2.f * prev_u[i];
      tr.sp_in[s][c] = 1.f - 2.f * prev_p[i];
    }
  }
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  bcjr_kernel<<<(B + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
      ls, lp, llr, alphas, tr, B, Tm, T);
  return (int)cudaGetLastError();
}
