// Fused DDC + FM discriminator for Hopper (sm_90a).
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_ddc.py::make_pallas_ddc_fm
// (K1, kernel body _make_kernel_fm).  One pass over the planar (2, L) f32
// input block computes, for every decimated output t = 0 .. T-1 (T = L / M),
//
//   z[t]     = sum_i h[i] * x[t*M - D + i],        D = n - M,
//   audio[t] = atan2(Im d, Re d) * scale,  d = z[t] conj(z[t-1]) e^{-j drad},
//
// with h the complex NCO-folded bandpass taps, x[-D .. -1] the carried tail,
// (cd, sd) = (cos drad, -sin drad) and scale = 1 / (2 pi kf), and the stats
// [sum |z|^2, z[T-1].re, z[T-1].im, z[0].re, z[0].im], so the decimated-rate
// complex signal never reaches device memory.  z[-1] is computed from a
// window one sample short: the M samples before the tail are read as 0, as
// K1's tile-0 seam reads them, and the caller overwrites audio[0] from its
// carried state.
//
// The block is float32 planes, or the raw interleaved int16 (L, 2) of a
// ci16 recording (the *_i16 entry points: ddc_tc.cuh's kI16 stages and
// ddc_direct.cuh's int16 words, each sample converted in registers to the
// planes' float32 bit for bit, so the audio and stats are the planes').
//
// Bound: bytes (8 a sample in, 4 an output out: 0.045 ms at L = 2^24, M = 4
// on an H100 SXM; int16 in, 4 a sample: 0.025 ms).  The first design (direct-form FIR in FP32 FMA fed from
// shared memory) ran at 22 % of it, held by shared-memory bandwidth like
// the body's first design.  Design, two
// routes chosen from (n, M) alone (ops/cuda_ddc.py::fm_geometry):
//   * "tc", every geometry whose bank and spans fit one block's shared
//     memory (M up to ~100): the body's tensor-core product of ddc_tc.cuh
//     (TF32 x3 wgmma, frames as A from registers, the host-packed bank by
//     one TMA bulk copy, spans by TMA in a ring per warpgroup, persistent
//     blocks), with an FM epilogue on the accumulators.  The FM bank orders
//     its 2P columns so that column 8 j + 2 c + e holds part e (re, im) of
//     output c P/4 + j: each thread then holds whole complex outputs, P/4
//     consecutive ones of each of its two rows, so every output's
//     predecessor is in the same thread except the first of its run, which
//     is one __shfl away (lane - 1: the previous run of the row, or for
//     lane c = 0 the previous row's last).  A warp's first row needs the
//     output before the warp's 16 rows: every warp recomputes it as an FP32
//     dot over its n-sample window, read from the span in shared memory
//     once the tile's last products are issued (the span starts `pre`
//     samples early for that), so no warp waits for another and no sums are
//     staged through shared memory.  The discriminator (atan2f, the
//     rotation by (cd, sd)) runs on the sums; each thread stores its run of
//     P/4 outputs with 16-byte stores.
//   * "direct" (M too large for the spans, and every (n, M) the JAX
//     package's predicate gives K1): no shared memory; a warp walks a run
//     of R consecutive outputs, each the warp dot of ddc_direct.cuh (the
//     body's direct route, shared), after first computing the output
//     before the run, so every discriminator finds z[t - 1] in registers
//     (R + 1 dots for R outputs); lanes 0 .. R - 1 then run the R
//     discriminators side by side.  A first design staged the block's
//     input span in shared memory as M polyphase rows, which stopped
//     fitting 227 KB at M ~218 even with 32 threads a block.
// Either route runs in TF32 x3 (the direct route: FP32 FMA) or "fast", the
// TPU kernel's mode="fast": every sample and tap of the body rounded to bf16
// (to nearest even; the bank from float32 taps, as the TPU kernel's),
// products exact, f32 sums (the direct route rounds its operands before
// each FMA, the same function).  As in the TPU kernel, the seam (the output
// before a TPU tile of seam_period outputs, tile 0's included) stays an f32
// dot over the unrounded samples; a warp seam inside a TPU tile rounds its
// operands as the products do, so it equals the product's own output.  The
// discriminator, the energy and the edge stats are f32 in both modes.
// Both routes finish the stats in the kernel: each block writes its share
// of sum |z|^2 to a partial, and the block that finishes last (an atomic
// ticket it resets, so the kernel stays correct inside a CUDA graph) sums
// the partials in a fixed order; the sums are the same from run to run.
// What holds the tc route (PERF.md, torch_kernel_sweep.py): the epilogue
// after the product, mostly atan2f, whose IEEE division branches to a slow
// path around each call so a thread's 2 P/4 calls do not interleave, then
// the seams' dots.  The epilogue runs between a tile's products and the
// next tile's: run under the next tile's products (its sums copied to
// registers, which made ptxas serialize the wgmmas, or kept in shared
// memory) it slowed them more than it hid, and so did exchanging the
// seams between warps through shared memory (a barrier in the epilogue).

#include <cuda_runtime.h>

#include <type_traits>

#include "ddc_direct.cuh"
#include "ddc_tc.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFmExtra = 64;           // shared bytes of the tc route's stats

// The block's share of sum |z|^2 (e: this thread's) into
// partials[blockIdx.x]; the block that finishes last sums the partials in a
// fixed order into stats[0] and resets the ticket for the next launch.
// red: blockDim.x / 32 + 1 floats of shared memory.  Every thread calls it.
__device__ void finish_stats(float e, float* red, float* __restrict__ partials,
                             unsigned* ticket, float* __restrict__ stats) {
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(kFull, e, off);
  if ((tid & 31) == 0) red[tid >> 5] = e;
  __syncthreads();
  if (tid == 0) {
    float b = 0.f;
    for (int k = 0; k < nw; ++k) b += red[k];
    partials[blockIdx.x] = b;
    __threadfence();
    const unsigned done = atomicAdd(ticket, 1u);
    red[nw] = done == gridDim.x - 1 ? 1.f : 0.f;
  }
  __syncthreads();
  if (red[nw] != 0.f && tid < 32) {
    __threadfence();
    float s = 0.f;
    for (unsigned k = tid; k < gridDim.x; k += 32) s += __ldcg(partials + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (tid == 0) {
      stats[0] = s;
      *ticket = 0u;
    }
  }
}

// audio[t0 .. t0 + Q) = a, the part before T (t0 a multiple of Q).
template <int Q>
__device__ __forceinline__ void store_run(float* __restrict__ audio, long long t0,
                                          const float (&a)[Q], long long T) {
  if (t0 + Q <= T) {
    if constexpr (Q % 4 == 0) {
#pragma unroll
      for (int k = 0; k < Q / 4; ++k)
        reinterpret_cast<float4*>(audio + t0)[k] =
            make_float4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
    } else if constexpr (Q == 2) {
      *reinterpret_cast<float2*>(audio + t0) = make_float2(a[0], a[1]);
    } else {
      audio[t0] = a[0];
    }
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (t0 + j < T) audio[t0 + j] = a[j];
  }
}

// The FM epilogue of the tensor-core route (see the note above).
template <int P, bool kFast>
struct FmEpilogue {
  static constexpr bool kPre = true;
  const float* __restrict__ taps;  // (2, n) [re; im] f32
  float* __restrict__ audio;
  float* __restrict__ stats;
  int n;
  float cd, sd, scale;
  long long seam_period;           // fast: outputs of a TPU tile
  float esum;                      // this thread's sum of |z|^2
  float sr, si;                    // the output before this warp's rows

  // z[t0 + 16 w P - 1] (t0 the tile's first output) by an FP32 dot over its
  // window, which starts pre + hpad - n + 16 w hop samples into the span;
  // fast: its operands rounded to bf16 unless it is a TPU tile's seam
  template <class Span>
  __device__ __forceinline__ void from_span(const Geom& g, long long tau,
                                            const Span& span, int w,
                                            int lane) {
    const int o = g.pre + g.hpad - n + 16 * w * g.hop;
    const bool round =
        kFast && ((tau * kFrames + 16 * w) * P) % seam_period != 0;
    float zr = 0.f, zi = 0.f;
    for (int i = lane; i < n; i += 32) {
      float hr = __ldg(taps + i), hi = __ldg(taps + n + i);
      const float2 v = span.at(o + i);
      float a = v.x, b = v.y;
      if (round) {
        hr = bf16_round(hr);
        hi = bf16_round(hi);
        a = bf16_round(a);
        b = bf16_round(b);
      }
      zr = fmaf(hr, a, zr);
      zr = fmaf(-hi, b, zr);
      zi = fmaf(hr, b, zi);
      zi = fmaf(hi, a, zi);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      zr += __shfl_xor_sync(kFull, zr, off);
      zi += __shfl_xor_sync(kFull, zi, off);
    }
    sr = zr;
    si = zi;
  }

  __device__ __forceinline__ void tile(const Geom& g, long long tau,
                                       const float (&acc)[P], int w, int lane) {
    constexpr int Q = P / 4;       // consecutive outputs of a row a thread holds
    const int r = lane >> 2, c = lane & 3;
    // acc[4 j + 2 h + e]: part e of output c Q + j of frame row 16 w + r + 8 h.
    // The last output of lane - 1 in each row: the predecessor of this
    // lane's first (for lane 0, lane 31's first row precedes its second)
    const int src = (lane + 31) & 31;
    const float l0r = __shfl_sync(kFull, acc[4 * (Q - 1)], src);
    const float l0i = __shfl_sync(kFull, acc[4 * (Q - 1) + 1], src);
    const float l1r = __shfl_sync(kFull, acc[4 * (Q - 1) + 2], src);
    const float l1i = __shfl_sync(kFull, acc[4 * (Q - 1) + 3], src);
    const float first[2][2] = {{lane ? l0r : sr, lane ? l0i : si},
                               {lane ? l1r : l0r, lane ? l1i : l0i}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long t0 = (tau * kFrames + 16 * w + r + 8 * h) * P + c * Q;
      float pr = first[h][0], pi = first[h][1];
      float a[Q];
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float cr = acc[4 * j + 2 * h], ci = acc[4 * j + 2 * h + 1];
        const float ure = cr * pr + ci * pi;
        const float uim = ci * pr - cr * pi;
        const float dre = ure * cd - uim * sd;
        const float dim = uim * cd + ure * sd;
        a[j] = atan2f(dim, dre) * scale;
        e = fmaf(cr, cr, fmaf(ci, ci, e));
        pr = cr;
        pi = ci;
      }
      if (t0 + Q <= g.T) {
        esum += e;
      } else {                     // the block's last run: outputs past T
#pragma unroll
        for (int j = 0; j < Q; ++j)
          if (t0 + j < g.T) {
            const float cr = acc[4 * j + 2 * h], ci = acc[4 * j + 2 * h + 1];
            esum = fmaf(cr, cr, fmaf(ci, ci, esum));
          }
      }
      if (t0 == 0) {
        stats[3] = acc[2 * h];
        stats[4] = acc[2 * h + 1];
      }
      if (t0 <= g.T - 1 && g.T - 1 < t0 + Q) {
#pragma unroll
        for (int j = 0; j < Q; ++j)
          if (t0 + j == g.T - 1) {
            stats[1] = acc[4 * j + 2 * h];
            stats[2] = acc[4 * j + 2 * h + 1];
          }
      }
      store_run<Q>(audio, t0, a, g.T);
    }
  }
};

template <int P, bool kFast, bool kI16>
__global__ void __launch_bounds__(256, 1)
ddc_fm_tc_kernel(const void* __restrict__ x, const float* __restrict__ tail,
                 const float* __restrict__ bank, const float* __restrict__ taps,
                 float* __restrict__ audio, float* __restrict__ stats,
                 float* __restrict__ partials, unsigned* ticket, const Geom g,
                 long long n_tiles, int wgs, int stages, unsigned bank_bytes,
                 int n, float cd, float sd, float scale, long long seam_period) {
  extern __shared__ __align__(128) unsigned char smem[];
  // after the bars: the stats' words
  float* red = reinterpret_cast<float*>(
      smem + tc_smem_bytes(g, P, wgs, stages, 0, kFast, kI16));
  FmEpilogue<P, kFast> epi{taps, audio, stats, n, cd, sd, scale, seam_period,
                           0.f, 0.f, 0.f};
  ddc_tc_run<P, kFast, kI16>(x, tail, bank, g, n_tiles, wgs, stages,
                             bank_bytes, epi);
  finish_stats(epi.esum, red, partials, ticket, stats);
}

template <int P, bool kI16>
int launch_tc(const void* x, const float* tail, const float* bank,
              const float* taps, float* audio, float* stats, float* partials,
              unsigned* ticket, const Geom& g, int wgs, int stages,
              unsigned bank_bytes, size_t smem, int max_blocks, int n, float cd,
              float sd, float scale, bool fast, long long seam_period,
              int device, cudaStream_t stream) {
  auto kernel = fast ? ddc_fm_tc_kernel<P, true, kI16>
                     : ddc_fm_tc_kernel<P, false, kI16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long frames = (g.T + P - 1) / P;
  const long long n_tiles = (frames + kFrames - 1) / kFrames;
  long long blocks = (n_tiles + wgs - 1) / wgs;
  if (blocks > sm_count(device)) blocks = sm_count(device);
  if (blocks > max_blocks) blocks = max_blocks;
  kernel<<<(unsigned)blocks, 128 * wgs, smem, stream>>>(
      x, tail, bank, taps, audio, stats, partials, ticket, g, n_tiles, wgs,
      stages, bank_bytes, n, cd, sd, scale, seam_period);
  return (int)cudaGetLastError();
}

// The large-M route: a warp a run of R consecutive outputs t0 .. t0 + R - 1
// (see the note above).  The warp first computes z[t0 - 1] (in fast mode an
// f32 dot over the unrounded samples where t0 starts a TPU tile: R divides
// the tile, so no other output's predecessor is a seam), then each output
// of the run by the warp dot of ddc_direct.cuh; lane j keeps output j and
// its predecessor, and lanes 0 .. R - 1 run the discriminators side by
// side and store the run's audio with one coalesced store.
template <int R, class X>
__global__ void ddc_fm_direct_kernel(const X* __restrict__ x,
                                     const float* __restrict__ tail,
                                     const float* __restrict__ taps,
                                     float* __restrict__ audio,
                                     float* __restrict__ stats,
                                     float* __restrict__ partials,
                                     unsigned* ticket, long long L, long long T,
                                     int n, int M, float cd, float sd,
                                     float scale, int fast,
                                     long long seam_period) {
  __shared__ float red[33];
  const int lane = threadIdx.x & 31;
  const int D = n - M;
  const long long runs = (T + R - 1) / R;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  float e = 0.f;
  for (long long run = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       run < runs; run += warps) {
    const long long t0 = run * R;
    // lane j keeps z[t0 + j] in (cr, ci) and its predecessor in (qr, qi):
    // z[t0 - 1] for lane 0, from the loop below for the others
    float qr, qi, cr = 0.f, ci = 0.f;
    warp_dot(x, tail, taps, L, D, n, (t0 - 1) * M - D, lane,
             fast && t0 % seam_period != 0, qr, qi);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (t0 + k < T) {
        float zr, zi;
        warp_dot(x, tail, taps, L, D, n, (t0 + k) * M - D, lane, fast != 0,
                 zr, zi);
        if (lane == k) {
          cr = zr;
          ci = zi;
        }
        if (lane == k + 1) {
          qr = zr;
          qi = zi;
        }
      }
    }
    const long long t = t0 + lane;
    if (lane < R && t < T) {
      const float ure = cr * qr + ci * qi;
      const float uim = ci * qr - cr * qi;
      const float dre = ure * cd - uim * sd;
      const float dim = uim * cd + ure * sd;
      audio[t] = atan2f(dim, dre) * scale;
      e = fmaf(cr, cr, fmaf(ci, ci, e));
      if (t == 0) {
        stats[3] = cr;
        stats[4] = ci;
      }
      if (t == T - 1) {
        stats[1] = cr;
        stats[2] = ci;
      }
    }
  }
  finish_stats(e, red, partials, ticket, stats);
}

template <int R, bool kI16>
int launch_direct(const void* x, const float* tail, const float* taps,
                  float* audio, float* stats, float* partials, unsigned* ticket,
                  long long L, long long T, int n, int M, int warps, int blocks,
                  float cd, float sd, float scale, int fast,
                  long long seam_period, cudaStream_t stream) {
  using X = std::conditional_t<kI16, unsigned, float>;
  ddc_fm_direct_kernel<R, X><<<(unsigned)blocks, 32 * warps, 0, stream>>>(
      static_cast<const X*>(x), tail, taps, audio, stats, partials, ticket, L,
      T, n, M, cd, sd, scale, fast, seam_period);
  return (int)cudaGetLastError();
}

template <bool kI16>
int tc_launch(const void* x, const float* tail, const float* bank,
              const float* taps, float* audio, float* stats, float* partials,
              unsigned* ticket, long long L, int n, int M, int P, int hpad,
              int KP, int pre, int wgs, int stages, int smem, int max_blocks,
              float cd, float sd, float scale, int fast, long long seam_period,
              int device, cudaStream_t stream) {
  if (M <= 0 || n <= M || L <= 0 || L % M != 0 || hpad < n - M || hpad % 4 ||
      KP % 32 || KP < hpad + P * M || pre < n - hpad || pre < 0 || pre % 4 ||
      (wgs != 1 && wgs != 2) || (stages != 1 && stages != 2) || max_blocks < 1 ||
      (fast && (seam_period <= 0 || seam_period % (16 * P))) ||
      (reinterpret_cast<unsigned long long>(bank) & 15) ||
      (reinterpret_cast<unsigned long long>(audio) & 15) ||
      (reinterpret_cast<unsigned long long>(x) & 3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geom g = make_geom(x, L, n, M, P, hpad, KP, pre, kI16);
  const unsigned bank_bytes = tc_bank_bytes(P, KP, fast != 0);
  if ((size_t)smem < tc_smem_bytes(g, P, wgs, stages, kFmExtra, fast != 0, kI16))
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 4: return launch_tc<4, kI16>(x, tail, bank, taps, audio, stats, partials,
                                      ticket, g, wgs, stages, bank_bytes, smem,
                                      max_blocks, n, cd, sd, scale, fast != 0,
                                      seam_period, device, stream);
    case 8: return launch_tc<8, kI16>(x, tail, bank, taps, audio, stats, partials,
                                      ticket, g, wgs, stages, bank_bytes, smem,
                                      max_blocks, n, cd, sd, scale, fast != 0,
                                      seam_period, device, stream);
    case 16: return launch_tc<16, kI16>(x, tail, bank, taps, audio, stats,
                                        partials, ticket, g, wgs, stages,
                                        bank_bytes, smem, max_blocks, n, cd, sd,
                                        scale, fast != 0, seam_period, device,
                                        stream);
    case 32: return launch_tc<32, kI16>(x, tail, bank, taps, audio, stats,
                                        partials, ticket, g, wgs, stages,
                                        bank_bytes, smem, max_blocks, n, cd, sd,
                                        scale, fast != 0, seam_period, device,
                                        stream);
    case 64: return launch_tc<64, kI16>(x, tail, bank, taps, audio, stats,
                                        partials, ticket, g, wgs, stages,
                                        bank_bytes, smem, max_blocks, n, cd, sd,
                                        scale, fast != 0, seam_period, device,
                                        stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kI16>
int direct_launch(const void* x, const float* tail, const float* taps,
                  float* audio, float* stats, float* partials, unsigned* ticket,
                  long long L, int n, int M, int R, int warps, int blocks,
                  float cd, float sd, float scale, int fast,
                  long long seam_period, int device, cudaStream_t stream) {
  if (M <= 0 || n <= M || L <= 0 || L % M != 0 || warps < 1 || warps > 32 ||
      blocks < 1 || R < 1 || (fast && (seam_period <= 0 || seam_period % R)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long T = L / M;
  switch (R) {
    case 4: return launch_direct<4, kI16>(x, tail, taps, audio, stats, partials,
                                          ticket, L, T, n, M, warps, blocks, cd,
                                          sd, scale, fast, seam_period, stream);
    case 8: return launch_direct<8, kI16>(x, tail, taps, audio, stats, partials,
                                          ticket, L, T, n, M, warps, blocks, cd,
                                          sd, scale, fast, seam_period, stream);
    case 16: return launch_direct<16, kI16>(x, tail, taps, audio, stats,
                                            partials, ticket, L, T, n, M, warps,
                                            blocks, cd, sd, scale, fast,
                                            seam_period, stream);
    case 32: return launch_direct<32, kI16>(x, tail, taps, audio, stats,
                                            partials, ticket, L, T, n, M, warps,
                                            blocks, cd, sd, scale, fast,
                                            seam_period, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The tensor-core route.  x (2, L), tail (2, n - M), taps (2, n) [re row;
// im row] f32; bank: the packed bank of ops/cuda_ddc.py::body_tc_bank in the
// FM column order (fast = 0: the tf32 hi and lo banks; fast = 1: bf16), for
// frames of P
// outputs read through windows of KP samples from hpad before the frame,
// spans starting pre samples earlier, wgs warpgroups a block, stages span
// buffers a warpgroup and smem bytes of shared memory a block
// (ops/cuda_ddc.py::fm_geometry).  audio (L / M,) 16-byte aligned, stats
// (5,), partials (max_blocks,), ticket: one word, 0 before the first launch
// (each launch leaves it 0); fast mode: seam_period, the outputs of a TPU
// tile (a multiple of 16 P), whose seams stay f32.  All on card `device`;
// launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int ddc_fm_launch(const float* x, const float* tail, const float* bank,
                             const float* taps, float* audio, float* stats,
                             float* partials, unsigned* ticket, long long L,
                             int n, int M, int P, int hpad, int KP, int pre,
                             int wgs, int stages, int smem, int max_blocks,
                             float cd, float sd, float scale, int fast,
                             long long seam_period, int device,
                             cudaStream_t stream) {
  return tc_launch<false>(x, tail, bank, taps, audio, stats, partials, ticket,
                          L, n, M, P, hpad, KP, pre, wgs, stages, smem,
                          max_blocks, cd, sd, scale, fast, seam_period, device,
                          stream);
}

// The direct route: x, tail, taps, fast and seam_period as above; runs of R
// outputs (4, 8, 16 or 32; R divides seam_period), warps a block and blocks
// from ops/cuda_ddc.py::launch_geometry and _launch_fm; partials (blocks,).
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int ddc_fm_direct_launch(const float* x, const float* tail,
                                    const float* taps, float* audio, float* stats,
                                    float* partials, unsigned* ticket, long long L,
                                    int n, int M, int R, int warps, int blocks,
                                    float cd, float sd, float scale, int fast,
                                    long long seam_period, int device,
                                    cudaStream_t stream) {
  return direct_launch<false>(x, tail, taps, audio, stats, partials, ticket, L,
                              n, M, R, warps, blocks, cd, sd, scale, fast,
                              seam_period, device, stream);
}

// ddc_fm_launch on the raw int16 block x (L, 2), 4-byte aligned; smem from
// fm_geometry(..., ci16=True) (a stage holds the span's words).
extern "C" int ddc_fm_launch_i16(const void* x, const float* tail,
                                 const float* bank, const float* taps,
                                 float* audio, float* stats, float* partials,
                                 unsigned* ticket, long long L, int n, int M,
                                 int P, int hpad, int KP, int pre, int wgs,
                                 int stages, int smem, int max_blocks, float cd,
                                 float sd, float scale, int fast,
                                 long long seam_period, int device,
                                 cudaStream_t stream) {
  return tc_launch<true>(x, tail, bank, taps, audio, stats, partials, ticket, L,
                         n, M, P, hpad, KP, pre, wgs, stages, smem, max_blocks,
                         cd, sd, scale, fast, seam_period, device, stream);
}

// ddc_fm_direct_launch on the raw int16 block x (L, 2), 4-byte aligned.
extern "C" int ddc_fm_direct_launch_i16(const void* x, const float* tail,
                                        const float* taps, float* audio,
                                        float* stats, float* partials,
                                        unsigned* ticket, long long L, int n,
                                        int M, int R, int warps, int blocks,
                                        float cd, float sd, float scale,
                                        int fast, long long seam_period,
                                        int device, cudaStream_t stream) {
  return direct_launch<true>(x, tail, taps, audio, stats, partials, ticket, L,
                             n, M, R, warps, blocks, cd, sd, scale, fast,
                             seam_period, device, stream);
}
