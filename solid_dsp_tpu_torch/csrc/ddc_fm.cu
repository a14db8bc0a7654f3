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
// Bound: bytes (8 a sample in, 4 an output out: 0.045 ms at L = 2^24, M = 4
// on an H100 SXM).  The first design (direct-form FIR in FP32 FMA fed from
// shared memory, kept below as the large-M route) ran at 22 % of it, held
// by shared-memory bandwidth like the body's first design.  Design, two
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
//   * "direct" (M too large for the spans): one block stages its input span
//     in shared memory as M polyphase rows and each thread computes R = 4
//     outputs in FP32 FMA, thread 0 the seam z[t0 - 1] beside them.
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

#include "ddc_tc.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kOutputsPerThread = 4;   // the direct route's R
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
template <int P>
struct FmEpilogue {
  static constexpr bool kPre = true;
  const float* __restrict__ taps;  // (2, n) [re; im] f32
  float* __restrict__ audio;
  float* __restrict__ stats;
  int n;
  float cd, sd, scale;
  float esum;                      // this thread's sum of |z|^2
  float sr, si;                    // the output before this warp's rows

  // z[t0 + 16 w P - 1] (t0 the tile's first output) by an FP32 dot over its
  // window, which starts pre + hpad - n + 16 w hop samples into the span
  __device__ __forceinline__ void from_span(const Geom& g, const float* re,
                                         const float* im, int w, int lane) {
    const int o = g.pre + g.hpad - n + 16 * w * g.hop;
    float zr = 0.f, zi = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float hr = __ldg(taps + i), hi = __ldg(taps + n + i);
      const float a = re[o + i], b = im[o + i];
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

template <int P>
__global__ void __launch_bounds__(256, 1)
ddc_fm_tc_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                 const float* __restrict__ bank, const float* __restrict__ taps,
                 float* __restrict__ audio, float* __restrict__ stats,
                 float* __restrict__ partials, unsigned* ticket, const Geom g,
                 long long n_tiles, int wgs, int stages, unsigned bank_bytes,
                 int n, float cd, float sd, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // after the bars: the stats' words
  float* red = reinterpret_cast<float*>(smem + tc_smem_bytes(g, P, wgs, stages, 0));
  FmEpilogue<P> epi{taps, audio, stats, n, cd, sd, scale, 0.f, 0.f, 0.f};
  ddc_tc_run<P>(x, tail, bank, g, n_tiles, wgs, stages, bank_bytes, epi);
  finish_stats(epi.esum, red, partials, ticket, stats);
}

template <int P>
int launch_tc(const float* x, const float* tail, const float* bank,
              const float* taps, float* audio, float* stats, float* partials,
              unsigned* ticket, const Geom& g, int wgs, int stages,
              unsigned bank_bytes, size_t smem, int max_blocks, int n, float cd,
              float sd, float scale, int device, cudaStream_t stream) {
  auto kernel = ddc_fm_tc_kernel<P>;
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
      stages, bank_bytes, n, cd, sd, scale);
  return (int)cudaGetLastError();
}

// The large-M route: direct-form FIR in FP32 FMA from polyphase rows.
__global__ void ddc_fm_direct_kernel(const float* __restrict__ x,
                                     const float* __restrict__ tail,
                                     const float* __restrict__ taps,
                                     float* __restrict__ audio,
                                     float* __restrict__ stats,
                                     float* __restrict__ partials,
                                     unsigned* ticket, long long L, long long T,
                                     int n, int M, int U, float cd, float sd,
                                     float scale) {
  constexpr int R = kOutputsPerThread;
  extern __shared__ float dsmem[];
  const int nthr = blockDim.x;
  const int tbo = nthr * R;
  float* xs_r = dsmem;              // [M][U] polyphase rows, real plane
  float* xs_i = xs_r + M * U;       // [M][U] imaginary plane
  float* h_r = xs_i + M * U;        // [n]
  float* h_i = h_r + n;             // [n]
  float* z_r = h_i + n;             // [tbo + 1]: z[t0 - 1 + j]
  float* z_i = z_r + tbo + 1;
  float* red = z_i + tbo + 1;       // [nthr / 32 + 1]

  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * tbo;
  const int D = n - M;
  const long long b0 = (t0 - 1) * M - D;  // first sample of z[t0 - 1]

  for (int i = tid; i < n; i += nthr) {
    h_r[i] = taps[i];
    h_i[i] = taps[n + i];
  }
  for (int k = tid; k < M * U; k += nthr) {
    const long long s = b0 + k;
    float vr = 0.f, vi = 0.f;
    if (s >= 0) {
      if (s < L) {
        vr = x[s];
        vi = x[L + s];
      }
    } else if (s >= -D) {
      vr = tail[s + D];
      vi = tail[D + s + D];
    }
    const int u = k / M;
    const int r = k - u * M;
    xs_r[r * U + u] = vr;
    xs_i[r * U + u] = vi;
  }
  __syncthreads();

  // Local output j reads xs[r][j + 1 + q] for tap i = q*M + r; the seam
  // output j = -1 reads xs[r][q].
  const int nq = (n + M - 1) / M;
  float zr[R], zi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) zr[k] = zi[k] = 0.f;
  float sr = 0.f, si = 0.f;
  for (int q = 0; q < nq; ++q) {
    for (int r = 0; r < M; ++r) {
      const int i = q * M + r;
      if (i >= n) break;
      const float hr = h_r[i], hi = h_i[i];
      const float* ar = xs_r + r * U + q + 1 + tid;
      const float* ai = xs_i + r * U + q + 1 + tid;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float a = ar[k * nthr], b = ai[k * nthr];
        zr[k] = fmaf(hr, a, zr[k]);
        zr[k] = fmaf(-hi, b, zr[k]);
        zi[k] = fmaf(hr, b, zi[k]);
        zi[k] = fmaf(hi, a, zi[k]);
      }
      if (tid == 0) {
        const float a = xs_r[r * U + q], b = xs_i[r * U + q];
        sr = fmaf(hr, a, sr);
        sr = fmaf(-hi, b, sr);
        si = fmaf(hr, b, si);
        si = fmaf(hi, a, si);
      }
    }
  }
  if (tid == 0) {
    z_r[0] = sr;
    z_i[0] = si;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    z_r[1 + tid + k * nthr] = zr[k];
    z_i[1 + tid + k * nthr] = zi[k];
  }
  __syncthreads();

  float e = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = tid + k * nthr;
    const long long t = t0 + j;
    if (t < T) {
      const float cr = z_r[j + 1], ci = z_i[j + 1];
      const float pr = z_r[j], pi = z_i[j];
      const float ure = cr * pr + ci * pi;
      const float uim = ci * pr - cr * pi;
      const float dre = ure * cd - uim * sd;
      const float dim = uim * cd + ure * sd;
      audio[t] = atan2f(dim, dre) * scale;
      e += cr * cr + ci * ci;
      if (t == T - 1) {
        stats[1] = cr;
        stats[2] = ci;
      }
      if (t == 0) {
        stats[3] = cr;
        stats[4] = ci;
      }
    }
  }
  finish_stats(e, red, partials, ticket, stats);
}

}  // namespace

// Shared-memory bytes of one block of the direct route; the wrapper sizes
// its launch with the same formula (ops/cuda_ddc.py::launch_geometry).
static size_t ddc_fm_direct_smem_bytes(int n, int M, int threads) {
  const int tbo = threads * kOutputsPerThread;
  const int U = tbo + (n + M - 1) / M;
  return sizeof(float) * (2 * (size_t)M * U + 2 * (size_t)n +
                          2 * (size_t)(tbo + 1) + threads / 32 + 1);
}

// The tensor-core route.  x (2, L), tail (2, n - M), taps (2, n) [re row;
// im row] f32; bank: the packed hi and lo banks of
// ops/cuda_ddc.py::body_tc_bank in the FM column order, for frames of P
// outputs read through windows of KP samples from hpad before the frame,
// spans starting pre samples earlier, wgs warpgroups a block, stages span
// buffers a warpgroup and smem bytes of shared memory a block
// (ops/cuda_ddc.py::fm_geometry).  audio (L / M,) 16-byte aligned, stats
// (5,), partials (max_blocks,), ticket: one word, 0 before the first launch
// (each launch leaves it 0).  All on card `device`; launches on `stream`,
// does not synchronise, returns the launch's cudaError_t.
extern "C" int ddc_fm_launch(const float* x, const float* tail, const float* bank,
                             const float* taps, float* audio, float* stats,
                             float* partials, unsigned* ticket, long long L,
                             int n, int M, int P, int hpad, int KP, int pre,
                             int wgs, int stages, int smem, int max_blocks,
                             float cd, float sd, float scale, int device,
                             cudaStream_t stream) {
  if (M <= 0 || n <= M || L <= 0 || L % M != 0 || hpad < n - M || hpad % 4 ||
      KP % 32 || KP < hpad + P * M || pre < n - hpad || pre < 0 || pre % 4 ||
      (wgs != 1 && wgs != 2) || (stages != 1 && stages != 2) || max_blocks < 1 ||
      (reinterpret_cast<unsigned long long>(bank) & 15) ||
      (reinterpret_cast<unsigned long long>(audio) & 15) ||
      (reinterpret_cast<unsigned long long>(x) & 3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Geom g = make_geom(x, L, n, M, P, hpad, KP, pre);
  const unsigned bank_bytes = tc_bank_bytes(P, KP);
  if ((size_t)smem < tc_smem_bytes(g, P, wgs, stages, kFmExtra))
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 4: return launch_tc<4>(x, tail, bank, taps, audio, stats, partials, ticket,
                                g, wgs, stages, bank_bytes, smem, max_blocks, n, cd,
                                sd, scale, device, stream);
    case 8: return launch_tc<8>(x, tail, bank, taps, audio, stats, partials, ticket,
                                g, wgs, stages, bank_bytes, smem, max_blocks, n, cd,
                                sd, scale, device, stream);
    case 16: return launch_tc<16>(x, tail, bank, taps, audio, stats, partials, ticket,
                                  g, wgs, stages, bank_bytes, smem, max_blocks, n, cd,
                                  sd, scale, device, stream);
    case 32: return launch_tc<32>(x, tail, bank, taps, audio, stats, partials, ticket,
                                  g, wgs, stages, bank_bytes, smem, max_blocks, n, cd,
                                  sd, scale, device, stream);
    case 64: return launch_tc<64>(x, tail, bank, taps, audio, stats, partials, ticket,
                                  g, wgs, stages, bank_bytes, smem, max_blocks, n, cd,
                                  sd, scale, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The direct route: x, tail, taps as above; threads a block from
// ops/cuda_ddc.py::launch_geometry; partials (max_blocks,) with max_blocks
// >= the blocks, ceil(T / (4 threads)).  Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" int ddc_fm_direct_launch(const float* x, const float* tail,
                                    const float* taps, float* audio, float* stats,
                                    float* partials, unsigned* ticket, long long L,
                                    int n, int M, int threads, int max_blocks,
                                    float cd, float sd, float scale, int device,
                                    cudaStream_t stream) {
  if (M <= 0 || n <= M || L % M != 0 || L / M <= 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const long long T = L / M;
  const int tbo = threads * kOutputsPerThread;
  const long long blocks = (T + tbo - 1) / tbo;
  if (blocks > max_blocks) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int U = tbo + (n + M - 1) / M;
  const size_t smem = ddc_fm_direct_smem_bytes(n, M, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ddc_fm_direct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ddc_fm_direct_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      x, tail, taps, audio, stats, partials, ticket, L, T, n, M, U, cd, sd, scale);
  return (int)cudaGetLastError();
}
