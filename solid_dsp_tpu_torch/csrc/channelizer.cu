// Polyphase channelizer kernels for Hopper (sm_90a): K4 and K5.
//
// Replaces two TPU kernels of solid_dsp_tpu/ops/pallas_kernels.py:
//   * make_pallas_channelizer (K4, kernel body _make_chan_kernel): the fused
//     critically-sampled channelizer, branch filter and M-point DFT in one
//     pass;
//   * pfb_frontend (K5, kernel body _frontend_kernel): the branch products
//     only; the caller takes the FFT.
//
// Both run the (K+1)-tap permuted branch filter Hp2 down the frame rows of
// each lane q (pallas_kernels.py module docstring):
//
//   z[u, q] = sum_{k=0..K} hp[k, q] * xrow(u - k)[q]
//
// where xrow(r) is row r of the block, or, for r < 0, row nt + r of the nt
// carried tail rows (the previous block's last rows).  K4 then writes
//
//   Y[u, m] = sum_q z[u, q] e^{-2 pi i q m / M}
//
// as (U, 2M) f32 [Re | Im] columns; K5 writes z itself.
//
// The branch filter (branch_rows): a thread owns one lane and a run of R
// consecutive rows, loads the R + 8 rows it needs into registers once and
// forms its R outputs from them, with the taps in registers (zero past K,
// so a filter of K <= 8 taps is one code path).  Reads are coalesced along
// the lanes and each input row is read from memory about once.
//
// K5 bound: memory.  Each input sample is read once and each output written
// once (16 bytes a complex sample in and out) against 2 (K + 1) FLOPs a
// real lane.  Design: branch_rows over 32 rows a thread, one thread a real
// lane; complex64 rides as interleaved (re, im) float lanes sharing one
// real tap, as on the TPU.  K > 8 takes a loop over the taps instead.
//
// K4 bound: operations.  The DFT as a product is 8 U M^2 FLOPs (8.6 GFLOP
// at M = 256, U = 16384) against 2 * 16 bytes a frame sample of memory.
// The TPU kernel holds the whole folded bank in VMEM; here the f32 bank
// [C | S] (M, 2M) is 1 MiB at M = 256 and does not fit shared memory, so
// the kernel is a tiled product: each thread block owns 128 rows x 64
// channels, and for each slab of 16 lanes q it computes that slab of z for
// its rows into shared memory (branch_rows, straight from the input and the
// tail rows: no block depends on another) and stages the matching 16 x 64
// slab of C and S; each thread accumulates 8 rows x 4 channels of complex
// outputs in registers in FP32 FMA, reading z and the bank as float4.
// "x3" is FP32 throughout (the Hopper meaning of its ~f32 contract);
// "fast" rounds z to bf16 here and takes a bank the wrapper rounded to
// bf16, accumulating in FP32, as the TPU's single bf16 pass does.  The
// branch filter is recomputed for each of the M / 64 channel tiles: 36
// FLOPs a z value a tile against 8 M DFT FLOPs, about 7 % more work at
// M = 256.  Tensor cores (wgmma on bf16 splits) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 8;           // CHAN_HALO: carried tail rows, K <= 8

// Branch-filter outputs of rows u0 .. u0+R-1 of lane q: rows of stride
// `stride` floats, rows >= U read as 0, rows < 0 from the nt tail rows
// (rows before those as 0: their taps are 0).  h[0..8]: the taps of lane q,
// zero past K.  Sums in the TPU kernel's order (tap 0 first).
template <int R>
__device__ __forceinline__ void branch_rows(
    const float* __restrict__ x, const float* __restrict__ tail, int nt,
    long long stride, long long U, const float (&h)[kHalo + 1], long long u0,
    long long q, float (&out)[R]) {
  float win[R + kHalo];
#pragma unroll
  for (int j = 0; j < R + kHalo; ++j) {
    const long long r = u0 - kHalo + j;
    float v = 0.f;
    if (r >= 0) {
      if (r < U) v = __ldg(x + r * stride + q);
    } else if (r >= -nt) {
      v = __ldg(tail + (nt + r) * stride + q);
    }
    win[j] = v;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k <= kHalo; ++k) acc = fmaf(h[k], win[kHalo + i - k], acc);
    out[i] = acc;
  }
}

// ----------------------------------------------------------------- K5
constexpr int kFrontRows = 32;     // rows each thread walks

// x (U, lanes) and tail (K, lanes) interleaved complex rows, h (K+1, lanes),
// z (U, lanes); lanes = 2M; K <= 8.
__global__ void pfb_frontend_kernel(const float* __restrict__ x,
                                    const float* __restrict__ tail,
                                    const float* __restrict__ h,
                                    float* __restrict__ z,
                                    long long U, int lanes, int K) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float hl[kHalo + 1];
#pragma unroll
  for (int k = 0; k <= kHalo; ++k) hl[k] = k <= K ? __ldg(h + k * lanes + l) : 0.f;
  const long long u0 = (long long)blockIdx.y * kFrontRows;
  float out[kFrontRows];
  branch_rows<kFrontRows>(x, tail, K, lanes, U, hl, u0, l, out);
#pragma unroll
  for (int i = 0; i < kFrontRows; ++i)
    if (u0 + i < U) z[(u0 + i) * lanes + l] = out[i];
}

// The same for K > 8: a loop over the taps, one output at a time.
__global__ void pfb_frontend_long_kernel(const float* __restrict__ x,
                                         const float* __restrict__ tail,
                                         const float* __restrict__ h,
                                         float* __restrict__ z,
                                         long long U, int lanes, int K) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const long long u0 = (long long)blockIdx.y * kFrontRows;
  const long long u1 = u0 + kFrontRows < U ? u0 + kFrontRows : U;
  for (long long u = u0; u < u1; ++u) {
    float acc = 0.f;
    for (int k = 0; k <= K; ++k) {
      const long long r = u - k;
      const float v = r >= 0 ? __ldg(x + r * lanes + l)
                             : __ldg(tail + (K + r) * lanes + l);
      acc = fmaf(__ldg(h + k * lanes + l), v, acc);
    }
    z[u * lanes + l] = acc;
  }
}

// ----------------------------------------------------------------- K4
constexpr int kTileRows = 128;     // rows u of one thread block
constexpr int kTileCh = 64;        // channels m of one thread block
constexpr int kSlab = 16;          // lanes q staged per step
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kRowsPer = 8;        // rows of one thread (and of one z run)
constexpr int kChPer = 4;          // channels of one thread
constexpr int kZStride = kTileRows + 4;   // z slab row stride, 16-byte aligned

// xf (2, U, M) planes, tail (2, 8, M), hp (K+1, M), bank (M, 2M) = [C | S]
// with C + iS = e^{-2 pi i q m / M}; y (U, 2M).
__global__ void __launch_bounds__(kThreads, 2)
chan_fused_kernel(const float* __restrict__ xf, const float* __restrict__ tail,
                  const float* __restrict__ hp, const float* __restrict__ bank,
                  float* __restrict__ y, long long U, int M, int K,
                  int round_z) {
  __shared__ __align__(16) float zr_s[kSlab * kZStride];   // [q][u]
  __shared__ __align__(16) float zi_s[kSlab * kZStride];
  __shared__ __align__(16) float c_s[kSlab * kTileCh];     // [q][m]
  __shared__ __align__(16) float s_s[kSlab * kTileCh];

  const int tid = threadIdx.x;
  const int tx = tid & 15;           // channels tx*4 .. +3
  const int ty = tid >> 4;           // rows ty*8 .. +7
  const long long u0 = (long long)blockIdx.y * kTileRows;
  const int m0 = blockIdx.x * kTileCh;
  const long long plane = U * (long long)M;

  float yr[kRowsPer][kChPer], yi[kRowsPer][kChPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < kChPer; ++j) yr[i][j] = yi[i][j] = 0.f;

  for (int q0 = 0; q0 < M; q0 += kSlab) {
    __syncthreads();                 // the previous slab is consumed
    // z slab: lane q0 + (tid & 15), rows (tid >> 4) * 8 .. +7, one plane
    // after the other, so that one plane's window is live beside the 64
    // running sums (both at once spill past the 128 registers a thread)
    {
      const int ql = tid & (kSlab - 1);
      const int ul = (tid / kSlab) * kRowsPer;
      const long long q = q0 + ql;
      float h[kHalo + 1];
#pragma unroll
      for (int k = 0; k <= kHalo; ++k)
        h[k] = (q < M && k <= K) ? __ldg(hp + k * M + q) : 0.f;
#pragma unroll 1
      for (int p = 0; p < 2; ++p) {
        float z[kRowsPer];
        if (q < M) {
          branch_rows<kRowsPer>(xf + p * plane, tail + p * kHalo * M, kHalo, M,
                                U, h, u0 + ul, q, z);
        } else {
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) z[i] = 0.f;
        }
        if (round_z) {
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i)
            z[i] = __bfloat162float(__float2bfloat16_rn(z[i]));
        }
        float4* d = reinterpret_cast<float4*>((p ? zi_s : zr_s) + ql * kZStride + ul);
        d[0] = make_float4(z[0], z[1], z[2], z[3]);
        d[1] = make_float4(z[4], z[5], z[6], z[7]);
      }
    }
    // bank slab: lanes q0 .. q0+15 x channels m0 .. m0+63 of C and S
    {
      const int ml = tid & (kTileCh - 1);
      const int m = m0 + ml;
      for (int ql = tid / kTileCh; ql < kSlab; ql += kThreads / kTileCh) {
        const int q = q0 + ql;
        float c = 0.f, s = 0.f;
        if (q < M && m < M) {
          c = __ldg(bank + (long long)q * 2 * M + m);
          s = __ldg(bank + (long long)q * 2 * M + M + m);
        }
        c_s[ql * kTileCh + ml] = c;
        s_s[ql * kTileCh + ml] = s;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int ql = 0; ql < kSlab; ++ql) {
      const float4* ar4 = reinterpret_cast<const float4*>(zr_s + ql * kZStride + ty * kRowsPer);
      const float4* ai4 = reinterpret_cast<const float4*>(zi_s + ql * kZStride + ty * kRowsPer);
      const float4 r0 = ar4[0], r1 = ar4[1], i0 = ai4[0], i1 = ai4[1];
      const float ar[kRowsPer] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      const float ai[kRowsPer] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
      const float4 c4 = *reinterpret_cast<const float4*>(c_s + ql * kTileCh + tx * kChPer);
      const float4 s4 = *reinterpret_cast<const float4*>(s_s + ql * kTileCh + tx * kChPer);
      const float c[kChPer] = {c4.x, c4.y, c4.z, c4.w};
      const float s[kChPer] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kChPer; ++j) {
          yr[i][j] = fmaf(ar[i], c[j], yr[i][j]);
          yr[i][j] = fmaf(-ai[i], s[j], yr[i][j]);
          yi[i][j] = fmaf(ar[i], s[j], yi[i][j]);
          yi[i][j] = fmaf(ai[i], c[j], yi[i][j]);
        }
    }
  }
  const int mt = m0 + tx * kChPer;
  const bool vec = (M % 4 == 0) && (mt + kChPer <= M);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const long long u = u0 + ty * kRowsPer + i;
    if (u >= U) continue;
    float* row = y + u * 2 * M;
    if (vec) {
      *reinterpret_cast<float4*>(row + mt) =
          make_float4(yr[i][0], yr[i][1], yr[i][2], yr[i][3]);
      *reinterpret_cast<float4*>(row + M + mt) =
          make_float4(yi[i][0], yi[i][1], yi[i][2], yi[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kChPer; ++j) {
        if (mt + j < M) {
          row[mt + j] = yr[i][j];
          row[M + mt + j] = yi[i][j];
        }
      }
    }
  }
}

}  // namespace

// K5.  x (U, 2M) and tail (K, 2M): complex64 rows read as interleaved f32;
// h (K+1, 2M) f32 (pfb_frontend_taps); z (U, 2M) f32.  Contiguous, on card
// `device`.  Launches on `stream`, does not synchronise, returns the
// launch's cudaError_t.
extern "C" int pfb_frontend_launch(const float* x, const float* tail,
                                   const float* h, float* z, long long U,
                                   int M, int K, int device,
                                   cudaStream_t stream) {
  if (U <= 0 || M <= 0 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int lanes = 2 * M;
  const int threads = 128;
  const dim3 grid((lanes + threads - 1) / threads,
                  (unsigned)((U + kFrontRows - 1) / kFrontRows));
  if (K <= kHalo)
    pfb_frontend_kernel<<<grid, threads, 0, stream>>>(x, tail, h, z, U, lanes, K);
  else
    pfb_frontend_long_kernel<<<grid, threads, 0, stream>>>(x, tail, h, z, U,
                                                           lanes, K);
  return (int)cudaGetLastError();
}

// K4.  xf (2, U, M) f32 planes; tail (2, 8, M) f32 carried rows; hp (K+1, M)
// f32 with K <= 8; bank (M, 2M) f32 [C | S] (bf16-rounded values for
// "fast"); y (U, 2M) f32.  round_z = 1 rounds the branch products to bf16
// ("fast").  Contiguous, on card `device`.  Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" int chan_fused_launch(const float* xf, const float* tail,
                                 const float* hp, const float* bank, float* y,
                                 long long U, int M, int K, int round_z,
                                 int device, cudaStream_t stream) {
  if (U <= 0 || M <= 0 || K < 1 || K > kHalo) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const dim3 grid((M + kTileCh - 1) / kTileCh,
                  (unsigned)((U + kTileRows - 1) / kTileRows));
  chan_fused_kernel<<<grid, kThreads, 0, stream>>>(xf, tail, hp, bank, y, U, M,
                                                   K, round_z);
  return (int)cudaGetLastError();
}
