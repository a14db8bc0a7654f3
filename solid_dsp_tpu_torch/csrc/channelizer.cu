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
// at M = 256, U = 16384) against 2 * 16 bytes a frame sample of memory; on
// the CUDA cores (FP32 FMA, the earlier design) it cannot go below 0.128 ms,
// so the product runs on the tensor cores with the TPU kernel's own
// arithmetic (pallas_kernels.py:360-374): "x3" is three bf16 products with
// FP32 accumulation, zh.Bh + zl.Bh + zh.Bl (hi = bf16(a), lo = bf16(a -
// hi)), "fast" one, bf16(z).bf16(B).
//
// Design (chan_fused_kernel): one block of two warpgroups owns 128 rows u
// x 256 output columns; the columns interleave re and im, n = 2 m + (0 | 1),
// so a thread's accumulator pair is one complex channel output, and the
// depth (K of the product) runs over 32-lane chunks c, plane c & 1 (zr, then
// zi) of lanes (c >> 1) * 32 .. +31.  Each warpgroup owns 64 rows: for each
// chunk it computes the (K+1)-tap branch filter in FP32 (one lane and 16
// rows a thread, tap 0 first, both planes of a lane group at once, from
// frame rows that TMA tile loads through tensor maps bring into shared
// memory two groups ahead), splits z into bf16 hi and lo and stores them
// in wgmma's K-major core-matrix layout, then runs wgmma m64n256k16 (A and
// B from shared memory) on them, and builds the next chunk's A while the
// tensor cores run.  One thread brings the bank
// tiles (host-packed in the same layout, hi and lo: chan_bank_tiles) with
// one TMA bulk copy a chunk, two chunks ahead, into a ring of kChanStages
// stages with full/empty mbarriers.  The A core matrices sit 144 bytes
// apart along K (not 128), so the 2-byte stores of one row hit four
// different bank groups.  The 64 x 256 sums stay in registers; at the end
// they are staged in shared memory as rows of y and stored 16 bytes a
// thread, masked past U and M.  The branch filter is recomputed for each
// 256-column tile (twice at M = 256).  Every M works: lanes past M and
// columns past 2M are zero in the packed bank and masked at the store; with
// M % 4 != 0 (rows not 16-byte aligned) the frame rows come by plain loads
// and the sums go straight from registers to y.  Frame rows by per-thread
// copies (cp.async, or loads) stalled the computing warps on the memory
// system and by per-row bulk copies on the TMA unit's issue rate; one tile
// load a plane and group does neither.  What holds it at M = 256 (PERF.md):
// the branch filter and its bf16 split on two warpgroups, with the wgmma
// hidden under them, not the tensor cores.
//
// Layouts, a template parameter: planar xf (2, U, M) f32 -> (U, 2M) f32, the
// JAX kernel's contract, or complex64 x (U, M) -> (U, M) complex64 with no
// split or merge pass around the kernel.  The carried tail rows are (2, 8, M)
// planar f32 in both.  Both layouts run the same arithmetic on the same
// values, so they are bit-equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
constexpr int kChanRows = 128;            // rows u a block (two warpgroups)
constexpr int kChanCols = 256;            // output columns a block
constexpr int kChunk = 32;                // depth a stage (lanes of a plane)
constexpr int kChanStages = 3;
constexpr int kXBufs = 2;                 // lane groups a warpgroup holds
constexpr int kWin = 16 + 8;              // rows of one thread's window
constexpr int kChanThreads = 256;         // two warpgroups
constexpr unsigned kBTile = kChanCols * kChunk * 2;     // one bf16 tile, 16 KB
constexpr unsigned kALbo = 144;           // A core matrices along K, bytes
constexpr unsigned kASbo = 4 * kALbo;     // A core matrices along rows
constexpr unsigned kARegion = 8 * kASbo;  // 64 rows x 32 lanes, one of hi/lo
constexpr unsigned kStageBytes = 2 * kBTile + 4 * kARegion;   // 51,200
constexpr int kXRows = 64 + 8;            // a warpgroup's rows with the halo
constexpr unsigned kXRowBytes = 2 * kChunk * 4;   // both planes of 32 lanes
constexpr unsigned kXBufBytes = kXRows * kXRowBytes;
constexpr unsigned kOutStride = 2 * 128 * 4 + 16;   // a staged output row
constexpr unsigned kTailBytes = 2 * 8 * kChunk * 4;   // the tail rows' planes
constexpr int kChanSmem = kChanStages * kStageBytes + 2 * kXBufs * kXBufBytes +
                          kXBufs * kTailBytes + (2 * kChanStages + 2 * kXBufs) * 8;

// 2-D / 3-D TMA tile loads through a tensor map (a kernel parameter).
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// d (64 x 256 f32 of this warpgroup) += A (64 x 16 bf16) . B (16 x 256).
__device__ __forceinline__ void wgmma_256(float (&d)[128],
                                          unsigned long long da,
                                          unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <bool kX3, bool kComplex>
__global__ void __launch_bounds__(kChanThreads, 1)
chan_fused_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                  const float* __restrict__ hp,
                  const unsigned short* __restrict__ tiles,
                  float* __restrict__ y, long long U, int M, int K,
                  int n_chunks, int aligned,
                  const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* tailbuf = smem + kChanStages * kStageBytes + 2 * kXBufs * kXBufBytes;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      tailbuf + kXBufs * kTailBytes);
  unsigned long long* empty = full + kChanStages;
  unsigned long long* xfull = empty + kChanStages;   // [warpgroup][buffer]
  const int cw = threadIdx.x / 128;           // warpgroup: rows cw*64 .. +63
  const int tid = threadIdx.x & 127;
  const int ql = tid & 31;                    // lane within a 32-lane group
  const int rg = tid >> 5;                    // rows rg*16 .. +15 of the 64
  const long long u0 = (long long)blockIdx.y * kChanRows;
  const long long uw = u0 + cw * 64;          // this warpgroup's first row
  const int nt = blockIdx.x;                  // column tile
  const unsigned b_bytes = kX3 ? 2 * kBTile : kBTile;
  const unsigned smem0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned char* xbuf = smem + kChanStages * kStageBytes + cw * kXBufs * kXBufBytes;
  const long long plane = U * (long long)M;
  const int groups = n_chunks / 2;            // 32-lane groups, two planes each
  const bool lead = threadIdx.x == 0;         // issues the bank tiles

  if (lead) {
    for (int s = 0; s < kChanStages; ++s) {
      mbar_init(smem_addr(full + s), 1);      // the tile's copy
      mbar_init(smem_addr(empty + s), 2);     // one arrival a warpgroup
    }
    for (int b = 0; b < 2 * kXBufs; ++b) mbar_init(smem_addr(xfull + b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue_tile = [&](int c) {              // bank tile c into stage c % S
    const int s = c % kChanStages;
    mbar_expect_tx(smem_addr(full + s), b_bytes);
    bulk_load(smem0 + s * kStageBytes,
              tiles + ((long long)nt * n_chunks + c) * (b_bytes / 2), b_bytes,
              smem_addr(full + s));
  };
  if (lead)
    for (int c = 0; c < kChanStages - 1 && c < n_chunks; ++c) issue_tile(c);

  // Lane group g's rows uw - 8 .. uw + 63 of this warpgroup, both planes,
  // into its buffer b: [plane][row j][32 lanes] (128-byte rows) from the
  // planar input, [row j][(re, im) x 32] (256-byte rows) from complex
  // input; zero past U and M.  With M % 4 == 0 (aligned) by TMA tile loads
  // through tensor maps (one a plane, or one for complex rows), issued by
  // one thread two groups ahead and counted on xfull; rows before the block
  // (the first warpgroup of the first rows) come from the tail rows into
  // tailbuf[b] as [plane][8][32].  Else by plain loads and stores, tail
  // rows in place, when the group is needed.
  auto fill = [&](int g, int b) {
    const int q0 = g * kChunk;
    unsigned char* buf = xbuf + b * kXBufBytes;
    if (g >= groups) return;
    if (aligned) {
      if (tid == 0) {
        const unsigned bar = smem_addr(xfull + cw * kXBufs + b);
        const bool tl = uw == 0;
        mbar_expect_tx(bar, kXBufBytes + (tl ? kTailBytes : 0));
        if (kComplex) {
          tma_load_2d(smem_addr(buf), &xmap, 2 * q0, (int)(uw - kHalo), bar);
        } else {
          for (int p = 0; p < 2; ++p)
            tma_load_3d(smem_addr(buf + p * (kXBufBytes / 2)), &xmap, q0,
                        (int)(uw - kHalo), p, bar);
        }
        if (tl)
          for (int p = 0; p < 2; ++p)
            tma_load_3d(smem_addr(tailbuf + b * kTailBytes + p * (kTailBytes / 2)),
                        &tmap, q0, 0, p, bar);
      }
    } else {
      for (int e = tid; e < kXRows * 2 * kChunk; e += 128) {
        const int p = e / (kXRows * kChunk), j = (e / kChunk) % kXRows;
        const int l = e % kChunk;
        const long long r = uw - kHalo + j;
        const int q = q0 + l;
        float v = 0.f;
        if (q < M && r < U)
          v = r < 0 ? __ldg(tail + (p * kHalo + kHalo + r) * M + q)
              : kComplex ? __ldg(x + 2 * (r * M + q) + p)
                         : __ldg(x + p * plane + r * M + q);
        reinterpret_cast<float*>(buf + p * (kXBufBytes / 2))[j * kChunk + l] = v;
      }
    }
  };
  // frame row j (row uw - 8 + j) of lane ql, plane p, from buffer b
  auto x_at = [&](int b, int j, int p) -> float {
    const long long r = uw - kHalo + j;
    const unsigned char* buf = xbuf + b * kXBufBytes;
    if (aligned && r < 0)
      return reinterpret_cast<const float*>(
          tailbuf + b * kTailBytes + p * (kTailBytes / 2))[(j) * kChunk + ql];
    if (kComplex && aligned)
      return reinterpret_cast<const float*>(buf)[j * 2 * kChunk + 2 * ql + p];
    return reinterpret_cast<const float*>(buf + p * (kXBufBytes / 2))[j * kChunk + ql];
  };

  // A of chunk c (this warpgroup's 64 rows x 32 lanes of plane c & 1) into
  // stage c % S, with the bf16 split.  At the first chunk of lane group g
  // both planes' branch filters run in FP32 (one lane and 16 rows a
  // thread, tap 0 first) from g's frame rows, so that their buffer is free
  // at once for group g + 2's copies; plane 1's z waits in registers for
  // the next chunk, and meanwhile the next group's taps are loaded.
  float h[kHalo + 1], z1[16];
  auto load_taps = [&](int g) {
    const int q = g * kChunk + ql;
#pragma unroll
    for (int k = 0; k <= kHalo; ++k)
      h[k] = (q < M && k <= K && g < groups) ? __ldg(hp + k * M + q) : 0.f;
  };
  auto make_a = [&](int c) {
    const int g = c >> 1, p = c & 1;
    const int b = g % kXBufs;
    float z0[16];
    if (p == 0) {
      if (aligned) {
        mbar_wait(smem_addr(xfull + cw * kXBufs + b), (g / kXBufs) & 1);
      } else {
        fill(g, b);
        named_sync(1 + cw, 128);
      }
      // both planes' windows (one 8-byte read a row from complex rows)
      float win[2][kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const int j = rg * 16 + i;
        if (kComplex && aligned && uw - kHalo + j >= 0) {
          const float2 v = reinterpret_cast<const float2*>(
              xbuf + b * kXBufBytes)[j * kChunk + ql];
          win[0][i] = v.x;
          win[1][i] = v.y;
        } else {
          win[0][i] = x_at(b, j, 0);
          win[1][i] = x_at(b, j, 1);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k <= kHalo; ++k) {
          a0 = fmaf(h[k], win[0][kHalo + i - k], a0);
          a1 = fmaf(h[k], win[1][kHalo + i - k], a1);
        }
        z0[i] = a0;
        z1[i] = a1;
      }
      named_sync(1 + cw, 128);                // buffer b is read
      if (aligned) fill(g + 2, b);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) z0[i] = z1[i];
      load_taps(g + 1);
    }
    // row rr = rg*16 + i of this warpgroup: core matrix (ql / 8, rr / 8),
    // row rr % 8
    unsigned char* a = smem + (c % kChanStages) * kStageBytes + 2 * kBTile +
                       cw * 2 * kARegion + (ql >> 3) * kALbo + (ql & 7) * 2;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int rr = rg * 16 + i;
      const __nv_bfloat16 hi = __float2bfloat16_rn(z0[i]);
      unsigned char* e = a + (rr >> 3) * kASbo + (rr & 7) * 16;
      *reinterpret_cast<__nv_bfloat16*>(e) = hi;
      if (kX3)
        *reinterpret_cast<__nv_bfloat16*>(e + kARegion) =
            __float2bfloat16_rn(z0[i] - __bfloat162float(hi));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + cw, 128);                  // A of chunk c is complete
  };

  if (aligned) {
    fill(0, 0);
    fill(1, 1);
  }
  load_taps(0);
  make_a(0);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kChanStages;
    mbar_wait(smem_addr(full + s), (c / kChanStages) & 1);
    const unsigned stage = smem0 + s * kStageBytes;
    const unsigned ah = stage + 2 * kBTile + cw * 2 * kARegion;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      const unsigned long long da = gmma_desc(ah + ks * 2 * kALbo, kALbo, kASbo);
      const unsigned long long db =
          gmma_desc(stage + ks * 2 * (kBTile / 4), kBTile / 4, 128);
      wgmma_256(d, da, db);
      if (kX3) {
        wgmma_256(d, gmma_desc(ah + kARegion + ks * 2 * kALbo, kALbo, kASbo), db);
        wgmma_256(d, da, gmma_desc(stage + kBTile + ks * 2 * (kBTile / 4),
                                   kBTile / 4, 128));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the next chunk's A while the tensor cores run this one (its stage
    // was last read by chunk c + 1 - S, complete since the last wait)
    if (c + 1 < n_chunks) make_a(c + 1);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (c > 0 && tid == 0) mbar_arrive(smem_addr(empty + (c - 1) % kChanStages));
    const int cn = c + kChanStages - 1;       // the tile into stage (c - 1) % S
    if (lead && cn < n_chunks) {
      if (c > 0)
        mbar_wait(smem_addr(empty + cn % kChanStages), ((c - 1) / kChanStages) & 1);
      issue_tile(cn);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

  // accumulator d[4i + 2h + e]: row 16 w + l/4 + 8h of this warpgroup,
  // column 8i + 2 (l % 4) + e, e = 0 re, 1 im of channel 4i + l % 4 of
  // the tile's 128
  const int w = tid >> 5, l = tid & 31;
  const int m0 = nt * (kChanCols / 2);
  const long long ur = uw + w * 16 + (l >> 2);
  if (aligned) {
    // stage the outputs as rows in the layout of y (the stages are free
    // once both warpgroups are done), then store them 16 bytes a thread
    named_sync(3, 256);
    unsigned char* out = smem + cw * 64 * kOutStride;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ml = 4 * i + (l & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* row = reinterpret_cast<float*>(
            out + (w * 16 + (l >> 2) + 8 * hh) * kOutStride);
        const float re = d[4 * i + 2 * hh], im = d[4 * i + 2 * hh + 1];
        if (kComplex) {
          reinterpret_cast<float2*>(row)[ml] = make_float2(re, im);
        } else {
          row[ml] = re;
          row[kChanCols / 2 + ml] = im;
        }
      }
    }
    named_sync(1 + cw, 128);
    // 16 bytes a thread, consecutive threads on consecutive bytes: row j,
    // piece k of 64 (planar: re 4 k .. of the first 32, then im)
    for (int e = tid; e < 64 * 64; e += 128) {
      const int j = e >> 6, k = e & 63;
      const long long u = uw + j;
      const float4 v = *reinterpret_cast<const float4*>(out + j * kOutStride + 16 * k);
      if (u >= U) continue;
      if (kComplex) {
        if (m0 + 2 * k < M)
          *reinterpret_cast<float4*>(y + 2 * (u * M + m0) + 4 * k) = v;
      } else {
        const int part = k >> 5, ml = 4 * (k & 31);
        if (m0 + ml < M)
          *reinterpret_cast<float4*>(y + u * 2 * M + part * M + m0 + ml) = v;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int m = m0 + 4 * i + (l & 3);
      if (m >= M) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long u = ur + 8 * hh;
        if (u >= U) continue;
        const float re = d[4 * i + 2 * hh], im = d[4 * i + 2 * hh + 1];
        if (kComplex) {
          reinterpret_cast<float2*>(y)[u * M + m] = make_float2(re, im);
        } else {
          y[u * 2 * M + m] = re;
          y[u * 2 * M + M + m] = im;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry points (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A float32 tiled tensor map, dims and box innermost first, strides in bytes
// (rank - 1 of them); elements outside the tensor read as zero.
bool make_map(CUtensorMap* map, const float* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                  const_cast<float*>(base), dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kX3, bool kComplex>
int chan_launch(const float* x, const float* tail, const float* hp,
                const unsigned short* tiles, float* y, long long U, int M,
                int K, cudaStream_t stream) {
  auto kernel = chan_fused_kernel<kX3, kComplex>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChanSmem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = 2 * ((M + kChunk - 1) / kChunk);
  const dim3 grid((2 * M + kChanCols - 1) / kChanCols,
                  (unsigned)((U + kChanRows - 1) / kChanRows));
  // tile loads and 16-byte stores need 16-byte-aligned rows
  int aligned = M % 4 == 0 &&
      !((reinterpret_cast<unsigned long long>(x) |
         reinterpret_cast<unsigned long long>(tail) |
         reinterpret_cast<unsigned long long>(y)) & 15);
  CUtensorMap xmap = {}, tmap = {};
  if (aligned) {
    const cuuint64_t m = M, u = U;
    const cuuint32_t rows = kXRows, lanes = kChunk;
    if (kComplex) {
      const cuuint64_t dims[2] = {2 * m, u}, strides[1] = {2 * m * 4};
      const cuuint32_t box[2] = {2 * lanes, rows};
      aligned = make_map(&xmap, x, 2, dims, strides, box);
    } else {
      const cuuint64_t dims[3] = {m, u, 2}, strides[2] = {m * 4, u * m * 4};
      const cuuint32_t box[3] = {lanes, rows, 1};
      aligned = make_map(&xmap, x, 3, dims, strides, box);
    }
    const cuuint64_t tdims[3] = {m, kHalo, 2}, tstrides[2] = {m * 4, kHalo * m * 4};
    const cuuint32_t tbox[3] = {lanes, kHalo, 1};
    if (aligned && !make_map(&tmap, tail, 3, tdims, tstrides, tbox))
      return (int)cudaErrorInvalidValue;
    if (!aligned) return (int)cudaErrorInvalidValue;
  }
  kernel<<<grid, kChanThreads, kChanSmem, stream>>>(
      x, tail, hp, tiles, y, U, M, K, n_chunks, aligned, xmap, tmap);
  return (int)cudaGetLastError();
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

// K4.  x: planar (2, U, M) f32 (complex = 0) or complex64 (U, M) read as f32
// pairs (complex = 1); tail (2, 8, M) f32 carried rows; hp (K+1, M) f32
// with K <= 8; tiles: the bank packed by ops/cuda_chan.py::chan_bank_tiles
// (bf16 bits; hi then lo tiles for x3 = 1, hi only for x3 = 0); y (U, 2M)
// f32 [Re | Im] (planar) or complex64 (U, M).  Contiguous, on card
// `device`, tiles 16-byte aligned.  Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" int chan_fused_launch(const float* x, const float* tail,
                                 const float* hp, const unsigned short* tiles,
                                 float* y, long long U, int M, int K, int x3,
                                 int complex_layout, int device,
                                 cudaStream_t stream) {
  if (U <= 0 || U > 0x7fffffffLL * kChanRows || M <= 0 || K < 1 ||
      K > kHalo || (reinterpret_cast<unsigned long long>(tiles) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (x3)
    return complex_layout ? chan_launch<true, true>(x, tail, hp, tiles, y, U, M, K, stream)
                          : chan_launch<true, false>(x, tail, hp, tiles, y, U, M, K, stream);
  return complex_layout ? chan_launch<false, true>(x, tail, hp, tiles, y, U, M, K, stream)
                        : chan_launch<false, false>(x, tail, hp, tiles, y, U, M, K, stream);
}
