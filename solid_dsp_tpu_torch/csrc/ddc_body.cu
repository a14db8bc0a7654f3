// Unrotated DDC body for Hopper (sm_90a): K2 and K3 on TF32 tensor cores.
//
// Replaces two TPU kernels of solid_dsp_tpu/ops/pallas_ddc.py:
//   * make_pallas_ddc_full (K2, kernel body _make_kernel_full): the body of
//     a block whose length is a multiple of 64*M, tail row included;
//   * make_pallas_ddc_body (K3, kernel body _make_kernel): the same body
//     over the interior of any other block.  K3 exists on the TPU because
//     a sliced Pallas operand costs a full copy there; this kernel reads
//     any block length and the carried tail in place, so K3's counterpart
//     is this kernel launched on an unaligned block (ops/cuda_ddc.py counts
//     the two routes apart).
//
// For the planar (2, L) f32 block x, the carried tail x[-D .. -1]
// (D = n - M) and the complex NCO-folded bandpass taps h it computes, for
// every decimated output t = 0 .. T-1 (T = L / M, any L that M divides),
//
//   z[t] = sum_i h[i] * x[t*M - D + i]
//
// and writes z as (2, T) f32 [re row; im row].  The caller rotates z at
// the decimated rate, or feeds it to a rotation-invariant epilogue; energy
// and the last sample are torch reductions in the glue (ops/ddc.py).
//
// Bound: bytes (8 a sample in, 8 an output out: 0.050 ms at L = 2^24 on an
// H100 SXM).  The earlier design (FP32 FMA fed from shared memory, two
// shared loads for four FMAs) ran at 30 % of it, held by shared-memory
// bandwidth.  Design: a banded-Toeplitz frame product on the tensor cores,
// as the TPU kernel's, in TF32 x3 (hi = tf32(a), lo = a - hi read as TF32;
// the product hi.hi + lo.hi + hi.lo with f32 sums keeps ~21 mantissa bits,
// the x3 / "highest" contract; the samples' split is integer arithmetic,
// since cvt.rna.tf32 runs on the quarter-rate conversion unit):
//   * frames of hop = P*M samples, P outputs each; frame f's outputs read
//     the window x[f*hop - hpad .. f*hop - hpad + KP), hpad = D rounded up
//     to 4, KP = hpad + hop rounded up to 32, so z[f, :] = window . B with
//     the banded bank B (KP x 2P per plane, [re | im] columns) and the
//     planes summed along K.  P is the smallest power of two >= 4 with
//     hop >= 64 (P = 16 at M = 4), or less where the bank and stages do not
//     fit shared memory: fewer outputs a frame cost fewer FLOPs a sample
//     (24 P KP / hop: 768 at n = 64, M = 4, 0.026 ms of TF32 at 2^24);
//   * wgmma m64nNk8 (N = 2P), A = 64 frames x 8 window samples from
//     registers (two fragment sets: a group of 4 k-steps is split while
//     the previous group's products run, and a set is rebuilt only after
//     the wait that covers its group; without that, reused registers
//     corrupted products in flight), B = the bank from shared memory:
//     split into hi and lo on
//     the host from float64 taps, packed in wgmma's K-major core-matrix
//     layout (ops/cuda_ddc.py::body_tc_bank) and brought in once a block
//     by one TMA bulk copy;
//   * the window samples of K are permuted (host bank and kernel alike) so
//     that each thread reads its A fragments of two k-steps as one 16-byte
//     shared load of four neighbouring samples, and threads of odd rows
//     take the two halves of 32 samples in the other order, so a
//     quarter-warp's loads hit 32 different banks when hop is a multiple
//     of 32 words;
//   * persistent blocks of one or two warpgroups; each warpgroup owns tiles
//     of 64 frames (its 64 x 2P sums in registers) and a ring of two stages
//     in shared memory (one where two do not fit: large M), each the tile's
//     span of both planes, brought by one TMA bulk copy a plane while the
//     previous tile is computed, and released for the tile after next as
//     soon as its fragments are in registers.  A span
//     that starts off a 16-byte boundary (an odd plane offset) is copied
//     from the next aligned sample; the threads fill the few samples before
//     it, the carried tail, the zeros before the tail and past the block
//     (short blocks and the last, partial tile), then the warpgroup reads
//     with 4-byte loads instead of 16-byte ones when a plane is unaligned;
//   * outputs past T are not stored, so any L that M divides works, L
//     shorter than the filter included.
// What holds it (PERF.md): the tensor cores' TF32 rate at N = 32, about a
// third of the peak; P = 8 (N = 16) and one warpgroup a block are slower
// (torch_kernel_sweep.py), and so were a double-width hi.[hi | lo]
// product, a third fragment set in flight and paired 8-byte stores.  The
// banded bank's zero column blocks are a quarter of the products at
// n = 64, M = 4; skipping them by branching at run time to half-width
// products was slower, so the skip has to be fixed at compile time.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kFrames = 64;          // frames of a tile: wgmma's 64 rows

// d (64 x N f32 of this warpgroup) += A (64 x 8 tf32, registers) . B (8 x N
// tf32, shared memory descriptor b): wgmma m64nNk8, N = 2P.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const unsigned (&a)[4],
                                           unsigned long long b);
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// a rounded to TF32 (10 mantissa bits, ties away from zero): the result of
// cvt.rna.tf32.f32 for finite a, by integer operations at full rate (the
// conversion runs on the quarter-rate unit and held the kernel).
__device__ __forceinline__ unsigned tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// One value of the span: the block, the carried tail before it, zeros
// before the tail and past the block.
__device__ __forceinline__ float span_value(const float* __restrict__ xp,
                                            const float* __restrict__ tp,
                                            long long s, long long L, int D) {
  if (s >= 0) return s < L ? xp[s] : 0.f;
  return s >= -D ? tp[s + D] : 0.f;
}

struct Geom {
  long long L, T;
  int D, hpad, hop, KP, span, SP;  // SP: floats a plane of a stage
  int off[2];                      // float offset of each plane mod 4
};

// Copied part [c0, c1) of the span [s0, s1) of one plane: the aligned
// samples inside the block.
__device__ __forceinline__ void copied(const Geom& g, int p, long long s0,
                                       long long& c0, long long& c1) {
  const long long lo = s0 > 0 ? s0 : 0;
  const long long s1 = s0 + g.span;
  const long long hi = s1 < g.L ? s1 : g.L;
  c0 = lo + ((4 - ((g.off[p] + lo) & 3)) & 3);
  c1 = hi - ((g.off[p] + hi) & 3);
  if (c1 < c0) c1 = c0;
}

template <int P>
__global__ void __launch_bounds__(256, 1)
ddc_body_tc_kernel(const float* __restrict__ x, const float* __restrict__ tail,
                   const float* __restrict__ bank, float* __restrict__ z,
                   const Geom g, long long n_tiles, int wgs, int stages,
                   unsigned bank_bytes) {
  constexpr int N = 2 * P;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned sbase = smem_addr(smem);
  float* stage_mem = reinterpret_cast<float*>(smem + bank_bytes);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem + bank_bytes + (size_t)wgs * stages * 2 * g.SP * 4);
  // bars[0]: the bank; bars[1 + stages wg + stage]: a stage's span
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5, lane = tid & 31, r = lane >> 2, c = lane & 3;
  const float* planes[2] = {x, x + g.L};
  const float* tails[2] = {tail, tail + g.D};

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(bars), 1);
    for (int b = 0; b < stages * wgs; ++b) mbar_init(smem_addr(bars + 1 + b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(smem_addr(bars), bank_bytes);
    bulk_load(sbase, bank, bank_bytes, smem_addr(bars));
  }

  const long long first = (long long)blockIdx.x * wgs + wg;
  const long long stride = (long long)gridDim.x * wgs;
  float* my_stages = stage_mem + (size_t)wg * stages * 2 * g.SP;
  auto stage_plane = [&](int st, int p) { return my_stages + (st * 2 + p) * g.SP; };
  auto tile_start = [&](long long tau) {          // first sample of the span
    return tau * kFrames * g.hop - g.hpad;
  };
  // tile i of this warpgroup into stage i % stages (one thread)
  auto load_tile = [&](long long i) {
    const long long tau = first + i * stride;
    if (tau >= n_tiles) return;
    const int st = (int)(i % stages);
    const unsigned bar = smem_addr(bars + 1 + stages * wg + st);
    const long long s0 = tile_start(tau);
    long long c0[2], c1[2];
    unsigned bytes = 0;
    for (int p = 0; p < 2; ++p) {
      copied(g, p, s0, c0[p], c1[p]);
      bytes += (unsigned)(c1[p] - c0[p]) * 4u;
    }
    mbar_expect_tx(bar, bytes);
    for (int p = 0; p < 2; ++p)
      if (c1[p] > c0[p])
        bulk_load(smem_addr(stage_plane(st, p) + (c0[p] - s0 + g.off[p])),
                  planes[p] + c0[p], (unsigned)(c1[p] - c0[p]) * 4u, bar);
  };
  if (tid == 0)
    for (int i = 0; i < stages; ++i) load_tile(i);
  mbar_wait(smem_addr(bars), 0);                    // the bank is in

  const bool vec = g.off[0] == 0 && g.off[1] == 0;
  const int sw = (g.hop & 31) == 0 ? (r & 1) : 0;  // odd rows: halves swapped
  const int groups = g.KP / 32;                     // 4 k-steps each, a plane
  const unsigned ks_bytes = 32u * N;                // one k-step of the bank
  const unsigned n_steps = (unsigned)g.KP / 4;      // both planes
  for (long long i = 0; first + i * stride < n_tiles; ++i) {
    const long long tau = first + i * stride;
    const int st = (int)(i % stages);
    const long long s0 = tile_start(tau);
    mbar_wait(smem_addr(bars + 1 + stages * wg + st),
              (unsigned)((i / stages) & 1));
    // the span's samples no copy brought
    for (int p = 0; p < 2; ++p) {
      long long c0, c1;
      copied(g, p, s0, c0, c1);
      float* buf = stage_plane(st, p) + g.off[p];
      for (long long s = s0 + tid; s < c0; s += 128)
        buf[s - s0] = span_value(planes[p], tails[p], s, g.L, g.D);
      for (long long s = c1 + tid; s < s0 + g.span; s += 128)
        buf[s - s0] = span_value(planes[p], tails[p], s, g.L, g.D);
    }
    named_sync(1 + wg, 128);

    float acc[P];
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = 0.f;
    // A fragments of group q (4 k-steps of one plane), hi and lo, split
    // from the span: samples 32m .. 32m+15 (k-steps 4m, 4m+1) and
    // 32m+16 .. 32m+31 (4m+2, 4m+3) of rows r and r + 8
    auto build = [&](int q, unsigned (&a)[2][4][4]) {
      const int p = q / groups, m = q - p * groups;
      const float* row = stage_plane(st, p) + g.off[p] + (16 * w + r) * g.hop + 4 * c;
      const int ja = 32 * m + 16 * sw, jb = 32 * m + 16 * (1 - sw);
      const float4 u0 = load4(row + ja, vec), u1 = load4(row + jb, vec);
      const float4 v0 = load4(row + 8 * g.hop + ja, vec);
      const float4 v1 = load4(row + 8 * g.hop + jb, vec);
      const float4 ra = sw ? u1 : u0, rb = sw ? u0 : u1;
      const float4 sa = sw ? v1 : v0, sb = sw ? v0 : v1;
      const float vals[4][4] = {{ra.x, sa.x, ra.y, sa.y}, {ra.z, sa.z, ra.w, sa.w},
                                {rb.x, sb.x, rb.y, sb.y}, {rb.z, sb.z, rb.w, sb.w}};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[0][k][e] = tf32_rna(vals[k][e]);
          // lo = a - hi exactly; the tensor cores read its TF32 part (the
          // low 13 bits ignored), an error of 2^-21 |a| at most
          a[1][k][e] = __float_as_uint(vals[k][e] - __uint_as_float(a[0][k][e]));
        }
    };
    // group q's 12 products: hi.hi, lo.hi, hi.lo for each k-step
    auto mma = [&](int q, unsigned (&a)[2][4][4]) {
#pragma unroll
      for (int j = 0; j < P; ++j) fence_operand(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned step = (unsigned)q * 4 + k;
        const unsigned long long bh =
            gmma_desc(sbase + step * ks_bytes, 16 * N, 128);
        const unsigned long long bl =
            gmma_desc(sbase + (n_steps + step) * ks_bytes, 16 * N, 128);
        wgmma_tf32<N>(acc, a[0][k], bh);
        wgmma_tf32<N>(acc, a[1][k], bh);
        wgmma_tf32<N>(acc, a[0][k], bl);
      }
      wgmma_commit();
    };
    // keeps a fragment set's registers untouched until its products are done
    auto hold = [&](unsigned (&a)[2][4][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) fence_operand(a[h][k][e]);
    };
    // two fragment sets: group q is built while group q - 1's products run;
    // a set is rebuilt only after the wait that covers its last group
    unsigned fa[2][4][4], fb[2][4][4];
    const int nq = 2 * groups;
    build(0, fa);
    mma(0, fa);
    for (int q = 1; q < nq; q += 2) {
      build(q, fb);
      mma(q, fb);
      wgmma_wait<1>();                              // group q - 1 is done
      hold(fa);
      if (q + 1 < nq) {
        build(q + 1, fa);
        mma(q + 1, fa);
        wgmma_wait<1>();                            // group q is done
        hold(fb);
      }
    }
    // every fragment is in registers: the stage is free for the tile after
    // next while the last products run and the sums are stored
    named_sync(1 + wg, 128);
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(i + stages);
    }
    wgmma_wait<0>();
    hold(fa);
    hold(fb);
#pragma unroll
    for (int j = 0; j < P; ++j) fence_operand(acc[j]);
    // acc[4 j + 2 h + e]: frame row 16 w + r + 8 h, column 8 j + 2 c + e
#pragma unroll
    for (int j = 0; j < P / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          const int plane = col >= P;
          const long long t =
              (tau * kFrames + 16 * w + r + 8 * h) * P + (col - plane * P);
          if (t < g.T) z[plane * g.T + t] = acc[4 * j + 2 * h + e];
        }
  }
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

template <int P>
int launch(const float* x, const float* tail, const float* bank, float* z,
           const Geom& g, int wgs, int stages, unsigned bank_bytes, size_t smem,
           int device, cudaStream_t stream) {
  auto kernel = ddc_body_tc_kernel<P>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long frames = (g.T + P - 1) / P;
  const long long n_tiles = (frames + kFrames - 1) / kFrames;
  long long blocks = (n_tiles + wgs - 1) / wgs;
  if (blocks > sm_count(device)) blocks = sm_count(device);
  kernel<<<(unsigned)blocks, 128 * wgs, smem, stream>>>(x, tail, bank, z, g,
                                                         n_tiles, wgs, stages,
                                                         bank_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// x (2, L), tail (2, n - M), z (2, L / M) [re row; im row] f32; bank: the
// packed hi and lo banks of ops/cuda_ddc.py::body_tc_bank for frames of P
// outputs (2 * KP / 4 k-steps of 8 * 2P f32 each, 16-byte aligned), with
// hpad and KP of ops/cuda_ddc.py::body_tc_geometry; wgs warpgroups a block,
// stages span buffers a warpgroup and smem bytes of shared memory a block
// (the same function).  x and z
// 4-byte aligned, contiguous, on card `device`.  Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t.
extern "C" int ddc_body_launch(const float* x, const float* tail,
                               const float* bank, float* z, long long L, int n,
                               int M, int P, int hpad, int KP, int wgs,
                               int stages, int smem, int device,
                               cudaStream_t stream) {
  if (M <= 0 || n <= M || L <= 0 || L % M != 0 || hpad < n - M || hpad % 4 ||
      KP % 32 || KP < hpad + P * M || (wgs != 1 && wgs != 2) ||
      (stages != 1 && stages != 2) ||
      (reinterpret_cast<unsigned long long>(bank) & 15) ||
      (reinterpret_cast<unsigned long long>(x) & 3))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  Geom g;
  g.L = L;
  g.T = L / M;
  g.D = n - M;
  g.hpad = hpad;
  g.hop = P * M;
  g.KP = KP;
  g.span = (kFrames - 1) * g.hop + KP;
  g.SP = (g.span + 4 + 3) / 4 * 4;
  const unsigned long long xa = reinterpret_cast<unsigned long long>(x) >> 2;
  g.off[0] = (int)(xa & 3);
  g.off[1] = (int)((xa + (unsigned long long)L) & 3);
  const unsigned bank_bytes = (unsigned)(2 * (KP / 4) * 32 * 2 * P);
  const size_t need = bank_bytes + (size_t)wgs * stages * 2 * g.SP * 4 +
                      (1 + stages * wgs) * 8;
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 4: return launch<4>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 8: return launch<8>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 16: return launch<16>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 32: return launch<32>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    case 64: return launch<64>(x, tail, bank, z, g, wgs, stages, bank_bytes, smem, device,
                                stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
