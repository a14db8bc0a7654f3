// What S4's chunk-and-join entries share (track_chunks.cu: the LTI and
// backward entries; track_forward.cu: the forward entry): rounded
// arithmetic, a launch's shape and its checks, cp.async staging, the
// kernels' solve and the dynamic shared memory limit.

#pragma once

#include <cuda_runtime.h>

namespace {

// Every operation rounded on its own (nvcc contracts nothing into an FMA),
// so that a chunk's walk is the plain version's bit for bit.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }

// A state (x, P) of N + N^2 values, as the joins write it.
__host__ __device__ constexpr int state_size(int N) { return N * N + N; }

// One launch's shape: L lanes of T steps, chunks of Lc steps (a power of
// two), nc chunks in ng groups of a block's chunks; pass 2's 2^tl threads a
// lane, each a run of 2^rl groups.
struct Geo {
  long long T;
  int L, Lc, nc, ng, tl, rl;
};

// The arguments every entry checks: L lanes in 1 .. 65535, Lc a power of
// two, 2^tl <= the pass-2 threads, rl >= 0, and nc, ng those of T.
inline bool bad_geometry(long long T, int L, int Lc, int nc, int ng, int cb, int tl, int rl,
                         int join_max) {
  if (T <= 0 || L <= 0 || L > 65535 || Lc <= 0 || (Lc & (Lc - 1)) || tl < 0 ||
      (1 << tl) > join_max || rl < 0 || rl > 30 || nc <= 0 || ng <= 0)
    return true;
  return ng != (nc + cb - 1) / cb;
}

template <typename R>
__device__ __forceinline__ void copy_async(R* dst, const R* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"((int)sizeof(R))
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}
// wait until at most `Pending` of this thread's newest copy groups are
// still in flight
template <int Pending>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(Pending) : "memory");
#endif
}

// An (RP x CP) matrix of device memory, row-major, into registers.
template <typename R, int RP, int CP>
__device__ __forceinline__ void load_f(R (&F)[RP][CP], const R* __restrict__ Fm) {
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) F[i][j] = Fm[i * CP + j];
}

// Y <- M^-1 Y for M (MP x MP) symmetric positive definite and Y (MP x NP):
// forward elimination without pivoting, then back substitution; M is
// overwritten.
template <typename R, int MP, int NP>
__device__ __forceinline__ void spd_solve(R (&M)[MP][MP], R (&Y)[MP][NP]) {
#pragma unroll
  for (int k = 0; k < MP; ++k) {
    const R inv = quot(R(1), M[k][k]);
#pragma unroll
    for (int i = k + 1; i < MP; ++i) {
      const R f = mul(M[i][k], inv);
#pragma unroll
      for (int j = k; j < MP; ++j) M[i][j] = sub(M[i][j], mul(f, M[k][j]));
#pragma unroll
      for (int j = 0; j < NP; ++j) Y[i][j] = sub(Y[i][j], mul(f, Y[k][j]));
    }
  }
#pragma unroll
  for (int k = MP - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      R s = Y[k][j];
#pragma unroll
      for (int l = k + 1; l < MP; ++l) s = sub(s, mul(M[k][l], Y[l][j]));
      Y[k][j] = quot(s, M[k][k]);
    }
  }
}

// Raise a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
