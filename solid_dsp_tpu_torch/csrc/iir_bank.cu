// Multi-channel IIR biquad-cascade bank for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_kernels.py::iir_bank_apply
// (K6, kernel body _iir_bank_kernel).  For every real lane l of the
// (T, 2C) block (complex64 channels as interleaved re/im lanes; the real
// coefficients act on both alike) and every section s, direct form II:
//
//   w0 = v - a1[s] w1[s] - a2[s] w2[s]
//   v  = b0[s] w0 + b1[s] w1[s] + b2[s] w2[s]
//   (w2[s], w1[s]) <- (w1[s], w0)
//
// with the state (2S, 2C) rows [w1_0, w2_0, w1_1, ...] carried in from the
// previous block and written out after row T-1.  Any T; no tiles.
//
// Bound: latency.  The recurrence is serial in time, so the work
// (9 S FLOPs a lane a row) and the bytes (16 a complex sample in and out)
// are both far below the card's rates; what costs is the chain of dependent
// operations per row, and with only 2C lanes of work (512 threads at
// C = 256) keeping enough reads in flight to cover memory latency.  Design:
//   * one thread per lane, its coefficients and its whole cascade state in
//     registers (S is a template parameter), nothing shared between threads;
//   * the terms that depend only on the state, a1 w1 + a2 w2 and
//     b1 w1 + b2 w2, are formed before the row's input arrives, so only two
//     dependent operations per section (w0, then v) sit on the chain;
//   * one warp a block, and each thread streams its lane through a ring of
//     shared memory with asynchronous copies (cp.async): 8 stages of 32 rows,
//     7 stages in flight while one is filtered, so the chain never waits on
//     device memory; loads and stores are coalesced along the lanes.
// A time-parallel form (chunked recurrences joined by a scan of the
// state-transition matrices) is later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;          // rows a stage
constexpr int kStages = 8;         // stages of the ring
constexpr int kThreads = 32;       // one warp: 32 lanes a block

template <int S>
__global__ void __launch_bounds__(kThreads)
iir_bank_kernel(const float* __restrict__ x, const float* __restrict__ sos,
                const float* __restrict__ st_in, float* __restrict__ y,
                float* __restrict__ st_out, long long T, int lanes) {
  __shared__ float ring[kStages * kRows * kThreads];    // [stage][row][lane]
  const int lt = threadIdx.x;
  const int l = blockIdx.x * kThreads + lt;
  if (l >= lanes) return;            // no block-wide barrier below
  float b0[S], b1[S], b2[S], a1[S], a2[S], w1[S], w2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = sos[(s * 5 + 0) * lanes + l];
    b1[s] = sos[(s * 5 + 1) * lanes + l];
    b2[s] = sos[(s * 5 + 2) * lanes + l];
    a1[s] = sos[(s * 5 + 3) * lanes + l];
    a2[s] = sos[(s * 5 + 4) * lanes + l];
    w1[s] = st_in[(2 * s) * lanes + l];
    w2[s] = st_in[(2 * s + 1) * lanes + l];
  }
  const long long n_stages = (T + kRows - 1) / kRows;
  // Each thread copies and reads only its own lane's column of the ring,
  // so no thread waits for another.
  auto issue = [&](long long g) {
    if (g < n_stages) {
      float* dst = ring + (g % kStages) * kRows * kThreads + lt;
      const long long t0 = g * kRows;
      for (int r = 0; r < kRows && t0 + r < T; ++r)
        __pipeline_memcpy_async(dst + r * kThreads, x + (t0 + r) * lanes + l,
                                sizeof(float));
    }
    __pipeline_commit();
  };
  for (int g = 0; g < kStages - 1; ++g) issue(g);
  for (long long g = 0; g < n_stages; ++g) {
    issue(g + kStages - 1);          // refills the slot stage g - 1 used
    __pipeline_wait_prior(kStages - 1);
    const float* src = ring + (g % kStages) * kRows * kThreads + lt;
    const long long t0 = g * kRows;
    const int rows = T - t0 < kRows ? (int)(T - t0) : kRows;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float v = src[r * kThreads];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float fb = fmaf(a2[s], w2[s], a1[s] * w1[s]);
        const float ff = fmaf(b2[s], w2[s], b1[s] * w1[s]);
        const float w0 = v - fb;
        v = fmaf(b0[s], w0, ff);
        w2[s] = w1[s];
        w1[s] = w0;
      }
      y[(t0 + r) * lanes + l] = v;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    st_out[(2 * s) * lanes + l] = w1[s];
    st_out[(2 * s + 1) * lanes + l] = w2[s];
  }
}

template <int S>
int launch(const float* x, const float* sos, const float* st_in, float* y,
           float* st_out, long long T, int lanes, cudaStream_t stream) {
  const unsigned blocks = (lanes + kThreads - 1) / kThreads;
  iir_bank_kernel<S><<<blocks, kThreads, 0, stream>>>(x, sos, st_in, y, st_out,
                                                       T, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// x (T, 2C) and y (T, 2C): complex64 (T, C) read and written as interleaved
// f32; sos (5S, 2C) f32, row 5s + k holding coefficient k (b0 b1 b2 a1 a2)
// of section s for every lane; st_in and st_out (2S, 2C) f32.  1 <= S <= 8,
// any T >= 0.  Contiguous, on card `device`.  Launches on `stream`, does not
// synchronise, returns the launch's cudaError_t.
extern "C" int iir_bank_launch(const float* x, const float* sos,
                               const float* st_in, float* y, float* st_out,
                               long long T, int C, int S, int device,
                               cudaStream_t stream) {
  if (T < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int lanes = 2 * C;
  switch (S) {
    case 1: return launch<1>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 2: return launch<2>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 3: return launch<3>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 4: return launch<4>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 5: return launch<5>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 6: return launch<6>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 7: return launch<7>(x, sos, st_in, y, st_out, T, lanes, stream);
    case 8: return launch<8>(x, sos, st_in, y, st_out, T, lanes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
