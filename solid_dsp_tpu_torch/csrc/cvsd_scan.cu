// S8: the CVSD codec's walk (continuously variable slope delta, one bit a
// sample) for Hopper (sm_90a), both directions in one source: cvsd_encode
// (x -> bits) and cvsd_decode (bits -> the reference trajectory).
//
// It replaces no TPU kernel: in the JAX package each direction is a
// lax.scan, solid_dsp_tpu/models/cvsd.py:86 (encode) and :119 (decode).
// PyTorch has no scan, and a per-sample recurrence in eager torch ops costs
// about a dozen launches a sample (the plain version,
// models/cvsd.py::cvsd_walk_plain), so the walk is one kernel here.
//
// Bound: latency.  Each sample's bit feeds the step size and the reference
// that the next sample is compared with, so a lane is one dependent chain
// of a compare, the history word's update, two FMULs, two FADDs and four
// clamps a sample, whatever the card's width; the bytes (4 in and 4 out a
// sample) would take 3.35 TB/s far less time.  Lanes (rows of the flattened
// leading axes) are independent: one thread walks one lane.
//
// Design: a block is one warp and 32 lanes.  A lane's samples are
// contiguous in memory, so the threads of a warp walking their own lanes
// would read 32 rows a step, uncoalesced.  Instead each chunk of CH = 32
// samples of the block's 32 lanes is loaded row by row (a warp's load is 32
// consecutive words of one lane: 128 bytes), kept in registers, put into
// shared memory (rows padded to 33 words, so the walk's reads are free of
// bank conflicts) and read into registers before the walk; the next chunk's
// loads are issued before the current chunk's walk, so their latency hides
// behind its 32 dependent steps.  The outputs go to shared memory and leave
// row by row, coalesced, after the chunk.  Full chunks are walked without
// guards.
//
// Arithmetic: the plain version's float operations in its order, with the
// _rn intrinsics so that nvcc contracts none into an FMA: step' =
// clamp(beta * step + (agree ? gamma : 0), dmin, dmax); ref' = clamp(leak *
// ref + (bit ? step' : -step'), -1, 1).  The last n_history bits (n_history
// <= 32) are a word, starting as zeros as JAX's history does; they agree
// when the word is all zeros or all ones under its mask.  So S8 is
// bit-equal to the plain version.
//
// Entry points (each returns the launch's cudaError_t):
//   cvsd_encode_f32: x (B, N) float32 -> bits (B, N) int32
//   cvsd_decode_f32: bits (B, N) int32 (0 or 1) -> y (B, N) float32

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;   // a block: one warp, a thread a lane
constexpr int CH = 32;      // samples a chunk
constexpr int PAD = CH + 1;

struct Params {
  float beta, gamma, dmin, dmax, leak;
  unsigned mask;            // (1 << n_history) - 1
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One step of the walk on lane state (ref, step, hist) given this sample's
// bit; returns nothing, updates in place.
__device__ __forceinline__ void cvsd_step(unsigned bit, float& ref,
                                          float& step, unsigned& hist,
                                          const Params& p) {
  hist = ((hist << 1) | bit) & p.mask;
  const bool agree = (hist == 0u) | (hist == p.mask);
  step = clampf(__fadd_rn(__fmul_rn(p.beta, step), agree ? p.gamma : 0.0f),
                p.dmin, p.dmax);
  ref = clampf(__fadd_rn(__fmul_rn(p.leak, ref), bit ? step : -step), -1.0f,
               1.0f);
}

// Encode: the input word is x's float bits, the output the bit; decode: the
// input is the bit, the output ref's float bits.
template <bool ENCODE>
__device__ __forceinline__ unsigned walk_one(unsigned v, float& ref,
                                             float& step, unsigned& hist,
                                             const Params& p) {
  if (ENCODE) {
    const unsigned bit = __uint_as_float(v) >= ref ? 1u : 0u;
    cvsd_step(bit, ref, step, hist, p);
    return bit;
  }
  cvsd_step(v == 1u ? 1u : 0u, ref, step, hist, p);
  return __float_as_uint(ref);
}

template <bool ENCODE>
__global__ void __launch_bounds__(LANES)
cvsd_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out,
            int B, long long N, Params p) {
  __shared__ unsigned s_in[LANES][PAD];
  __shared__ unsigned s_out[LANES][PAD];
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * LANES;
  const int nl = min(LANES, B - lane0);
  const unsigned* src = in + (long long)lane0 * N;
  unsigned* dst = out + (long long)lane0 * N;
  float ref = 0.0f, step = p.dmin;
  unsigned hist = 0u;
  unsigned nxt[LANES];
  // row r's sample c0 + t of a chunk, for every row of the block
  auto load = [&](long long c0) {
    const long long j = c0 + t;
#pragma unroll
    for (int r = 0; r < LANES; ++r)
      nxt[r] = (r < nl && j < N) ? src[(long long)r * N + j] : 0u;
  };
  load(0);
  for (long long c0 = 0; c0 < N; c0 += CH) {
#pragma unroll
    for (int r = 0; r < LANES; ++r) s_in[r][t] = nxt[r];
    __syncwarp();
    if (c0 + CH < N) load(c0 + CH);   // in flight during this chunk's walk
    if (t < nl) {
      if (c0 + CH <= N) {
        // the chunk's inputs into registers first: a shared read issued
        // between two steps would sit on the chain (after the previous
        // step's store), one read latency a step
        unsigned v[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) v[j] = s_in[t][j];
#pragma unroll
        for (int j = 0; j < CH; ++j)
          v[j] = walk_one<ENCODE>(v[j], ref, step, hist, p);
#pragma unroll
        for (int j = 0; j < CH; ++j) s_out[t][j] = v[j];
      } else {
        const int len = (int)(N - c0);
        for (int j = 0; j < len; ++j)
          s_out[t][j] = walk_one<ENCODE>(s_in[t][j], ref, step, hist, p);
      }
    }
    __syncwarp();
    if (c0 + t < N) {
      for (int r = 0; r < nl; ++r) dst[(long long)r * N + c0 + t] = s_out[r][t];
    }
    __syncwarp();
  }
}

template <bool ENCODE>
int launch(const void* in, void* out, int B, long long N, float beta,
           float gamma, float dmin, float dmax, float leak, unsigned mask,
           cudaStream_t stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const Params p{beta, gamma, dmin, dmax, leak, mask};
  cvsd_kernel<ENCODE><<<(B + LANES - 1) / LANES, LANES, 0, stream>>>(
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out), B, N, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cvsd_encode_f32(const void* x, void* bits, int B,
                               long long N, float beta, float gamma,
                               float dmin, float dmax, float leak,
                               unsigned mask, void* stream) {
  return launch<true>(x, bits, B, N, beta, gamma, dmin, dmax, leak, mask,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int cvsd_decode_f32(const void* bits, void* y, int B,
                               long long N, float beta, float gamma,
                               float dmin, float dmax, float leak,
                               unsigned mask, void* stream) {
  return launch<false>(bits, y, B, N, beta, gamma, dmin, dmax, leak, mask,
                       static_cast<cudaStream_t>(stream));
}
