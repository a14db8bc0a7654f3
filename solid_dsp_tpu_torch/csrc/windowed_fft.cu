// Windowed 4096-point FFT for Hopper (sm_90a): K7.
//
// Replaces the TPU kernel solid_dsp_tpu/ops/pallas_fft.py::
// make_fused_windowed_fft (kernel body _make_fft_kernel): each frame of F
// frames is multiplied by an analysis window and transformed,
//
//   Y[f, k] = sum_n w[n] x[f, n] e^{sign 2 pi i n k / 4096},
//
// unnormalized, in natural bin order.  Two layouts, a template parameter:
// planar (2, F, N) f32 planes in, (F, 2N) [Re | Im] rows out (the contract of
// windowed_fft_planar), or complex64 (F, N) in and out (windowed_fft).
//
// Bound: memory.  A frame is 32 KB in and 32 KB out against 5 N log2 N =
// 246 kFLOP, about 3.8 FLOP a byte, far below the card's FP32 ridge.  So the
// frame is read once, with the window applied at the load, and written once.
//
// Design: one thread block of 256 threads a frame, three radix-16 Stockham
// passes (N = 16^3).  Thread j owns butterfly j of each pass: it reads the 16
// points j + 256 r, applies the pass's twiddles, takes a 16-point DFT in
// registers (4 x 4 with the internal W16 twiddles) and writes its outputs at
// the Stockham positions, so that the last pass writes natural order.  Pass 1
// reads device memory and pass 3 writes it, both coalesced (consecutive
// threads on consecutive points); in between the frame lives in shared
// memory, one float2 of padding every 16 so that pass 1's stride-16 stores do
// not conflict (34,816 bytes).  The TPU kernel's 32 x 128 four-step, its
// block-diagonal stage-A bank and the transpose outside the kernel exist
// only for Mosaic's 128-lane rule and have no counterpart here.
//
// Accuracy: every twiddle, internal ones included, is read from a table
// tw[m] = e^{sign 2 pi i m / 4096} that the host builds in float64 and rounds
// to f32; the kernel forms each table index as an exact integer below 4096.
// No sin/cos runs on the device.  "x3" and "fast" both run this FP32
// arithmetic: the transform is bound by bytes, so a bf16 pass buys nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 4096;
constexpr int kThreads = kN / 16;          // butterflies a pass
constexpr int kPadded = kN + kN / 16;      // shared floats2 with padding

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (S i): the 4-point DFT's W4 = e^{S 2 pi i / 4}
template <int S>
__device__ __forceinline__ float2 rot(float2 a) {
  return S < 0 ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
}

template <int S>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = rot<S>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// In-place 16-point DFT, natural order in and out: n = 4 n1 + n2,
// k = k1 + 4 k2; w16[m] = W16^m for the products m = n2 k1 in 1..9.
template <int S>
__device__ __forceinline__ void dft16(float2 (&v)[16], const float2 (&w16)[10]) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4<S>(v[n2], v[4 + n2], v[8 + n2], v[12 + n2]);
  // v[4 k1 + n2] now holds the k1-th output of column n2
#pragma unroll
  for (int k1 = 1; k1 < 4; ++k1)
#pragma unroll
    for (int n2 = 1; n2 < 4; ++n2) v[4 * k1 + n2] = cmul(v[4 * k1 + n2], w16[n2 * k1]);
  float2 u[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 b0 = v[4 * k1], b1 = v[4 * k1 + 1], b2 = v[4 * k1 + 2], b3 = v[4 * k1 + 3];
    dft4<S>(b0, b1, b2, b3);
    u[k1] = b0;
    u[k1 + 4] = b1;
    u[k1 + 8] = b2;
    u[k1 + 12] = b3;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = u[r];
}

// One Stockham pass over shared memory with sub-transform size Ns (16 or
// 256): twiddle, 16-point DFT; the results stay in v.
template <int S, int Ns>
__device__ __forceinline__ void pass_from_shared(const float2* buf, int j,
                                                 const float2* __restrict__ tw,
                                                 const float2 (&w16)[10],
                                                 float2 (&v)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = buf[pad(j + r * kThreads)];
  const int step = (j % Ns) * (kN / (16 * Ns));
#pragma unroll
  for (int r = 1; r < 16; ++r) v[r] = cmul(v[r], __ldg(tw + step * r));
  dft16<S>(v, w16);
}

// x: planar (2, F, N) or complex (F, N) as float2; w (N,) window; tw (N,)
// float2 table; y: planar (F, 2N) [Re | Im] or complex (F, N).
template <int S, bool kPlanar>
__global__ void __launch_bounds__(kThreads)
windowed_fft_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float2* __restrict__ tw, float* __restrict__ y,
                    long long F) {
  __shared__ float2 buf[kPadded];
  const int j = threadIdx.x;
  const long long f = blockIdx.x;
  float2 w16[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) w16[m] = __ldg(tw + m * (kN / 16));

  // pass 1 (Ns = 1): device memory with the window, no twiddle
  float2 v[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int n = j + r * kThreads;
    const float wn = __ldg(w + n);
    float2 a;
    if (kPlanar) {
      a.x = __ldg(x + f * kN + n);
      a.y = __ldg(x + (F + f) * kN + n);
    } else {
      a = __ldg(reinterpret_cast<const float2*>(x) + f * kN + n);
    }
    v[r] = make_float2(a.x * wn, a.y * wn);
  }
  dft16<S>(v, w16);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[pad(16 * j + r)] = v[r];
  __syncthreads();

  // pass 2 (Ns = 16), in place: every read before any write
  pass_from_shared<S, 16>(buf, j, tw, w16, v);
  __syncthreads();
  const int d = (j / 16) * 256 + (j % 16);
#pragma unroll
  for (int r = 0; r < 16; ++r) buf[pad(d + 16 * r)] = v[r];
  __syncthreads();

  // pass 3 (Ns = 256): natural order, straight to device memory
  pass_from_shared<S, 256>(buf, j, tw, w16, v);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int k = j + r * kThreads;
    if (kPlanar) {
      y[f * 2 * kN + k] = v[r].x;
      y[f * 2 * kN + kN + k] = v[r].y;
    } else {
      reinterpret_cast<float2*>(y)[f * kN + k] = v[r];
    }
  }
}

template <int S>
void launch(const float* x, const float* w, const float2* tw, float* y,
            long long F, int planar, cudaStream_t stream) {
  if (planar)
    windowed_fft_kernel<S, true><<<(unsigned)F, kThreads, 0, stream>>>(x, w, tw, y, F);
  else
    windowed_fft_kernel<S, false><<<(unsigned)F, kThreads, 0, stream>>>(x, w, tw, y, F);
}

}  // namespace

// K7.  x: planar (2, F, 4096) f32 (planar = 1) or complex64 (F, 4096) read
// as f32 pairs (planar = 0); w (4096,) f32; tw (4096, 2) f32, the table
// e^{sign 2 pi i m / 4096}; y: (F, 8192) f32 [Re | Im] (planar) or complex64
// (F, 4096).  sign is -1 (forward) or +1.  Contiguous, on card `device`.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int windowed_fft_launch(const float* x, const float* w,
                                   const float* tw, float* y, long long F,
                                   int planar, int sign, int device,
                                   cudaStream_t stream) {
  if (F <= 0 || F > 0x7fffffffLL || (sign != 1 && sign != -1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  if (sign < 0)
    launch<-1>(x, w, tw2, y, F, planar, stream);
  else
    launch<1>(x, w, tw2, y, F, planar, stream);
  return (int)cudaGetLastError();
}
