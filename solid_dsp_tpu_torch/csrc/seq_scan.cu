// The two nonlinear sequential scans of the port, for Hopper (sm_90a): S1
// (the exact per-sample AGC with its squelch FSM) and S2 (the
// decision-directed QPSK Costas loop).  S3, the IIR filters' linear
// w-recurrence, is time-parallel in iir_scan.cu.
//
// Neither replaces a TPU kernel: in the JAX package each is a lax.scan,
// solid_dsp_tpu/ops/agc.py::_agc_scan (:108-149) and
// solid_dsp_tpu/models/qpsk.py::qpsk_carrier_pll (:101-126).  PyTorch has no
// scan, and a per-sample recurrence in eager torch ops costs ~15-20 launches a
// sample, so each recurrence is one kernel here.
//
// Bound: latency.  Each sample depends on the one before it through the gain
// (S1: a logf and an expf on the chain) or the phase (S2: sincos and atan2),
// and neither recurrence is linear, so one sequence runs at one dependent
// step per ~0.1 us (S1) or ~0.2 us (S2) on an H100 however many SMs it has;
// the bytes (each sample read once and written once) would take 3.35 TB/s
// far less time.  A multi-sequence or chunk-speculative design is later work.
//
// Design: one thread per independent sequence (a leading index of the
// block), its state in registers, time walked in order.  Samples are loaded
// a chunk of 8 at a time into registers, the next chunk's loads started
// before the current chunk's steps, so a load's latency is hidden behind a
// chunk of steps.
// The arithmetic is the plain PyTorch version's (ops/agc.py::agc_scan_plain,
// models/qpsk.py::costas_pll_plain), in the same
// order: products and sums with the _rn intrinsics so that nvcc fuses none
// into an FMA the plain version does not have; no fast-math.  The lock and a
// DISABLED squelch are fixed for a block (DISABLED maps to DISABLED, timer
// untouched), so the kernel picks a loop without the FSM, or without the
// gain update, where they cannot run: exact, and the FSM's code left in the
// loop cost ~25 % of a step even untaken (PERF.md).
//
// Entry points (each returns the launch's cudaError_t):
//   agc_scan_f32 / agc_scan_f64:   x (B, T) complex -> y (B, T), state in place
//   squelch_fsm_f32 / _f64:        rssi (B, T) real -> modes (B, T) int32,
//                                  mode/timer in place
//   costas_pll_f32 / _f64:         x (B, T) complex -> y (B, T), theta/dtheta
//                                  (B,) in place

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;
constexpr int THREADS = 128;

enum Squelch : int {
  UNKNOWN = 0, ENABLED = 1, RISE = 2, SIGNALHI = 3, FALL = 4, SIGNALLO = 5,
  TIMEOUT = 6, DISABLED = 7
};

template <typename R> struct C2;
template <> struct C2<float> { using T = float2; };
template <> struct C2<double> { using T = double2; };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float log_(float a) { return logf(a); }
__device__ __forceinline__ double log_(double a) { return log(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float log10_(float a) { return log10f(a); }
__device__ __forceinline__ double log10_(double a) { return log10(a); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ void sincos_(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sincos_(double a, double* s, double* c) { sincos(a, s, c); }

// One step of the 7-state squelch FSM (ref auto_gain_control/mod.rs:631-677):
// FALL arms the timer, SIGNALLO counts it down before the transition reads it.
template <typename R>
__device__ __forceinline__ void squelch_step(int& mode, int& timer, R rssi,
                                             R thr, int timeout) {
  const bool hi = rssi > thr;
  if (mode == FALL) timer = timeout;
  if (mode == SIGNALLO) timer = timer - 1;
  int m;
  switch (mode) {
    case ENABLED: m = hi ? RISE : ENABLED; break;
    case RISE: m = hi ? SIGNALHI : FALL; break;
    case SIGNALHI: m = hi ? SIGNALHI : FALL; break;
    case FALL: m = hi ? SIGNALHI : SIGNALLO; break;
    case SIGNALLO: m = timer == 0 ? TIMEOUT : (hi ? SIGNALHI : SIGNALLO); break;
    case TIMEOUT: m = ENABLED; break;
    default: m = DISABLED;
  }
  mode = m;
}

// Walk one sequence: step(x[t]) -> y[t] in time order.  Full chunks of
// CHUNK samples are loaded into registers a chunk ahead (the next chunk's
// loads started before this chunk's steps, so their latency hides behind
// CHUNK dependent steps); the ragged end takes one sample at a time.
template <typename In, typename Out, typename Step>
__device__ __forceinline__ void walk(const In* __restrict__ xs,
                                     Out* __restrict__ ys, long long T,
                                     Step step) {
  const long long full = T - T % CHUNK;
  In buf[CHUNK], nxt[CHUNK];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) buf[i] = xs[i];
  }
  for (long long t0 = 0; t0 < full; t0 += CHUNK) {
    if (t0 + CHUNK < full) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) nxt[i] = xs[t0 + CHUNK + i];
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) ys[t0 + i] = step(buf[i]);
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) buf[i] = nxt[i];
  }
  for (long long t = full; t < T; ++t) ys[t] = step(xs[t]);
}

// S1 on one sequence: out = x g; E = c1 E + |out|^2 c2; unlocked: g' = E >
// 1e-6 ? g exp(c3 ln E) : g, g' = min(g', 1e6), the FSM on rssi = -20
// log10 g' (FSM only: the mode is not DISABLED), y = x if the new mode is
// ENABLED else out * scale; locked: y = out, g, mode and timer kept.
template <typename R, bool LOCKED, bool FSM>
__device__ __forceinline__ void agc_walk(const typename C2<R>::T* xs,
                                         typename C2<R>::T* ys, long long T,
                                         R& g, R& E, int& md, int& tm, R c1,
                                         R c2, R c3, R scale, R thr,
                                         int timeout) {
  using CT = typename C2<R>::T;
  const R gate = R(1e-6), clamp = R(1e6), m20 = R(-20.0);
  walk(xs, ys, T, [&](CT xv) {
    const R ore = mul(xv.x, g), oim = mul(xv.y, g);
    const R ee = fma_(ore, ore, mul(oim, oim));
    E = add(mul(c1, E), mul(ee, c2));
    CT yv;
    if (LOCKED) {
      yv.x = ore;
      yv.y = oim;
      return yv;
    }
    R gn = E > gate ? mul(g, exp_(mul(c3, log_(E)))) : g;
    gn = gn > clamp ? clamp : gn;
    g = gn;
    if (FSM) {
      squelch_step(md, tm, mul(log10_(gn), m20), thr, timeout);
      if (md == ENABLED) return xv;
    }
    yv.x = mul(ore, scale);
    yv.y = mul(oim, scale);
    return yv;
  });
}

// S1: one thread a sequence; the lock and the FSM's DISABLED state are
// fixed for the block (DISABLED maps to DISABLED), so each picks a loop
// without the code it does not run.
template <typename R>
__global__ void __launch_bounds__(THREADS)
agc_scan_kernel(const typename C2<R>::T* __restrict__ x,
                typename C2<R>::T* __restrict__ y, R* __restrict__ gain,
                R* __restrict__ energy, const unsigned char* __restrict__ lock,
                int* __restrict__ mode, int* __restrict__ timer, int B,
                long long T, R c1, R c2, R c3, R scale, R thr, int timeout) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const auto* xs = x + (long long)b * T;
  auto* ys = y + (long long)b * T;
  R g = gain[b], E = energy[b];
  int md = mode[b], tm = timer[b];
  if (lock[b] != 0)
    agc_walk<R, true, false>(xs, ys, T, g, E, md, tm, c1, c2, c3, scale, thr,
                             timeout);
  else if (md == DISABLED)
    agc_walk<R, false, false>(xs, ys, T, g, E, md, tm, c1, c2, c3, scale, thr,
                              timeout);
  else
    agc_walk<R, false, true>(xs, ys, T, g, E, md, tm, c1, c2, c3, scale, thr,
                             timeout);
  gain[b] = g;
  energy[b] = E;
  mode[b] = md;
  timer[b] = tm;
}

// S1's second entry: the FSM alone over a given rssi track (the parallel
// AGC's squelch pass, whose gains the Newton solve already has).
template <typename R>
__global__ void __launch_bounds__(THREADS)
squelch_fsm_kernel(const R* __restrict__ rssi, int* __restrict__ modes,
                   int* __restrict__ mode, int* __restrict__ timer, int B,
                   long long T, R thr, int timeout) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int md = mode[b], tm = timer[b];
  walk(rssi + (long long)b * T, modes + (long long)b * T, T, [&](R r) {
    squelch_step(md, tm, r, thr, timeout);
    return md;
  });
  mode[b] = md;
  timer[b] = tm;
}

// S2: y = x e^{-j theta}; d = the Gray point of y's quadrant; e = arg(y conj d);
// dtheta += alpha e; theta = (theta + dtheta) + beta e.  theta is not wrapped.
template <typename R>
__global__ void __launch_bounds__(THREADS)
costas_pll_kernel(const typename C2<R>::T* __restrict__ x,
                  typename C2<R>::T* __restrict__ y, R* __restrict__ theta,
                  R* __restrict__ dtheta, int B, long long T, R alpha, R beta,
                  R h) {
  using CT = typename C2<R>::T;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  R th = theta[b], dth = dtheta[b];
  walk(x + (long long)b * T, y + (long long)b * T, T, [&](CT xv) {
    R s, c;
    sincos_(th, &s, &c);
    CT yv;                                   // x (c - j s)
    yv.x = add(mul(xv.x, c), mul(xv.y, s));
    yv.y = sub(mul(xv.y, c), mul(xv.x, s));
    const R dr = yv.x < R(0) ? -h : h;
    const R di = yv.y < R(0) ? -h : h;
    const R pr = add(mul(yv.x, dr), mul(yv.y, di));   // y conj(d)
    const R pi = sub(mul(yv.y, dr), mul(yv.x, di));
    const R e = atan2_(pi, pr);
    dth = add(dth, mul(alpha, e));
    th = add(add(th, dth), mul(beta, e));
    return yv;
  });
  theta[b] = th;
  dtheta[b] = dth;
}

template <typename F, typename... A>
int launch(F kernel, int B, int device, cudaStream_t stream, A... args) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

#define AGC_ENTRY(NAME, R)                                                    \
  extern "C" int NAME(const R* x, R* y, R* gain, R* energy,                   \
                      const unsigned char* lock, int* mode, int* timer,       \
                      int B, long long T, double c1, double c2, double c3,   \
                      double scale, double thr, int timeout, int device,      \
                      cudaStream_t stream) {                                  \
    using CT = C2<R>::T;                                                      \
    if (T <= 0) return (int)cudaErrorInvalidValue;                            \
    return launch(agc_scan_kernel<R>, B, device, stream,                      \
                  reinterpret_cast<const CT*>(x), reinterpret_cast<CT*>(y),   \
                  gain, energy, lock, mode, timer, B, T, (R)c1, (R)c2,        \
                  (R)c3, (R)scale, (R)thr, timeout);                          \
  }

#define FSM_ENTRY(NAME, R)                                                    \
  extern "C" int NAME(const R* rssi, int* modes, int* mode, int* timer,       \
                      int B, long long T, double thr, int timeout,            \
                      int device, cudaStream_t stream) {                      \
    if (T <= 0) return (int)cudaErrorInvalidValue;                            \
    return launch(squelch_fsm_kernel<R>, B, device, stream, rssi, modes,      \
                  mode, timer, B, T, (R)thr, timeout);                        \
  }

#define PLL_ENTRY(NAME, R)                                                    \
  extern "C" int NAME(const R* x, R* y, R* theta, R* dtheta, int B,           \
                      long long T, double alpha, double beta, double h,       \
                      int device, cudaStream_t stream) {                      \
    using CT = C2<R>::T;                                                      \
    if (T <= 0) return (int)cudaErrorInvalidValue;                            \
    return launch(costas_pll_kernel<R>, B, device, stream,                    \
                  reinterpret_cast<const CT*>(x), reinterpret_cast<CT*>(y),   \
                  theta, dtheta, B, T, (R)alpha, (R)beta, (R)h);              \
  }

AGC_ENTRY(agc_scan_f32, float)
AGC_ENTRY(agc_scan_f64, double)
FSM_ENTRY(squelch_fsm_f32, float)
FSM_ENTRY(squelch_fsm_f64, double)
PLL_ENTRY(costas_pll_f32, float)
PLL_ENTRY(costas_pll_f64, double)
