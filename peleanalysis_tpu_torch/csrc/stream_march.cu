// RK4 streamline march: N lines, n_steps normalised RK4 steps each, trilinear
// samples of a vector field on the dual grid.
//
// Replaces the TPU kernel peleanalysis_tpu/stream/pallas_march.py
// `_round_kernel` (launched by `_march_round`, driven by `march_pallas`) and
// the XLA gather march `_trace_level` of peleanalysis_tpu/stream/trace.py;
// both compute what this kernel computes.  In the PyTorch port every
// streamline march of the stream tool goes through it
// (peleanalysis_tpu_torch/stream/march_kernels.py).
//
//   field : [SX, SY, SZ, 3], C order, component-minor (one corner's three
//           components are contiguous, so the 8 corners of a stencil are
//           4 runs of 6 values); FieldT = T, float under double positions
//           (a float32 state marched in float64, as the JAX package does),
//           or bfloat16
//   seeds : [N, 3] in the position type T (double or float); dirs: [N]
//           (+-1)
//   out   : [n_steps + 1, N, 3] in T, row 0 = the seeds
//   alive : [N] uint8, 0 once a stage's stencil left the volume
//
// Per stage, as in _trace_level: xc = (x - plo)/dx - 0.5, b = floor(xc);
// ok = every b in [0, S-2]; b is clamped before the gather (a line frozen
// outside the volume never reads out of bounds); t = clamp(xc - b, 0, 1);
// v = sum over the corners in CORNER_OFFSETS_S order of
// value * ((wx * wy) * wz); k = (dir * v) / max(|v|, smallest normal of T).
// A step is x + (h/6)((k1 + 2 k2) + 2 k3 + k4); a line whose four stages
// are not all ok keeps its position from then on.
//
// Bound: the gathers.  A stage reads 24 values that neighbouring lines of a
// warp mostly share through L1/L2 (seeds from a surface are close in
// memory order), against ~120 flops, six of them divisions; each line is a
// chain of 4 n_steps dependent gathers, so latency is hidden only by the
// number of lines in flight.  Design: one thread per line, the line's
// position in registers, plain __ldg loads, no shared memory or TMA.
//
// Rounding: every operation rounds once (the _rn intrinsics, and the build
// passes --fmad=false), in the order of the plain PyTorch version
// march_torch, so the two agree bitwise on the card.  float and bfloat16
// field values widen to T exactly before any arithmetic.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

// field loads, widened to the state type
struct Bf16 { uint16_t bits; };
__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const Bf16* p) {
  // bfloat16 is the high half of a float32: widening is exact
  return __uint_as_float(
      ((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

constexpr int kThreads = 128;

template <typename FieldT, typename T>
struct Volume {
  const FieldT* field;
  int64_t S[3];
  T plo[3];
  T dx[3];
};

// One RK4 stage: the unit vector at x (times the line's direction) in k;
// returns whether the stencil lay inside the volume.
template <typename FieldT, typename T>
__device__ __forceinline__ bool unit_vec(const Volume<FieldT, T>& vol, T dir,
                                         const T x[3], T k[3]) {
  T t[3];
  int64_t b[3];
  bool ok = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const T xc = sub_rn(div_rn(sub_rn(x[d], vol.plo[d]), vol.dx[d]), T(0.5));
    T bf = floor(xc);
    const T hi = T(vol.S[d] - 2);
    ok = ok && bf >= T(0) && bf <= hi;
    bf = fmin(fmax(bf, T(0)), hi);       // clamp before the gather
    t[d] = fmin(fmax(sub_rn(xc, bf), T(0)), T(1));
    b[d] = (int64_t)bf;
  }
  const T wx[2] = {sub_rn(T(1), t[0]), t[0]};
  const T wy[2] = {sub_rn(T(1), t[1]), t[1]};
  const T wz[2] = {sub_rn(T(1), t[2]), t[2]};
  const int64_t sy = vol.S[2] * 3;
  const int64_t sx = vol.S[1] * sy;
  const FieldT* base = vol.field + b[0] * sx + b[1] * sy + b[2] * 3;
  T v[3];
#pragma unroll
  for (int c = 0; c < 8; ++c) {           // CORNER_OFFSETS_S order
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const T w = mul_rn(mul_rn(wx[ox], wy[oy]), wz[oz]);
    const FieldT* p = base + ox * sx + oy * sy + oz * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const T term = mul_rn(T(ld(p + e)), w);
      v[e] = c == 0 ? term : add_rn(v[e], term);
    }
  }
  const T n = sqrt_rn(add_rn(add_rn(mul_rn(v[0], v[0]), mul_rn(v[1], v[1])),
                             mul_rn(v[2], v[2])));
  const T m = fmax(n, tiny<T>());
#pragma unroll
  for (int e = 0; e < 3; ++e) k[e] = div_rn(mul_rn(dir, v[e]), m);
  return ok;
}

template <typename FieldT, typename T>
__global__ void __launch_bounds__(kThreads)
march_kernel(Volume<FieldT, T> vol, const T* __restrict__ seeds,
             const T* __restrict__ dirs, T* __restrict__ out,
             uint8_t* __restrict__ alive_out, int64_t N, int64_t n_steps,
             T h_half, T h, T h_sixth) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  T x[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = seeds[n * 3 + d];
    out[n * 3 + d] = x[d];
  }
  const T dir = dirs[n];
  bool alive = true;
  for (int64_t s = 1; s <= n_steps; ++s) {
    if (alive) {
      T k1[3], k2[3], k3[3], k4[3], y[3];
      bool ok = unit_vec(vol, dir, x, k1);
#pragma unroll
      for (int d = 0; d < 3; ++d) y[d] = add_rn(x[d], mul_rn(h_half, k1[d]));
      ok = unit_vec(vol, dir, y, k2) && ok;
#pragma unroll
      for (int d = 0; d < 3; ++d) y[d] = add_rn(x[d], mul_rn(h_half, k2[d]));
      ok = unit_vec(vol, dir, y, k3) && ok;
#pragma unroll
      for (int d = 0; d < 3; ++d) y[d] = add_rn(x[d], mul_rn(h, k3[d]));
      ok = unit_vec(vol, dir, y, k4) && ok;
      if (ok) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const T sum = add_rn(add_rn(add_rn(k1[d], mul_rn(T(2), k2[d])),
                                      mul_rn(T(2), k3[d])), k4[d]);
          x[d] = add_rn(x[d], mul_rn(h_sixth, sum));
        }
      } else {
        alive = false;                    // frozen for good
      }
    }
    T* row = out + (s * N + n) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) row[d] = x[d];
  }
  alive_out[n] = alive ? 1 : 0;
}

template <typename FieldT, typename T>
int launch(const void* field, const void* seeds, const void* dirs, void* out,
           void* alive, int64_t N, int64_t n_steps, int64_t SX, int64_t SY,
           int64_t SZ, double plo0, double plo1, double plo2, double dx0,
           double dx1, double dx2, double h, void* stream) {
  // constants round to T once, as the plain version's 0-dim tensors do
  Volume<FieldT, T> vol{(const FieldT*)field, {SX, SY, SZ},
                        {(T)plo0, (T)plo1, (T)plo2}, {(T)dx0, (T)dx1, (T)dx2}};
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  march_kernel<FieldT, T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      vol, (const T*)seeds, (const T*)dirs, (T*)out, (uint8_t*)alive, N,
      n_steps, (T)(0.5 * h), (T)h, (T)(h / 6.0));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, one per (field type, state type).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
#define STREAM_MARCH_ENTRY(NAME, FIELD_T, T)                                  \
  extern "C" int NAME(const void* field, const void* seeds, const void* dirs, \
                      void* out, void* alive, int64_t N, int64_t n_steps,     \
                      int64_t SX, int64_t SY, int64_t SZ, double plo0,        \
                      double plo1, double plo2, double dx0, double dx1,       \
                      double dx2, double h, void* stream) {                   \
    return launch<FIELD_T, T>(field, seeds, dirs, out, alive, N, n_steps, SX, \
                              SY, SZ, plo0, plo1, plo2, dx0, dx1, dx2, h,     \
                              stream);                                        \
  }

STREAM_MARCH_ENTRY(stream_march_f64, double, double)
STREAM_MARCH_ENTRY(stream_march_f32, float, float)
STREAM_MARCH_ENTRY(stream_march_f32_f64, float, double)
STREAM_MARCH_ENTRY(stream_march_bf16_f64, Bf16, double)
STREAM_MARCH_ENTRY(stream_march_bf16_f32, Bf16, float)
