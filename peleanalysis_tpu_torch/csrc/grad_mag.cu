// Centered gradient + magnitude of one ghost-filled scalar, in one pass.
//
// Replaces the TPU kernel peleanalysis_tpu/ops/pallas_kernels.py
// `_grad_mag_kernel` (launched by `grad_mag_pallas`, dispatched by
// `grad_mag`).  In the PyTorch port every gradient of the grad and curvature
// tools goes through this kernel (peleanalysis_tpu_torch/ops/grad_kernels.py).
//
//   in : grown [X+2, Y+2, Z+2], C order (z contiguous), 1 ghost ring
//   out: [4, X, Y, Z] = gx, gy, gz, sqrt(gx^2 + gy^2 + gz^2)
//        ([3, X, Y, Z] without the magnitude)
//
// Bound: device-memory bandwidth.  Per cell it reads 1 value (the six
// neighbours come again from L1/L2) and writes 3 or 4, against 7 flops.
// Design: one thread per output cell; z, the contiguous axis, maps to
// threadIdx.x, so a warp loads and stores 32 consecutive values.  There is no
// shared-memory tile, register window along x or TMA yet.
//
// Numerics follow the JAX main path (ops/stencil.py centered_gradient +
// magnitude), not the Pallas kernel: (a - b) / d with d = (T)(2 dx), a true
// division, and sqrt((gx*gx + gy*gy) + gz*gz) in that order.  The _rn
// intrinsics keep nvcc from contracting a multiply-add into an FMA; the build
// also passes --fmad=false and never --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

constexpr int kBlockZ = 32;  // one warp along z
constexpr int kBlockY = 8;

template <typename T>
__global__ void __launch_bounds__(kBlockZ * kBlockY)
grad_mag_kernel(const T* __restrict__ in, T* __restrict__ out,
                int64_t X, int64_t Y, int64_t Z,
                T d0, T d1, T d2, int with_mag) {
  const int64_t k = (int64_t)blockIdx.x * kBlockZ + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= Z || j >= Y) return;

  const int64_t sy = Z + 2;             // grown strides (z stride is 1)
  const int64_t sx = (Y + 2) * (Z + 2);
  const int64_t c = (i + 1) * sx + (j + 1) * sy + (k + 1);

  const T gx = div_rn(sub_rn(in[c + sx], in[c - sx]), d0);
  const T gy = div_rn(sub_rn(in[c + sy], in[c - sy]), d1);
  const T gz = div_rn(sub_rn(in[c + 1], in[c - 1]), d2);

  const int64_t n = X * Y * Z;
  const int64_t o = (i * Y + j) * Z + k;
  out[o] = gx;
  out[n + o] = gy;
  out[2 * n + o] = gz;
  if (with_mag) {
    const T s = add_rn(add_rn(mul_rn(gx, gx), mul_rn(gy, gy)), mul_rn(gz, gz));
    out[3 * n + o] = sqrt_rn(s);
  }
}

template <typename T>
int launch(const void* in, void* out, int64_t X, int64_t Y, int64_t Z,
           double two_dx0, double two_dx1, double two_dx2, int with_mag,
           void* stream) {
  const dim3 block(kBlockZ, kBlockY, 1);
  const dim3 grid((unsigned)((Z + kBlockZ - 1) / kBlockZ),
                  (unsigned)((Y + kBlockY - 1) / kBlockY), (unsigned)X);
  grad_mag_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)in, (T*)out, X, Y, Z, (T)two_dx0, (T)two_dx1, (T)two_dx2,
      with_mag);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  two_dx* are 2*dx in double; the kernel
// rounds them to T once, as the JAX path rounds 2*dx to the array dtype.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int grad_mag_f32(const void* in, void* out, int64_t X, int64_t Y,
                            int64_t Z, double two_dx0, double two_dx1,
                            double two_dx2, int with_mag, void* stream) {
  return launch<float>(in, out, X, Y, Z, two_dx0, two_dx1, two_dx2, with_mag,
                       stream);
}

extern "C" int grad_mag_f64(const void* in, void* out, int64_t X, int64_t Y,
                            int64_t Z, double two_dx0, double two_dx1,
                            double two_dx2, int with_mag, void* stream) {
  return launch<double>(in, out, X, Y, Z, two_dx0, two_dx1, two_dx2,
                        with_mag, stream);
}
