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
//   field : [SX, SY, SZ, C], C order, component-minor, 16-byte aligned:
//           C = 4 for a float or bfloat16 field, (x, y, z, 0), so that a
//           corner is one 16- or 8-byte vector load; C = 3 for a double
//           field, a corner in a 16-byte and an 8-byte load.
//           FieldT = T, float under double positions (a float32 state
//           marched in float64, as the JAX package does), or bfloat16.
//           Fewer than 2^31 elements: cell offsets are 32-bit
//   seeds : [N, 3] in the position type T (double or float); dirs: [N]
//           (+-1)
//   order : [N] int64 or null: thread i marches line order[i] (null: i)
//   out   : [n_steps + 1, N, 3] in T, row 0 = the seeds
//   alive : [N] uint8, 0 once a stage's stencil left the volume
//
// The field may be a window of the volume: it holds the cells o0..
// o0+LX-1 (and so on) of an [SX, SY, SZ] volume, C order over
// [LX, LY, LZ, C].  Every coordinate, bound and clamp is the whole
// volume's, so a line computes exactly what it computes in the whole
// volume, as long as its stencils stay in the window (the caller's halo);
// only the address of a cell moves.  The migrating march of partStream
// (parallel/particles.py) steps each block's lines this way.
//
// Per stage, as in _trace_level: xc = (x - plo)/dx - 0.5, b = floor(xc);
// ok = every b in [0, S-2]; b is clamped before the gather (a line frozen
// outside the volume never reads out of bounds); t = clamp(xc - b, 0, 1);
// v = sum over the corners in CORNER_OFFSETS_S order of
// value * ((wx * wy) * wz); k = (dir * v) / max(|v|, smallest normal of T).
// A step is x + (h/6)((k1 + 2 k2) + 2 k3 + k4); a line whose four stages
// are not all ok keeps its position from then on.
//
// Bound: operations.  A line-step is 375 operations (4 stages of 84, and
// 39 for the stage inputs and the update; the 8 corner weights share their
// 4 products wx * wy); each field cell the stencils touch is read once.  At
// the production shape (260,104 lines x 25 steps, 1.58 M cells touched)
// that is 2.44 GFLOP, 72 us at the H100's 34 TFLOP/s in float64 (36 us at
// 67 in float32), above the 62 us its 209 MB take at 3.35 TB/s.  Those
// peaks count a fused multiply-add as two operations, which --fmad=false
// forbids: at one operation an instruction the float64 floor is twice
// that, ~144 us.  The count takes a division or a square root as one
// operation; on the card each is ~10 instructions with a range check and
// a branch around them, so the issue rate, not the memory, is what the
// kernel meets (PERF.md).
//
// Design: one thread per line, its position and the RK sum in registers;
// 32-bit cell offsets; the base index by a saturating floor conversion,
// clamped in integers; a corner in one vector load (a padded float or
// bfloat16 cell) or two (a double cell: its aligned pair and the third
// value), its terms summed as they land; 128 threads a block and 8 blocks
// an SM (64 registers), which measured best: more lines in flight thrash
// the L1, fewer hide less latency.  Where the gathers weigh most (a double
// field) the wrapper sorts the lines by the Morton code of their seed cell
// (order_key_kernel and a radix sort), so that a block's lines start in a
// compact patch and share their stencils through L1; the kernel writes
// each line at its own index, so the order changes nothing in the result.
// No shared memory or TMA: a
// block's lines spread over a surface patch that moves with them, so no
// tile holds their stencils.
//
// Rounding: every operation rounds once (the _rn intrinsics, and the build
// passes --fmad=false), in the order of the plain PyTorch version
// march_torch, so the two agree bitwise on the card; the plain version's
// clamp of t is left out where it changes nothing (unit_vec).  float and bfloat16
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

// Components a cell holds: a float or bfloat16 cell is padded to
// (x, y, z, 0), one aligned 16- or 8-byte vector load; a double cell stays
// (x, y, z), two loads, because padding it to 32 bytes costs more in cache
// traffic than the load it saves (PERF.md).  The field starts on a 16-byte
// boundary.
template <typename FieldT> struct Layout { static constexpr int C = 4; };
template <> struct Layout<double> { static constexpr int C = 3; };

// One cell's (x, y, z), widened to the state type.
struct Bf16 { uint16_t bits; };
__device__ __forceinline__ void ld_cell(const double* p, double v[3]) {
  // 24 bytes: (x, y) or (y, z), whichever pair is 16-byte aligned, in one
  // load and the third value in another
  const bool odd = (reinterpret_cast<uintptr_t>(p) & 8) != 0;
  const double2 a = __ldg(reinterpret_cast<const double2*>(p + (odd ? 1 : 0)));
  const double s = __ldg(p + (odd ? 0 : 2));
  v[0] = odd ? s : a.x;
  v[1] = odd ? a.x : a.y;
  v[2] = odd ? a.y : s;
}
template <typename T>
__device__ __forceinline__ void ld_cell(const float* p, T v[3]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = T(q.x);
  v[1] = T(q.y);
  v[2] = T(q.z);
}
template <typename T>
__device__ __forceinline__ void ld_cell(const Bf16* p, T v[3]) {
  // bfloat16 is the high half of a float32: widening is exact
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = T(__uint_as_float(q.x << 16));
  v[1] = T(__uint_as_float(q.x & 0xffff0000u));
  v[2] = T(__uint_as_float(q.y << 16));
}

// 128 threads a block and 8 blocks an SM: at most 64 registers a thread.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;

template <typename T>
struct Grid {
  T plo[3];
  T dx[3];
  int hi[3];        // S - 2: the largest base index
};

template <typename FieldT, typename T>
struct Volume {
  const FieldT* field;
  int sx, sy;       // element strides of x and y
  Grid<T> g;
};

// Round to T once, as the plain version's 0-dim tensors do.
template <typename T>
Grid<T> make_grid(int64_t SX, int64_t SY, int64_t SZ, double plo0,
                  double plo1, double plo2, double dx0, double dx1,
                  double dx2) {
  return {{(T)plo0, (T)plo1, (T)plo2},
          {(T)dx0, (T)dx1, (T)dx2},
          {(int)(SX - 2), (int)(SY - 2), (int)(SZ - 2)}};
}

__device__ __forceinline__ int floor_int(double v) { return __double2int_rd(v); }
__device__ __forceinline__ int floor_int(float v) { return __float2int_rd(v); }

// The cell coordinate of x along d (xc) and its base index floor(xc),
// clamped into the volume (b); returns whether the base lay inside.  The
// conversion saturates and takes NaN to 0, so b is the clamp of floor(xc)
// whatever xc is, and a NaN coordinate is outside.
template <typename T>
__device__ __forceinline__ bool base_cell(const Grid<T>& g, int d, T x, T& xc,
                                          int& b) {
  xc = sub_rn(div_rn(sub_rn(x, g.plo[d]), g.dx[d]), T(0.5));
  const int f = floor_int(xc);
  b = min(max(f, 0), g.hi[d]);          // clamp before the gather
  return f == b && xc == xc;
}

// One RK4 stage: the unit vector at x (times the line's direction) in k;
// returns whether the stencil lay inside the volume.
template <typename FieldT, typename T>
__device__ __forceinline__ bool unit_vec(const Volume<FieldT, T>& vol, T dir,
                                         const T x[3], T k[3]) {
  T t[3];
  int b[3];
  bool ok = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T xc;
    ok = base_cell(vol.g, d, x[d], xc, b[d]) && ok;
    // inside, xc - b is exact and in [0, 1); outside, the step is dropped
    // whatever t is, so the plain version's clamp of t changes nothing
    t[d] = sub_rn(xc, T(b[d]));
  }
  const T wx[2] = {sub_rn(T(1), t[0]), t[0]};
  const T wy[2] = {sub_rn(T(1), t[1]), t[1]};
  const T wz[2] = {sub_rn(T(1), t[2]), t[2]};
  constexpr int C = Layout<FieldT>::C;
  const FieldT* base = vol.field + (b[0] * vol.sx + b[1] * vol.sy + b[2] * C);
  T v[3];
#pragma unroll
  for (int c = 0; c < 8; ++c) {           // CORNER_OFFSETS_S order
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const T w = mul_rn(mul_rn(wx[ox], wy[oy]), wz[oz]);
    T f[3];
    ld_cell(base + (ox * vol.sx + oy * vol.sy + oz * C), f);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const T term = mul_rn(f[e], w);
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
__global__ void __launch_bounds__(kThreads, kMinBlocks)
march_kernel(Volume<FieldT, T> vol, const T* __restrict__ seeds,
             const T* __restrict__ dirs, const int64_t* __restrict__ order,
             T* __restrict__ out, uint8_t* __restrict__ alive_out, int64_t N,
             int n_steps, T h_half, T h, T h_sixth) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const int64_t n = order ? order[i] : i;  // the line, in locality order
  T x[3];
  T* row = out + n * 3;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x[d] = seeds[n * 3 + d];
    row[d] = x[d];
  }
  const T dir = dirs[n];
  bool alive = true;
  for (int s = 1; s <= n_steps; ++s) {
    if (alive) {
      // acc carries k1 + 2 k2 + 2 k3, summed in the plain version's order
      T k[3], acc[3], y[3];
      bool ok = unit_vec(vol, dir, x, k);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        acc[d] = k[d];
        y[d] = add_rn(x[d], mul_rn(h_half, k[d]));
      }
      ok = unit_vec(vol, dir, y, k) && ok;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        acc[d] = add_rn(acc[d], mul_rn(T(2), k[d]));
        y[d] = add_rn(x[d], mul_rn(h_half, k[d]));
      }
      ok = unit_vec(vol, dir, y, k) && ok;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        acc[d] = add_rn(acc[d], mul_rn(T(2), k[d]));
        y[d] = add_rn(x[d], mul_rn(h, k[d]));
      }
      ok = unit_vec(vol, dir, y, k) && ok;
      if (ok) {
#pragma unroll
        for (int d = 0; d < 3; ++d)
          x[d] = add_rn(x[d], mul_rn(h_sixth, add_rn(acc[d], k[d])));
      } else {
        alive = false;                    // frozen for good
      }
    }
    row += N * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) row[d] = x[d];
  }
  alive_out[n] = alive ? 1 : 0;
}

template <typename FieldT, typename T>
int launch(const void* field, const void* seeds, const void* dirs,
           const void* order, void* out, void* alive, int64_t N,
           int64_t n_steps, int64_t SX, int64_t SY, int64_t SZ, int64_t LY,
           int64_t LZ, int64_t o0, int64_t o1, int64_t o2, double plo0,
           double plo1, double plo2, double dx0, double dx1, double dx2,
           double h, void* stream) {
  constexpr int C = Layout<FieldT>::C;
  // the window's strides; the base moves back by the window's origin, so
  // that the volume's cell (b0, b1, b2) lands on the window's
  const int64_t sx = LY * LZ * C, sy = LZ * C;
  const Volume<FieldT, T> vol{
      (const FieldT*)field - (o0 * sx + o1 * sy + o2 * C), (int)sx, (int)sy,
      make_grid<T>(SX, SY, SZ, plo0, plo1, plo2, dx0, dx1, dx2)};
  const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
  march_kernel<FieldT, T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      vol, (const T*)seeds, (const T*)dirs, (const int64_t*)order, (T*)out,
      (uint8_t*)alive, N, (int)n_steps, (T)(0.5 * h), (T)h, (T)(h / 6.0));
  return (int)cudaGetLastError();
}

// Locality order of the lines: the sort key of a line is the Morton code of
// its seed's base cell (10 bits a dimension, of the cell index >> shift, so
// that the largest index fits), with the line's direction above it, so that
// a warp's lines start in neighbouring cells and go the same way.
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3ffu;                            // 10 bits -> every third of 30
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__global__ void order_key_kernel(Grid<double> g,
                                 const double* __restrict__ seeds,
                                 const double* __restrict__ dirs,
                                 int* __restrict__ key, int64_t N, int shift) {
  const int64_t n = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  unsigned k = dirs[n] < 0.0 ? 1u << 30 : 0u;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    double xc;
    int b;
    base_cell(g, d, seeds[n * 3 + d], xc, b);
    k |= spread3((unsigned)b >> shift) << d;
  }
  key[n] = (int)k;
}

int launch_key(const void* seeds, const void* dirs, void* key, int64_t N,
               int64_t SX, int64_t SY, int64_t SZ, double plo0, double plo1,
               double plo2, double dx0, double dx1, double dx2, int shift,
               void* stream) {
  const unsigned blocks = (unsigned)((N + 255) / 256);
  order_key_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      make_grid<double>(SX, SY, SZ, plo0, plo1, plo2, dx0, dx1, dx2),
      (const double*)seeds, (const double*)dirs, (int*)key, N, shift);
  return (int)cudaGetLastError();
}

// What the compiler and the occupancy calculator make of one variant:
// registers per thread, local (spill) bytes per thread, threads per block,
// resident blocks per SM.
template <typename FieldT, typename T>
int report(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, march_kernel<FieldT, T>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, march_kernel<FieldT, T>, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = kThreads;
  out[3] = blocks;
  return (int)err;
}

}  // namespace

// Plain C entry points for ctypes, one per (field type, state type), and
// NAME_report for its registers and occupancy; stream_march_key_f64 for the
// order key of double positions.  The field holds the cells o0.. of an
// [SX, SY, SZ] volume with y and z extents LY, LZ: the whole volume is
// LY = SY, LZ = SZ, o = 0.  Each returns a cudaError_t (0 = cudaSuccess).
#define STREAM_MARCH_ENTRY(NAME, FIELD_T, T)                                  \
  extern "C" int NAME(                                                        \
      const void* field, const void* seeds, const void* dirs,                 \
      const void* order, void* out, void* alive, int64_t N, int64_t n_steps,  \
      int64_t SX, int64_t SY, int64_t SZ, int64_t LY, int64_t LZ,             \
      int64_t o0, int64_t o1, int64_t o2, double plo0, double plo1,           \
      double plo2, double dx0, double dx1, double dx2, double h,              \
      void* stream) {                                                         \
    return launch<FIELD_T, T>(field, seeds, dirs, order, out, alive, N,       \
                              n_steps, SX, SY, SZ, LY, LZ, o0, o1, o2, plo0,  \
                              plo1, plo2, dx0, dx1, dx2, h, stream);          \
  }                                                                           \
  extern "C" int NAME##_report(int* out) { return report<FIELD_T, T>(out); }

extern "C" int stream_march_key_f64(const void* seeds, const void* dirs,
                                    void* key, int64_t N, int64_t SX,
                                    int64_t SY, int64_t SZ, double plo0,
                                    double plo1, double plo2, double dx0,
                                    double dx1, double dx2, int shift,
                                    void* stream) {
  return launch_key(seeds, dirs, key, N, SX, SY, SZ, plo0, plo1, plo2, dx0,
                    dx1, dx2, shift, stream);
}

STREAM_MARCH_ENTRY(stream_march_f64, double, double)
STREAM_MARCH_ENTRY(stream_march_f32, float, float)
STREAM_MARCH_ENTRY(stream_march_f32_f64, float, double)
STREAM_MARCH_ENTRY(stream_march_bf16_f64, Bf16, double)
STREAM_MARCH_ENTRY(stream_march_bf16_f32, Bf16, float)
