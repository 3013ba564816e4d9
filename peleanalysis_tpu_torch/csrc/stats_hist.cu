// Masked, weighted histograms on the H100: the binned moments of
// conditionalMean and the joint pdfs of jpdf.
//
// Replaces no Pallas kernel.  It is the H100 counterpart of the XLA one-hot
// contractions of peleanalysis_tpu/ops/stats.py (binned_stats :30,
// joint_pdf :137, joint_pdf_multi :184).  Those contract a [cells, nbins]
// one-hot on the TPU's matrix unit because scatter-adds serialize there; on
// the H100 a one-hot moves nbins times the data, so here every cell is read
// once and added into a histogram privatized in shared memory.
//
// Bound: bytes.  A cell costs a handful of flops and 1 + ncomp (or nv)
// values plus a mask byte; at 19.4 M float32 cells with one averaged
// component the inputs are ~175 MB, ~52 us at 3.35 TB/s.
//
// Design:
//  * Shared variant: each block accumulates a contiguous range of cells into
//    shared-memory bins with atomics (hits, shifted sums and sums of
//    squares; joint: b, bx1, bx2 per pair, one pair per blockIdx.y), then
//    writes its bins as a per-block partial.  A second kernel sums the
//    partials over blocks in block order, in float64, and rounds once to the
//    state's type.
//  * Warp aggregation: a warp's 32 cells are grouped by bin
//    (__match_any_sync) and each group's values summed by a pairwise tree of
//    shuffles before one lane adds them with an atomic.  The tools' fields
//    are smooth, so a block's cells crowd into few bins: without it a float32
//    bin of a block adds tens of thousands of cells one after another, its
//    rounding error growing with their count, and the colliding atomics
//    serialize.
//  * Global variant, chosen when the bins do not fit in shared memory:
//    float64 atomics straight into one global accumulator, then the same
//    finishing kernel over one "block".
//  * Hits: with a scalar weight each cell adds 1 and the total is scaled by
//    the weight in float64 at the end, so hits are exact integer counts
//    times the weight (a block's count stays below 2^24); with a per-cell
//    weight the weights are summed.
//  * Min/max: atomicMin/atomicMax on the ordered-integer encoding of the
//    value's bits (a float's order is its encoding's order).
//  * Bin index: in the state's type, one rounding per operation (the _rn
//    intrinsics; built with --fmad=false), floored, in either of the two
//    forms the JAX package computes: (v - lo) / span * nbins where the
//    edges are traced values, and (v - lo) * K where XLA folded constant
//    edges into K = fl(fl(1/span) * nbins).  NaN goes to bin 0 and the rest
//    saturate as XLA's float->int32 cast does, so a cell lands in the bin
//    the JAX package puts it in.
//
// Plain C interface for ctypes; every entry point returns the cudaError_t
// of its launches (0 on success).  Parameters travel by value in a struct.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAXC 32      // averaged components of one binned launch
#define MAXV 16      // variables of one joint launch
#define MAXP 120     // pairs of one joint launch (16 * 15 / 2)

struct BinnedParams {
  long long n;             // cells
  int ncomp;               // averaged components
  int nbins;
  int clamp;               // 1: out-of-range cells go to the edge bins
  int minmax;              // 1: per-bin min/max of the unshifted values
  int has_w;               // 1: per-cell weights at w_ptr; 0: wscal
  int nblocks;             // shared variant: blocks (= partials)
  int divide;              // 1: (v - lo) / scale * nbins; 0: (v - lo) * scale
  double wscal;
  double lo, scale;        // bin edges, already rounded to the state type
  unsigned long long bin_ptr;            // [n]
  unsigned long long avg_ptr[MAXC];      // [n] each
  unsigned long long w_ptr;              // [n] or 0
  unsigned long long mask_ptr;           // [n] bool
  unsigned long long shift_ptr;          // [ncomp], state type
};

struct JointParams {
  long long n;
  int nv, npairs, nbins;
  int has_w;
  int nblocks;             // shared variant: blocks per pair
  int divide;              // as in BinnedParams
  double wscal;
  double lo[MAXV], scale[MAXV];
  int pi[MAXP], pj[MAXP];
  unsigned long long v_ptr[MAXV];        // [n] each
  unsigned long long w_ptr;
  unsigned long long mask_ptr;
  unsigned long long shift_ptr;          // [nv], state type
};

// ---------------------------------------------------------------------------
// type helpers
template <typename T> struct Enc;
template <> struct Enc<float> { typedef int type; };
template <> struct Enc<double> { typedef long long type; };

__device__ __forceinline__ int encode(float v) {
  int b = __float_as_int(v);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}
__device__ __forceinline__ long long encode(double v) {
  long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7fffffffffffffffLL);
}
__device__ __forceinline__ float decode(int e) {
  return __int_as_float(e >= 0 ? e : (e ^ 0x7fffffff));
}
__device__ __forceinline__ double decode(long long e) {
  return __longlong_as_double(e >= 0 ? e : (e ^ 0x7fffffffffffffffLL));
}

__device__ __forceinline__ float bin_coord(float v, float lo, float scale,
                                           float nb, int divide) {
  float t = __fsub_rn(v, lo);
  return divide ? __fmul_rn(__fdiv_rn(t, scale), nb) : __fmul_rn(t, scale);
}
__device__ __forceinline__ double bin_coord(double v, double lo, double scale,
                                            double nb, int divide) {
  double t = __dsub_rn(v, lo);
  return divide ? __dmul_rn(__ddiv_rn(t, scale), nb) : __dmul_rn(t, scale);
}
template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// floor of the bin coordinate; NaN -> 0.  *ok is cleared for an out-of-range
// cell unless clamp; the returned bin is clamped to [0, nbins).
template <typename T>
__device__ __forceinline__ int bin_of(T v, T lo, T scale, int divide,
                                      int nbins, int clamp, bool* ok) {
  T f = floor(bin_coord(v, lo, scale, (T)nbins, divide));
  if (f != f) f = (T)0;
  if (!clamp && !(f >= (T)0 && f < (T)nbins)) *ok = false;
  f = f < (T)0 ? (T)0 : f;
  f = f > (T)(nbins - 1) ? (T)(nbins - 1) : f;
  return (int)f;
}

template <typename A, typename T>
__device__ __forceinline__ void add_to(A* p, T v) {
  atomicAdd(p, (A)v);
}

#define FULL 0xffffffffu

// Sums each x[k] over `peers` (the lanes whose cells fall in this lane's bin)
// by a pairwise tree of shuffles; the group's lowest lane ends with the sums.
// Every lane of the warp calls it.  On smooth fields a warp's cells mostly
// share a bin: one atomic then adds the warp's sum instead of 32 cells one
// after another, so a float32 bin of a block adds up to 32x fewer rounded
// terms.
template <int N, typename T>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             T (&x)[N]) {
  int rel = __popc(peers & ((1u << lane) - 1u));     // rank in the group
  unsigned above = peers & ~((2u << lane) - 1u);     // the group's higher lanes
  while (__any_sync(FULL, above)) {
    int next = __ffs(above);                         // 1-based; 0: none
    for (int k = 0; k < N; ++k) {
      T t = __shfl_sync(FULL, x[k], next ? next - 1 : lane);
      if (next) x[k] = x[k] + t;
    }
    // odd ranks have been added into their lower neighbour: drop them
    above &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
}

// ---------------------------------------------------------------------------
// binned moments: accumulator layout per bin [hit, sum_0.., sq_0..]
template <typename T, typename A, bool SHARED>
__global__ void binned_kernel(BinnedParams p, A* acc_out,
                              typename Enc<T>::type* mm_out) {
  typedef typename Enc<T>::type E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = 1 + 2 * p.ncomp;
  const int nacc = p.nbins * slots;
  const int nmm = p.nbins * p.ncomp;
  A* acc;
  E* mn;
  long long start, end, step;
  if (SHARED) {
    acc = reinterpret_cast<A*>(smem_raw);
    mn = reinterpret_cast<E*>(smem_raw + sizeof(A) * nacc);
    for (int j = threadIdx.x; j < nacc; j += blockDim.x) acc[j] = (A)0;
    if (p.minmax) {
      for (int j = threadIdx.x; j < nmm; j += blockDim.x) {
        mn[j] = encode(pos_inf<T>());
        mn[nmm + j] = encode(-pos_inf<T>());
      }
    }
    __syncthreads();
    long long chunk = (p.n + p.nblocks - 1) / p.nblocks;
    start = (long long)blockIdx.x * chunk + threadIdx.x;
    end = min(p.n, (long long)(blockIdx.x + 1) * chunk);
    step = blockDim.x;
  } else {
    acc = acc_out;
    mn = mm_out;
    start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    end = p.n;
    step = (long long)gridDim.x * blockDim.x;
  }
  const T* bv = reinterpret_cast<const T*>(p.bin_ptr);
  const T* w = reinterpret_cast<const T*>(p.w_ptr);
  const unsigned char* mask = reinterpret_cast<const unsigned char*>(p.mask_ptr);
  const T* shift = reinterpret_cast<const T*>(p.shift_ptr);
  const T lo = (T)p.lo, scale = (T)p.scale, ws = (T)p.wscal;
  const int lane = threadIdx.x & 31;
  // the warp walks its cells together (i0 is the same in every lane), so
  // the lanes of a bin can be summed before the atomics
  for (long long i0 = start - lane; i0 < end; i0 += step) {
    const long long i = i0 + lane;
    bool ok = i < end && mask[i] != 0;
    int b = ok ? bin_of(bv[i], lo, scale, p.divide, p.nbins, p.clamp, &ok)
               : 0;
    const unsigned peers = __match_any_sync(FULL, ok ? b : -1);
    const bool leader = ok && __ffs(peers) - 1 == lane;
    T wc = ok ? (p.has_w ? w[i] : ws) : (T)0;
    A* a = acc + (long long)b * slots;
    T hit[1] = {ok ? (p.has_w ? wc : (T)1) : (T)0};
    reduce_peers(peers, lane, hit);
    if (leader) add_to(a, hit[0]);
    for (int k = 0; k < p.ncomp; ++k) {
      T m[2] = {(T)0, (T)0};
      if (ok) {
        T v = reinterpret_cast<const T*>(p.avg_ptr[k])[i];
        T vs = sub_rn(v, shift[k]);
        m[0] = mul_rn(wc, vs);
        m[1] = mul_rn(wc, mul_rn(vs, vs));
        if (p.minmax) {
          E e = encode(v);
          atomicMin(mn + b * p.ncomp + k, e);
          atomicMax(mn + nmm + b * p.ncomp + k, e);
        }
      }
      reduce_peers(peers, lane, m);
      if (leader) {
        add_to(a + 1 + k, m[0]);
        add_to(a + 1 + p.ncomp + k, m[1]);
      }
    }
  }
  if (SHARED) {
    __syncthreads();
    A* dst = acc_out + (long long)blockIdx.x * nacc;
    for (int j = threadIdx.x; j < nacc; j += blockDim.x) dst[j] = acc[j];
    if (p.minmax) {
      E* mdst = mm_out + (long long)blockIdx.x * 2 * nmm;
      for (int j = threadIdx.x; j < 2 * nmm; j += blockDim.x) mdst[j] = mn[j];
    }
  }
}

// partials [nparts, nbins * slots] (and [nparts, 2, nbins * ncomp]) summed
// over parts in order, in float64 -> hits [nbins], sums, sumsq, mins, maxs
// [nbins, ncomp] in T
template <typename T, typename A>
__global__ void binned_finish(BinnedParams p, int nparts, const A* part,
                              const typename Enc<T>::type* mm, T* hits,
                              T* sums, T* sumsq, T* mins, T* maxs) {
  typedef typename Enc<T>::type E;
  const int slots = 1 + 2 * p.ncomp;
  const int nacc = p.nbins * slots;
  const int nmm = p.nbins * p.ncomp;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nacc) {
    double s = 0.0;
    for (int b = 0; b < nparts; ++b) s += (double)part[(long long)b * nacc + j];
    int bin = j / slots, slot = j % slots;
    if (slot == 0) {
      hits[bin] = (T)(p.has_w ? s : s * p.wscal);
    } else if (slot <= p.ncomp) {
      sums[bin * p.ncomp + slot - 1] = (T)s;
    } else {
      sumsq[bin * p.ncomp + slot - 1 - p.ncomp] = (T)s;
    }
  }
  if (p.minmax && j < nmm) {
    E lo = mm[j], hi = mm[nmm + j];
    for (int b = 1; b < nparts; ++b) {
      lo = min(lo, mm[(long long)b * 2 * nmm + j]);
      hi = max(hi, mm[(long long)b * 2 * nmm + nmm + j]);
    }
    mins[j] = decode(lo);
    maxs[j] = decode(hi);
  }
}

template <typename T, typename E>
__global__ void fill_enc(E* mm, int nmm) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < nmm) {
    mm[j] = encode(pos_inf<T>());
    mm[nmm + j] = encode(-pos_inf<T>());
  }
}

static const int THREADS = 512;

static int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

template <typename T>
static int launch_binned(BinnedParams p, int shared, void* scratch,
                         void* mm_scratch, T* hits, T* sums, T* sumsq,
                         T* mins, T* maxs, cudaStream_t s) {
  typedef typename Enc<T>::type E;
  const int slots = 1 + 2 * p.ncomp;
  const int nacc = p.nbins * slots;
  const int nmm = p.nbins * p.ncomp;
  const int nfin = nacc > nmm ? nacc : nmm;
  if (shared) {
    size_t smem = sizeof(T) * nacc + (p.minmax ? sizeof(E) * 2 * nmm : 0);
    cudaError_t e = cudaFuncSetAttribute(
        binned_kernel<T, T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    binned_kernel<T, T, true><<<p.nblocks, THREADS, smem, s>>>(
        p, (T*)scratch, (E*)mm_scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    binned_finish<T, T><<<cdiv(nfin, 256), 256, 0, s>>>(
        p, p.nblocks, (const T*)scratch, (const E*)mm_scratch, hits, sums,
        sumsq, mins, maxs);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(double) * nacc, s);
  if (e != cudaSuccess) return (int)e;
  if (p.minmax) {
    fill_enc<T, E><<<cdiv(nmm, 256), 256, 0, s>>>((E*)mm_scratch, nmm);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  binned_kernel<T, double, false><<<p.nblocks, THREADS, 0, s>>>(
      p, (double*)scratch, (E*)mm_scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  binned_finish<T, double><<<cdiv(nfin, 256), 256, 0, s>>>(
      p, 1, (const double*)scratch, (const E*)mm_scratch, hits, sums, sumsq,
      mins, maxs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// joint pdfs: accumulator layout per pair [3][nbins * nbins] (b, bx1, bx2)
template <typename T, typename A, bool SHARED>
__global__ void joint_kernel(JointParams p, A* acc_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb2 = p.nbins * p.nbins;
  const int pair = blockIdx.y;
  const int vi = p.pi[pair], vj = p.pj[pair];
  A* acc;
  long long start, end, step;
  if (SHARED) {
    acc = reinterpret_cast<A*>(smem_raw);
    for (int j = threadIdx.x; j < 3 * nb2; j += blockDim.x) acc[j] = (A)0;
    __syncthreads();
    long long chunk = (p.n + p.nblocks - 1) / p.nblocks;
    start = (long long)blockIdx.x * chunk + threadIdx.x;
    end = min(p.n, (long long)(blockIdx.x + 1) * chunk);
    step = blockDim.x;
  } else {
    acc = acc_out + (long long)pair * 3 * nb2;
    start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    end = p.n;
    step = (long long)gridDim.x * blockDim.x;
  }
  const T* v1 = reinterpret_cast<const T*>(p.v_ptr[vi]);
  const T* v2 = reinterpret_cast<const T*>(p.v_ptr[vj]);
  const T* w = reinterpret_cast<const T*>(p.w_ptr);
  const unsigned char* mask = reinterpret_cast<const unsigned char*>(p.mask_ptr);
  const T* shift = reinterpret_cast<const T*>(p.shift_ptr);
  const T lo1 = (T)p.lo[vi], sc1 = (T)p.scale[vi];
  const T lo2 = (T)p.lo[vj], sc2 = (T)p.scale[vj];
  const T c1 = shift[vi], c2 = shift[vj];
  const T ws = (T)p.wscal;
  const int lane = threadIdx.x & 31;
  // a warp's lanes walk together and sum a bin's cells before the atomics,
  // as in binned_kernel
  for (long long i0 = start - lane; i0 < end; i0 += step) {
    const long long i = i0 + lane;
    const bool in = i < end && mask[i] != 0;
    int bin = 0;
    T x[3] = {(T)0, (T)0, (T)0};
    if (in) {
      bool ok = true;
      T a = v1[i], b = v2[i];
      int i1 = bin_of(a, lo1, sc1, p.divide, p.nbins, 1, &ok);
      int i2 = bin_of(b, lo2, sc2, p.divide, p.nbins, 1, &ok);
      bin = i1 * p.nbins + i2;
      T wc = p.has_w ? w[i] : ws;
      x[0] = p.has_w ? wc : (T)1;
      x[1] = mul_rn(wc, sub_rn(a, c1));
      x[2] = mul_rn(wc, sub_rn(b, c2));
    }
    const unsigned peers = __match_any_sync(FULL, in ? bin : -1);
    reduce_peers(peers, lane, x);
    if (in && __ffs(peers) - 1 == lane) {
      add_to(acc + bin, x[0]);
      add_to(acc + nb2 + bin, x[1]);
      add_to(acc + 2 * nb2 + bin, x[2]);
    }
  }
  if (SHARED) {
    __syncthreads();
    A* dst = acc_out + ((long long)pair * p.nblocks + blockIdx.x) * 3 * nb2;
    for (int j = threadIdx.x; j < 3 * nb2; j += blockDim.x) dst[j] = acc[j];
  }
}

// partials [npairs, nparts, 3 * nb2] summed over parts in order, in float64
// -> out [3, npairs, nbins, nbins] in T
template <typename T, typename A>
__global__ void joint_finish(JointParams p, int nparts, const A* part,
                             T* out) {
  const int nb2 = p.nbins * p.nbins;
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (long long)p.npairs * 3 * nb2) return;
  int pair = (int)(j / (3 * nb2));
  int r = (int)(j % (3 * nb2));
  int slot = r / nb2, bin = r % nb2;
  const A* src = part + (long long)pair * nparts * 3 * nb2 + r;
  double s = 0.0;
  for (int b = 0; b < nparts; ++b) s += (double)src[(long long)b * 3 * nb2];
  if (slot == 0 && !p.has_w) s *= p.wscal;
  out[((long long)slot * p.npairs + pair) * nb2 + bin] = (T)s;
}

template <typename T>
static int launch_joint(JointParams p, int shared, void* scratch, T* out,
                        cudaStream_t s) {
  const int nb2 = p.nbins * p.nbins;
  const long long nout = (long long)p.npairs * 3 * nb2;
  dim3 grid(p.nblocks, p.npairs);
  if (shared) {
    size_t smem = sizeof(T) * 3 * nb2;
    cudaError_t e = cudaFuncSetAttribute(
        joint_kernel<T, T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    joint_kernel<T, T, true><<<grid, THREADS, smem, s>>>(p, (T*)scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    joint_finish<T, T><<<cdiv(nout, 256), 256, 0, s>>>(
        p, p.nblocks, (const T*)scratch, out);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(double) * nout, s);
  if (e != cudaSuccess) return (int)e;
  joint_kernel<T, double, false><<<grid, THREADS, 0, s>>>(p, (double*)scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  joint_finish<T, double><<<cdiv(nout, 256), 256, 0, s>>>(
      p, 1, (const double*)scratch, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
extern "C" {

// scratch: shared variant [nblocks, nbins * (1 + 2 ncomp)] of the state type
// (and mm_scratch [nblocks, 2, nbins * ncomp] of its encoding), global
// variant [nbins * (1 + 2 ncomp)] float64 (mm_scratch [2, nbins * ncomp])
int stats_binned_f32(BinnedParams p, int shared, void* scratch,
                     void* mm_scratch, float* hits, float* sums, float* sumsq,
                     float* mins, float* maxs, void* stream) {
  return launch_binned<float>(p, shared, scratch, mm_scratch, hits, sums,
                              sumsq, mins, maxs, (cudaStream_t)stream);
}

int stats_binned_f64(BinnedParams p, int shared, void* scratch,
                     void* mm_scratch, double* hits, double* sums,
                     double* sumsq, double* mins, double* maxs, void* stream) {
  return launch_binned<double>(p, shared, scratch, mm_scratch, hits, sums,
                               sumsq, mins, maxs, (cudaStream_t)stream);
}

// scratch: shared variant [npairs, nblocks, 3, nbins^2] of the state type,
// global variant [npairs, 3, nbins^2] float64; out [3, npairs, nbins, nbins]
int stats_joint_f32(JointParams p, int shared, void* scratch, float* out,
                    void* stream) {
  return launch_joint<float>(p, shared, scratch, out, (cudaStream_t)stream);
}

int stats_joint_f64(JointParams p, int shared, void* scratch, double* out,
                    void* stream) {
  return launch_joint<double>(p, shared, scratch, out, (cudaStream_t)stream);
}

// the shared memory a block may use on the current device, for the
// wrapper's choice of variant
int stats_max_shared_bytes(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // extern "C"
