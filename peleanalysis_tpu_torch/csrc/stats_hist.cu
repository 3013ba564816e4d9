// Masked, weighted histograms on the H100: the binned moments of
// conditionalMean and the joint pdfs of jpdf.
//
// Replaces no Pallas kernel.  It is the H100 counterpart of the XLA one-hot
// contractions of peleanalysis_tpu/ops/stats.py (binned_stats :30,
// joint_pdf :137, joint_pdf_multi :184).  Those contract a [cells, nbins]
// one-hot on the TPU's matrix unit because scatter-adds serialize there; on
// the H100 a one-hot moves nbins times the data, so here every cell is read
// once and added into a histogram held in shared memory.
//
// Bound: bytes.  A cell costs a handful of flops and 1 + ncomp (or nv)
// values plus a mask byte; at 19.4 M float32 cells with one averaged
// component (or one pair) the inputs are ~175 MB, ~52 us at 3.35 TB/s.
//
// What bounds it in practice (measured, PERF.md §6): the card has no float
// add into shared memory, and atomicAdd there is a compare-and-swap loop
// (ATOMS.CAST.SPIN), about 40% of this kernel's time; the loads and the bin
// arithmetic alone take ~1.5x the bytes bound.  So the design cuts and
// spreads those atomics and keeps the memory stream simple; the
// alternatives tried (64-bit compare-and-swap over a slot pair, tiles
// sorted by bin, thread-block clusters with or without distributed shared
// memory, register prefetch) measured slower.
//
//  * Memory stream: a persistent grid (4 blocks of 512 threads an SM for
//    float32 binned moments, 2 for the joint pdfs, fewer where the shared
//    memory asks); a block walks a contiguous range of cells, each thread
//    16 bytes of each array at once (float4 / double2, the mask's 4 or 2
//    bytes).  A warp's last, partial stretch, or pointers off a 16-byte
//    boundary, take the same code one cell at a time with bounds; callers
//    pad nothing.
//  * Aggregation in registers: a thread's cells that share a bin (a run)
//    are summed before one atomic, and when every lane's cells share one bin
//    the warp sums them (5 shuffles a value) and one lane adds them: a warp
//    in a smooth field's flat region adds 128 cells at once.  Min/max fold
//    into the same run, and an atomicMax is issued only when the value beats
//    the slot's current one (a plain shared load first).  Counts with a
//    scalar weight are integers (ATOMS.ADD, exact).
//  * Privatized sub-histograms: the binned entry gives each warp its own
//    copy in shared memory where they fit, so colliding compare-and-swap
//    loops stay inside a warp.  A float32 copy is folded into the block's
//    float64 sums every round of cells: a slot adds at most BINNED_ADDS
//    (1024) rounded float32 terms between folds (ops/stats_kernels
//    .plan_binned), 6.1e-5 of its magnitude at worst.  A joint slot adds at
//    most one float32 term a run of its block's cells (plan.slot_adds).
//  * The joint entry accumulates every pair of a cell in one block (each
//    variable read once from device memory, its other pairs from L1): up to
//    3 pairs x 64^2 bins x (count + 2 sums) in float32 fit one block.
//  * Histograms no block holds (e.g. 256^2 joint bins, 16384 binned bins,
//    float64 joint pdfs of 3 pairs) go to device memory: one cell a lane,
//    a warp's equal bins summed by shuffles, float64 reductions into
//    planes (binned_device, joint_device).
//  * Finish: a second kernel sums the partials of every output slot in a
//    fixed order (8 groups of parts, each in order, then the groups in
//    order), in float64, on as many blocks as there are 32-slot groups, and
//    rounds once to the state's type; the result does not depend on the
//    order in which blocks finished.  Min/max are exact.
//  * Host: one scratch buffer a call, laid out by the plan; the
//    shared-memory attribute set when a kernel's size changes.
//
// Min/max keys: the ordered-integer encoding of the value's bits, made
// unsigned (key = enc ^ sign bit), the min stored as ~key, so both are an
// atomicMax on a zeroed slot and an empty slot decodes to +-inf.
//
// Bin index: in the state's type, one rounding per operation (the _rn
// intrinsics; built with --fmad=false), floored, in either of the two forms
// the JAX package computes: (v - lo) / span * nbins where the edges are
// traced values, and (v - lo) * K where XLA folded constant edges into
// K = fl(fl(1/span) * nbins).  NaN goes to bin 0 and the rest saturate as
// XLA's float->int32 cast does, so a cell lands in the bin the JAX package
// puts it in.
//
// Plain C interface for ctypes; every entry point returns the cudaError_t
// of its launches (0 on success).  Parameters travel by value in the
// structs of stats_hist_params.h.
#include <cuda_runtime.h>

#include "stats_hist_params.h"

#define FULL 0xffffffffu
enum { SHARED = 0, DEVICE = 1 };     // StatsPlan::variant

// ---------------------------------------------------------------------------
// type helpers
template <typename T> struct Key;
template <> struct Key<float> { typedef unsigned type; };
template <> struct Key<double> { typedef unsigned long long type; };

template <typename T, int VEC> struct VecT;
template <> struct VecT<float, 4> { typedef float4 type; };
template <> struct VecT<double, 2> { typedef double2 type; };
template <int VEC> struct MaskT;
template <> struct MaskT<4> { typedef uchar4 type; };
template <> struct MaskT<2> { typedef uchar2 type; };

__device__ __forceinline__ unsigned key_of(float v) {
  int b = __float_as_int(v);
  return (unsigned)(b >= 0 ? b : (b ^ 0x7fffffff)) ^ 0x80000000u;
}
__device__ __forceinline__ unsigned long long key_of(double v) {
  long long b = __double_as_longlong(v);
  return (unsigned long long)(b >= 0 ? b : (b ^ 0x7fffffffffffffffLL)) ^
         0x8000000000000000ull;
}
__device__ __forceinline__ float from_key(unsigned k, float) {
  int e = (int)(k ^ 0x80000000u);
  return __int_as_float(e >= 0 ? e : (e ^ 0x7fffffff));
}
__device__ __forceinline__ double from_key(unsigned long long k, double) {
  long long e = (long long)(k ^ 0x8000000000000000ull);
  return __longlong_as_double(e >= 0 ? e : (e ^ 0x7fffffffffffffffLL));
}
template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double pos_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
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

// floor of the bin coordinate, converted as XLA's float->int32 cast does
// (saturating, NaN -> 0; cvt.rmi).  *ok is cleared for an out-of-range
// cell unless clamp; the returned bin is clamped to [0, nbins).
__device__ __forceinline__ int floor_int(float x) { return __float2int_rd(x); }
__device__ __forceinline__ int floor_int(double x) {
  return __double2int_rd(x);
}
template <typename T>
__device__ __forceinline__ int bin_of(T v, T lo, T scale, int divide,
                                      int nbins, int clamp, bool* ok) {
  const int b = floor_int(bin_coord(v, lo, scale, (T)nbins, divide));
  if (!clamp && (b < 0 || b >= nbins)) *ok = false;
  return min(max(b, 0), nbins - 1);
}

// VEC consecutive values from i on: WHOLE, all of them, in one 16-byte load
// (VEC > 1); else the first nvalid (the rest 0), one at a time
template <bool WHOLE, typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, long long i,
                                         int nvalid, T (&x)[VEC]) {
  if constexpr (WHOLE && VEC > 1) {
    typedef typename VecT<T, VEC>::type V;
    V v = __ldg(reinterpret_cast<const V*>(p + i));
    const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int c = 0; c < VEC; ++c) x[c] = t[c];
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      x[c] = WHOLE || c < nvalid ? __ldg(p + i + c) : (T)0;
  }
}

template <bool WHOLE, int VEC>
__device__ __forceinline__ void load_mask(const unsigned char* __restrict__ p,
                                          long long i, int nvalid,
                                          bool (&m)[VEC]) {
  if constexpr (WHOLE && VEC > 1) {
    typedef typename MaskT<VEC>::type V;
    V v = __ldg(reinterpret_cast<const V*>(p + i));
    const unsigned char* t = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
    for (int c = 0; c < VEC; ++c) m[c] = t[c] != 0;
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      m[c] = (WHOLE || c < nvalid) && __ldg(p + i + c) != 0;
  }
}

template <typename T> __device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = x + __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ unsigned warp_max(unsigned x) {
  return __reduce_max_sync(FULL, x);
}
__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    unsigned long long y = __shfl_xor_sync(FULL, x, o);
    x = y > x ? y : x;
  }
  return x;
}

// ---------------------------------------------------------------------------
// Shared variant: a block's histograms in shared memory.  One histogram of
// nb bins: S accumulator slots a bin [nb][S], min/max keys [2][nb][ncomp]
// (max, then ~min), counts [nb].
template <typename T, typename K> struct View {
  T* acc;
  K* mm;
  unsigned* cnt;
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

// bytes of one histogram of nb bins: acc, then keys, then counts
template <typename T, typename K>
__device__ __forceinline__ long long copy_bytes(int nb, int S, int nmm,
                                                int has_cnt) {
  return align16((long long)nb * S * sizeof(T)) +
         align16((long long)2 * nb * nmm * sizeof(K)) +
         (has_cnt ? align16((long long)nb * 4) : 0);
}

template <typename T, typename K>
__device__ __forceinline__ View<T, K> view_at(unsigned char* base, int nb,
                                              int S, int nmm) {
  View<T, K> v;
  v.acc = reinterpret_cast<T*>(base);
  v.mm = reinterpret_cast<K*>(base + align16((long long)nb * S * sizeof(T)));
  v.cnt = reinterpret_cast<unsigned*>(
      base + align16((long long)nb * S * sizeof(T)) +
      align16((long long)2 * nb * nmm * sizeof(K)));
  return v;
}

// the slot's max with k: a plain load first skips the atomic when k cannot
// raise it (most cells, once a bin has seen a few)
template <typename K>
__device__ __forceinline__ void key_max(K* p, K k) {
  if (k > *reinterpret_cast<volatile K*>(p)) atomicMax(p, k);
}

// ok[c] and bin[c] of a lane's cells -> run ends, and the lane's key: the
// bin of its one run, -1 no cell, -2 several runs
template <int VEC>
__device__ __forceinline__ int runs(const bool (&ok)[VEC],
                                    const int (&bin)[VEC],
                                    bool (&last)[VEC]) {
  int key = -1;
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    if (ok[c]) key = key == -1 || key == bin[c] ? bin[c] : -2;
  int next = -1;
#pragma unroll
  for (int c = VEC - 1; c >= 0; --c) {
    last[c] = ok[c] && bin[c] != next;
    if (ok[c]) next = bin[c];
  }
  return key;
}

template <bool B> struct Whole { static constexpr bool value = B; };

// The block's cells [start, end) and the warp's part of them: 32 x VEC
// consecutive cells a step, v0 the same in every lane; step(Whole<true>,
// v0) where all of them lie below end (the loads need no bounds), and
// step(Whole<false>, v0) for the warp's last, partial stretch.
template <int VEC, typename F>
__device__ __forceinline__ void walk(long long start, long long end, F step) {
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)blockDim.x * VEC;
  long long v0 = start + (long long)warp * 32 * VEC;
  for (; v0 + 32 * VEC <= end; v0 += stride) step(Whole<true>(), v0);
  if (v0 < end) step(Whole<false>(), v0);
}

// binned moments: slots a bin [sum_0, sq_0, sum_1, sq_1, ..., then the
// weight sum and a pad if has_w].  A sub-histogram a warp (ncopies of them,
// warp w adding into copy w % ncopies), folded into the block's float64
// sums every round_cells cells, then the block's partial: sums [S][bins] in
// float64, keys [2][bins][ncomp], counts [bins].
template <typename T, int VEC>
__global__ void __launch_bounds__(512, sizeof(T) == 4 ? 4 : 2)
    binned_kernel(BinnedParams p, unsigned char* scratch) {
  typedef typename Key<T>::type K;
  extern __shared__ __align__(16) unsigned char smem[];
  const StatsPlan& pl = p.plan;
  const int ncomp = p.ncomp, hw = p.has_w, S = 2 * ncomp + 2 * hw;
  const int nmm = p.minmax ? ncomp : 0, NB = p.nbins;
  const int threads = blockDim.x, ncopies = pl.ncopies;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cb = copy_bytes<T, K>(NB, S, nmm, !hw);
  double* acc64 = reinterpret_cast<double*>(smem + ncopies * cb);
  const View<T, K> v = view_at<T, K>(smem + (warp % ncopies) * cb, NB, S,
                                     nmm);
  {
    unsigned* z = reinterpret_cast<unsigned*>(smem);
    const long long words = (ncopies * cb) / 4 + 2LL * NB * S;
    for (long long j = threadIdx.x; j < words; j += threads) z[j] = 0u;
  }
  __syncthreads();
  const T* bv = reinterpret_cast<const T*>(p.bin_ptr);
  const T* w = reinterpret_cast<const T*>(p.w_ptr);
  const unsigned char* mask =
      reinterpret_cast<const unsigned char*>(p.mask_ptr);
  const T* shift = reinterpret_cast<const T*>(p.shift_ptr);
  const T lo = (T)p.lo, scale = (T)p.scale, ws = (T)p.wscal;
  auto step = [&](auto whole, long long v0, long long end) {
    constexpr bool WHOLE = decltype(whole)::value;
    const long long i = v0 + lane * VEC;
    const int nvalid = WHOLE ? VEC : (int)max(0LL, min((long long)VEC,
                                                       end - i));
    T x[VEC], wc[VEC];
    bool ok[VEC], last[VEC];
    int bin[VEC];
    load_vec<WHOLE>(bv, i, nvalid, x);
    load_mask<WHOLE>(mask, i, nvalid, ok);
    if (hw) {
      load_vec<WHOLE>(w, i, nvalid, wc);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) wc[c] = ws;
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      bin[c] = bin_of(x[c], lo, scale, p.divide, NB, p.clamp, &ok[c]);
    const int key = runs(ok, bin, last);
    const int top = __reduce_max_sync(FULL, key);
    // every lane's cells in bin top: the warp sums them, lane 0 adds
    const bool uni = top >= 0 && __all_sync(FULL, key == top || key == -1);
    if (uni) {
      if (hw) {
        T h = (T)0;
#pragma unroll
        for (int c = 0; c < VEC; ++c) if (ok[c]) h = h + wc[c];
        h = warp_sum(h);
        if (lane == 0) atomicAdd(v.acc + (long long)top * S + 2 * ncomp, h);
      } else {
        unsigned h = 0;
#pragma unroll
        for (int c = 0; c < VEC; ++c) h += ok[c];
        h = __reduce_add_sync(FULL, h);
        if (lane == 0) atomicAdd(v.cnt + top, h);
      }
    } else {
      T h = (T)0;
      unsigned hc = 0;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (!ok[c]) continue;
        if (hw) h = h + wc[c]; else ++hc;
        if (last[c]) {
          if (hw) atomicAdd(v.acc + (long long)bin[c] * S + 2 * ncomp, h);
          else atomicAdd(v.cnt + bin[c], hc);
          h = (T)0;
          hc = 0;
        }
      }
    }
    for (int k = 0; k < ncomp; ++k) {
      T av[VEC];
      load_vec<WHOLE>(reinterpret_cast<const T*>(p.avg_ptr[k]), i, nvalid,
                      av);
      const T sh = shift[k];
      T s1 = (T)0, s2 = (T)0;
      K kmax = 0, kmin = 0;               // max key, ~min key
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (!ok[c]) continue;
        const T vs = sub_rn(av[c], sh);
        s1 = s1 + mul_rn(wc[c], vs);
        s2 = s2 + mul_rn(wc[c], mul_rn(vs, vs));
        if (nmm) {
          const K kk = key_of(av[c]);
          kmax = kk > kmax ? kk : kmax;
          kmin = (K)~kk > kmin ? (K)~kk : kmin;
        }
        if (!uni && last[c]) {
          T* a = v.acc + (long long)bin[c] * S + 2 * k;
          atomicAdd(a, s1);
          atomicAdd(a + 1, s2);
          if (nmm) {
            key_max(v.mm + (long long)bin[c] * nmm + k, kmax);
            key_max(v.mm + (long long)(NB + bin[c]) * nmm + k, kmin);
          }
          s1 = s2 = (T)0;
          kmax = kmin = 0;
        }
      }
      if (uni) {
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (nmm) {
          kmax = warp_max(kmax);
          kmin = warp_max(kmin);
        }
        if (lane == 0) {
          T* a = v.acc + (long long)top * S + 2 * k;
          atomicAdd(a, s1);
          atomicAdd(a + 1, s2);
          if (nmm) {
            key_max(v.mm + (long long)top * nmm + k, kmax);
            key_max(v.mm + (long long)(NB + top) * nmm + k, kmin);
          }
        }
      }
    }
  };
  const long long bstart = (long long)blockIdx.x * pl.chunk;
  const long long bend = min(p.n, bstart + pl.chunk);
  for (long long r0 = bstart; r0 < bend; r0 += pl.round_cells) {
    const long long rend = min(bend, r0 + pl.round_cells);
    walk<VEC>(r0, rend, [&](auto whole, long long v0) {
      step(whole, v0, rend);
    });
    // fold the sub-histograms' sums into the block's float64 sums, in
    // copy order
    __syncthreads();
    for (int j = threadIdx.x; j < NB * S; j += threads) {
      double s = acc64[j];
      for (int c = 0; c < ncopies; ++c) {
        T* a = reinterpret_cast<T*>(smem + c * cb) + j;
        s += (double)*a;
        *a = (T)0;
      }
      acc64[j] = s;
    }
    __syncthreads();
  }
  double* pacc = reinterpret_cast<double*>(scratch + pl.acc_off);
  K* pmm = reinterpret_cast<K*>(scratch + pl.mm_off);
  unsigned* pcnt = reinterpret_cast<unsigned*>(scratch + pl.cnt_off);
  const long long part = blockIdx.x;
  for (int j = threadIdx.x; j < NB * S; j += threads) {
    const int sl = j / NB, b = j % NB;
    pacc[(part * S + sl) * NB + b] = acc64[b * S + sl];
  }
  for (int j = threadIdx.x; j < 2 * NB * nmm; j += threads) {
    K m = 0;
    for (int c = 0; c < ncopies; ++c) {
      const K x = view_at<T, K>(smem + c * cb, NB, S, nmm).mm[j];
      m = x > m ? x : m;
    }
    pmm[part * 2 * NB * nmm + j] = m;
  }
  if (!hw) {
    for (int j = threadIdx.x; j < NB; j += threads) {
      unsigned s = 0;
      for (int c = 0; c < ncopies; ++c)
        s += view_at<T, K>(smem + c * cb, NB, S, nmm).cnt[j];
      pcnt[part * NB + j] = s;
    }
  }
}

// joint pdfs: bins are (pair, i1, i2) flattened, pair * nbins^2 + i1 * nbins
// + i2, slots a bin [bx1, bx2, then the weight sum and a pad if has_w]; one
// histogram a block, every pair of a cell added by the block, then the
// block's partial: sums [S][bins] in T, counts [bins].
template <typename T, int VEC>
__global__ void __launch_bounds__(1024, 1)
    joint_kernel(JointParams p, unsigned char* scratch) {
  typedef typename Key<T>::type K;
  extern __shared__ __align__(16) unsigned char smem[];
  const StatsPlan& pl = p.plan;
  const int hw = p.has_w, S = 2 + 2 * hw, nbins = p.nbins;
  const int nb2 = nbins * nbins, NB = p.npairs * nb2;
  const int threads = blockDim.x, lane = threadIdx.x & 31;
  const View<T, K> v = view_at<T, K>(smem, NB, S, 0);
  {
    unsigned* z = reinterpret_cast<unsigned*>(smem);
    const long long words = copy_bytes<T, K>(NB, S, 0, !hw) / 4;
    for (long long j = threadIdx.x; j < words; j += threads) z[j] = 0u;
  }
  __syncthreads();
  const T* w = reinterpret_cast<const T*>(p.w_ptr);
  const unsigned char* mask =
      reinterpret_cast<const unsigned char*>(p.mask_ptr);
  const T* shift = reinterpret_cast<const T*>(p.shift_ptr);
  const T ws = (T)p.wscal;
  const long long bstart = (long long)blockIdx.x * pl.chunk;
  const long long bend = min(p.n, bstart + pl.chunk);
  walk<VEC>(bstart, bend, [&](auto whole, long long v0) {
    constexpr bool WHOLE = decltype(whole)::value;
    const long long i = v0 + lane * VEC;
    const int nvalid = WHOLE ? VEC : (int)max(0LL, min((long long)VEC,
                                                       bend - i));
    T wc[VEC];
    bool in[VEC];
    load_mask<WHOLE>(mask, i, nvalid, in);
    if (hw) {
      load_vec<WHOLE>(w, i, nvalid, wc);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) wc[c] = ws;
    }
    for (int q = 0; q < p.npairs; ++q) {
      const int vi = p.pi[q], vj = p.pj[q];
      T a[VEC], b[VEC];
      // a variable's later pairs find its values in L1
      load_vec<WHOLE>(reinterpret_cast<const T*>(p.v_ptr[vi]), i, nvalid, a);
      load_vec<WHOLE>(reinterpret_cast<const T*>(p.v_ptr[vj]), i, nvalid, b);
      const T lo1 = (T)p.lo[vi], sc1 = (T)p.scale[vi];
      const T lo2 = (T)p.lo[vj], sc2 = (T)p.scale[vj];
      const T c1 = shift[vi], c2 = shift[vj];
      int bin[VEC];
      bool last[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        bool keep = true;
        const int i1 = bin_of(a[c], lo1, sc1, p.divide, nbins, 1, &keep);
        const int i2 = bin_of(b[c], lo2, sc2, p.divide, nbins, 1, &keep);
        bin[c] = q * nb2 + i1 * nbins + i2;
      }
      const int key = runs(in, bin, last);
      const int top = __reduce_max_sync(FULL, key);
      const bool uni = top >= 0 && __all_sync(FULL, key == top || key == -1);
      T h = (T)0, x1 = (T)0, x2 = (T)0;
      unsigned hc = 0;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (!in[c]) continue;
        if (hw) h = h + wc[c]; else ++hc;
        x1 = x1 + mul_rn(wc[c], sub_rn(a[c], c1));
        x2 = x2 + mul_rn(wc[c], sub_rn(b[c], c2));
        if (!uni && last[c]) {
          T* s = v.acc + (long long)bin[c] * S;
          atomicAdd(s, x1);
          atomicAdd(s + 1, x2);
          if (hw) atomicAdd(s + 2, h); else atomicAdd(v.cnt + bin[c], hc);
          h = x1 = x2 = (T)0;
          hc = 0;
        }
      }
      if (uni) {
        x1 = warp_sum(x1);
        x2 = warp_sum(x2);
        if (hw) h = warp_sum(h); else hc = __reduce_add_sync(FULL, hc);
        if (lane == 0) {
          T* s = v.acc + (long long)top * S;
          atomicAdd(s, x1);
          atomicAdd(s + 1, x2);
          if (hw) atomicAdd(s + 2, h); else atomicAdd(v.cnt + top, hc);
        }
      }
    }
  });
  __syncthreads();
  T* pacc = reinterpret_cast<T*>(scratch + pl.acc_off);
  unsigned* pcnt = reinterpret_cast<unsigned*>(scratch + pl.cnt_off);
  const long long part = blockIdx.x;
  for (int j = threadIdx.x; j < NB * S; j += threads) {
    const int sl = j / NB, b = j % NB;
    pacc[(part * S + sl) * NB + b] = v.acc[(long long)b * S + sl];
  }
  if (!hw) {
    for (int j = threadIdx.x; j < NB; j += threads)
      pcnt[part * NB + j] = v.cnt[j];
  }
}

// ---------------------------------------------------------------------------
// Device-memory variant, for histograms that no block's shared memory
// holds: one cell a lane, the lanes of a warp whose cells share a bin
// summed by a tree of shuffles (__match_any_sync), and the group's lowest
// lane adds them with float64 reductions (REDG.E.ADD.F64) into one
// accumulator laid out as a partial: sums [S][bins] (a plane a slot, the
// counts or weight sums in plane S - 2), keys [2][bins][ncomp].  The
// planes measured faster than a bin's slots side by side, and float64
// counts faster than 32-bit integer reductions.

// Sums each x[k] over `peers` (the lanes whose cells share this lane's bin)
// by a pairwise tree of shuffles; the group's lowest lane ends with the
// sums.  Every lane of the warp calls it.
template <int N, typename T>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             T (&x)[N]) {
  int rel = __popc(peers & ((1u << lane) - 1u));     // rank in the group
  unsigned above = peers & ~((2u << lane) - 1u);     // the group's higher lanes
  while (__any_sync(FULL, above)) {
    const int next = __ffs(above);                   // 1-based; 0: none
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T t = __shfl_sync(FULL, x[k], next ? next - 1 : lane);
      if (next) x[k] = x[k] + t;
    }
    // odd ranks have been added into their lower neighbour: drop them
    above &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
}

template <typename K>
__device__ __forceinline__ K group_max(unsigned peers, int lane, K x) {
  K m[1] = {x};
  // max is order-free: the same tree, with max for the sum
  int rel = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(FULL, above)) {
    const int next = __ffs(above);
    const K t = __shfl_sync(FULL, m[0], next ? next - 1 : lane);
    if (next && t > m[0]) m[0] = t;
    above &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
  return m[0];
}

template <typename T>
__global__ void __launch_bounds__(512, 4)
    binned_device(BinnedParams p, unsigned char* scratch) {
  typedef typename Key<T>::type K;
  const StatsPlan& pl = p.plan;
  const int ncomp = p.ncomp, hw = p.has_w, NB = p.nbins;
  const int nmm = p.minmax ? ncomp : 0;
  double* acc = reinterpret_cast<double*>(scratch + pl.acc_off);
  K* mm = reinterpret_cast<K*>(scratch + pl.mm_off);
  const T* bv = reinterpret_cast<const T*>(p.bin_ptr);
  const T* w = reinterpret_cast<const T*>(p.w_ptr);
  const unsigned char* mask =
      reinterpret_cast<const unsigned char*>(p.mask_ptr);
  const T* shift = reinterpret_cast<const T*>(p.shift_ptr);
  const T lo = (T)p.lo, scale = (T)p.scale, ws = (T)p.wscal;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x;
  // the warp's lanes walk together (i0 the same in every lane)
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
       i0 < p.n; i0 += step) {
    const long long i = i0 + lane;
    bool ok = i < p.n && __ldg(mask + i) != 0;
    const int b = ok ? bin_of(__ldg(bv + i), lo, scale, p.divide, NB,
                              p.clamp, &ok)
                     : 0;
    const unsigned peers = __match_any_sync(FULL, ok ? b : -1);
    const bool leader = ok && __ffs(peers) - 1 == lane;
    const T wc = ok ? (hw ? __ldg(w + i) : ws) : (T)0;
    T h[1] = {ok ? (hw ? wc : (T)1) : (T)0};
    reduce_peers(peers, lane, h);
    if (leader) atomicAdd(acc + (long long)2 * ncomp * NB + b, (double)h[0]);
    for (int k = 0; k < ncomp; ++k) {
      T m[2] = {(T)0, (T)0};
      K kmax = 0, kmin = 0;
      if (ok) {
        const T v = __ldg(reinterpret_cast<const T*>(p.avg_ptr[k]) + i);
        const T vs = sub_rn(v, shift[k]);
        m[0] = mul_rn(wc, vs);
        m[1] = mul_rn(wc, mul_rn(vs, vs));
        kmax = key_of(v);
        kmin = (K)~kmax;
      }
      reduce_peers(peers, lane, m);
      if (nmm) {
        kmax = group_max(peers, lane, kmax);
        kmin = group_max(peers, lane, kmin);
      }
      if (leader) {
        atomicAdd(acc + (long long)(2 * k) * NB + b, (double)m[0]);
        atomicAdd(acc + (long long)(2 * k + 1) * NB + b, (double)m[1]);
        if (nmm) {
          atomicMax(mm + (long long)b * nmm + k, kmax);
          atomicMax(mm + (long long)(NB + b) * nmm + k, kmin);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(512, 4)
    joint_device(JointParams p, unsigned char* scratch) {
  const StatsPlan& pl = p.plan;
  const int hw = p.has_w, nbins = p.nbins, nb2 = nbins * nbins;
  const long long NB = (long long)p.npairs * nb2;
  double* acc = reinterpret_cast<double*>(scratch + pl.acc_off);
  const T* w = reinterpret_cast<const T*>(p.w_ptr);
  const unsigned char* mask =
      reinterpret_cast<const unsigned char*>(p.mask_ptr);
  const T* shift = reinterpret_cast<const T*>(p.shift_ptr);
  const T ws = (T)p.wscal;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
       i0 < p.n; i0 += step) {
    const long long i = i0 + lane;
    const bool in = i < p.n && __ldg(mask + i) != 0;
    const T wc = in ? (hw ? __ldg(w + i) : ws) : (T)0;
    for (int q = 0; q < p.npairs; ++q) {
      const int vi = p.pi[q], vj = p.pj[q];
      long long f = 0;
      T x[3] = {(T)0, (T)0, (T)0};
      if (in) {
        bool keep = true;
        const T a = __ldg(reinterpret_cast<const T*>(p.v_ptr[vi]) + i);
        const T b = __ldg(reinterpret_cast<const T*>(p.v_ptr[vj]) + i);
        const int i1 = bin_of(a, (T)p.lo[vi], (T)p.scale[vi], p.divide, nbins,
                              1, &keep);
        const int i2 = bin_of(b, (T)p.lo[vj], (T)p.scale[vj], p.divide, nbins,
                              1, &keep);
        f = (long long)q * nb2 + i1 * nbins + i2;
        x[0] = mul_rn(wc, sub_rn(a, shift[vi]));
        x[1] = mul_rn(wc, sub_rn(b, shift[vj]));
        x[2] = hw ? wc : (T)1;
      }
      const unsigned peers = __match_any_sync(FULL, in ? (int)f : -1);
      reduce_peers(peers, lane, x);
      if (in && __ffs(peers) - 1 == lane) {
        atomicAdd(acc + f, (double)x[0]);
        atomicAdd(acc + NB + f, (double)x[1]);
        atomicAdd(acc + 2 * NB + f, (double)x[2]);
      }
    }
  }
}

// The partials of every output slot summed over parts in a fixed order:
// block (32, 8); lane x takes slot 32 * blockIdx.x + x, group y the parts
// [y P / 8, (y + 1) P / 8) in order, then group 0 adds the 8 group sums in
// order.  Sums in float64, rounded once to T; keys by max.
#define FIN_GROUPS 8

// binned: hits [nbins], sums, sumsq, mins, maxs [nbins, ncomp]
template <typename T>
__global__ void binned_finish(BinnedParams p, const unsigned char* scratch,
                              T* hits, T* sums, T* sumsq, T* mins, T* maxs) {
  typedef typename Key<T>::type K;
  __shared__ double gs[FIN_GROUPS][32];
  __shared__ K gk[FIN_GROUPS][32];
  const StatsPlan& pl = p.plan;
  const int NB = p.nbins, ncomp = p.ncomp, hw = p.has_w;
  // weight sums, or device memory's counts, in a slot pair of their own
  const int hs = hw || pl.variant == DEVICE;
  const int S = 2 * ncomp + 2 * hs, nmm = p.minmax ? ncomp : 0;
  const double* acc = reinterpret_cast<const double*>(scratch + pl.acc_off);
  const K* mm = reinterpret_cast<const K*>(scratch + pl.mm_off);
  const unsigned* cnt = reinterpret_cast<const unsigned*>(scratch + pl.cnt_off);
  const long long nsum = (long long)NB * (1 + 2 * ncomp);
  const long long nkey = 2LL * NB * nmm;
  const long long j = (long long)blockIdx.x * 32 + threadIdx.x;
  const int g = threadIdx.y, P = pl.nparts;
  const int qa = (int)((long long)P * g / FIN_GROUPS);
  const int qb = (int)((long long)P * (g + 1) / FIN_GROUPS);
  if (j < nsum) {
    double s = 0.0;
    if (j < NB && !hs) {
      for (int q = qa; q < qb; ++q) s += (double)cnt[(long long)q * NB + j];
    } else {
      // the slot and bin of output j: sums, then sums of squares, each
      // [bin][comp]
      long long sl, b;
      if (j < NB) {
        sl = 2 * ncomp;
        b = j;
      } else {
        const long long r = (j - NB) % ((long long)NB * ncomp);
        sl = 2 * (r % ncomp) + (j - NB) / ((long long)NB * ncomp);
        b = r / ncomp;
      }
      for (int q = qa; q < qb; ++q) s += acc[((long long)q * S + sl) * NB + b];
    }
    gs[g][threadIdx.x] = s;
  } else if (j < nsum + nkey) {
    const long long r = j - nsum;
    K m = 0;
    for (int q = qa; q < qb; ++q) {
      const K x = mm[(long long)q * 2 * NB * nmm + r];
      m = x > m ? x : m;
    }
    gk[g][threadIdx.x] = m;
  }
  __syncthreads();
  if (g != 0) return;
  if (j < nsum) {
    double s = gs[0][threadIdx.x];
    for (int y = 1; y < FIN_GROUPS; ++y) s += gs[y][threadIdx.x];
    if (j < NB) {
      hits[j] = (T)(hw ? s : s * p.wscal);
    } else {
      const long long r = (j - NB) % ((long long)NB * ncomp);
      ((j - NB) < (long long)NB * ncomp ? sums : sumsq)[r] = (T)s;
    }
  } else if (j < nsum + nkey) {
    K m = gk[0][threadIdx.x];
    for (int y = 1; y < FIN_GROUPS; ++y)
      m = gk[y][threadIdx.x] > m ? gk[y][threadIdx.x] : m;
    const long long r = j - nsum;
    if (r < (long long)NB * nmm) {
      maxs[r] = m ? from_key(m, (T)0) : -pos_inf<T>();
    } else {
      mins[r - (long long)NB * nmm] = m ? from_key((K)~m, (T)0) : pos_inf<T>();
    }
  }
}

// joint: out [3][npairs * nbins^2] (b, bx1, bx2), as binned_finish
template <typename T, typename PT>
__global__ void joint_finish(JointParams p, const unsigned char* scratch,
                             T* out) {
  __shared__ double gs[FIN_GROUPS][32];
  const StatsPlan& pl = p.plan;
  const int hw = p.has_w, hs = hw || pl.variant == DEVICE, S = 2 + 2 * hs;
  const long long NB = (long long)p.npairs * p.nbins * p.nbins;
  const PT* acc = reinterpret_cast<const PT*>(scratch + pl.acc_off);
  const unsigned* cnt = reinterpret_cast<const unsigned*>(scratch + pl.cnt_off);
  const long long j = (long long)blockIdx.x * 32 + threadIdx.x;
  const int g = threadIdx.y, P = pl.nparts;
  const int qa = (int)((long long)P * g / FIN_GROUPS);
  const int qb = (int)((long long)P * (g + 1) / FIN_GROUPS);
  const int slot = (int)(j / NB);
  const long long f = j % NB;
  if (j < 3 * NB) {
    double s = 0.0;
    if (slot == 0 && !hs) {
      for (int q = qa; q < qb; ++q) s += (double)cnt[q * NB + f];
    } else {
      const int sl = slot == 0 ? 2 : slot - 1;
      for (int q = qa; q < qb; ++q) s += (double)acc[(q * S + sl) * NB + f];
    }
    gs[g][threadIdx.x] = s;
  }
  __syncthreads();
  if (g != 0 || j >= 3 * NB) return;
  double s = gs[0][threadIdx.x];
  for (int y = 1; y < FIN_GROUPS; ++y) s += gs[y][threadIdx.x];
  out[j] = (T)(slot == 0 && !hw ? s * p.wscal : s);
}

// ---------------------------------------------------------------------------
// launches
static int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// the dynamic shared-memory attribute, set when a kernel's size on a device
// changes, not every launch
static cudaError_t allow_smem(const void* fn, int bytes) {
  struct Entry { const void* fn; int dev, bytes; };
  static Entry seen[64];
  static int nseen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Entry* hit = nullptr;
  for (int k = 0; k < nseen; ++k)
    if (seen[k].fn == fn && seen[k].dev == dev) hit = &seen[k];
  if (!hit) {
    if (nseen == 64) nseen = 0;     // forget, and set again below
    hit = &seen[nseen++];
    *hit = Entry{fn, dev, -1};
  }
  if (hit->bytes != bytes) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    hit->bytes = bytes;
  }
  return cudaSuccess;
}

template <typename P>
static cudaError_t launch(void (*fn)(P, unsigned char*), const P& p,
                          unsigned char* scratch, cudaStream_t s) {
  const StatsPlan& pl = p.plan;
  cudaError_t e;
  if (pl.variant == DEVICE) {
    e = cudaMemsetAsync(scratch, 0, (size_t)pl.scratch_bytes, s);
  } else {
    e = allow_smem((const void*)fn, pl.smem);
  }
  if (e != cudaSuccess) return e;
  fn<<<pl.nblocks, pl.threads, pl.smem, s>>>(p, scratch);
  return cudaGetLastError();
}

// the histogram kernel of a plan: 16-byte loads (V cells) or one cell
template <typename T, int V>
static void (*binned_fn(const StatsPlan& pl))(BinnedParams, unsigned char*) {
  if (pl.variant == DEVICE) return &binned_device<T>;
  return pl.vec == V ? &binned_kernel<T, V> : &binned_kernel<T, 1>;
}

template <typename T, int V>
static void (*joint_fn(const StatsPlan& pl))(JointParams, unsigned char*) {
  if (pl.variant == DEVICE) return &joint_device<T>;
  return pl.vec == V ? &joint_kernel<T, V> : &joint_kernel<T, 1>;
}

template <typename T, int V>
static int launch_binned(const BinnedParams& p, void* scratch, T* hits,
                         T* sums, T* sumsq, T* mins, T* maxs,
                         cudaStream_t s) {
  unsigned char* sc = reinterpret_cast<unsigned char*>(scratch);
  cudaError_t e = launch(binned_fn<T, V>(p.plan), p, sc, s);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)p.nbins * (1 + 2 * p.ncomp) +
                          (p.minmax ? 2LL * p.nbins * p.ncomp : 0);
  binned_finish<T><<<cdiv(slots, 32), dim3(32, FIN_GROUPS), 0, s>>>(
      p, sc, hits, sums, sumsq, mins, maxs);
  return (int)cudaGetLastError();
}

template <typename T, int V>
static int launch_joint(const JointParams& p, void* scratch, T* out,
                        cudaStream_t s) {
  unsigned char* sc = reinterpret_cast<unsigned char*>(scratch);
  cudaError_t e = launch(joint_fn<T, V>(p.plan), p, sc, s);
  if (e != cudaSuccess) return (int)e;
  const long long slots = 3LL * p.npairs * p.nbins * p.nbins;
  if (p.plan.variant == DEVICE) {
    joint_finish<T, double><<<cdiv(slots, 32), dim3(32, FIN_GROUPS), 0, s>>>(
        p, sc, out);
  } else {
    joint_finish<T, T><<<cdiv(slots, 32), dim3(32, FIN_GROUPS), 0, s>>>(
        p, sc, out);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
extern "C" {

// scratch: plan.scratch_bytes, laid out by the plan (acc_off, mm_off,
// cnt_off); mins/maxs unused without minmax
int stats_binned_f32(BinnedParams p, void* scratch, float* hits, float* sums,
                     float* sumsq, float* mins, float* maxs, void* stream) {
  return launch_binned<float, 4>(p, scratch, hits, sums, sumsq, mins, maxs,
                                 (cudaStream_t)stream);
}

int stats_binned_f64(BinnedParams p, void* scratch, double* hits,
                     double* sums, double* sumsq, double* mins, double* maxs,
                     void* stream) {
  return launch_binned<double, 2>(p, scratch, hits, sums, sumsq, mins, maxs,
                                  (cudaStream_t)stream);
}

// out [3, npairs, nbins, nbins] (b, bx1, bx2)
int stats_joint_f32(JointParams p, void* scratch, float* out, void* stream) {
  return launch_joint<float, 4>(p, scratch, out, (cudaStream_t)stream);
}

int stats_joint_f64(JointParams p, void* scratch, double* out, void* stream) {
  return launch_joint<double, 2>(p, scratch, out, (cudaStream_t)stream);
}

// the shared memory a block may use on the current device, for the plan
int stats_max_shared_bytes(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// sizeof of the parameter structs as this build lays them out, for the
// wrapper's check of its ctypes mirrors
int stats_struct_sizes(int* out) {
  out[0] = (int)sizeof(StatsPlan);
  out[1] = (int)sizeof(BinnedParams);
  out[2] = (int)sizeof(JointParams);
  return 0;
}

}  // extern "C"
