// Parameters of the stats histogram kernels (stats_hist.cu), passed by value
// from ops/stats_kernels.py, whose ctypes Structures mirror these structs
// field for field (tests/test_torch_stats_plan.py compiles this header with
// g++ and holds every offset and size against them).
#ifndef STATS_HIST_PARAMS_H
#define STATS_HIST_PARAMS_H

#define STATS_MAXC 32      // averaged components of one binned launch
#define STATS_MAXV 16      // variables of one joint launch
#define STATS_MAXP 120     // pairs of one joint launch (16 * 15 / 2)

// How one launch runs: ops/stats_kernels.plan_binned / plan_joint.
struct StatsPlan {
  long long chunk;          // cells of one block (a multiple of 4)
  long long round_cells;    // cells a block adds before folding its float32
                            // sub-histograms into float64 (binned)
  long long acc_off;        // byte offsets in the scratch of the partials:
  long long mm_off;         //   sums [nparts][slots][bins], min/max keys
  long long cnt_off;        //   [nparts][2][bins][ncomp], counts
  long long scratch_bytes;  //   [nparts][bins]; and its size
  int variant;              // 0 shared memory, 1 device memory
  int nblocks;              // blocks of the histogram kernel
  int threads;              // threads of a block (512 or 1024)
  int ncopies;              // sub-histograms of a block (binned, shared)
  int nparts;               // partials the finish sums
  int vec;                  // cells a thread loads at once (1, 2 or 4)
  int smem;                 // dynamic shared bytes of a block
  int pad;
};

struct BinnedParams {
  long long n;              // cells
  int ncomp;                // averaged components
  int nbins;
  int clamp;                // 1: out-of-range cells go to the edge bins
  int minmax;               // 1: per-bin min/max of the unshifted values
  int has_w;                // 1: per-cell weights at w_ptr; 0: wscal
  int divide;               // 1: (v - lo) / scale * nbins; 0: (v - lo) * scale
  double wscal;
  double lo, scale;         // bin edges, already rounded to the state type
  unsigned long long bin_ptr;                // [n]
  unsigned long long avg_ptr[STATS_MAXC];    // [n] each
  unsigned long long w_ptr;                  // [n] or 0
  unsigned long long mask_ptr;               // [n] bool
  unsigned long long shift_ptr;              // [ncomp], state type
  StatsPlan plan;
};

struct JointParams {
  long long n;
  int nv, npairs, nbins;
  int has_w;
  int divide;               // as in BinnedParams
  double wscal;
  double lo[STATS_MAXV], scale[STATS_MAXV];
  int pi[STATS_MAXP], pj[STATS_MAXP];
  unsigned long long v_ptr[STATS_MAXV];      // [n] each
  unsigned long long w_ptr;
  unsigned long long mask_ptr;
  unsigned long long shift_ptr;              // [nv], state type
  StatsPlan plan;
};

#endif  // STATS_HIST_PARAMS_H
