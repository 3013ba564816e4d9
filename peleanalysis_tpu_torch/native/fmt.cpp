// Fast ASCII float formatting for the text writers (Tecplot line dumps,
// MEF Tecplot text, StreamData element tables).  A copy of
// peleanalysis_tpu/native/fmt.cpp, so the port writes the same bytes.
//
// glibc snprintf("%.9g") runs ~350 ns/value single-threaded, so zones are
// formatted in parallel (per-thread scratch + one serial compaction; the
// output width is data-dependent, so threads cannot write in place).
// The text equals Python's %-formatting for every finite value and for
// +-inf; a NaN with its sign bit set prints as "-nan" (Python: "nan").
// The reference writes the same zones from C++ too: Src/stream.cpp:2227-2302.
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

long fmt_lines(const double* vals, long lo, long hi, long st, long ncols,
               char* p) {
  char* start = p;
  for (long i = lo; i < hi; ++i) {
    p += snprintf(p, 96, "ZONE T=\"line%ld\" I=%ld DATAPACKING=POINT\n",
                  i, st);
    const double* row = vals + i * st * ncols;
    for (long s = 0; s < st; ++s) {
      for (long c = 0; c < ncols; ++c) {
        if (c) *p++ = ' ';
        p += snprintf(p, 32, "%.9g", row[s * ncols + c]);
      }
      *p++ = '\n';
    }
  }
  return p - start;
}

}  // namespace

extern "C" {

// Format the body of a per-line-zones Tecplot dump:
//   ZONE T="line<i>" I=<st> DATAPACKING=POINT\n
//   <st rows of ncols space-separated %.9g>\n
// `cap` must be >= nlines * (96 + st * (ncols * 32 + 1)) (the Python
// wrapper sizes it so; each formatted value is < 32 chars, each header
// < 96).  Returns bytes written.
long tecplot_zones(const double* vals, long nlines, long st, long ncols,
                   char* out, long cap) {
  int nt = (int)std::min<long>(
      std::max(1u, std::thread::hardware_concurrency()), 16);
  long per_line = 96 + st * (ncols * 32 + 1);
  if (cap < nlines * per_line) return -1;
  if (nt <= 1 || nlines < 256) return fmt_lines(vals, 0, nlines, st, ncols,
                                                out);
  long chunk = (nlines + nt - 1) / nt;
  std::vector<std::thread> ts;
  std::vector<long> sizes(nt, 0);
  std::vector<long> los(nt), offs(nt);
  for (int t = 0; t < nt; ++t) {
    long lo = t * chunk, hi = std::min(nlines, lo + chunk);
    los[t] = lo;
    offs[t] = lo * per_line;          // worst-case-spaced scratch regions
    if (lo >= hi) continue;
    ts.emplace_back([=, &sizes] {
      sizes[t] = fmt_lines(vals, lo, hi, st, ncols, out + offs[t]);
    });
  }
  for (auto& th : ts) th.join();
  long total = sizes[0];              // chunk 0 is already in place
  for (int t = 1; t < nt; ++t) {
    if (!sizes[t]) continue;
    std::memmove(out + total, out + offs[t], sizes[t]);
    total += sizes[t];
  }
  return total;
}

// Generic %.<prec>g row formatter: nrows lines of ncols space-separated
// values.  Returns bytes written, or -1 if `cap` would be exceeded.
long format_g_rows(const double* vals, long nrows, long ncols, int prec,
                   char* out, long cap) {
  char* p = out;
  char* end = out + cap;
  for (long r = 0; r < nrows; ++r) {
    if (end - p < 40 * (ncols + 1)) return -1;
    for (long c = 0; c < ncols; ++c) {
      if (c) *p++ = ' ';
      p += snprintf(p, 40, "%.*g", prec, vals[r * ncols + c]);
    }
    *p++ = '\n';
  }
  return p - out;
}

// %ld rows (element connectivity tables).
long format_i_rows(const long long* vals, long nrows, long ncols,
                   char* out, long cap) {
  char* p = out;
  char* end = out + cap;
  for (long r = 0; r < nrows; ++r) {
    if (end - p < 24 * (ncols + 1)) return -1;
    for (long c = 0; c < ncols; ++c) {
      if (c) *p++ = ' ';
      p += snprintf(p, 24, "%lld", vals[r * ncols + c]);
    }
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"
