// Parallel VisMF/FAB reader — the native data loader of the PyTorch port,
// a copy of peleanalysis_tpu/native/vismf_io.cpp (the counterpart of the
// reference's C++ AmrData demand-paged FAB reads, its Src/ usage of
// amrex::AmrData / VisMF::Read).  Reads many FAB records concurrently with a std::thread
// pool, converting on-disk Fortran-ordered (x fastest, comp outermost)
// float32/float64 data into C-ordered float64 [comp, x, y, z] destination
// blocks.  Exposed through ctypes (no pybind11 in the image).
//
// ABI (see peleanalysis_tpu_torch/native/__init__.py load_fabs):
//   paths[i]       : FAB file path
//   offsets[i]     : byte offset of the FAB record (ASCII header line first)
//   dims[3*i..]    : nx, ny, nz of the box
//   n_sel          : number of selected components (same for every job)
//   sel[n_sel]     : on-disk component indices to read
//   itemsize       : on-disk scalar size (4 or 8), same for all jobs
//   dests[i]       : double* destination [n_sel, nx, ny, nz] C-contiguous
// Returns 0 on success, else the 1-based index of the first failed job.

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

bool read_one(const char* path, long long offset, int nx, int ny, int nz,
              int n_sel, const int* sel, int itemsize, double* dest) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    if (std::fseek(f, (long)offset, SEEK_SET) != 0) { std::fclose(f); return false; }
    // skip the ASCII FAB header line
    int ch;
    while ((ch = std::fgetc(f)) != EOF && ch != '\n') {}
    if (ch == EOF) { std::fclose(f); return false; }
    long long data_start = std::ftell(f);
    const long long cells = (long long)nx * ny * nz;
    std::vector<unsigned char> raw((size_t)(cells * itemsize));
    for (int s = 0; s < n_sel; ++s) {
        const long long comp_off = data_start + (long long)sel[s] * cells * itemsize;
        if (std::fseek(f, (long)comp_off, SEEK_SET) != 0) { std::fclose(f); return false; }
        if (std::fread(raw.data(), 1, raw.size(), f) != raw.size()) {
            std::fclose(f); return false;
        }
        // disk: Fortran order (x fastest): raw[(k*ny + j)*nx + i]
        // dest: C order [s, i, j, k]: dest[((s*nx + i)*ny + j)*nz + k]
        // tiled (i,k) transpose per j-slab to keep both streams cache-local
        double* dst = dest + (long long)s * cells;
        const int TB = 32;
        const long long snx = (long long)ny * nz;
#define PELE_TRANSPOSE(SRC_T)                                              \
        do {                                                               \
            const SRC_T* src = (const SRC_T*)raw.data();                   \
            for (int j = 0; j < ny; ++j)                                   \
                for (int i0 = 0; i0 < nx; i0 += TB)                        \
                    for (int k0 = 0; k0 < nz; k0 += TB) {                  \
                        const int i1 = i0 + TB < nx ? i0 + TB : nx;        \
                        const int k1 = k0 + TB < nz ? k0 + TB : nz;        \
                        for (int k = k0; k < k1; ++k) {                    \
                            const SRC_T* row =                             \
                                src + ((long long)k * ny + j) * nx;        \
                            double* col = dst + (long long)j * nz + k;     \
                            for (int i = i0; i < i1; ++i)                  \
                                col[(long long)i * snx] = (double)row[i];  \
                        }                                                  \
                    }                                                      \
        } while (0)
        if (itemsize == 8) {
            PELE_TRANSPOSE(double);
        } else if (itemsize == 4) {
            PELE_TRANSPOSE(float);
        } else {
            std::fclose(f);
            return false;
        }
#undef PELE_TRANSPOSE
    }
    std::fclose(f);
    return true;
}

}  // namespace

extern "C" int load_fabs(const char** paths, const long long* offsets,
                         const int* dims, int n_sel, const int* sel,
                         int itemsize, double** dests, int njobs,
                         int nthreads) {
    if (njobs <= 0) return 0;
    if (nthreads < 1) nthreads = 1;
    std::atomic<int> next(0), fail(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= njobs || fail.load()) return;
            if (!read_one(paths[i], offsets[i], dims[3 * i], dims[3 * i + 1],
                          dims[3 * i + 2], n_sel, sel, itemsize, dests[i])) {
                int expected = 0;
                fail.compare_exchange_strong(expected, i + 1);
                return;
            }
        }
    };
    int nt = nthreads < njobs ? nthreads : njobs;
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return fail.load();
}
