// Fast trajectory text IO for reference-format files (the port's copy of
// crdmodel_tpu/native/trajio.cpp).
//
// The reference writes every snapshot of the full local field as " %.16e"
// formatted text (src/FHNmodel_torus.cpp:438-450): for the canonical FHN
// torus run that is ~340 MB of text. Python-side formatting is an order of
// magnitude slower than buffered C stdio, so this small host library is the
// hot path of crdmodel_tpu_torch/io/trajectory.py; a numpy writer takes
// over where g++ is missing (native/build.py compiles this file at first
// use with g++ -O2 -shared -fPIC).
//
// Bound with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Append n_rows rows of n_cols doubles to `path` (mode: "w" or "a"),
// each value formatted as " %.16e", one row per line.
// Returns 0 on success, negative errno-style code on failure.
int trajio_write_rows(const char* path, const char* mode, const double* data,
                      int64_t n_rows, int64_t n_cols) {
    FILE* f = std::fopen(path, mode);
    if (!f) return -1;
    // big stdio buffer: the write pattern is millions of ~24B snprintfs
    static const size_t BUFSZ = 4u << 20;
    char* buf = static_cast<char*>(std::malloc(BUFSZ));
    if (buf) setvbuf(f, buf, _IOFBF, BUFSZ);
    int rc = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        const double* row = data + r * n_cols;
        for (int64_t c = 0; c < n_cols; ++c) {
            if (std::fprintf(f, " %.16e", row[c]) < 0) { rc = -2; goto done; }
        }
        if (std::fputc('\n', f) == EOF) { rc = -2; goto done; }
    }
done:
    if (std::fclose(f) != 0 && rc == 0) rc = -3;
    std::free(buf);
    return rc;
}

}  // extern "C"
