// Native data-loading parsers for the host-side ETL (a copy of
// deeplearning4j_tpu/native/fastload.cpp for the PyTorch port).
//
// Role parity: the reference's ingestion path is native too (DataVec readers
// backed by javacpp/opencv; libnd4j does the array assembly). The device
// math is the card's, but the host-side record parsing that feeds device
// buffers is a real bottleneck for big CSV/idx corpora: a single-pass C++
// parser instead of the Python csv module.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11).
//
// Built at first use by native/__init__.py into build/ at the repository
// root:  g++ -O3 -shared -fPIC -std=c++17 fastload.cpp -o libfastload-<digest>.so
// (the .so.bin suffix keeps pkgutil from importing the artifact as a
// CPython extension module)

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse a numeric-only delimited buffer into row-major float64.
//   buf/n        : text buffer (need not be NUL-terminated)
//   skip_lines   : header lines to drop
//   delim        : field delimiter
//   out/max_vals : caller-allocated output and its capacity
//   n_rows/n_cols: parsed shape (every row must match n_cols)
// Returns 0 ok; 1 output capacity exceeded; 2 ragged rows; 3 bad/empty
// number (includes trailing-delimiter rows, matching the Python path's
// float('') error); 4 field too long for the fixed parse buffer.
int parse_csv_f64(const char* buf, int64_t n, int32_t skip_lines, char delim,
                  double* out, int64_t max_vals,
                  int64_t* n_rows, int64_t* n_cols) {
    int64_t i = 0;
    for (int32_t s = 0; s < skip_lines && i < n; ++s) {
        while (i < n && buf[i] != '\n') ++i;
        if (i < n) ++i;
    }
    int64_t rows = 0, cols = -1, vals = 0;
    while (i < n) {
        // skip blank lines
        if (buf[i] == '\n' || buf[i] == '\r') { ++i; continue; }
        int64_t row_cols = 0;
        bool expect_field = true;
        while (expect_field) {
            char tmp[64];
            int64_t t = 0;
            while (i < n && buf[i] != delim && buf[i] != '\n' && buf[i] != '\r') {
                if (t >= 63) return 4;  // refuse, never truncate silently
                tmp[t++] = buf[i];
                ++i;
            }
            if (t == 0) return 3;  // empty field ("1,2," or "1,,2")
            tmp[t] = '\0';
            char* end = nullptr;
            double v = strtod(tmp, &end);
            if (end == tmp || *end != '\0') return 3;
            if (vals >= max_vals) return 1;
            out[vals++] = v;
            ++row_cols;
            if (i < n && buf[i] == delim) {
                ++i;               // another field MUST follow
                expect_field = true;
            } else {
                expect_field = false;
            }
            while (i < n && buf[i] == '\r') ++i;
        }
        if (i < n && buf[i] == '\n') ++i;
        if (cols < 0) cols = row_cols;
        else if (row_cols != cols) return 2;
        ++rows;
    }
    *n_rows = rows;
    *n_cols = cols < 0 ? 0 : cols;
    return 0;
}

// Decode big-endian IDX (MNIST-style) image archives: u8 payload copied out,
// header validated. Returns 0 ok; 1 bad magic; 2 capacity exceeded.
int parse_idx_images(const uint8_t* buf, int64_t n,
                     uint8_t* out, int64_t max_bytes,
                     int64_t* count, int64_t* h, int64_t* w) {
    if (n < 16) return 1;
    uint32_t magic = (uint32_t(buf[0]) << 24) | (uint32_t(buf[1]) << 16) |
                     (uint32_t(buf[2]) << 8) | uint32_t(buf[3]);
    if (magic != 0x00000803u) return 1;
    auto be32 = [&](int64_t off) {
        return (int64_t(buf[off]) << 24) | (int64_t(buf[off + 1]) << 16) |
               (int64_t(buf[off + 2]) << 8) | int64_t(buf[off + 3]);
    };
    int64_t cnt = be32(4), hh = be32(8), ww = be32(12);
    if (cnt < 0 || hh < 0 || ww < 0) return 2;
    int64_t need = 0;
    // overflow-checked product: a corrupt header must not wrap negative and
    // slip past the bounds checks into memcpy
    if (__builtin_mul_overflow(cnt, hh, &need) ||
        __builtin_mul_overflow(need, ww, &need)) return 2;
    if (need > max_bytes || need > n - 16) return 2;
    memcpy(out, buf + 16, size_t(need));
    *count = cnt; *h = hh; *w = ww;
    return 0;
}

}  // extern "C"
