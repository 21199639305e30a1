// Fast CSV loader for RankAAE-schema spectra datasets: the port's own copy
// of native/csv_loader.cpp (the JAX package's), unchanged but for this
// comment, so the two packages parse every file to the same floats.
//
// The reference delegates CSV ingestion to pandas' C parser
// (sc/clustering/dataloader.py:12).  This loader reads the file in one
// mmap'd pass with a locale-free float parser and no Python objects
// (its time against pandas on the card's host: PERF.md, chip_smoke.py 12d).
//
// Schema contract: a header line naming the columns, a 2-level row index in
// the first `n_index_cols` fields, '#'-prefixed comment lines anywhere,
// float data everywhere else.
//
// C ABI (consumed by rankaae_tpu_torch/data/native.py via ctypes):
//   rankaae_csv_dims(path, &n_rows, &n_cols)  -> 0 on success
//   rankaae_csv_read(path, out, n_rows, n_data_cols, n_index_cols) -> rows read
//   rankaae_csv_header(path, buf, buf_len)    -> header length (or -1)

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size == 0) {
            ::close(fd);
            fd = -1;
            return false;
        }
        size = static_cast<size_t>(st.st_size);
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) {
            ::close(fd);
            fd = -1;
            return false;
        }
        madvise(p, size, MADV_SEQUENTIAL);
        data = static_cast<const char*>(p);
        return true;
    }

    ~MappedFile() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

inline const char* next_line(const char* p, const char* end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    return nl ? nl + 1 : end;
}

inline bool is_comment_or_blank(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    return p >= end || *p == '#' || *p == '\n' || *p == '\r';
}

// Find the first non-comment line (the header); returns its start, sets len.
const char* find_header(const MappedFile& mf, size_t* len) {
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    while (p < end) {
        const char* nl = next_line(p, end);
        if (!is_comment_or_blank(p, nl)) {
            const char* stop = nl;
            while (stop > p && (stop[-1] == '\n' || stop[-1] == '\r')) --stop;
            *len = static_cast<size_t>(stop - p);
            return p;
        }
        p = nl;
    }
    return nullptr;
}

inline int count_fields(const char* p, const char* end) {
    int n = 1;
    for (; p < end && *p != '\n'; ++p)
        if (*p == ',') ++n;
    return n;
}

// Locale-free float parser (strtof is the hot spot: locale lookups + errno).
// Accumulates in double (exact for <= 17 significant digits), handles
// sign / fraction / exponent / inf / nan.  ~20x strtof.
inline float fast_parse_float(const char* p, const char** after) {
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    else if (*p == '+') ++p;

    if ((p[0] == 'n' || p[0] == 'N') && (p[1] == 'a' || p[1] == 'A')) {
        *after = p + 3;
        return __builtin_nanf("");
    }
    if (p[0] == 'i' || p[0] == 'I') {
        *after = p + 3;
        return neg ? -__builtin_inff() : __builtin_inff();
    }

    double value = 0.0;
    while (*p >= '0' && *p <= '9') value = value * 10.0 + (*p++ - '0');
    if (*p == '.') {
        ++p;
        double scale = 0.1;
        while (*p >= '0' && *p <= '9') {
            value += (*p++ - '0') * scale;
            scale *= 0.1;
        }
    }
    if (*p == 'e' || *p == 'E') {
        ++p;
        bool eneg = false;
        if (*p == '-') { eneg = true; ++p; }
        else if (*p == '+') ++p;
        int exp = 0;
        while (*p >= '0' && *p <= '9') exp = exp * 10 + (*p++ - '0');
        static const double pow10[] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
                                       1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};
        double factor = 1.0;
        while (exp >= 16) { factor *= 1e16; exp -= 16; }
        factor *= pow10[exp];
        value = eneg ? value / factor : value * factor;
    }
    *after = p;
    return static_cast<float>(neg ? -value : value);
}

}  // namespace

extern "C" {

// Returns 0 on success; n_rows = data lines after the header (comments
// excluded), n_cols = fields in the header (index columns included).
int rankaae_csv_dims(const char* path, int64_t* n_rows, int64_t* n_cols) {
    MappedFile mf;
    if (!mf.open(path)) return -1;
    size_t hlen = 0;
    const char* header = find_header(mf, &hlen);
    if (!header) return -2;
    const char* end = mf.data + mf.size;
    *n_cols = count_fields(header, header + hlen);

    int64_t rows = 0;
    const char* p = next_line(header, end);
    while (p < end) {
        const char* nl = next_line(p, end);
        if (!is_comment_or_blank(p, nl)) ++rows;
        p = nl;
    }
    *n_rows = rows;
    return 0;
}

// Copies the header line (no newline) into buf; returns its length, or -1.
int64_t rankaae_csv_header(const char* path, char* buf, int64_t buf_len) {
    MappedFile mf;
    if (!mf.open(path)) return -1;
    size_t hlen = 0;
    const char* header = find_header(mf, &hlen);
    if (!header) return -1;
    if (static_cast<int64_t>(hlen) + 1 > buf_len) return -1;
    memcpy(buf, header, hlen);
    buf[hlen] = '\0';
    return static_cast<int64_t>(hlen);
}

// Parses the float payload: for each data row, skips `n_index_cols` fields
// then reads `n_data_cols` floats into `out` (row-major).  Returns the
// number of rows parsed, or a negative error code.
int64_t rankaae_csv_read(const char* path, float* out, int64_t n_rows,
                         int64_t n_data_cols, int64_t n_index_cols) {
    MappedFile mf;
    if (!mf.open(path)) return -1;
    size_t hlen = 0;
    const char* header = find_header(mf, &hlen);
    if (!header) return -2;
    const char* end = mf.data + mf.size;

    int64_t row = 0;
    const char* p = next_line(header, end);
    while (p < end && row < n_rows) {
        const char* nl = next_line(p, end);
        if (!is_comment_or_blank(p, nl)) {
            const char* q = p;
            // skip index fields
            for (int64_t i = 0; i < n_index_cols; ++i) {
                const char* c = static_cast<const char*>(memchr(q, ',', nl - q));
                if (!c) return -3;
                q = c + 1;
            }
            float* dst = out + row * n_data_cols;
            for (int64_t i = 0; i < n_data_cols; ++i) {
                const char* after = nullptr;
                dst[i] = fast_parse_float(q, &after);
                if (after == q) return -4;
                q = after;
                if (*q == ',') ++q;
            }
            ++row;
        }
        p = nl;
    }
    return row;
}

}  // extern "C"
