// bedparse: the bed scanners of the port, host C++ (built by the host
// compiler, not nvcc; see kernels/_build.py), bound with ctypes.
//
// Both functions parse one block of complete bed lines into columnar arrays
// and return the number of rows kept.  Rules (those of the JAX package's
// native scanners, hichap_master_tpu/native/hicio.cpp):
//   * a chromosome field loses a leading "chr", then matches the label table
//     verbatim; a row with an unknown chromosome is dropped;
//   * a row with a missing field, or a position that is empty, not a
//     (optionally negative) decimal integer, or longer than 18 characters,
//     is dropped;
//   * "\r\n" line ends are accepted.
//
//   bedparse_valid    15/23-column valid beds: columns 1, 6, 8, 13
//                     (chrom1, fragment-mid1, chrom2, fragment-mid2)
//   bedparse_allelic  allelic beds: columns 0-3 (chrom1, pos1, chrom2,
//                     pos2) and, with with_tag, an optional column 4:
//                     "Both"/"R1"/"R2" -> 0/1/2, absent or other -> -1

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Labels {
    const char* const* names;
    int n;
    std::vector<size_t> len;

    Labels(const char* const* labels, int n_labels)
        : names(labels), n(n_labels), len(n_labels) {
        for (int i = 0; i < n; ++i) len[i] = std::strlen(names[i]);
    }

    int lookup(const char* b, const char* e) const {
        if (e - b >= 3 && b[0] == 'c' && b[1] == 'h' && b[2] == 'r') b += 3;
        const size_t m = static_cast<size_t>(e - b);
        for (int i = 0; i < n; ++i)
            if (len[i] == m && std::memcmp(names[i], b, m) == 0) return i;
        return -1;
    }
};

bool number(const char* b, const char* e, int64_t* out) {
    if (b == e || e - b > 18) return false;  // > 18 characters: overflow
    const bool neg = (*b == '-');
    if (neg && ++b == e) return false;
    int64_t v = 0;
    for (; b < e; ++b) {
        if (*b < '0' || *b > '9') return false;
        v = v * 10 + (*b - '0');
    }
    *out = neg ? -v : v;
    return true;
}

// One line [p, next): its end without "\r", and where the next line starts.
const char* line_end(const char* p, const char* end, const char** next) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    const char* eol = nl ? nl : end;
    if (eol > p && eol[-1] == '\r') --eol;
    *next = nl ? nl + 1 : end;
    return eol;
}

}  // namespace

extern "C" long bedparse_valid(const char* buf, long nbytes,
                               const char* const* labels, int n_labels,
                               int32_t* c1, int64_t* p1, int32_t* c2,
                               int64_t* p2) {
    const Labels table(labels, n_labels);
    long out = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    while (p < end) {
        const char* next;
        const char* eol = line_end(p, end, &next);
        const char* fb[4] = {nullptr, nullptr, nullptr, nullptr};
        const char* fe[4] = {nullptr, nullptr, nullptr, nullptr};
        int col = 0;
        const char* fs = p;
        for (const char* q = p; q <= eol && col <= 13; ++q) {
            if (q == eol || *q == '\t') {
                const int k = col == 1 ? 0 : col == 6 ? 1 : col == 8 ? 2
                            : col == 13 ? 3 : -1;
                if (k >= 0) {
                    fb[k] = fs;
                    fe[k] = q;
                }
                ++col;
                fs = q + 1;
            }
        }
        p = next;
        if (!fb[3]) continue;  // no column 13
        const int a = table.lookup(fb[0], fe[0]);
        const int b = table.lookup(fb[2], fe[2]);
        if (a < 0 || b < 0) continue;
        int64_t v1, v2;
        if (!number(fb[1], fe[1], &v1) || !number(fb[3], fe[3], &v2))
            continue;
        c1[out] = a;
        p1[out] = v1;
        c2[out] = b;
        p2[out] = v2;
        ++out;
    }
    return out;
}

extern "C" long bedparse_allelic(const char* buf, long nbytes,
                                 const char* const* labels, int n_labels,
                                 int with_tag, int32_t* c1, int64_t* p1,
                                 int32_t* c2, int64_t* p2, int8_t* tag) {
    const Labels table(labels, n_labels);
    const int want = with_tag ? 5 : 4;
    long out = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    while (p < end) {
        const char* next;
        const char* eol = line_end(p, end, &next);
        const char* fb[5];
        const char* fe[5];
        int col = 0;
        const char* fs = p;
        for (const char* q = p; q <= eol && col < want; ++q) {
            if (q == eol || *q == '\t') {
                fb[col] = fs;
                fe[col] = q;
                ++col;
                fs = q + 1;
            }
        }
        p = next;
        if (col < 4) continue;  // a missing field
        const int a = table.lookup(fb[0], fe[0]);
        const int b = table.lookup(fb[2], fe[2]);
        if (a < 0 || b < 0) continue;
        int64_t v1, v2;
        if (!number(fb[1], fe[1], &v1) || !number(fb[3], fe[3], &v2))
            continue;
        if (with_tag) {
            int8_t t = -1;
            if (col == 5) {
                const size_t tl = static_cast<size_t>(fe[4] - fb[4]);
                if (tl == 4 && std::memcmp(fb[4], "Both", 4) == 0) t = 0;
                else if (tl == 2 && fb[4][0] == 'R' && fb[4][1] == '1') t = 1;
                else if (tl == 2 && fb[4][0] == 'R' && fb[4][1] == '2') t = 2;
            }
            tag[out] = t;
        }
        c1[out] = a;
        p1[out] = v1;
        c2[out] = b;
        p2[out] = v2;
        ++out;
    }
    return out;
}
