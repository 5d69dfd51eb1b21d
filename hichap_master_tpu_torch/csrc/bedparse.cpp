// bedparse: the bed scanners and writers of the port, host C++ (built by
// the host compiler, not nvcc; see kernels/_build.py), bound with ctypes.
//
// bedparse_valid and bedparse_allelic parse one block of complete bed
// lines into columnar arrays and return the number of rows kept.  Rules (those of the JAX package's
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
//
// bedparse_record (the filtering stage's scanner) keeps every row and
// every chromosome string as written, "chr" included: see its comment.
// bedparse_gather writes chosen lines back verbatim; bedparse_format
// writes lines from columns (integers, words of a table, bytes).

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
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

namespace {

// The integer columns of a 15/23-column record, in the order of the
// output's rows (RECORD_INTS in io/bedio.py).
constexpr int kIntCols[14] = {2, 3, 5, 6, 7, 9, 10, 12, 13, 14,
                              17, 19, 20, 21};

// Chromosome strings interned into a caller-owned table: bytes in `tab`,
// entry i at [off[i], off[i] + len[i]).  Entries already in the table keep
// their ids; new strings are appended in the order they are met.
struct Interner {
    char* tab;
    long tab_cap;
    int32_t* off;
    int32_t* len;
    int max;
    int32_t* n;
    long used = 0;
    std::unordered_map<std::string_view, int> ids;

    Interner(char* t, long cap, int32_t* o, int32_t* l, int m, int32_t* count)
        : tab(t), tab_cap(cap), off(o), len(l), max(m), n(count) {
        for (int i = 0; i < *n; ++i) {
            ids.emplace(std::string_view(tab + off[i], len[i]), i);
            used = off[i] + len[i];
        }
    }

    // The id of [b, e), or -1 when the table is full.
    int get(const char* b, const char* e) {
        const std::string_view key(b, static_cast<size_t>(e - b));
        auto it = ids.find(key);
        if (it != ids.end()) return it->second;
        if (*n >= max || used + static_cast<long>(key.size()) > tab_cap)
            return -1;
        std::memcpy(tab + used, b, key.size());
        const int id = *n;
        off[id] = static_cast<int32_t>(used);
        len[id] = static_cast<int32_t>(key.size());
        ids.emplace(std::string_view(tab + used, key.size()), id);
        used += static_cast<long>(key.size());
        ++*n;
        return id;
    }
};

}  // namespace

// bedparse_record: one block of chunk-bed or valid-bed lines (15 or 23
// tab-separated columns) into columns; no row is dropped and no label
// table is given.  Row r of the block:
//   line_off[r]  byte offset of its line in the caller's text (base + its
//                offset in buf), line_len[r] its length without "\n" or
//                "\r\n" (so that a line writes back as the JAX package's
//                filtering writes it: "\r\n" becomes "\n");
//   name_len[r]  the length of column 0 (the read name; it starts the line);
//   chrom[k * cap + r]  ids of columns 1, 8 and 15 in the interned table
//                (-1 where the column is absent);
//   ints[k * cap + r]   columns 2, 3, 5, 6, 7, 9, 10, 12, 13, 14, 17, 19,
//                20, 21 (0 where absent);
//   cand[r]      column 22 of a row of 23 or more fields: "R1" 1, "R2" 2,
//                else 0;
//   nfields[r]   its number of fields (capped at 32767); ok[r] 0 when an
//                integer column that is present does not parse (the rules
//                of `number`), else 1.
// Fields end at "\t" or at the line's end without "\r".  Returns the
// number of rows, or -1 when the intern table is full (the caller grows it
// and scans the block again; the entries added so far stay valid).
extern "C" long bedparse_record(const char* buf, long nbytes, long base,
                                long cap, char* tab, long tab_cap,
                                int32_t* tab_off, int32_t* tab_len,
                                int tab_max, int32_t* n_tab,
                                int64_t* line_off, int32_t* line_len,
                                int32_t* name_len, int32_t* chrom,
                                int64_t* ints, int8_t* cand,
                                int16_t* nfields, int8_t* ok) {
    Interner table(tab, tab_cap, tab_off, tab_len, tab_max, n_tab);
    int slot[23];
    for (int c = 0; c < 23; ++c) slot[c] = -1;
    for (int k = 0; k < 14; ++k) slot[kIntCols[k]] = k;
    long r = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    while (p < end) {
        const char* next;
        const char* eol = line_end(p, end, &next);
        line_off[r] = base + (p - buf);
        line_len[r] = static_cast<int32_t>(eol - p);
        name_len[r] = 0;
        for (int k = 0; k < 3; ++k) chrom[k * cap + r] = -1;
        for (int k = 0; k < 14; ++k) ints[k * cap + r] = 0;
        cand[r] = 0;
        int8_t good = 1;
        long col = 0;
        const char* fs = p;
        for (const char* q = p; q <= eol; ++q) {
            if (q != eol && *q != '\t') continue;
            if (col == 0) {
                name_len[r] = static_cast<int32_t>(q - fs);
            } else if (col == 1 || col == 8 || col == 15) {
                const int id = table.get(fs, q);
                if (id < 0) return -1;
                chrom[(col == 1 ? 0 : col == 8 ? 1 : 2) * cap + r] = id;
            } else if (col < 23 && slot[col] >= 0) {
                int64_t v;
                if (number(fs, q, &v)) ints[slot[col] * cap + r] = v;
                else good = 0;
            } else if (col == 22) {
                const size_t tl = static_cast<size_t>(q - fs);
                if (tl == 2 && fs[0] == 'R' && fs[1] == '1') cand[r] = 1;
                else if (tl == 2 && fs[0] == 'R' && fs[1] == '2') cand[r] = 2;
            }
            ++col;
            fs = q + 1;
        }
        nfields[r] = static_cast<int16_t>(col < 32767 ? col : 32767);
        ok[r] = good;
        p = next;
        ++r;
    }
    return r;
}

// bedparse_gather: lines rows[0..n) of `text` (offsets and lengths as
// bedparse_record gives them), each followed by "\n", into `out`, which
// holds sum(len[rows[i]] + 1) bytes.  Returns the bytes written.
extern "C" long bedparse_gather(const char* text, const int64_t* off,
                                const int32_t* len, const int64_t* rows,
                                long n, char* out) {
    char* q = out;
    for (long i = 0; i < n; ++i) {
        const int64_t r = rows[i];
        std::memcpy(q, text + off[r], static_cast<size_t>(len[r]));
        q += len[r];
        *q++ = '\n';
    }
    return static_cast<long>(q - out);
}

// bedparse_format: n lines of tab-separated fields, each field one or more
// parts written one after the other; part p belongs to field field[p]
// (fields in order) and is, by kind[p]:
//   0  an integer: ((const int64_t*)data[p])[r] in decimal, "-" first when
//      negative;
//   1  a word: entry ((const int64_t*)data[p])[r] of a table, the bytes
//      tab[p][toff[p][i] .. + tlen[p][i]);
//   2  constant bytes: tab[p][0 .. tlen[p][0]);
//   3  a slice of a byte array: tab[p][((const int64_t*)data[p])[r] .. +
//      ((const int64_t*)aux[p])[r]).
// Row r ends after field row_fields[r] - 1 (all nfields where row_fields
// is null) with "\n".  Returns the bytes written, or -1 if `cap` bytes
// would not hold them.
extern "C" long bedparse_format(long n, int nparts, const int* kind,
                                const int* field, const void* const* data,
                                const void* const* aux,
                                const char* const* tab,
                                const int64_t* const* toff,
                                const int64_t* const* tlen, int nfields,
                                const int8_t* row_fields, char* out,
                                long cap) {
    char* q = out;
    char* const end = out + cap;
    for (long r = 0; r < n; ++r) {
        const int upto = row_fields ? row_fields[r] : nfields;
        for (int p = 0; p < nparts; ++p) {
            const int f = field[p];
            if (f >= upto) break;
            if (p > 0 && field[p - 1] != f) {
                if (q >= end) return -1;
                *q++ = '\t';
            }
            const char* src = nullptr;
            int64_t len = 0;
            char digits[24];
            switch (kind[p]) {
                case 0: {
                    const int64_t v = static_cast<const int64_t*>(data[p])[r];
                    uint64_t a = v < 0 ? 0 - static_cast<uint64_t>(v)
                                       : static_cast<uint64_t>(v);
                    char* d = digits + sizeof(digits);
                    do {
                        *--d = static_cast<char>('0' + a % 10);
                        a /= 10;
                    } while (a);
                    if (v < 0) *--d = '-';
                    src = d;
                    len = digits + sizeof(digits) - d;
                    break;
                }
                case 1: {
                    const int64_t i = static_cast<const int64_t*>(data[p])[r];
                    src = tab[p] + toff[p][i];
                    len = tlen[p][i];
                    break;
                }
                case 2:
                    src = tab[p];
                    len = tlen[p][0];
                    break;
                default:
                    src = tab[p] + static_cast<const int64_t*>(data[p])[r];
                    len = static_cast<const int64_t*>(aux[p])[r];
            }
            if (end - q < len) return -1;
            std::memcpy(q, src, static_cast<size_t>(len));
            q += len;
        }
        if (q >= end) return -1;
        *q++ = '\n';
    }
    return static_cast<long>(q - out);
}
