// fastaparse: the front's host scanners (built with bedparse.cpp and
// samparse.cpp by the host compiler, see kernels/_build.py), bound with
// ctypes.  They read FASTA, SNP tables and FASTQ as Python's text mode
// reads them in the JAX package (hichap_master_tpu/io/fasta.py,
// pipeline/chunking.py): a line ends at "\n", "\r" or "\r\n".  Every entry
// takes a block of complete lines (the caller cuts blocks after a line
// end, the last block of a file excepted).

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>

namespace {

// The end of the line that starts at p (before its "\n", "\r" or "\r\n")
// and where the next line starts.
const char* line_end(const char* p, const char* end, const char** next) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* eol = nl ? nl : end;
    const char* cr = static_cast<const char*>(
        std::memchr(p, '\r', static_cast<size_t>(eol - p)));
    if (cr) {
        *next = (cr + 1 < end && cr[1] == '\n') ? cr + 2 : cr + 1;
        return cr;
    }
    *next = nl ? nl + 1 : end;
    return eol;
}

// Whether any byte of [b, e) is outside ASCII.
bool high(const char* b, const char* e) {
    uint64_t acc = 0;
    for (; b + 8 <= e; b += 8) {
        uint64_t w;
        std::memcpy(&w, b, 8);
        acc |= w;
    }
    for (; b < e; ++b) acc |= static_cast<unsigned char>(*b);
    return (acc & 0x8080808080808080ULL) != 0;
}

// The ASCII whitespace of Python's str.split().
inline bool space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
           c == '\r' || (c >= 0x1c && c <= 0x1f);
}

// A decimal integer with an optional sign, at most 18 digits.
bool integer(const char* b, const char* e, int64_t* out) {
    bool neg = false;
    if (b < e && (*b == '-' || *b == '+')) neg = (*b++ == '-');
    if (b == e || e - b > 18) return false;
    int64_t v = 0;
    for (; b < e; ++b) {
        if (*b < '0' || *b > '9') return false;
        v = v * 10 + (*b - '0');
    }
    *out = neg ? -v : v;
    return true;
}

}  // namespace

// fastaparse_fasta: the sequence lines of a block of FASTA appended to
// `seq` (line ends dropped, every other byte kept, trailing blanks
// included), and each header line (">" at a line start) as an event:
// hdr_start/hdr_end its bytes after ">" in `buf`, hdr_at the sequence
// bytes written before it.  Lines before the first header are written as
// well; the caller drops them.  *is_high is set when a sequence byte is
// outside ASCII.  Returns the sequence bytes written, or -1 when more than
// hdr_cap headers would be needed.
extern "C" long fastaparse_fasta(const char* buf, long nbytes, char* seq,
                                 int64_t* hdr_start, int64_t* hdr_end,
                                 int64_t* hdr_at, long hdr_cap, long* n_hdr,
                                 int* is_high) {
    const char* p = buf;
    const char* const end = buf + nbytes;
    long used = 0, h = 0;
    bool hi = false;
    while (p < end) {
        const char* next;
        const char* eol = line_end(p, end, &next);
        if (eol > p && *p == '>') {
            if (h >= hdr_cap) return -1;
            hdr_start[h] = p + 1 - buf;
            hdr_end[h] = eol - buf;
            hdr_at[h] = used;
            ++h;
        } else if (eol > p) {
            const size_t n = static_cast<size_t>(eol - p);
            std::memcpy(seq + used, p, n);
            hi = hi || high(p, eol);
            used += static_cast<long>(n);
        }
        p = next;
    }
    *n_hdr = h;
    *is_high = hi ? 1 : 0;
    return used;
}

// fastaparse_snps: the SNP lines of a block (hichap_master_tpu/io/fasta.py
// parse_snp_file): fields split on ASCII whitespace; a line of fewer than
// 5 fields is skipped.  Row r: chrom[r] the interned first field, pos[r]
// the integer of the second, the spans (a_off, a_len: 3 per row) of the
// third to fifth fields in `buf`, line_off/line_len the line, and
// slow[r] = 1 when the line must be parsed by Python instead (a byte
// outside ASCII, or a second field that is not [+-]digits: Python's int()
// decides; chrom[r] and pos[r] are then undefined).  Returns the rows, or
// -1 when the intern table is full (grow it and scan the block again).
extern "C" long fastaparse_snps(const char* buf, long nbytes, char* tab,
                                long tab_cap, int32_t* tab_off,
                                int32_t* tab_len, int tab_max, int32_t* n_tab,
                                int32_t* chrom, int64_t* pos, int64_t* a_off,
                                int32_t* a_len, int64_t* line_off,
                                int32_t* line_len, int8_t* slow) {
    std::unordered_map<std::string_view, int> ids;
    long used = 0;
    for (int i = 0; i < *n_tab; ++i) {
        ids.emplace(std::string_view(tab + tab_off[i], tab_len[i]), i);
        used = tab_off[i] + tab_len[i];
    }
    const char* p = buf;
    const char* const end = buf + nbytes;
    long r = 0;
    while (p < end) {
        const char* next;
        const char* eol = line_end(p, end, &next);
        const char* q = p;
        const char* start = p;
        p = next;
        const bool is_high = high(start, eol);
        const char* fb[5];
        const char* fe[5];
        int col = 0;
        if (!is_high) {
            while (col < 5) {
                while (q < eol && space(*q)) ++q;
                if (q == eol) break;
                fb[col] = q;
                while (q < eol && !space(*q)) ++q;
                fe[col++] = q;
            }
            if (col < 5) continue;
        }
        line_off[r] = start - buf;
        line_len[r] = static_cast<int32_t>(eol - start);
        int64_t v = 0;
        if (is_high || !integer(fb[1], fe[1], &v)) {
            slow[r] = 1;
            chrom[r] = -1;
            pos[r] = 0;
            for (int k = 0; k < 3; ++k) {
                a_off[3 * r + k] = 0;
                a_len[3 * r + k] = 0;
            }
            ++r;
            continue;
        }
        const std::string_view key(fb[0], static_cast<size_t>(fe[0] - fb[0]));
        auto it = ids.find(key);
        int id;
        if (it != ids.end()) {
            id = it->second;
        } else {
            if (*n_tab >= tab_max ||
                used + static_cast<long>(key.size()) > tab_cap)
                return -1;
            std::memcpy(tab + used, key.data(), key.size());
            id = *n_tab;
            tab_off[id] = static_cast<int32_t>(used);
            tab_len[id] = static_cast<int32_t>(key.size());
            ids.emplace(std::string_view(tab + used, key.size()), id);
            used += static_cast<long>(key.size());
            ++*n_tab;
        }
        slow[r] = 0;
        chrom[r] = id;
        pos[r] = v;
        for (int k = 0; k < 3; ++k) {
            a_off[3 * r + k] = fb[2 + k] - buf;
            a_len[3 * r + k] = static_cast<int32_t>(fe[2 + k] - fb[2 + k]);
        }
        ++r;
    }
    return r;
}

// fastaparse_fastq: FASTQ records of a block into the chunk text of the
// JAX package's split_reads (hichap_master_tpu/pipeline/chunking.py):
// a header line (line 0 of a record) is split on whitespace and written as
// its first field, "_", `mate`, then " " and each further field, then
// "\n"; lines 1-3 are written as read, their line end as "\n" (none after
// an unterminated last line).  state[0] is the record's line (0-3) at the
// start and is updated; at most `reads` headers are taken.  Returns
//   0  the block is done;
//   1  a header is due and `reads` were taken (start the next chunk);
//   2  a header line does not start with "@";
//   3  a header line holds a byte outside ASCII (Python splits it);
// with *consumed the bytes of `buf` used (up to the line that stopped the
// scan), *written the bytes written to `out`, *taken the headers taken
// and *is_high set when a written line holds a byte outside ASCII.
extern "C" long fastaparse_fastq(const char* buf, long nbytes,
                                 const char* mate, long mate_len,
                                 int64_t* state, long reads, char* out,
                                 long* consumed, long* written, long* taken,
                                 int* is_high) {
    const char* p = buf;
    const char* const end = buf + nbytes;
    char* q = out;
    long k = state[0], n = 0;
    long status = 0;
    bool hi = false;
    while (p < end) {
        const char* next;
        const char* eol = line_end(p, end, &next);
        if (k == 0) {
            if (n == reads) {
                status = 1;
                break;
            }
            if (eol == p || *p != '@') {
                status = 2;
                break;
            }
            if (high(p, eol)) {
                status = 3;
                break;
            }
            const char* s = p;
            bool first = true;
            while (true) {
                while (s < eol && space(*s)) ++s;
                if (s == eol) break;
                const char* t = s;
                while (t < eol && !space(*t)) ++t;
                if (!first) *q++ = ' ';
                std::memcpy(q, s, static_cast<size_t>(t - s));
                q += t - s;
                if (first) {
                    *q++ = '_';
                    std::memcpy(q, mate, static_cast<size_t>(mate_len));
                    q += mate_len;
                    first = false;
                }
                s = t;
            }
            *q++ = '\n';
            ++n;
        } else {
            const size_t len = static_cast<size_t>(eol - p);
            std::memcpy(q, p, len);
            hi = hi || high(p, eol);
            q += len;
            if (next > eol) *q++ = '\n';
        }
        k = (k + 1) & 3;
        p = next;
    }
    state[0] = k;
    *consumed = p - buf;
    *written = q - out;
    *taken = n;
    *is_high = hi ? 1 : 0;
    return status;
}
