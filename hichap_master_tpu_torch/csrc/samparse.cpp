// samparse: the alignment scanners of the port, host C++ (built with
// bedparse.cpp by the host compiler, see kernels/_build.py), bound with
// ctypes.  They turn SAM text, BAM records and restriction-fragment tables
// into columns, and encode columns as BAM records.
//
// Every alignment scanner gives, for record r of its block:
//   name bytes appended to `names` at name_off[r] (relative to the block's
//   names buffer), name_len[r]; base_len[r] the length of the name up to
//   its last "_" (0 without one: "_".join(name.split("_")[:-1])); tag[r]
//   the code of the name after its last "_" (the whole name without one):
//   "1" 1, "2" 2, "11" 3, "12" 4, "21" 5, "22" 6, anything else 0;
//   last[r] 1 when the name's last byte is '1', 2 when '2', else 0;
//   flag[r]; ref[r] (SAM: an id into the interned reference table, -1 for
//   "*"; BAM: the record's refID as written); pos[r] 0-based; qlen[r];
//   the sequence bytes appended to `seqs` at seq_off[r], seq_len[r];
//   as[r], xs[r] the AS and XS integer tags (0 when absent) and has[r]
//   (bit 0 AS present, bit 1 XS present); where `quals` is not null, the
//   QUAL text (as the JAX package's AlnRecord.qual holds it, UTF-8)
//   appended to `quals` at qual_off[r], qual_len[r].

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>

namespace {

// A decimal integer with an optional sign ("+" or "-"), at most 18 digits.
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

// Chromosome strings interned into a caller-owned table, as in bedparse.cpp.
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

// The columns of one scanner call.
struct Out {
    char* names;
    int64_t* name_off;
    int32_t* name_len;
    int32_t* base_len;
    int8_t* tag;
    int8_t* last;
    int32_t* flag;
    int32_t* ref;
    int64_t* pos;
    int32_t* qlen;
    char* seqs;
    int64_t* seq_off;
    int32_t* seq_len;
    int64_t* as;
    int64_t* xs;
    int8_t* has;
    char* quals;
    int64_t* qual_off;
    int32_t* qual_len;
    long names_used = 0;
    long seqs_used = 0;
    long quals_used = 0;

    void name(long r, const char* b, long n) {
        std::memcpy(names + names_used, b, static_cast<size_t>(n));
        name_off[r] = names_used;
        name_len[r] = static_cast<int32_t>(n);
        names_used += n;
        const void* u = n ? memrchr(b, '_', static_cast<size_t>(n)) : nullptr;
        const char* us = static_cast<const char*>(u);
        base_len[r] = us ? static_cast<int32_t>(us - b) : 0;
        const char* t = us ? us + 1 : b;
        const long tl = b + n - t;
        int8_t code = 0;
        if (tl == 1 && (t[0] == '1' || t[0] == '2')) {
            code = static_cast<int8_t>(t[0] - '0');
        } else if (tl == 2 && (t[0] == '1' || t[0] == '2') &&
                   (t[1] == '1' || t[1] == '2')) {
            code = static_cast<int8_t>(3 + 2 * (t[0] - '1') + (t[1] - '1'));
        }
        tag[r] = code;
        last[r] = n && (b[n - 1] == '1' || b[n - 1] == '2')
                      ? static_cast<int8_t>(b[n - 1] - '0') : 0;
    }
};

}  // namespace

// samparse_sam: one block of SAM text (complete lines) into the columns
// above, references interned into the caller's table.  The rules of the JAX
// package's parse_sam_line read through Python's text mode:
//   * a line ends at "\n", "\r" or "\r\n" (universal newlines);
//   * an empty line, a line that starts with "@" and a line of fewer than
//     11 tab-separated fields are skipped;
//   * RNAME "*" is no reference (-1); pos = POS - 1; qlen = the bytes of
//     SEQ, so a "*" SEQ has query length 1;
//   * among fields 12 on, "AS:i:<int>" and "XS:i:<int>" set AS and XS, the
//     last of each winning; other tags and types are ignored.
// FLAG, POS, MAPQ and the tag values must be integers (the JAX package's
// int() raises otherwise).  Returns the records (*bad_line: the lines of the
// block), -1 when the intern table is full (grow it and scan the block
// again), or -2 with *bad_line the index (0-based, in this block, counting
// every line) of a line that fails.
extern "C" long samparse_sam(const char* buf, long nbytes, char* tab,
                             long tab_cap, int32_t* tab_off, int32_t* tab_len,
                             int tab_max, int32_t* n_tab, char* names,
                             int64_t* name_off, int32_t* name_len,
                             int32_t* base_len, int8_t* tag, int8_t* last,
                             int32_t* flag, int32_t* ref, int64_t* pos,
                             int32_t* qlen, char* seqs, int64_t* seq_off,
                             int32_t* seq_len, int64_t* as, int64_t* xs,
                             int8_t* has, char* quals, int64_t* qual_off,
                             int32_t* qual_len, long* bad_line) {
    Interner table(tab, tab_cap, tab_off, tab_len, tab_max, n_tab);
    Out o{names, name_off, name_len, base_len, tag, last, flag, ref, pos,
          qlen, seqs, seq_off, seq_len, as, xs, has, quals, qual_off,
          qual_len};
    long r = 0, line = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    for (; p < end; ++line) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* eol = nl ? nl : end;
        const char* cr = static_cast<const char*>(
            std::memchr(p, '\r', static_cast<size_t>(eol - p)));
        const char* next;
        if (cr) {                       // "\r" ends the line ("\r\n": both)
            next = (cr + 1 < end && cr[1] == '\n') ? cr + 2 : cr + 1;
            eol = cr;
        } else {
            next = nl ? nl + 1 : end;
        }
        const char* q = p;
        p = next;
        if (eol == q || *q == '@') continue;
        const char* fb[11];
        const char* fe[11];
        int col = 0;
        const char* fs = q;
        while (col < 11) {
            const char* t = static_cast<const char*>(
                std::memchr(fs, '\t', static_cast<size_t>(eol - fs)));
            fb[col] = fs;
            fe[col] = t ? t : eol;
            ++col;
            if (!t) break;
            fs = t + 1;
        }
        if (col < 11) continue;
        int64_t v_flag, v_pos, v_mapq;
        if (!integer(fb[1], fe[1], &v_flag) || !integer(fb[3], fe[3], &v_pos)
            || !integer(fb[4], fe[4], &v_mapq)) {
            *bad_line = line;
            return -2;
        }
        int id = -1;
        if (!(fe[2] - fb[2] == 1 && fb[2][0] == '*')) {
            id = table.get(fb[2], fe[2]);
            if (id < 0) return -1;
        }
        int8_t h = 0;
        int64_t v_as = 0, v_xs = 0;
        const char* ts = fe[10];
        while (ts < eol) {              // the tags: fields 12 on
            ++ts;
            const char* t = static_cast<const char*>(
                std::memchr(ts, '\t', static_cast<size_t>(eol - ts)));
            const char* te = t ? t : eol;
            if (te - ts >= 5 && ts[2] == ':' && ts[3] == 'i' && ts[4] == ':'
                && ((ts[0] == 'A' || ts[0] == 'X') && ts[1] == 'S')) {
                int64_t v;
                if (!integer(ts + 5, te, &v)) {
                    *bad_line = line;
                    return -2;
                }
                if (ts[0] == 'A') {
                    v_as = v;
                    h |= 1;
                } else {
                    v_xs = v;
                    h |= 2;
                }
            }
            ts = te;
        }
        o.name(r, fb[0], fe[0] - fb[0]);
        flag[r] = static_cast<int32_t>(v_flag);
        ref[r] = id;
        pos[r] = v_pos - 1;
        const long sl = fe[9] - fb[9];
        std::memcpy(seqs + o.seqs_used, fb[9], static_cast<size_t>(sl));
        seq_off[r] = o.seqs_used;
        seq_len[r] = static_cast<int32_t>(sl);
        o.seqs_used += sl;
        qlen[r] = static_cast<int32_t>(sl);
        if (quals) {                    // QUAL: field 11 as written
            const long ql = fe[10] - fb[10];
            std::memcpy(quals + o.quals_used, fb[10],
                        static_cast<size_t>(ql));
            qual_off[r] = o.quals_used;
            qual_len[r] = static_cast<int32_t>(ql);
            o.quals_used += ql;
        }
        as[r] = v_as;
        xs[r] = v_xs;
        has[r] = h;
        ++r;
    }
    *bad_line = line;
    return r;
}

namespace {

template <typename T>
T load(const unsigned char* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;
}

// The AS and XS tags of a BAM record's auxiliary block [p, e), scanned as
// the JAX package's _parse_tags does (hichap_master_tpu/io/bam.py:41-80):
// integer types cCsSiI set AS or XS (the last wins), A/f/Z/H and B arrays
// are skipped, an unknown type ends the scan.  Returns false where the JAX
// package raises (a truncated integer, a Z/H string without NUL, an array
// of an unknown element type).
bool bam_tags(const unsigned char* p, const unsigned char* e, int64_t* v_as,
              int64_t* v_xs, int8_t* h) {
    const long n = e - p;
    long i = 0;
    while (i + 3 <= n) {
        const unsigned char t0 = p[i], t1 = p[i + 1], typ = p[i + 2];
        i += 3;
        long sz = 0;
        int64_t val = 0;
        switch (typ) {
            case 'c': sz = 1; if (i + sz <= n) val = load<int8_t>(p + i); break;
            case 'C': sz = 1; if (i + sz <= n) val = load<uint8_t>(p + i); break;
            case 's': sz = 2; if (i + sz <= n) val = load<int16_t>(p + i); break;
            case 'S': sz = 2; if (i + sz <= n) val = load<uint16_t>(p + i); break;
            case 'i': sz = 4; if (i + sz <= n) val = load<int32_t>(p + i); break;
            case 'I': sz = 4; if (i + sz <= n) val = load<uint32_t>(p + i); break;
            default: break;
        }
        if (sz) {
            if (i + sz > n) return false;
            i += sz;
            if (t0 == 'A' && t1 == 'S') {
                *v_as = val;
                *h |= 1;
            } else if (t0 == 'X' && t1 == 'S') {
                *v_xs = val;
                *h |= 2;
            }
        } else if (typ == 'A') {
            i += 1;
        } else if (typ == 'f') {
            i += 4;
        } else if (typ == 'Z' || typ == 'H') {
            const void* z = i < n ? std::memchr(p + i, 0,
                                                static_cast<size_t>(n - i))
                                  : nullptr;
            if (!z) return false;
            i = static_cast<const unsigned char*>(z) - p + 1;
        } else if (typ == 'B') {
            if (i >= n) return false;
            long elt;
            switch (p[i]) {
                case 'c': case 'C': elt = 1; break;
                case 's': case 'S': elt = 2; break;
                case 'i': case 'I': case 'f': elt = 4; break;
                default: return false;
            }
            if (i + 5 > n) return false;
            const uint32_t cnt = load<uint32_t>(p + i + 1);
            i += 5 + static_cast<long>(cnt) * elt;
            if (i > n) break;
        } else {
            break;                      // unknown type: cannot skip safely
        }
    }
    return true;
}

}  // namespace

// samparse_bam: BAM records (each block_size, then the record) from the
// start of `buf` into the columns above, stopping before the first record
// that `buf` does not hold whole; *consumed is the bytes parsed.  The name
// is the read name without its NUL; SEQ's 4-bit codes decode through
// "=ACMGRSVTWYHKDBN", and qlen = l_seq (0 for an empty SEQ, where SAM's "*"
// gives 1).  QUAL, where asked for, is the JAX package's text
// (hichap_master_tpu/io/bam.py:122-125): "*" when l_seq > 0 and the first
// byte is 0xff, else chr(q + 33) for every byte q, as UTF-8 (two bytes
// from q = 95 on); l_seq 0 gives "".  Returns the records, or -2 with
// *bad_line the index of the record that fails (see bam_tags, or a record
// shorter than its fields).
extern "C" long samparse_bam(const char* buf, long nbytes, char* names,
                             int64_t* name_off, int32_t* name_len,
                             int32_t* base_len, int8_t* tag, int8_t* last,
                             int32_t* flag, int32_t* ref, int64_t* pos,
                             int32_t* qlen, char* seqs, int64_t* seq_off,
                             int32_t* seq_len, int64_t* as, int64_t* xs,
                             int8_t* has, char* quals, int64_t* qual_off,
                             int32_t* qual_len, long* consumed,
                             long* bad_line) {
    static const char kCodes[] = "=ACMGRSVTWYHKDBN";
    Out o{names, name_off, name_len, base_len, tag, last, flag, ref, pos,
          qlen, seqs, seq_off, seq_len, as, xs, has, quals, qual_off,
          qual_len};
    const unsigned char* u = reinterpret_cast<const unsigned char*>(buf);
    long at = 0, r = 0;
    while (at + 4 <= nbytes) {
        const int32_t bs = load<int32_t>(u + at);
        if (bs < 32) {
            *bad_line = r;
            return -2;
        }
        if (at + 4 + bs > nbytes) break;
        const unsigned char* rec = u + at + 4;
        const int32_t ref_id = load<int32_t>(rec);
        const int32_t p0 = load<int32_t>(rec + 4);
        const long l_name = rec[8];
        const long n_cigar = load<uint16_t>(rec + 12);
        const uint16_t fl = load<uint16_t>(rec + 14);
        const int32_t l_seq = load<int32_t>(rec + 16);
        const long seq_at = 32 + l_name + 4 * n_cigar;
        const long tags_at = seq_at + (l_seq + 1) / 2 + l_seq;
        if (l_seq < 0 || tags_at > bs) {
            *bad_line = r;
            return -2;
        }
        int64_t v_as = 0, v_xs = 0;
        int8_t h = 0;
        if (!bam_tags(rec + tags_at, rec + bs, &v_as, &v_xs, &h)) {
            *bad_line = r;
            return -2;
        }
        o.name(r, reinterpret_cast<const char*>(rec + 32),
               l_name > 0 ? l_name - 1 : 0);
        flag[r] = fl;
        ref[r] = ref_id;
        pos[r] = p0;
        char* s = seqs + o.seqs_used;
        for (int32_t k = 0; k < l_seq; ++k) {
            const unsigned char b = rec[seq_at + k / 2];
            s[k] = kCodes[(k & 1) ? (b & 15) : (b >> 4)];
        }
        seq_off[r] = o.seqs_used;
        seq_len[r] = l_seq;
        o.seqs_used += l_seq;
        qlen[r] = l_seq;
        if (quals) {
            const unsigned char* qs = rec + seq_at + (l_seq + 1) / 2;
            char* w = quals + o.quals_used;
            char* const w0 = w;
            if (l_seq > 0 && qs[0] == 0xff) {
                *w++ = '*';
            } else {
                for (int32_t k = 0; k < l_seq; ++k) {
                    const int v = qs[k] + 33;
                    if (v < 0x80) {
                        *w++ = static_cast<char>(v);
                    } else {
                        *w++ = static_cast<char>(0xc0 | (v >> 6));
                        *w++ = static_cast<char>(0x80 | (v & 0x3f));
                    }
                }
            }
            qual_off[r] = o.quals_used;
            qual_len[r] = static_cast<int32_t>(w - w0);
            o.quals_used += w - w0;
        }
        as[r] = v_as;
        xs[r] = v_xs;
        has[r] = h;
        at += 4 + bs;
        ++r;
    }
    *consumed = at;
    return r;
}

// samparse_bam_encode: n records as BAM (block_size, then the record, as the
// JAX package's _encode_record writes them: bin 0, no CIGAR, next refID and
// pos -1, tlen 0; SEQ bases outside "=ACMGRSVTWYHKDBN" as 15; QUAL 0xff per
// base where qual is null or a record's qual_len is not its seq_len, else
// each byte - 33; then "ASi" and "XSi" int32 tags where present).  Returns
// the bytes written, or -1 if `cap` bytes would not hold them.
extern "C" long samparse_bam_encode(long n, const char* names,
                                    const int64_t* name_off,
                                    const int32_t* name_len,
                                    const int32_t* flag, const int32_t* ref,
                                    const int64_t* pos, const int32_t* mapq,
                                    const char* seqs, const int64_t* seq_off,
                                    const int32_t* seq_len, const char* qual,
                                    const int64_t* qual_off,
                                    const int32_t* qual_len,
                                    const int64_t* as, const int64_t* xs,
                                    const int8_t* has, char* out, long cap) {
    int8_t code[256];
    std::memset(code, 15, sizeof(code));
    static const char kCodes[] = "=ACMGRSVTWYHKDBN";
    for (int k = 0; k < 16; ++k)
        code[static_cast<unsigned char>(kCodes[k])] = static_cast<int8_t>(k);
    unsigned char* q = reinterpret_cast<unsigned char*>(out);
    unsigned char* const stop = q + cap;
    for (long r = 0; r < n; ++r) {
        const long ln = name_len[r] + 1, ls = seq_len[r];
        const long body = 32 + ln + (ls + 1) / 2 + ls +
                          ((has[r] & 1) ? 7 : 0) + ((has[r] & 2) ? 7 : 0);
        if (stop - q < 4 + body) return -1;
        const int32_t head[9] = {static_cast<int32_t>(body), ref[r],
                                 static_cast<int32_t>(pos[r]), 0, 0,
                                 static_cast<int32_t>(ls), -1, -1, 0};
        std::memcpy(q, head, 12);
        q[12] = static_cast<unsigned char>(ln);
        q[13] = static_cast<unsigned char>(mapq[r]);
        const uint16_t bin = 0, n_cigar = 0;
        const uint16_t fl = static_cast<uint16_t>(flag[r]);
        std::memcpy(q + 14, &bin, 2);
        std::memcpy(q + 16, &n_cigar, 2);
        std::memcpy(q + 18, &fl, 2);
        std::memcpy(q + 20, head + 5, 16);
        q += 36;
        std::memcpy(q, names + name_off[r], static_cast<size_t>(ln - 1));
        q[ln - 1] = 0;
        q += ln;
        const unsigned char* s =
            reinterpret_cast<const unsigned char*>(seqs + seq_off[r]);
        for (long k = 0; k < ls; k += 2) {
            const int hi = code[s[k]];
            const int lo = k + 1 < ls ? code[s[k + 1]] : 0;
            *q++ = static_cast<unsigned char>((hi << 4) | lo);
        }
        if (qual && qual_len[r] == ls) {
            const char* qs = qual + qual_off[r];
            for (long k = 0; k < ls; ++k)
                *q++ = static_cast<unsigned char>(qs[k] - 33);
        } else {
            std::memset(q, 0xff, static_cast<size_t>(ls));
            q += ls;
        }
        if (has[r] & 1) {
            const int32_t v = static_cast<int32_t>(as[r]);
            std::memcpy(q, "ASi", 3);
            std::memcpy(q + 3, &v, 4);
            q += 7;
        }
        if (has[r] & 2) {
            const int32_t v = static_cast<int32_t>(xs[r]);
            std::memcpy(q, "XSi", 3);
            std::memcpy(q + 3, &v, 4);
            q += 7;
        }
    }
    return static_cast<long>(q - reinterpret_cast<unsigned char*>(out));
}

// samparse_fragments: one block of a restriction-fragment table (complete
// lines) into (chromosome id of field 1, the integer of field 3), fields
// split on runs of whitespace as Python's str.split() does for ASCII.  A
// line of fewer than 3 fields, or a field 3 that is no integer, fails as
// the JAX package's load_fragments does.  Returns the rows (*bad_line: the
// lines of the block), -1 for a full intern table, or -2 with *bad_line the
// index of the line that fails.
extern "C" long samparse_fragments(const char* buf, long nbytes, char* tab,
                                   long tab_cap, int32_t* tab_off,
                                   int32_t* tab_len, int tab_max,
                                   int32_t* n_tab, int32_t* chrom,
                                   int64_t* end_col, long* bad_line) {
    Interner table(tab, tab_cap, tab_off, tab_len, tab_max, n_tab);
    auto space = [](char c) {
        return c == ' ' || c == '\t' || c == '\v' || c == '\f' || c == '\r' ||
               (c >= 0x1c && c <= 0x1f);
    };
    long r = 0, line = 0;
    const char* p = buf;
    const char* const end = buf + nbytes;
    for (; p < end; ++line) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* eol = nl ? nl : end;
        const char* fb[3];
        const char* fe[3];
        int col = 0;
        const char* q = p;
        while (col < 3) {
            while (q < eol && space(*q)) ++q;
            if (q == eol) break;
            fb[col] = q;
            while (q < eol && !space(*q)) ++q;
            fe[col++] = q;
        }
        p = nl ? nl + 1 : end;
        int64_t v;
        if (col < 3 || !integer(fb[2], fe[2], &v)) {
            *bad_line = line;
            return -2;
        }
        const int id = table.get(fb[0], fe[0]);
        if (id < 0) return -1;
        chrom[r] = id;
        end_col[r] = v;
        ++r;
    }
    *bad_line = line;
    return r;
}
