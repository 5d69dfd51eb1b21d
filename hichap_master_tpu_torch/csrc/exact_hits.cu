// K9: every read's exact occurrences in a genome, on both strands, through
// K8's index (csrc/exact_index.cu).
//
// Port-only: it replaces no Pallas kernel.  FakeAligner's _hits
// (hichap_master_tpu/pipeline/mapping.py:248-267) runs str.find for the
// read and its reverse complement across every chromosome.  Entry 2 r + t
// is read r on strand t (1: the reverse complement, A C G T swapped with
// T G C A, every other byte kept, read backwards); for each entry the
// kernel gives the lowest global position of an exact occurrence that lies
// inside one chromosome (-1 for none) and the number of such occurrences,
// capped at 2.  The genome is upper-cased, the read is not: a read with a
// byte in a..z has no occurrence.
//
// Exactness rests on one fact: every occurrence of a read contains every
// keyed window of it (k bytes of ACGT), so the bucket of any one window
// holds all its hits, and the seed may be chosen by any rule.
//
// What bounds it on the H100: the reads and outputs once, one pair of
// bucket starts an entry, the seed bucket's positions and L genome bytes a
// candidate.  The design, one warp a read and both strands in one pass:
//   - the read is staged once in shared memory with its reverse complement
//     beside it (the only load of the read);
//   - the seed of each strand is the smallest bucket among a bounded set of
//     windows, the disjoint ones at 0, k, 2k, ... and the last (13 at 150
//     bases, k 13, instead of 138), the same windows serving both strands;
//     only a read with none of ACGT among them looks at every offset;
//   - both strands' candidates share the warp's lanes; a candidate is held
//     inside its chromosome (starts and ends staged in shared memory) and
//     compared four bytes at a time (aligned genome words joined by a
//     funnel shift against the staged strand);
//   - a read shorter than k takes the buckets its prefix spans and K8's
//     side list, which is ascending, so the walk stops once each strand
//     has two hits and the next side position lies past its first.
// A read with no such window and no such prefix (a byte outside ACGT in
// every window) is marked; exact_hits_scan then compares it at every
// position of the genome: a block per 32 kb segment staged in shared
// memory once for every marked entry, the minimum and count by atomics;
// an entry that already has two hits before a segment is passed over
// there (an all-N read: after the first N run).  The wrapper sizes the
// staging room to the longest read of the call, up to what a block's
// shared memory holds; a longer read is not staged, and both kernels read
// its strands from device memory (read_byte), the same comparisons.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanSeg = 1 << 15;      // positions a block of the scan
constexpr int kChromStage = 256;      // chromosomes staged a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int base_code(uint8_t c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

__device__ __forceinline__ uint8_t complement(uint8_t c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    default: return c;
  }
}

// Byte j of the read on strand t (1: the reverse complement).
__device__ __forceinline__ uint8_t read_byte(const uint8_t* __restrict__ r,
                                             int L, int t, int j) {
  return t ? complement(r[L - 1 - j]) : r[j];
}

// The last c in [0, C) with start[c] <= p (0 when there is none).
__device__ __forceinline__ int chrom_of(const int64_t* start, int C,
                                        int64_t p) {
  int lo = 0, hi = C - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void keep(int64_t p, int64_t* best, int* n) {
  if (p < *best) *best = p;
  ++*n;
}

// One strand of a read: staged in shared memory (kStaged: s, 4-byte
// aligned, zero past L up to a multiple of 4), or, for a read longer than
// the staging room, read from device memory a byte at a time (r).  The
// two are separate instantiations, so the staged path carries no test;
// strands go by value (a reference to a choice of two would put both on
// the stack).
template <bool kStaged>
struct Strand {
  static constexpr bool staged = kStaged;
  const uint8_t* s;
  const uint8_t* r;
  int L, t;

  __device__ __forceinline__ uint8_t at(int j) const {
    if (kStaged) return s[j];
    return read_byte(r, L, t, j);
  }
  // bytes j .. j + 3, little-endian (zero past L when not staged)
  __device__ __forceinline__ uint32_t word(int j) const {
    if (kStaged) return *reinterpret_cast<const uint32_t*>(s + j);
    uint32_t w = 0;
    for (int d = 0; d < 4 && j + d < L; ++d)
      w |= (uint32_t)read_byte(r, L, t, j + d) << (8 * d);
    return w;
  }
};

// Whether genome bytes p .. p + L (p + L <= G) equal the strand's: aligned
// 4-byte words of the genome joined by a funnel shift, against the
// strand's words.
template <class Str>
__device__ __forceinline__ bool equal_at(const uint32_t* __restrict__ g32,
                                         int64_t G, int64_t p,
                                         const Str s) {
  const int L = s.L;
  const int64_t last = (G - 1) >> 2;
  int64_t a = p >> 2;
  const uint32_t sh = 8u * (uint32_t)(p & 3);
  uint32_t lo = g32[a];
  for (int j = 0; j < L; j += 4) {
    const uint32_t hi = a + 1 <= last ? g32[a + 1] : 0u;
    const uint32_t w = __funnelshift_r(lo, hi, sh);
    const int rem = L - j;
    const uint32_t m = rem >= 4 ? kFull : (1u << (8 * rem)) - 1u;
    if ((w ^ s.word(j)) & m) return false;
    lo = hi;
    ++a;
  }
  return true;
}

// The key of the strand's k bytes at q (-1 when one is not ACGT).
template <class Str>
__device__ __forceinline__ int64_t key_at(const Str s, int q, int k) {
  int64_t key = 0;
  for (int j = 0; j < k; ++j) {
    const int b = base_code(s.at(q + j));
    if (b < 0) return -1;
    key = (key << 2) | b;
  }
  return key;
}

// A strand's seed: the smallest bucket (ties: the lowest forward window).
struct Seed {
  int64_t size, lo;
  int q;
};

__device__ __forceinline__ void better(Seed& a, int64_t size, int64_t lo,
                                       int q) {
  if (size < a.size || (size == a.size && q < a.q)) {
    a.size = size;
    a.lo = lo;
    a.q = q;
  }
}

__device__ __forceinline__ void warp_min(Seed& a) {
  for (int d = 16; d; d >>= 1) {
    const int64_t s2 = __shfl_xor_sync(kFull, a.size, d);
    const int64_t l2 = __shfl_xor_sync(kFull, a.lo, d);
    const int q2 = __shfl_xor_sync(kFull, a.q, d);
    better(a, s2, l2, q2);
  }
}

// Seeds of both strands over the forward windows q = q0, q0 + dq, ...
// (and the last window L - k when `last`); strand 1's window for forward
// window q is its offset L - k - q.
template <class Str>
__device__ __forceinline__ void seeds(const Str fw, const Str rc,
                                      int k, int dq, bool last,
                                      const int64_t* __restrict__ bucket,
                                      Seed (&sd)[2]) {
  const int lane = threadIdx.x & 31;
  const int L = fw.L;
  const int n = (L - k) / dq + 1 + (last && (L - k) % dq != 0);
  for (int i = lane; i < n; i += 32) {
    const int q = i * dq < L - k ? i * dq : L - k;
    const int64_t kf = key_at(fw, q, k);
    if (kf < 0) continue;
    const int64_t kr = key_at(rc, L - k - q, k);
    const int64_t f0 = bucket[kf], f1 = bucket[kf + 1];
    const int64_t r0 = bucket[kr], r1 = bucket[kr + 1];
    better(sd[0], f1 - f0, f0, q);
    better(sd[1], r1 - r0, r0, q);
  }
  warp_min(sd[0]);
  warp_min(sd[1]);
}

// One read's search, both strands (the warp's lanes): the seeds, the
// candidates of both strands, and for a read shorter than k the side list.
template <class Str>
__device__ __forceinline__ void search(
    const uint8_t* __restrict__ g, int64_t G, const int64_t* st,
    const int64_t* en, int C, int k, const int64_t* __restrict__ bucket,
    const unsigned int* __restrict__ pos, const int64_t* __restrict__ side,
    int64_t S, const Str fw, const Str rc, bool other, int64_t e,
    int64_t* __restrict__ hit, int* __restrict__ count,
    int* __restrict__ marked) {
  const int lane = threadIdx.x & 31;
  const int L = fw.L;
  Seed sd[2];
  int64_t off[2] = {0, 0};
  bool seeded = false, short_read = false;
  if (L >= k) {
    for (int t = 0; t < 2; ++t) sd[t] = Seed{INT64_MAX, 0, 0x7fffffff};
    seeds(fw, rc, k, k, true, bucket, sd);
    if (sd[0].size == INT64_MAX && other)
      seeds(fw, rc, k, 1, false, bucket, sd);   // every offset
    seeded = sd[0].size != INT64_MAX;
    off[0] = sd[0].q;
    off[1] = L - k - sd[1].q;
  } else if (!other) {
    for (int t = 0; t < 2; ++t) {
      const Str s = t ? rc : fw;
      int64_t prefix = 0;
      for (int j = 0; j < L; ++j) prefix = (prefix << 2) | base_code(s.at(j));
      const int shift = 2 * (k - L);
      const int64_t lo = bucket[prefix << shift];
      sd[t] = Seed{bucket[(prefix + 1) << shift] - lo, lo, 0};
    }
    seeded = short_read = true;
  }
  if (!seeded) {
    if (lane < 2) {
      marked[e + lane] = 1;
      hit[e + lane] = -1;
      count[e + lane] = 0;
    }
    return;
  }
  const uint32_t* g32 = reinterpret_cast<const uint32_t*>(g);
  int64_t best[2] = {INT64_MAX, INT64_MAX};
  int n[2] = {0, 0};
  const int64_t nf = sd[0].size, total = nf + sd[1].size;
  for (int64_t i = lane; i < total; i += 32) {
    const int t = i >= nf;
    const int64_t q = pos[t ? sd[1].lo + (i - nf) : sd[0].lo + i];
    const int64_t p = q - off[t];
    const int c = chrom_of(st, C, q);
    if (p >= st[c] && p + L <= en[c] && equal_at(g32, G, p, t ? rc : fw))
      keep(p, &best[t], &n[t]);
  }
  for (int t = 0; t < 2; ++t) {
    for (int d = 16; d; d >>= 1) {
      const int64_t b2 = __shfl_xor_sync(kFull, best[t], d);
      if (b2 < best[t]) best[t] = b2;
      n[t] += __shfl_xor_sync(kFull, n[t], d);
    }
  }
  if (short_read) {
    // the side list ascends: stop once each strand has two hits and the
    // next side position lies past its first
    for (int64_t b0 = 0; b0 < S; b0 += 32) {
      const int64_t i = b0 + lane;
      int64_t bs[2] = {INT64_MAX, INT64_MAX};
      int ns[2] = {0, 0};
      if (i < S) {
        const int64_t p = side[i];
        const int c = chrom_of(st, C, p);
        if (p >= st[c] && p + L <= en[c]) {
          for (int t = 0; t < 2; ++t)
            if (equal_at(g32, G, p, t ? rc : fw)) keep(p, &bs[t], &ns[t]);
        }
      }
      for (int t = 0; t < 2; ++t) {
        for (int d = 16; d; d >>= 1) {
          const int64_t b2 = __shfl_xor_sync(kFull, bs[t], d);
          if (b2 < bs[t]) bs[t] = b2;
          ns[t] += __shfl_xor_sync(kFull, ns[t], d);
        }
        if (bs[t] < best[t]) best[t] = bs[t];
        n[t] += ns[t];
      }
      if (b0 + 32 >= S) break;
      const int64_t next = side[b0 + 32];
      if (n[0] >= 2 && n[1] >= 2 && next > best[0] && next > best[1]) break;
    }
  }
  if (lane < 2) {
    hit[e + lane] = n[lane] ? best[lane] : -1;
    count[e + lane] = n[lane] < 2 ? n[lane] : 2;
    marked[e + lane] = 0;
  }
}

// The search of a read longer than the staging room, its strands read
// from device memory; out of line, so the staged path keeps its registers.
__device__ __noinline__ void search_long(
    const uint8_t* __restrict__ g, int64_t G, const int64_t* st,
    const int64_t* en, int C, int k, const int64_t* __restrict__ bucket,
    const unsigned int* __restrict__ pos, const int64_t* __restrict__ side,
    int64_t S, const uint8_t* src, int L, bool other, int64_t e,
    int64_t* __restrict__ hit, int* __restrict__ count,
    int* __restrict__ marked) {
  search(g, G, st, en, C, k, bucket, pos, side, S,
         Strand<false>{nullptr, src, L, 0}, Strand<false>{nullptr, src, L, 1},
         other, e, hit, count, marked);
}

__global__ void hits_seeded(const uint8_t* __restrict__ g, int64_t G,
                            const int64_t* __restrict__ start,
                            const int64_t* __restrict__ end, int C, int k,
                            const int64_t* __restrict__ bucket,
                            const unsigned int* __restrict__ pos,
                            const int64_t* __restrict__ side, int64_t S,
                            const uint8_t* __restrict__ reads,
                            const int64_t* __restrict__ read_off,
                            const int* __restrict__ read_len, int64_t R,
                            int lcap, int64_t* __restrict__ hit,
                            int* __restrict__ count,
                            int* __restrict__ marked) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int64_t* cs = reinterpret_cast<int64_t*>(smem);
  int64_t* ce = cs + kChromStage;
  const bool staged = C <= kChromStage;
  if (staged) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      cs[c] = start[c];
      ce[c] = end[c];
    }
  }
  __syncthreads();
  const int64_t* st = staged ? cs : start;
  const int64_t* en = staged ? ce : end;
  const int64_t r = (int64_t)blockIdx.x * warps + w;
  if (r >= R) return;
  const int L = read_len[r];
  const uint8_t* src = reads + read_off[r];
  const bool fits = L <= lcap;
  uint8_t* sf =
      smem + 2 * kChromStage * sizeof(int64_t) + 2 * (size_t)w * lcap;
  uint8_t* sr = sf + lcap;
  int lower = 0, other = 0;
  if (fits) {
    for (int j = lane; j < lcap; j += 32) {
      const uint8_t c = j < L ? src[j] : 0;
      sf[j] = c;
      if (j < L) {
        sr[L - 1 - j] = complement(c);
        lower |= c >= 'a' && c <= 'z';
        other |= base_code(c) < 0;
      } else {
        sr[j] = 0;
      }
    }
  } else {
    for (int j = lane; j < L; j += 32) {
      const uint8_t c = src[j];
      lower |= c >= 'a' && c <= 'z';
      other |= base_code(c) < 0;
    }
  }
  __syncwarp();
  lower = __any_sync(kFull, lower);
  other = __any_sync(kFull, other);
  const int64_t e = 2 * r;
  if (L == 0 || lower) {
    if (lane < 2) {
      hit[e + lane] = -1;
      count[e + lane] = 0;
      marked[e + lane] = 0;
    }
    return;
  }
  if (fits)
    search(g, G, st, en, C, k, bucket, pos, side, S,
           Strand<true>{sf, src, L, 0}, Strand<true>{sr, src, L, 1}, other,
           e, hit, count, marked);
  else
    search_long(g, G, st, en, C, k, bucket, pos, side, S, src, L, other, e,
                hit, count, marked);
}

// One marked entry against the span positions of a segment staged at seg
// (genome position s0): four positions a step, their first four bytes
// against the strand's by one 32-bit compare each (aligned words of the
// segment joined by a funnel shift), the rest byte by byte.  A staged
// strand ends inside the staged bytes; a longer one reads the genome past
// staged_end from device memory.
template <class Str>
__device__ __forceinline__ void scan_segment(
    const uint8_t* seg, const uint8_t* __restrict__ g, int64_t s0, int span,
    const Str sd, const int64_t* __restrict__ start,
    const int64_t* __restrict__ end, int C, int64_t& best, int& n,
    int staged_end = 0) {
  const int L = sd.L;
  const uint32_t* seg32 = reinterpret_cast<const uint32_t*>(seg);
  const uint32_t head = sd.word(0);
  const uint32_t mask = L >= 4 ? kFull : (1u << (8 * L)) - 1u;
  for (int q = 4 * threadIdx.x; q < span; q += 4 * blockDim.x) {
    const uint32_t a = seg32[q >> 2], b = seg32[(q >> 2) + 1];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (q + d >= span || ((__funnelshift_r(a, b, 8 * d) ^ head) & mask))
        continue;
      const int x = q + d;
      const int64_t p = s0 + x;
      int j = 4;
      while (j < L &&
             (Str::staged || x + j < staged_end ? seg[x + j] : g[p + j]) ==
                 sd.at(j))
        ++j;
      if (j < L) continue;
      const int c = chrom_of(start, C, p);
      if (p >= start[c] && p + L <= end[c]) keep(p, &best, &n);
    }
  }
}

// scan_segment for a read longer than the staging room; out of line.
__device__ __noinline__ void scan_long(
    const uint8_t* seg, const uint8_t* __restrict__ g, int64_t s0, int span,
    int staged_end, const uint8_t* r, int L, int t,
    const int64_t* __restrict__ start, const int64_t* __restrict__ end,
    int C, int64_t& best, int& n) {
  scan_segment(seg, g, s0, span, Strand<false>{nullptr, r, L, t}, start,
               end, C, best, n, staged_end);
}

// A block per segment of kScanSeg positions, staged in shared memory
// with the lcap bytes after it; every marked entry which[0 .. M) is
// compared at every position of the segment, its strand's bytes staged
// too when they fit in lcap (a longer read is compared against device
// memory, the genome past the staged bytes too).  An entry that already
// has two hits, the first before the segment, is passed over: nothing in
// the segment can change its output.
__global__ void __launch_bounds__(kScanThreads)
hits_scan(const uint8_t* __restrict__ g, int64_t G,
          const int64_t* __restrict__ start, const int64_t* __restrict__ end,
          int C, const uint8_t* __restrict__ reads,
          const int64_t* __restrict__ read_off,
          const int* __restrict__ read_len, const int64_t* __restrict__ which,
          int M, int lcap, int64_t* __restrict__ hit,
          int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* seg = smem;                       // kScanSeg + lcap bytes
  uint8_t* rd = smem + kScanSeg + lcap;      // the entry's strand, lcap
  __shared__ int live;
  const int64_t s0 = (int64_t)blockIdx.x * kScanSeg;
  bool staged = false;
  for (int m = 0; m < M; ++m) {
    const int64_t e = which[m];
    if (threadIdx.x == 0)
      live = !(reinterpret_cast<volatile int*>(count)[e] >= 2 &&
               reinterpret_cast<volatile unsigned long long*>(hit)[e] <
                   (unsigned long long)s0);
    __syncthreads();
    const int L = read_len[e >> 1];
    const int64_t s1 = s0 + kScanSeg < G - L + 1 ? s0 + kScanSeg : G - L + 1;
    if (!live || s1 <= s0) {
      __syncthreads();
      continue;
    }
    if (!staged) {
      for (int64_t q = threadIdx.x; q < kScanSeg + lcap; q += blockDim.x)
        seg[q] = s0 + q < G ? g[s0 + q] : 0;
      staged = true;
    }
    const uint8_t* r = reads + read_off[e >> 1];
    const int t = (int)(e & 1);
    const bool fits = L <= lcap;
    if (fits) {
      for (int j = threadIdx.x; j < L; j += blockDim.x)
        rd[j] = read_byte(r, L, t, j);
    }
    __syncthreads();
    int64_t best = INT64_MAX;
    int n = 0;
    if (fits)
      scan_segment(seg, g, s0, (int)(s1 - s0), Strand<true>{rd, r, L, t},
                   start, end, C, best, n);
    else
      scan_long(seg, g, s0, (int)(s1 - s0), kScanSeg + lcap, r, L, t, start,
                end, C, best, n);
    for (int d = 16; d; d >>= 1) {
      const int64_t b2 = __shfl_xor_sync(kFull, best, d);
      if (b2 < best) best = b2;
      n += __shfl_xor_sync(kFull, n, d);
    }
    if ((threadIdx.x & 31) == 0 && n) {
      atomicMin(reinterpret_cast<unsigned long long*>(hit + e),
                (unsigned long long)best);
      atomicAdd(count + e, n);
    }
    __syncthreads();
  }
}

}  // namespace

// hit[2R] (int64), count[2R], marked[2R]: entry 2 r + t is read r on strand
// t.  A block of `warps` warps, a read each; `lcap` bytes of staging a
// strand (a multiple of 16 above the longest read).  Marked entries
// (marked 1) have hit -1 and count 0 until exact_hits_scan has run for
// them.  The genome must be 4-byte aligned.
extern "C" int exact_hits(const uint8_t* g, int64_t G, const int64_t* start,
                          const int64_t* end, int C, int k,
                          const int64_t* bucket, const unsigned int* pos,
                          const int64_t* side, int64_t S,
                          const uint8_t* reads, const int64_t* read_off,
                          const int* read_len, int64_t R, int warps, int lcap,
                          int64_t* hit, int* count, int* marked,
                          cudaStream_t stream) {
  if (R == 0) return 0;
  const size_t bytes = 2 * kChromStage * sizeof(int64_t) +
                       2 * (size_t)warps * lcap;
  int rc = (int)cudaFuncSetAttribute(
      (const void*)hits_seeded, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (rc) return rc;
  const int64_t blocks = (R + warps - 1) / warps;
  hits_seeded<<<(unsigned int)blocks, 32 * warps, bytes, stream>>>(
      g, G, start, end, C, k, bucket, pos, side, S, reads, read_off, read_len,
      R, lcap, hit, count, marked);
  return (int)cudaGetLastError();
}

// Shared memory a block of exact_hits takes besides its reads' staging.
extern "C" int exact_hits_fixed_smem() {
  return 2 * kChromStage * (int)sizeof(int64_t);
}

// The marked entries which[0 .. M), each compared at every position of
// the genome (lcap as for exact_hits); hit (-1) and count (0) of each set
// beforehand.  Counts are not capped here.
extern "C" int exact_hits_scan(const uint8_t* g, int64_t G,
                               const int64_t* start, const int64_t* end,
                               int C, const uint8_t* reads,
                               const int64_t* read_off, const int* read_len,
                               const int64_t* which, int M, int lcap,
                               int64_t* hit, int* count, cudaStream_t stream) {
  if (M == 0) return 0;
  const size_t bytes = kScanSeg + 2 * (size_t)lcap;
  int rc = (int)cudaFuncSetAttribute(
      (const void*)hits_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (rc) return rc;
  const int64_t segs = (G + kScanSeg - 1) / kScanSeg;
  hits_scan<<<(unsigned int)(segs > 0 ? segs : 1), kScanThreads, bytes,
              stream>>>(g, G, start, end, C, reads, read_off, read_len, which,
                        M, lcap, hit, count);
  return (int)cudaGetLastError();
}

// Positions a block of exact_hits_scan stages.
extern "C" int exact_hits_scan_segment() { return kScanSeg; }
