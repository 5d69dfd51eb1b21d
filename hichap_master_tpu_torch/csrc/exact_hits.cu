// K9: every read's exact occurrences in a genome, on both strands, through
// K8's index (csrc/exact_index.cu).
//
// Port-only: FakeAligner's _hits (hichap_master_tpu/pipeline/mapping.py:
// 248-267) runs str.find for the read and its reverse complement across
// every chromosome.  Here one warp takes one read and one strand (strand 1
// is the reverse complement: A C G T swapped with T G C A, every other byte
// kept, read backwards) and gives the lowest global position of an exact
// occurrence that lies inside one chromosome (-1 for none) and the number
// of such occurrences, capped at 2.  The genome is upper-cased, the read is
// not: a read with a byte in a..z has no occurrence.
//
// Seeded path: among the read's windows of k bytes that hold only ACGT
// (every offset), the lanes pick the one whose bucket is smallest (ties:
// the lowest offset), then walk that bucket's positions q, a candidate
// start p = q - offset each, and compare the whole read at p (early exit at
// the first byte that differs), keeping a candidate only when p .. p + len
// lies inside q's chromosome.  A read shorter than k of ACGT only takes the
// buckets its prefix spans (keys prefix << 2(k - len) up to the next
// prefix, one contiguous range of pos) and K8's side list.  A read with no
// such window and no such prefix (a byte outside ACGT in every window) is
// marked; exact_hits_scan then compares it at every position of the
// genome, one grid row per marked read, the minimum and count by atomics.
//
// Bound on the H100: the reads, the chosen buckets' positions and the
// genome bytes of each candidate are read once; the scan of a marked read
// reads the whole genome once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kScanThreads = 256;

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

__device__ __forceinline__ int chrom_of(const int64_t* __restrict__ start,
                                        int C, int64_t p) {
  int lo = 0, hi = C - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Whether the read (strand t) occurs at p, inside chromosome c.
__device__ __forceinline__ bool occurs(const uint8_t* __restrict__ g,
                                       int64_t G,
                                       const int64_t* __restrict__ start,
                                       const int64_t* __restrict__ end, int c,
                                       const uint8_t* __restrict__ r, int L,
                                       int t, int64_t p) {
  if (p < start[c] || p + L > end[c] || p + L > G) return false;
  for (int j = 0; j < L; ++j)
    if (g[p + j] != read_byte(r, L, t, j)) return false;
  return true;
}

__device__ __forceinline__ void keep(int64_t p, int64_t* best, int* n) {
  if (p < *best) *best = p;
  ++*n;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
hits_seeded(const uint8_t* __restrict__ g, int64_t G,
            const int64_t* __restrict__ start, const int64_t* __restrict__ end,
            int C, int k, const int64_t* __restrict__ bucket,
            const unsigned int* __restrict__ pos,
            const int64_t* __restrict__ side, int64_t S,
            const uint8_t* __restrict__ reads,
            const int64_t* __restrict__ read_off,
            const int* __restrict__ read_len, int64_t R,
            int64_t* __restrict__ hit, int* __restrict__ count,
            int* __restrict__ marked) {
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= 2 * R) return;
  const int64_t rd = e >> 1;
  const int t = (int)(e & 1);
  const int L = read_len[rd];
  const uint8_t* r = reads + read_off[rd];
  int lower = 0, other = 0;
  for (int j = lane; j < L; j += 32) {
    const uint8_t c = r[j];
    lower |= c >= 'a' && c <= 'z';
    other |= base_code(c) < 0;
  }
  lower = __any_sync(0xffffffffu, lower);
  other = __any_sync(0xffffffffu, other);
  int64_t best = INT64_MAX;
  int n = 0;
  if (L > 0 && !lower) {
    int64_t lo = 0, hi = 0, off = 0;
    bool seeded = false, short_read = false;
    if (L >= k) {
      // the smallest bucket among the ACGT-only windows
      int64_t size = INT64_MAX, key_best = -1;
      int o_best = 0x7fffffff;
      for (int o = lane; o + k <= L; o += 32) {
        int64_t key = 0;
        int j = 0;
        for (; j < k; ++j) {
          const int b = base_code(read_byte(r, L, t, o + j));
          if (b < 0) break;
          key = (key << 2) | b;
        }
        if (j < k) continue;
        const int64_t s = bucket[key + 1] - bucket[key];
        if (s < size) {
          size = s;
          o_best = o;
          key_best = key;
        }
      }
      for (int d = 16; d; d >>= 1) {
        const int64_t s2 = __shfl_xor_sync(0xffffffffu, size, d);
        const int o2 = __shfl_xor_sync(0xffffffffu, o_best, d);
        const int64_t k2 = __shfl_xor_sync(0xffffffffu, key_best, d);
        if (s2 < size || (s2 == size && o2 < o_best)) {
          size = s2;
          o_best = o2;
          key_best = k2;
        }
      }
      if (key_best >= 0) {
        seeded = true;
        lo = bucket[key_best];
        hi = bucket[key_best + 1];
        off = o_best;
      }
    } else if (!other) {
      int64_t prefix = 0;
      for (int j = 0; j < L; ++j)
        prefix = (prefix << 2) | base_code(read_byte(r, L, t, j));
      const int shift = 2 * (k - L);
      lo = bucket[prefix << shift];
      hi = bucket[(prefix + 1) << shift];
      seeded = short_read = true;
    }
    if (!seeded) {
      if (lane == 0) {
        marked[e] = 1;
        hit[e] = -1;
        count[e] = 0;
      }
      return;
    }
    for (int64_t i = lo + lane; i < hi; i += 32) {
      const int64_t q = pos[i];
      const int64_t p = q - off;
      if (p < 0) continue;
      if (occurs(g, G, start, end, chrom_of(start, C, q), r, L, t, p))
        keep(p, &best, &n);
    }
    if (short_read) {
      for (int64_t i = lane; i < S; i += 32) {
        const int64_t p = side[i];
        if (occurs(g, G, start, end, chrom_of(start, C, p), r, L, t, p))
          keep(p, &best, &n);
      }
    }
  }
  for (int d = 16; d; d >>= 1) {
    const int64_t b2 = __shfl_xor_sync(0xffffffffu, best, d);
    if (b2 < best) best = b2;
    n += __shfl_xor_sync(0xffffffffu, n, d);
  }
  if (lane == 0) {
    hit[e] = n ? best : -1;
    count[e] = n < 2 ? n : 2;
    marked[e] = 0;
  }
}

// One grid row per marked entry: the entry compared at every position.
__global__ void __launch_bounds__(kScanThreads)
hits_scan(const uint8_t* __restrict__ g, int64_t G,
          const int64_t* __restrict__ start, const int64_t* __restrict__ end,
          int C, const uint8_t* __restrict__ reads,
          const int64_t* __restrict__ read_off,
          const int* __restrict__ read_len, const int64_t* __restrict__ which,
          int64_t* __restrict__ hit, int* __restrict__ count) {
  const int64_t e = which[blockIdx.y];
  const int64_t rd = e >> 1;
  const int t = (int)(e & 1);
  const int L = read_len[rd];
  const uint8_t* r = reads + read_off[rd];
  const uint8_t first = read_byte(r, L, t, 0);
  int64_t best = INT64_MAX;
  int n = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p + L <= G; p += stride) {
    if (g[p] != first) continue;
    int j = 1;
    for (; j < L; ++j)
      if (g[p + j] != read_byte(r, L, t, j)) break;
    if (j < L) continue;
    const int c = chrom_of(start, C, p);
    if (p >= start[c] && p + L <= end[c]) keep(p, &best, &n);
  }
  for (int d = 16; d; d >>= 1) {
    const int64_t b2 = __shfl_xor_sync(0xffffffffu, best, d);
    if (b2 < best) best = b2;
    n += __shfl_xor_sync(0xffffffffu, n, d);
  }
  if ((threadIdx.x & 31) == 0 && n) {
    atomicMin(reinterpret_cast<unsigned long long*>(hit + e),
              (unsigned long long)best);
    atomicAdd(count + e, n);
  }
}

}  // namespace

// hit[2R] (int64), count[2R], marked[2R]: entry 2 r + t is read r on strand
// t.  Marked entries (marked 1) have hit -1 and count 0 until
// exact_hits_scan has run for them.
extern "C" int exact_hits(const uint8_t* g, int64_t G, const int64_t* start,
                          const int64_t* end, int C, int k,
                          const int64_t* bucket, const unsigned int* pos,
                          const int64_t* side, int64_t S,
                          const uint8_t* reads, const int64_t* read_off,
                          const int* read_len, int64_t R, int64_t* hit,
                          int* count, int* marked, cudaStream_t stream) {
  if (R == 0) return 0;
  const int64_t blocks = (2 * R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hits_seeded<<<(unsigned int)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      g, G, start, end, C, k, bucket, pos, side, S, reads, read_off, read_len,
      R, hit, count, marked);
  return (int)cudaGetLastError();
}

// The marked entries which[0..M) (M <= 65535), each compared at every
// position of the genome; hit (-1) and count (0) of each set beforehand.
// Counts are not capped here.
extern "C" int exact_hits_scan(const uint8_t* g, int64_t G,
                               const int64_t* start, const int64_t* end,
                               int C, const uint8_t* reads,
                               const int64_t* read_off, const int* read_len,
                               const int64_t* which, int M, int64_t* hit,
                               int* count, cudaStream_t stream) {
  if (M == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t want = (G + kScanThreads - 1) / kScanThreads;
  const int64_t most = (int64_t)sms * 8;
  if (want > most) want = most;
  if (want < 1) want = 1;
  const dim3 grid((unsigned int)want, (unsigned int)M);
  hits_scan<<<grid, kScanThreads, 0, stream>>>(g, G, start, end, C, reads,
                                               read_off, read_len, which, hit,
                                               count);
  return (int)cudaGetLastError();
}
