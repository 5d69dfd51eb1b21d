// K8: the k-mer index of a genome for FakeAligner's exact search.
//
// Port-only: it replaces no Pallas kernel.  The JAX package's FakeAligner
// runs str.find over every chromosome for every read
// (hichap_master_tpu/pipeline/mapping.py:248-267); the port indexes the
// genome once and searches every read of a chunk at once (K9,
// csrc/exact_hits.cu).
//
// The genome is one uint8 buffer on the card, upper-cased, its chromosomes
// one after the other (start[c] <= end[c] <= start[c + 1]).  A window of k
// bases is keyed (2 bits a base, A C G T = 0 1 2 3, the first base most
// significant) when it lies inside one chromosome and holds only A, C, G
// and T.  The index is
//   bucket[4^k + 1]  where each key's positions start,
//   pos[W]           the global positions of the keyed windows, uint32
//                    (hg19's 3.1e9 positions exceed 2^31), grouped by key
//                    and ascending inside each key,
//   side[S]          the ascending positions p whose byte is one of ACGT
//                    but whose window is not keyed: where a read shorter
//                    than k can still start.
// That is exactly the plain version's index (a stable sort of the keyed
// windows by key), the same bytes on every run: no atomic in device memory.
//
// What bounds it on the H100: the genome read and bucket, pos and side
// written once (3.1 + 0.54 + 11.5 + ~0 GB at hg19: ~4.5 ms at 3.35 TB/s).
// A direct counting sort over 4^k keys makes one scattered atomic a window
// on 268 MB of counters (k 13), five times the L2.  The design is a stable
// counting sort in two levels instead, every counter in shared memory and
// no atomic in device memory:
//   index_hist       a block per tile of the genome, sub-tile by sub-tile
//                    of 8,192 positions staged in shared memory as 2-bit
//                    codes and three bit masks (A/C/G/T, bad bytes, cuts
//                    where a chromosome starts or ends), so a window's
//                    test and key are two 64-bit shifts: a histogram of
//                    the keys' top h bits (the partition, 2^h <= 4,096)
//                    and a count of side positions, written per tile;
//   (host)           an exclusive scan over (partition, tile) in that
//                    order, by torch.cumsum: each tile's offset inside
//                    each partition, genome order kept;
//   index_partition  the tiles again: each sub-tile sorted stably by
//                    partition (CUB's block radix sort, side positions as
//                    one more partition, the sorted items striped so that
//                    a warp's stores cover consecutive items), each run
//                    written at its tile's running offset as one 8-byte
//                    record (the key's low 2k - h bits, the position);
//   index_bucket     a block per partition, the largest first: a
//                    histogram of the low bits (at most 16,384 counters),
//                    its scan (the partition's slice of bucket), then the
//                    records scattered by the low bits' top group (at
//                    most 256 runs a block), then each run of whole groups
//                    of at most 4,096 records sorted in shared memory by
//                    (group, last kLowBits bits) and written back in
//                    place; a larger group goes through the partition's
//                    spent records.
// What bounds the design: the scattered 8-byte stores of index_partition
// (about one a window: 4,096 partitions against 8,192 positions a sorted
// sub-tile; one block a multiprocessor keeps their partial sectors fewer
// in L2) and the block sorts (CUB, 3-4 radix passes a level).  A
// partition of any size is one block's loop, so a key that holds a large
// share of the windows makes its partition's block the last to finish,
// with the same result.  Chromosomes: a block stages the starts and ends
// that meet its tile (up to kChromStage of them) in shared memory and
// reads the others from device memory; any count works.  Scratch: 9 bytes
// a keyed window (the 8-byte records and one byte of low bits) and 12
// bytes per (partition, tile).
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTileItems = 16;                // positions a thread
constexpr int kSub = kThreads * kTileItems;   // positions a sub-tile
constexpr int kItems = 8;                     // records a thread, pass 3
constexpr int kChunk = kThreads * kItems;     // records a sort, pass 3
constexpr int kGroups = kSub / 16 + 2;       // 16-byte groups staged
constexpr int kMaskWords = kSub / 32 + 1;    // 32-position mask words
constexpr int kChromStage = 256;             // chromosomes staged a block
constexpr unsigned kFull = 0xffffffffu;

using TileSort =
    cub::BlockRadixSort<uint16_t, kThreads, kTileItems, uint32_t>;
using KeySort = cub::BlockRadixSort<uint16_t, kThreads, kItems, uint32_t>;
using UScan = cub::BlockScan<uint32_t, kThreads>;

// A sub-tile of the genome in shared memory: positions T0 .. T0 + kSub +
// 31 as 2-bit codes (position 16 v + i at bits 30 - 2 i of code[v]) and
// three masks (bit j of word w: position T0 + 32 w + j).
struct Tile {
  uint32_t code[kGroups];
  uint32_t acgt[kMaskWords];   // the byte is A, C, G or T
  uint32_t bad[kMaskWords];    // not ACGT, or outside every chromosome
  uint32_t cut[kMaskWords];    // a chromosome starts or ends at the byte
  uint16_t half[kGroups];      // acgt bits by 16 positions
  int64_t cs[kChromStage];     // the staged chromosome starts and ends
  int64_t ce[kChromStage];
};

struct Chroms {
  const int64_t* start;        // staged (shared) or device memory
  const int64_t* end;
  int lo, hi;                  // the chromosomes that can meet the tile
  int base;                    // index of start[0] in the full table
};

__device__ __forceinline__ bool is_acgt(uint32_t c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// A C G T -> 0 1 2 3 (any value for other bytes).
__device__ __forceinline__ uint32_t code_of(uint32_t c) {
  return ((c >> 1) ^ (c >> 2)) & 3u;
}

// The last chromosome c in [lo, hi) of a sorted table with start[c] <= p,
// or lo when there is none.
__device__ __forceinline__ int last_start(const int64_t* start, int lo,
                                          int hi, int64_t p) {
  if (hi <= lo || start[lo] > p) return lo;
  int a = lo, b = hi - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (start[mid] <= p) a = mid; else b = mid - 1;
  }
  return a;
}

// The chromosomes that can meet positions [T0, T1): staged in shared
// memory when there are at most kChromStage of them.
__device__ Chroms chrom_range(const int64_t* __restrict__ start,
                              const int64_t* __restrict__ end, int C,
                              int64_t T0, int64_t T1, Tile& t) {
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    range[0] = last_start(start, 0, C, T0);
    int a = range[0], b = C;      // the first c with start[c] >= T1
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (start[mid] >= T1) b = mid; else a = mid + 1;
    }
    range[1] = a;
  }
  __syncthreads();
  Chroms ch{start, end, range[0], range[1], 0};
  if (ch.hi - ch.lo <= kChromStage) {
    for (int c = ch.lo + threadIdx.x; c < ch.hi; c += blockDim.x) {
      t.cs[c - ch.lo] = start[c];
      t.ce[c - ch.lo] = end[c];
    }
    ch.start = t.cs;
    ch.end = t.ce;
    ch.base = ch.lo;
  }
  __syncthreads();
  return ch;
}

// Bits [a, b) of a 32-bit word (0 <= a < b <= 32).
__device__ __forceinline__ uint32_t bit_range(int a, int b) {
  const uint32_t hi = b >= 32 ? kFull : (1u << b) - 1u;
  return hi & ~((1u << a) - 1u);
}

// Stage positions T0 .. T0 + kSub + 31 of the genome.
__device__ void stage(const uint8_t* __restrict__ g, int64_t G, int64_t T0,
                      const Chroms& ch, Tile& t) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(g) + T0) & 15) == 0;
  for (int v = threadIdx.x; v < kGroups; v += blockDim.x) {
    const int64_t q = T0 + 16 * (int64_t)v;
    uint8_t b[16];
    if (aligned && q + 16 <= G) {
      const uint4 x = *reinterpret_cast<const uint4*>(g + q);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) b[i] = (w[i >> 2] >> (8 * (i & 3))) & 255;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) b[i] = q + i < G ? g[q + i] : 0;
    }
    uint32_t code = 0, acgt = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      code = (code << 2) | code_of(b[i]);
      acgt |= (uint32_t)is_acgt(b[i]) << i;
    }
    t.code[v] = code;
    t.half[v] = (uint16_t)acgt;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kMaskWords; w += blockDim.x) {
    const int64_t q0 = T0 + 32 * (int64_t)w;
    uint32_t inside = 0, cut = 0;
    int c = last_start(ch.start, ch.lo - ch.base, ch.hi - ch.base, q0);
    for (; c < ch.hi - ch.base && ch.start[c] < q0 + 32; ++c) {
      const int64_t s = ch.start[c], e = ch.end[c];
      const int64_t a = s > q0 ? s : q0, z = e < q0 + 32 ? e : q0 + 32;
      if (a < z) inside |= bit_range((int)(a - q0), (int)(z - q0));
      if (s >= q0 && s < q0 + 32) cut |= 1u << (s - q0);
      if (e >= q0 && e < q0 + 32) cut |= 1u << (e - q0);
    }
    const uint32_t acgt = t.half[2 * w] | ((uint32_t)t.half[2 * w + 1] << 16);
    t.acgt[w] = acgt;
    t.bad[w] = ~(acgt & inside);
    t.cut[w] = cut;
  }
  __syncthreads();
}

// Window at local position i: keyed (1) or side (2) or neither (0), and
// its key when keyed.
__device__ __forceinline__ int window(const Tile& t, int i, int k,
                                      uint32_t* key) {
  const int w = i >> 5, j = i & 31;
  const uint64_t bad = t.bad[w] | ((uint64_t)t.bad[w + 1] << 32);
  const uint64_t cut = t.cut[w] | ((uint64_t)t.cut[w + 1] << 32);
  const bool keyed = ((bad >> j) & ((1ull << k) - 1)) == 0 &&
                     ((cut >> (j + 1)) & ((1ull << (k - 1)) - 1)) == 0;
  if (keyed) {
    const int v = i >> 4, o = i & 15;
    const uint64_t y = ((uint64_t)t.code[v] << 32) | t.code[v + 1];
    *key = (uint32_t)((y >> (64 - 2 * o - 2 * k)) & ((1ull << (2 * k)) - 1));
    return 1;
  }
  return ((t.acgt[w] >> j) & 1u) ? 2 : 0;
}

// After a sort to the striped arrangement (item u of thread t is item
// u * kThreads + t of the sorted chunk, so a warp's stores cover
// consecutive items): each item's run start (the first item with its key,
// a binary search of the keys staged in skey) and whether it is its key's
// last.  The caller synchronises before skey is reused.
template <int ITEMS>
__device__ __forceinline__ void runs(const uint16_t (&key)[ITEMS],
                                     uint16_t* skey, int (&rs)[ITEMS],
                                     bool (&tail)[ITEMS]) {
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) skey[u * kThreads + threadIdx.x] = key[u];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int i = u * kThreads + threadIdx.x;
    int a = 0, b = i;                 // the first index with skey >= key
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (skey[mid] < key[u]) a = mid + 1; else b = mid;
    }
    rs[u] = a;
    tail[u] = i == ITEMS * kThreads - 1 || skey[i + 1] != key[u];
  }
}

// Dynamic shared memory of index_hist / index_partition.
struct PartShared {
  Tile tile;
  union {
    typename TileSort::TempStorage sort;
    uint16_t skey[kSub];
  } tmp;
  int64_t side_base;
  uint32_t side_n;
};

__global__ void __launch_bounds__(kThreads, 1)
index_hist(const uint8_t* __restrict__ g, int64_t G,
           const int64_t* __restrict__ start, const int64_t* __restrict__ end,
           int C, int k, int sub_bits, int tile, int B,
           int* __restrict__ hist, int* __restrict__ side_cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  PartShared& sh = *reinterpret_cast<PartShared*>(smem);
  uint32_t* cnt = reinterpret_cast<uint32_t*>(&sh + 1);
  const int P = 1 << (2 * k - sub_bits);
  const int b = blockIdx.x;
  const int64_t T = (int64_t)b * tile;
  for (int p = threadIdx.x; p < P; p += kThreads) cnt[p] = 0;
  if (threadIdx.x == 0) sh.side_n = 0;
  const int64_t Tend = T + tile < G ? T + tile : G;
  const Chroms ch = chrom_range(start, end, C, T, Tend + 32, sh.tile);
  const int lane = threadIdx.x & 31;
  for (int64_t T0 = T; T0 < Tend; T0 += kSub) {
    stage(g, G, T0, ch, sh.tile);
    uint32_t side = 0;
#pragma unroll
    for (int u = 0; u < kTileItems; ++u) {
      const int i = threadIdx.x * kTileItems + u;
      uint32_t key = 0;
      const int kind = T0 + i < G ? window(sh.tile, i, k, &key) : 0;
      const int part = kind == 1 ? (int)(key >> sub_bits) : -1;
      // a warp whose windows share one partition adds once (poly-A runs)
      const int p0 = __shfl_sync(kFull, part, 0);
      if (__all_sync(kFull, part == p0)) {
        if (lane == 0 && p0 >= 0) atomicAdd(cnt + p0, 32u);
      } else if (part >= 0) {
        atomicAdd(cnt + part, 1u);
      }
      side += kind == 2;
    }
    if (side) atomicAdd(&sh.side_n, side);
    __syncthreads();
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += kThreads)
    hist[(int64_t)p * B + b] = (int)cnt[p];
  if (threadIdx.x == 0) side_cnt[b] = (int)sh.side_n;
}

__global__ void __launch_bounds__(kThreads, 1)
index_partition(const uint8_t* __restrict__ g, int64_t G,
                const int64_t* __restrict__ start,
                const int64_t* __restrict__ end, int C, int k, int sub_bits,
                int tile, int B, const int64_t* __restrict__ offs,
                const int64_t* __restrict__ side_offs,
                uint64_t* __restrict__ spart, int64_t* __restrict__ side) {
  extern __shared__ __align__(16) unsigned char smem[];
  PartShared& sh = *reinterpret_cast<PartShared*>(smem);
  int64_t* base = reinterpret_cast<int64_t*>(&sh + 1);
  const int h = 2 * k - sub_bits, P = 1 << h;
  const int sort_bits = h + 1;                  // P: side, P + 1: neither
  const uint32_t sub_mask = (1u << sub_bits) - 1u;
  const int b = blockIdx.x;
  const int64_t T = (int64_t)b * tile;
  for (int p = threadIdx.x; p < P; p += kThreads)
    base[p] = offs[(int64_t)p * B + b];
  if (threadIdx.x == 0) sh.side_base = side_offs[b];
  const int64_t Tend = T + tile < G ? T + tile : G;
  const Chroms ch = chrom_range(start, end, C, T, Tend + 32, sh.tile);
  for (int64_t T0 = T; T0 < Tend; T0 += kSub) {
    stage(g, G, T0, ch, sh.tile);
    uint16_t key[kTileItems];
    uint32_t val[kTileItems];
#pragma unroll
    for (int u = 0; u < kTileItems; ++u) {
      const int i = threadIdx.x * kTileItems + u;
      uint32_t wkey = 0;
      const int kind = T0 + i < G ? window(sh.tile, i, k, &wkey) : 0;
      key[u] = (uint16_t)(kind == 1 ? (wkey >> sub_bits)
                          : kind == 2 ? P : P + 1);
      val[u] = ((wkey & sub_mask) << 16) | (uint32_t)i;
    }
    TileSort(sh.tmp.sort).SortBlockedToStriped(key, val, 0, sort_bits);
    __syncthreads();
    int rs[kTileItems];
    bool tail[kTileItems];
    runs(key, sh.tmp.skey, rs, tail);
#pragma unroll
    for (int u = 0; u < kTileItems; ++u) {
      const int i = u * kThreads + threadIdx.x;
      const int64_t p = T0 + (val[u] & 0xffffu);
      if (key[u] < P) {
        spart[base[key[u]] + (i - rs[u])] =
            ((uint64_t)(val[u] >> 16) << 32) | (uint64_t)p;
      } else if (key[u] == P) {
        side[sh.side_base + (i - rs[u])] = p;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kTileItems; ++u) {
      if (!tail[u]) continue;
      const int n = u * kThreads + threadIdx.x - rs[u] + 1;
      if (key[u] < P) base[key[u]] += n;
      else if (key[u] == P) sh.side_base += n;
    }
    __syncthreads();
  }
}

using KeySort64 = cub::BlockRadixSort<uint16_t, kThreads, kItems, uint64_t>;
constexpr int kLowBits = 6;        // sorted in shared memory, a region at once
constexpr int kGroupsMax = 256;    // 2^(14 - kLowBits)

struct BucketShared {
  union {
    typename KeySort64::TempStorage sort64;
    typename KeySort::TempStorage sort;
    typename UScan::TempStorage uscan;
    uint16_t skey[kChunk];
  } tmp;
  uint32_t gstart[kGroupsMax + 1];   // each group's start in the partition
  uint32_t gcur[kGroupsMax];         // cursors: groups, then one group's keys
  int span[2];                       // the groups [a, b) of a region
};

// The last g in [a, b) with gstart[g] <= x.
__device__ __forceinline__ int group_of(const uint32_t* gstart, int a, int b,
                                        uint32_t x) {
  while (a + 1 < b) {
    const int mid = (a + b) >> 1;
    if (gstart[mid] <= x) a = mid; else b = mid;
  }
  return a;
}

// One partition: spart[lo .. lo + n) (low key bits << 32 | position, in
// genome order) into pos[lo .. lo + n) sorted stably by the low bits, and
// the partition's slice of bucket.  The low bits split into a group (the
// top sub_bits - kLowBits) and kLowBits more: the records are scattered
// by group (a front of at most 256 runs a block, so the writes fill whole
// sectors in L2), then each run of whole groups of at most kChunk records
// is sorted in shared memory and written back in place; a larger group
// (a skewed key) is scattered through its partition's spent records.
__global__ void __launch_bounds__(kThreads, 2)
index_bucket(uint64_t* __restrict__ spart,
             const int64_t* __restrict__ pstart, const int* __restrict__ order,
             int sub_bits, unsigned int* __restrict__ pos,
             uint8_t* __restrict__ low, int64_t* __restrict__ bucket) {
  extern __shared__ __align__(16) unsigned char smem[];
  BucketShared& sh = *reinterpret_cast<BucketShared*>(smem);
  uint32_t* cur = reinterpret_cast<uint32_t*>(&sh + 1);
  const int part = order[blockIdx.x];
  const int64_t lo = pstart[part];
  const int64_t n = pstart[part + 1] - lo;
  const int nsub = 1 << sub_bits;
  const int lbits = sub_bits < kLowBits ? sub_bits : kLowBits;
  const int G = 1 << (sub_bits - lbits);
  const uint32_t lmask = (1u << lbits) - 1u;
  const int lane = threadIdx.x & 31;
  const uint64_t* in = spart + lo;
  for (int j = threadIdx.x; j < nsub; j += kThreads) cur[j] = 0;
  __syncthreads();
  // the counts of the low bits, their scan: the slice of bucket
  for (int64_t i0 = 0; i0 < n; i0 += kThreads) {
    const int64_t i = i0 + threadIdx.x;
    const int s = i < n ? (int)(in[i] >> 32) : -1;
    const int s0 = __shfl_sync(kFull, s, 0);
    if (__all_sync(kFull, s == s0)) {
      if (lane == 0 && s0 >= 0) atomicAdd(cur + s0, 32u);
    } else if (s >= 0) {
      atomicAdd(cur + s, 1u);
    }
  }
  __syncthreads();
  const int per = (nsub + kThreads - 1) / kThreads;
  const int j0 = threadIdx.x * per;
  const int j1 = j0 + per < nsub ? j0 + per : nsub;
  uint32_t sum = 0;
  for (int j = j0; j < j1; ++j) sum += cur[j];
  uint32_t run;
  UScan(sh.tmp.uscan).ExclusiveSum(sum, run);
  for (int j = j0; j < j1; ++j) {
    const uint32_t c = cur[j];
    cur[j] = run;
    bucket[(int64_t)part * nsub + j] = lo + run;
    run += c;
  }
  __syncthreads();
  for (int g = threadIdx.x; g <= G; g += kThreads) {
    sh.gstart[g] = g < G ? cur[g << lbits] : (uint32_t)n;
    if (g < G) sh.gcur[g] = cur[g << lbits];
  }
  __syncthreads();
  // scatter by group, chunk by chunk
  for (int64_t c0 = 0; c0 < n; c0 += kChunk) {
    uint16_t key[kItems];
    uint64_t val[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int64_t i = c0 + threadIdx.x * kItems + u;
      val[u] = i < n ? in[i] : 0ull;
      key[u] = i < n ? (uint16_t)((val[u] >> 32) >> lbits) : (uint16_t)G;
    }
    KeySort64(sh.tmp.sort64).SortBlockedToStriped(key, val, 0,
                                                  sub_bits - lbits + 1);
    __syncthreads();
    int rs[kItems];
    bool tail[kItems];
    runs(key, sh.tmp.skey, rs, tail);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (key[u] >= G) continue;
      const int64_t at = lo + sh.gcur[key[u]] +
                         (u * kThreads + threadIdx.x - rs[u]);
      pos[at] = (unsigned int)val[u];
      low[at] = (uint8_t)((val[u] >> 32) & lmask);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (tail[u] && key[u] < G)
        sh.gcur[key[u]] += u * kThreads + threadIdx.x - rs[u] + 1;
    }
    __syncthreads();
  }
  // each run of whole groups sorted by (group, low bits) in place
  unsigned int* spill = reinterpret_cast<unsigned int*>(spart + lo);
  for (int a = 0; a < G;) {
    if (threadIdx.x == 0) {
      int b = a + 1;
      while (b < G && sh.gstart[b + 1] - sh.gstart[a] <= (uint32_t)kChunk)
        ++b;
      sh.span[0] = b;
    }
    __syncthreads();
    const int b = sh.span[0];
    const uint32_t A = sh.gstart[a], m = sh.gstart[b] - A;
    if (m <= (uint32_t)kChunk) {
      const uint16_t none = (uint16_t)((b - a) << lbits);
      uint16_t key[kItems];
      uint32_t val[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const uint32_t i = threadIdx.x * kItems + u;
        key[u] = none;
        val[u] = 0;
        if (i < m) {
          val[u] = pos[lo + A + i];
          const int g = group_of(sh.gstart, a, b, A + i);
          key[u] = (uint16_t)(((g - a) << lbits) | low[lo + A + i]);
        }
      }
      if (m) {
        KeySort(sh.tmp.sort).SortBlockedToStriped(key, val, 0,
                                                  32 - __clz((int)none));
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const uint32_t i = u * kThreads + threadIdx.x;
          if (i < m) pos[lo + A + i] = val[u];
        }
      }
    } else {
      // one group past kChunk: its keys' cursors, a stable scatter into the
      // spent records of the partition, then a copy back
      for (int j = threadIdx.x; j <= (int)lmask; j += kThreads)
        sh.gcur[j] = cur[(a << lbits) + j] - A;
      __syncthreads();
      for (uint32_t c0 = 0; c0 < m; c0 += kChunk) {
        uint16_t key[kItems];
        uint32_t val[kItems];
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const uint32_t i = c0 + threadIdx.x * kItems + u;
          key[u] = i < m ? low[lo + A + i] : (uint16_t)(lmask + 1);
          val[u] = i < m ? pos[lo + A + i] : 0u;
        }
        KeySort(sh.tmp.sort).SortBlockedToStriped(key, val, 0, lbits + 1);
        __syncthreads();
        int rs[kItems];
        bool tail[kItems];
        runs(key, sh.tmp.skey, rs, tail);
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          if (key[u] <= lmask)
            spill[A + sh.gcur[key[u]] + (u * kThreads + threadIdx.x - rs[u])] =
                val[u];
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          if (tail[u] && key[u] <= lmask)
            sh.gcur[key[u]] += u * kThreads + threadIdx.x - rs[u] + 1;
        }
        __syncthreads();
      }
      for (uint32_t i = threadIdx.x; i < m; i += kThreads)
        pos[lo + A + i] = spill[A + i];
    }
    a = b;
    __syncthreads();
  }
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Pass 1: hist[p * B + b] (the keyed windows of tile b in partition p,
// the partition being a key's top 2k - sub_bits bits) and side_cnt[b].
// Tile b is positions [b * tile, (b + 1) * tile), tile a multiple of
// exact_index_sub_tile().
extern "C" int exact_index_hist(const uint8_t* g, int64_t G,
                                const int64_t* start, const int64_t* end,
                                int C, int k, int sub_bits, int tile, int B,
                                int* hist, int* side_cnt,
                                cudaStream_t stream) {
  const int P = 1 << (2 * k - sub_bits);
  const size_t bytes = sizeof(PartShared) + sizeof(uint32_t) * P;
  int rc = set_smem((const void*)index_hist, bytes);
  if (rc) return rc;
  index_hist<<<B, kThreads, bytes, stream>>>(g, G, start, end, C, k,
                                             sub_bits, tile, B, hist,
                                             side_cnt);
  return (int)cudaGetLastError();
}

// Pass 2: every keyed window's position and low key bits into spos / ssub
// at offs[p * B + b] onwards (the exclusive scan of hist), every side
// position into side at side_offs[b] onwards; both in genome order.
extern "C" int exact_index_partition(const uint8_t* g, int64_t G,
                                     const int64_t* start, const int64_t* end,
                                     int C, int k, int sub_bits, int tile,
                                     int B, const int64_t* offs,
                                     const int64_t* side_offs,
                                     uint64_t* spart, int64_t* side,
                                     cudaStream_t stream) {
  const int P = 1 << (2 * k - sub_bits);
  const size_t bytes = sizeof(PartShared) + sizeof(int64_t) * P;
  int rc = set_smem((const void*)index_partition, bytes);
  if (rc) return rc;
  index_partition<<<B, kThreads, bytes, stream>>>(
      g, G, start, end, C, k, sub_bits, tile, B, offs, side_offs, spart,
      side);
  return (int)cudaGetLastError();
}

// Pass 3: partition order[i] in block i: bucket[part << sub_bits ...] and
// its positions in pos, sorted stably by the low key bits.  pstart[P + 1]
// are the partitions' starts in spart (and pos); low[W] is scratch, and
// spart is spent.
extern "C" int exact_index_bucket(uint64_t* spart, const int64_t* pstart,
                                  const int* order, int P, int sub_bits,
                                  unsigned int* pos, uint8_t* low,
                                  int64_t* bucket, cudaStream_t stream) {
  const size_t bytes = sizeof(BucketShared) + sizeof(uint32_t) *
                       ((size_t)1 << sub_bits);
  int rc = set_smem((const void*)index_bucket, bytes);
  if (rc) return rc;
  index_bucket<<<P, kThreads, bytes, stream>>>(spart, pstart, order,
                                               sub_bits, pos, low, bucket);
  return (int)cudaGetLastError();
}

// Positions a sub-tile (tiles are multiples of it).
extern "C" int exact_index_sub_tile() { return kSub; }
