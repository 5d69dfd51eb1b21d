// K6: the sparse inter-chromosomal imputation vote (port-only kernel).
//
// Replaces the jitted gather chain of sparse_impute_vote_rowptr /
// _bounded_searchsorted / sparse_disk_sums_rowptr
// (hichap_master_tpu/ops/sparse_impute.py:162-227).  For every query
// (row_known, col_same, col_cross) it sums the symmetric un-imputed matrix U
// over the imputation disk around both candidate pixels and applies the
// vote: the same-haplotype candidate wins when its disk count is >=
// min_count and its share of the two-candidate total exceeds ratio, else the
// cross candidate takes the same test, else nothing.
//
// U is a row-sorted directed COO: scols [nnz] (columns, sorted within each
// row), row_ptr [S+1] (row slices) and cum [nnz+1], the int64 prefix of the
// counts.  Every disk row is one column interval [c + lo, c + hi], so its sum
// is cum[ub] - cum[lb] with lb and ub two binary searches in that row's
// slice of scols.
//
// Order of work.  The queries arrive in pair order, so neighbouring queries
// share no rows of U.  Small launches bucket them by row band (row_known /
// kBandRows) on the card: a histogram that gives each query a rank in one of
// its band's kSub sub-lists, a per-band prefix of the sub-lists, a scan of
// the band counts, and a scatter of (query, row, col_same, col_cross) into
// band order.  A query whose window leaves [0, S) gets hit 0 and tgt
// col_cross in the histogram and joins no band.  Then one block per band
// stages the band's rows of U -- the rows its disks reach, b*R + min(di) ..
// (b+1)*R - 1 + max(di) -- in shared memory: one contiguous slice of scols
// and of cum (16-byte cp.async, tails by plain loads) and the band's slice
// of row_ptr.  From the staged columns it builds a column-occupancy bitmap,
// one bit per 2^kBitShift columns.  A candidate c whose window columns
// [c + min(dj_lo), c + max(dj_hi)] meet no set bit has a disk sum of 0 with
// no search: exact, a bit is clear only when no entry of the band lies in
// its columns.  The other candidates take a warp each, a lane per two disk
// rows, four branchless searches of the staged rows in lock step.  Results
// go to each query's own index; the caller sees no reordering, and the
// order inside a band (set by the atomics) changes no result.
//
// What bounds it on the H100.  At hg19 10 kb (L = 1,000, 63 disk rows) the
// candidates lie on the other mate's chromosome while U's entries are
// mostly cis, near the diagonal: of the ~107.7 M (query, candidate, disk
// row) windows only ~0.02% hold an entry, and the bitmap sends ~7% of the
// candidates to the search.  The bytes left are the staging, U read
// (R + 62) / R times (~105 MB at R = 128), and the queries: read twice by
// the bucketing as int64 (~20 MB each), scattered once as 16 bytes a query
// and read back once, one byte and one int32 written per query: ~45 us at
// the card's rate.  The rest of the time is the searches, bound by issued
// instructions (~300 warp instructions a candidate), the dependent phases of
// a band's block (four blocks of 256 threads per SM), and the bucketing's
// atomics.
//
// A band whose slice exceeds the shared budget (kBudget entries, or more
// rows than the disk's span allows) runs the same code against device
// memory: only the pointers change, and its bitmap is built from the
// device's scols.  Real libraries can have such dense rows; the main path's
// input has none.
//
// All arithmetic is integer until the share test, which is evaluated in
// float32 exactly as the JAX program does (int sums rounded to f32, f32
// add, IEEE division), so hits and targets equal the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBandRows = 128;  // R: query rows per band
constexpr int kBitShift = 5;    // k: one bitmap bit per 32 columns
constexpr int kBudget = 3072;   // staged entries of U per band
constexpr int kThreads = 256;   // a band's block; queries per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// the shared layout keeps the staged arrays 16-byte aligned
static_assert(kBudget % 4 == 0, "the shared budget is a multiple of 4");
// a band's queries are counted in kSub sub-lists (by query index mod
// kSub), so that the histogram's atomics meet on one address 1/kSub as
// often; the sub-lists of a band are contiguous in band order
constexpr int kSub = 32;

// band scratch (int32): the sub-list counts, then in place their
// exclusive offsets inside their band [nb * kSub]; the bands' exclusive
// offsets [nb + 1]; per band the slice of U its disks reach, (row_ptr[lo],
// row_ptr[hi + 1]) [nb] int2; the disk's min(di), max(di), min(dj_lo),
// max(dj_hi)
__host__ __device__ __forceinline__ int offsets_at(int nb) { return nb * kSub; }
__host__ __device__ __forceinline__ int slices_at(int nb) {
  return (nb * kSub + nb + 2) & ~1;
}
__host__ __device__ __forceinline__ int band_scratch_ints(int nb) {
  return slices_at(nb) + 2 * nb + 4;
}

__device__ __forceinline__ bool in_window(long long r, long long cs,
                                          long long cc, int S, int L) {
  return r >= L && r + L + 1 <= S && cs >= L && cs + L + 1 <= S &&
         cc >= L && cc + L + 1 <= S;
}

// A dropped query (its window leaves [0, S)) is answered here: hit 0,
// tgt col_cross.  The others take a rank in their band's sub-list.
template <typename T>
__global__ void __launch_bounds__(kThreads)
band_histogram(const T* __restrict__ row_known, const T* __restrict__ col_same,
               const T* __restrict__ col_cross, int Q, int S, int L,
               int* __restrict__ counts, int* __restrict__ rank,
               unsigned char* __restrict__ hit, int* __restrict__ tgt) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  const long long r = row_known[q], cc = col_cross[q];
  if (!in_window(r, col_same[q], cc, S, L)) {
    hit[q] = 0;
    tgt[q] = (int)cc;
    return;
  }
  rank[q] = atomicAdd(counts + ((int)r / kBandRows) * kSub + (q & (kSub - 1)),
                      1);
}

__device__ __forceinline__ void disk_extent(const int* __restrict__ di,
                                            const int* __restrict__ dj_lo,
                                            const int* __restrict__ dj_hi,
                                            int D, int* st) {
  const int lane = threadIdx.x & 31;
  int lo = 0x7fffffff, hi = -0x7fffffff - 1, jlo = 0x7fffffff,
      jhi = -0x7fffffff - 1;
  for (int d = lane; d < D; d += 32) {
    lo = min(lo, di[d]);
    hi = max(hi, di[d]);
    jlo = min(jlo, dj_lo[d]);
    jhi = max(jhi, dj_hi[d]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    jlo = min(jlo, __shfl_xor_sync(0xffffffffu, jlo, o));
    jhi = max(jhi, __shfl_xor_sync(0xffffffffu, jhi, o));
  }
  if (lane == 0) {  // no disk: no row, and an empty column window
    st[0] = D ? lo : 0;
    st[1] = D ? hi : 0;
    st[2] = D ? jlo : 1;
    st[3] = D ? jhi : 0;
  }
}

// A thread per band: the exclusive offsets of its sub-lists inside the
// band (in place), the band's count, and the band's slice of U.
__global__ void __launch_bounds__(kThreads)
band_prefix(int* __restrict__ band, int nb, const int* __restrict__ row_ptr,
            int S, const int* __restrict__ di, const int* __restrict__ dj_lo,
            const int* __restrict__ dj_hi, int D) {
  __shared__ int s_st[4];
  if (threadIdx.x < 32) disk_extent(di, dj_lo, dj_hi, D, s_st);
  __syncthreads();
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < 4)
    band[slices_at(nb) + 2 * nb + threadIdx.x] = s_st[threadIdx.x];
  if (b >= nb) return;
  int4* sub = reinterpret_cast<int4*>(band + b * kSub);
  int4 v[kSub / 4];
#pragma unroll
  for (int i = 0; i < kSub / 4; ++i) v[i] = sub[i];
  int run = 0;
#pragma unroll
  for (int i = 0; i < kSub / 4; ++i) {
    const int a = v[i].x, c = v[i].y, e = v[i].z, f = v[i].w;
    v[i] = make_int4(run, run + a, run + a + c, run + a + c + e);
    run += a + c + e + f;
  }
#pragma unroll
  for (int i = 0; i < kSub / 4; ++i) sub[i] = v[i];
  band[offsets_at(nb) + b] = run;  // the count; band_scan makes it an offset
  const int lo = max(0, b * kBandRows + s_st[0]);
  const int hi = min(S - 1, (b + 1) * kBandRows - 1 + s_st[1]);
  reinterpret_cast<int2*>(band + slices_at(nb))[b] =
      make_int2(row_ptr[lo], row_ptr[hi + 1]);
}

// One block: the exclusive scan of the band counts (in place, the total
// at [nb]).
__global__ void __launch_bounds__(kScanThreads)
band_scan(int* __restrict__ band, int nb) {
  __shared__ int warp_tot[kScanThreads / 32];
  int* cnt = band + offsets_at(nb);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int b0 = min(nb, t * per), b1 = min(nb, b0 + per);
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += cnt[b];
  int incl = mine;  // inclusive scan over the block's threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - mine + (warp ? warp_tot[warp - 1] : 0);
  for (int b = b0; b < b1; ++b) {
    const int c = cnt[b];
    cnt[b] = run;
    run += c;
  }
  if (t == kScanThreads - 1) cnt[nb] = run;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_scatter(const T* __restrict__ row_known, const T* __restrict__ col_same,
             const T* __restrict__ col_cross, int Q, int S, int L,
             const int* __restrict__ sub, const int* __restrict__ offsets,
             const int* __restrict__ rank, int4* __restrict__ sorted) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  const long long r = row_known[q], cs = col_same[q], cc = col_cross[q];
  if (!in_window(r, cs, cc, S, L)) return;
  const int b = (int)r / kBandRows;
  const int pos = offsets[b] + sub[b * kSub + (q & (kSub - 1))] + rank[q];
  sorted[pos] = make_int4(q, (int)r, (int)cs, (int)cc);
}

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Loads of the band's slice: shared memory, or the read-only path of
// device memory for a band over the budget.
template <bool kShared, typename E>
__device__ __forceinline__ E load(const E* p) {
  if (kShared) return *p;
  return __ldg(p);
}

// src[a, b) -> dst[0, b - a): 16-byte cp.async where the device pointer is
// aligned (a is then aligned too), plain loads for the tail and otherwise.
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src,
                                      int a, int b, bool vec) {
  constexpr int V = 16 / sizeof(E);
  const int n = b - a, nv = vec ? n / V : 0;
  for (int i = threadIdx.x; i < nv; i += kThreads)
    cp_async16(dst + i * V, src + a + i * V);
  for (int i = nv * V + threadIdx.x; i < n; i += kThreads)
    dst[i] = src[a + i];
}

// A branchless lower-bound search for x over n entries from base: each
// step halves n (the answer stays in [base, base + n]) until one is left,
// and a finished search loads nothing, so several searches interleave in
// one loop.  done() gives the first position whose column is >= x.
struct Search {
  int base, n, x;
  template <bool kShared>
  __device__ __forceinline__ void step(const int* sc) {
    if (n > 1) {
      const int half = n >> 1;
      base = load<kShared>(sc + base + half) < x ? base + half : base;
      n -= half;
    }
  }
  template <bool kShared>
  __device__ __forceinline__ int done(const int* sc) const {
    return n > 0 && load<kShared>(sc + base) < x ? base + 1 : base;
  }
};

// Does any bit of the bitmap cover a column of [c0, c1]?
__device__ __forceinline__ bool occupied(const unsigned* bm, int c0, int c1) {
  if (c1 < c0) return false;
  const int b0 = c0 >> kBitShift, b1 = c1 >> kBitShift;
  for (int w = b0 >> 5; w <= (b1 >> 5); ++w) {
    unsigned m = bm[w];
    if (w == (b0 >> 5)) m &= ~0u << (b0 & 31);
    if (w == (b1 >> 5)) m &= ~0u >> (31 - (b1 & 31));
    if (m) return true;
  }
  return false;
}

// Dynamic shared memory of the vote kernel, in this order (16-byte
// aligned): cum [kBudget + 2] int64, scols [kBudget + 4], row_ptr
// [R + D, rounded to 4], the bitmap [W, rounded to 4], di | dj_lo | dj_hi.
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ int bitmap_words(int S) {
  return S > 0 ? ((S - 1) >> (kBitShift + 5)) + 1 : 1;
}

__host__ __device__ __forceinline__ size_t vote_smem_bytes(int S, int D) {
  return 8 * (size_t)(kBudget + 2) + 4 * (size_t)(kBudget + 4) +
         4 * (size_t)round4(kBandRows + D) +
         4 * (size_t)round4(bitmap_words(S)) + 12 * (size_t)D;
}

// The block's per-chunk state: its queries, their two disk sums, and the
// candidates that the bitmap sends to the search.
struct Chunk {
  int4 q[kThreads];
  long long sum[kThreads][2];
  int work[2 * kThreads];
  int nwork;
};

// Row r's entries are rp[r - rp_off] .. rp[r + 1 - rp_off] (device
// positions); the staged columns hold position g at sc[g - sc_off] and the
// prefix at cu[g - cu_off].
struct Slice {
  const int* sc;
  const long long* cu;
  const int* rp;
  int sc_off, cu_off, rp_off;
};

// The band's queries, chunk by chunk: the bitmap test of both candidates
// (a lane each), a warp per candidate that passes (a lane per two disk
// rows, four searches in one loop), then the vote (a lane per query).
template <bool kShared>
__device__ __forceinline__ void vote_band(
    const Slice u, const unsigned* bm, const int* s_di, const int* s_lo,
    const int* s_hi, int D, int dj_min, int dj_max,
    const int4* __restrict__ sorted, int beg, int end, int4 next, Chunk& ch,
    float min_count, float ratio, unsigned char* __restrict__ hit,
    int* __restrict__ tgt) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int delta = u.sc_off - u.cu_off;  // staged column -> prefix
  for (int base = beg; base < end; base += kThreads) {
    if (t == 0) ch.nwork = 0;
    __syncthreads();
    const bool has = base + t < end;
    const int4 q = next;
    if (base + kThreads + t < end) next = sorted[base + kThreads + t];
    const bool p0 = has && occupied(bm, q.z + dj_min, q.z + dj_max);
    const bool p1 = has && occupied(bm, q.w + dj_min, q.w + dj_max);
    if (has) {
      ch.q[t] = q;
      ch.sum[t][0] = 0;
      ch.sum[t][1] = 0;
    }
    const unsigned m0 = __ballot_sync(0xffffffffu, p0);
    const unsigned m1 = __ballot_sync(0xffffffffu, p1);
    int at = 0;
    if (lane == 0 && (m0 | m1))
      at = atomicAdd(&ch.nwork, __popc(m0) + __popc(m1));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (p0) ch.work[at + __popc(m0 & below)] = 2 * t;
    if (p1) ch.work[at + __popc(m0) + __popc(m1 & below)] = 2 * t + 1;
    __syncthreads();
    const int nwork = ch.nwork;
    for (int i = warp; i < nwork; i += kWarps) {
      const int item = ch.work[i], qi = item >> 1;
      const int r = ch.q[qi].y - u.rp_off;
      const int c = (item & 1) ? ch.q[qi].w : ch.q[qi].z;
      long long sum = 0;
      for (int d = lane; d < D; d += 64) {
        const bool two = d + 32 < D;
        const int r0 = r + s_di[d], r1 = two ? r + s_di[d + 32] : r0;
        const int a0 = load<kShared>(u.rp + r0) - u.sc_off;
        const int n0 = load<kShared>(u.rp + r0 + 1) - u.sc_off - a0;
        const int a1 = load<kShared>(u.rp + r1) - u.sc_off;
        const int n1 = two ? load<kShared>(u.rp + r1 + 1) - u.sc_off - a1 : 0;
        Search lb0{a0, n0, c + s_lo[d]}, ub0{a0, n0, c + s_hi[d] + 1};
        Search lb1{a1, n1, two ? c + s_lo[d + 32] : 0};
        Search ub1{a1, n1, two ? c + s_hi[d + 32] + 1 : 0};
        while ((lb0.n > 1) | (ub0.n > 1) | (lb1.n > 1) | (ub1.n > 1)) {
          lb0.step<kShared>(u.sc);
          ub0.step<kShared>(u.sc);
          lb1.step<kShared>(u.sc);
          ub1.step<kShared>(u.sc);
        }
        sum += load<kShared>(u.cu + ub0.done<kShared>(u.sc) + delta) -
               load<kShared>(u.cu + lb0.done<kShared>(u.sc) + delta);
        if (two)
          sum += load<kShared>(u.cu + ub1.done<kShared>(u.sc) + delta) -
                 load<kShared>(u.cu + lb1.done<kShared>(u.sc) + delta);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) ch.sum[qi][item & 1] = sum;
    }
    __syncthreads();
    if (has) {
      const float same = __ll2float_rn(ch.sum[t][0]);
      const float cross = __ll2float_rn(ch.sum[t][1]);
      const float tot = __fadd_rn(same, cross);
      const float share_same = tot > 0.f ? __fdiv_rn(same, tot) : 0.f;
      const float share_cross = tot > 0.f ? __fdiv_rn(cross, tot) : 0.f;
      const bool pick_same = same >= min_count && share_same > ratio;
      const bool pick_cross =
          !pick_same && cross >= min_count && share_cross > ratio;
      hit[q.x] = (pick_same || pick_cross) ? 1 : 0;
      tgt[q.x] = pick_same ? q.z : q.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
band_vote(const int* __restrict__ scols, const long long* __restrict__ cum,
          const int* __restrict__ row_ptr, const int* __restrict__ band,
          int nb, const int4* __restrict__ sorted,
          const int* __restrict__ di, const int* __restrict__ dj_lo,
          const int* __restrict__ dj_hi, int D, int S, float min_count,
          float ratio, unsigned char* __restrict__ hit,
          int* __restrict__ tgt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Chunk ch;

  // one round trip: the band's queries, its slice of U, the disk's extent
  const int b = blockIdx.x, t = threadIdx.x;
  const int beg = band[offsets_at(nb) + b], end = band[offsets_at(nb) + b + 1];
  const int2 slice = reinterpret_cast<const int2*>(band + slices_at(nb))[b];
  const int* st = band + slices_at(nb) + 2 * nb;
  const int di_min = st[0], di_max = st[1], dj_min = st[2], dj_max = st[3];
  if (beg == end) return;  // block-uniform
  const int lo = max(0, b * kBandRows + di_min);
  const int hi = min(S - 1, (b + 1) * kBandRows - 1 + di_max);
  const int e0 = slice.x, e1 = slice.y;
  // the first chunk's queries load while U is staged
  const int4 first = beg + t < end ? sorted[beg + t] : make_int4(0, 0, 0, 0);

  long long* s_cu = reinterpret_cast<long long*>(smem);
  int* s_sc = reinterpret_cast<int*>(s_cu + kBudget + 2);
  int* s_rp = s_sc + kBudget + 4;
  unsigned* s_bm = reinterpret_cast<unsigned*>(s_rp + round4(kBandRows + D));
  const int W = bitmap_words(S);
  int* s_di = reinterpret_cast<int*>(s_bm + round4(W));
  int* s_lo = s_di + D;
  int* s_hi = s_lo + D;

  // the band's slice of U: in shared memory when it fits, else in place
  const int rows = hi - lo + 1;
  const bool shared = e1 - e0 <= kBudget && rows < kBandRows + D;
  if (shared) {
    const bool vec = ((reinterpret_cast<uintptr_t>(scols) |
                       reinterpret_cast<uintptr_t>(cum)) & 15) == 0;
    stage(s_cu, cum, e0 & ~1, e1 + 1, vec);
    stage(s_sc, scols, e0 & ~3, e1, vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = t; i <= rows; i += kThreads) s_rp[i] = row_ptr[lo + i];
  }
  for (int w = t; w < W; w += kThreads) s_bm[w] = 0u;
  for (int d = t; d < D; d += kThreads) {
    s_di[d] = di[d];
    s_lo[d] = dj_lo[d];
    s_hi[d] = dj_hi[d];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the band's column bitmap: each thread ORs a run of consecutive entries
  // (sorted within a row, so mostly one word) into one atomic per word
  const int* sc = shared ? s_sc : scols;
  const int sc_off = shared ? e0 & ~3 : 0;
  {
    const int n = e1 - e0, per = (n + kThreads - 1) / kThreads;
    const int g0 = e0 + t * per, g1 = min(e1, g0 + per);
    int word = -1;
    unsigned bits = 0u;
    for (int g = g0; g < g1; ++g) {
      const int c = sc[g - sc_off];
      const int w = c >> (kBitShift + 5);
      if (w != word) {
        if (bits) atomicOr(s_bm + word, bits);
        word = w;
        bits = 0u;
      }
      bits |= 1u << ((c >> kBitShift) & 31);
    }
    if (bits) atomicOr(s_bm + word, bits);
  }
  __syncthreads();

  if (shared)
    vote_band<true>(Slice{s_sc, s_cu, s_rp, e0 & ~3, e0 & ~1, lo}, s_bm,
                    s_di, s_lo, s_hi, D, dj_min, dj_max, sorted, beg, end,
                    first, ch, min_count, ratio, hit, tgt);
  else
    vote_band<false>(Slice{scols, cum, row_ptr, 0, 0, 0}, s_bm, s_di, s_lo,
                     s_hi, D, dj_min, dj_max, sorted, beg, end, first, ch,
                     min_count, ratio, hit, tgt);
}

template <typename T>
int launch(const int* scols, const long long* cum, const int* row_ptr,
           const T* row_known, const T* col_same, const T* col_cross, int Q,
           const int* di, const int* dj_lo, const int* dj_hi, int D, int S,
           int L, float min_count, float ratio, unsigned char* hit, int* tgt,
           int* band, int* order, cudaStream_t stream) {
  const int nb = (S + kBandRows - 1) / kBandRows;
  const int qblocks = (Q + kThreads - 1) / kThreads;
  const size_t smem = vote_smem_bytes(S, D);
  int4* sorted = reinterpret_cast<int4*>(order);
  int* rank = order + 4 * (size_t)Q;
  cudaError_t e = cudaFuncSetAttribute(
      band_vote, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(band, 0, sizeof(int) * nb * kSub, stream);
  if (e != cudaSuccess) return (int)e;
  band_histogram<T><<<qblocks, kThreads, 0, stream>>>(
      row_known, col_same, col_cross, Q, S, L, band, rank, hit, tgt);
  band_prefix<<<(nb + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      band, nb, row_ptr, S, di, dj_lo, dj_hi, D);
  band_scan<<<1, kScanThreads, 0, stream>>>(band, nb);
  band_scatter<T><<<qblocks, kThreads, 0, stream>>>(
      row_known, col_same, col_cross, Q, S, L, band, band + offsets_at(nb),
      rank, sorted);
  band_vote<<<nb, kThreads, smem, stream>>>(
      scols, cum, row_ptr, band, nb, sorted, di, dj_lo, dj_hi, D, S,
      min_count, ratio, hit, tgt);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's constants: 0 the query rows per band (R), 1 the bitmap's
// shift (one bit per 2^k columns), 2 the shared budget in entries of U per
// band, 3 the int32 band scratch at S = arg1 (what the wrapper allocates).
extern "C" int impute_vote_constant(int which, int S) {
  switch (which) {
    case 0: return kBandRows;
    case 1: return kBitShift;
    case 2: return kBudget;
    case 3: return band_scratch_ints((S + kBandRows - 1) / kBandRows);
    default: return -1;
  }
}

// band: int32 scratch [impute_vote_constant(3, S)]; order: int32 scratch
// [5 Q], 16-byte aligned (the queries in band order as int4, then their
// ranks).  Queries are int32 (q64 = 0) or int64 (q64 = 1).
extern "C" int impute_vote(const int* scols, const long long* cum,
                           const int* row_ptr, const void* row_known,
                           const void* col_same, const void* col_cross,
                           int Q, int q64, const int* di, const int* dj_lo,
                           const int* dj_hi, int D, int S, int L,
                           float min_count, float ratio, unsigned char* hit,
                           int* tgt, int* band, int* order,
                           cudaStream_t stream) {
  if (Q <= 0) return (int)cudaSuccess;
  if (S <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  return q64 ? launch(scols, cum, row_ptr,
                      static_cast<const long long*>(row_known),
                      static_cast<const long long*>(col_same),
                      static_cast<const long long*>(col_cross), Q, di, dj_lo,
                      dj_hi, D, S, L, min_count, ratio, hit, tgt, band, order,
                      stream)
             : launch(scols, cum, row_ptr, static_cast<const int*>(row_known),
                      static_cast<const int*>(col_same),
                      static_cast<const int*>(col_cross), Q, di, dj_lo, dj_hi,
                      D, S, L, min_count, ratio, hit, tgt, band, order,
                      stream);
}
