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
// Bound on the H100: memory latency.  At hg19 10 kb (L = 1,000) a query has
// 63 disk rows per candidate: 126 (candidate, row) pairs, each a row_ptr
// load and two dependent binary searches of ~log2(row nnz) random loads.
// Design: one warp per query, the lanes striding over the pairs (same and
// cross interleaved, so both candidates of a disk row share its row_ptr
// lines), the second search starting at the first one's result; the two
// int64 sums are reduced with warp shuffles and lane 0 applies the rule.
// All arithmetic is integer until the share test, which is evaluated in
// float32 exactly as the JAX program does (int sums rounded to f32, f32
// add, IEEE division), so hits and targets equal the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // queries per 256-thread block

__device__ __forceinline__ int lower_bound(const int* __restrict__ scols,
                                           int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(scols + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(32 * kWarps)
impute_vote_kernel(const int* __restrict__ scols,
                   const long long* __restrict__ cum,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ row_known,
                   const int* __restrict__ col_same,
                   const int* __restrict__ col_cross, int Q,
                   const int* __restrict__ di, const int* __restrict__ dj_lo,
                   const int* __restrict__ dj_hi, int D, int S, int L,
                   float min_count, float ratio,
                   unsigned char* __restrict__ hit, int* __restrict__ tgt) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // warp-uniform
  const int r = row_known[q], cs = col_same[q], cc = col_cross[q];
  const bool inb = r >= L && r + L + 1 <= S && cs >= L && cs + L + 1 <= S &&
                   cc >= L && cc + L + 1 <= S;
  if (!inb) {  // the window would leave [0, S): dropped
    if (lane == 0) {
      hit[q] = 0;
      tgt[q] = cc;
    }
    return;
  }
  long long s_same = 0, s_cross = 0;
  for (int k = lane; k < 2 * D; k += 32) {
    const int d = k >> 1;
    const int c = (k & 1) ? cc : cs;
    const int row = r + __ldg(di + d);
    const int hi0 = __ldg(row_ptr + row + 1);
    const int a = lower_bound(scols, __ldg(row_ptr + row), hi0,
                              c + __ldg(dj_lo + d));
    const int b = lower_bound(scols, a, hi0, c + __ldg(dj_hi + d) + 1);
    const long long s = __ldg(cum + b) - __ldg(cum + a);
    if (k & 1) s_cross += s; else s_same += s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_same += __shfl_xor_sync(0xffffffffu, s_same, o);
    s_cross += __shfl_xor_sync(0xffffffffu, s_cross, o);
  }
  if (lane != 0) return;
  const float same = __ll2float_rn(s_same);
  const float cross = __ll2float_rn(s_cross);
  const float tot = __fadd_rn(same, cross);
  const float share_same = tot > 0.f ? __fdiv_rn(same, tot) : 0.f;
  const float share_cross = tot > 0.f ? __fdiv_rn(cross, tot) : 0.f;
  const bool pick_same = same >= min_count && share_same > ratio;
  const bool pick_cross =
      !pick_same && cross >= min_count && share_cross > ratio;
  hit[q] = (pick_same || pick_cross) ? 1 : 0;
  tgt[q] = pick_same ? cs : cc;
}

}  // namespace

extern "C" int impute_vote(const int* scols, const long long* cum,
                           const int* row_ptr, const int* row_known,
                           const int* col_same, const int* col_cross, int Q,
                           const int* di, const int* dj_lo, const int* dj_hi,
                           int D, int S, int L, float min_count, float ratio,
                           unsigned char* hit, int* tgt,
                           cudaStream_t stream) {
  if (Q <= 0) return (int)cudaSuccess;
  const int blocks = (Q + kWarps - 1) / kWarps;
  impute_vote_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
      scols, cum, row_ptr, row_known, col_same, col_cross, Q, di, dj_lo,
      dj_hi, D, S, L, min_count, ratio, hit, tgt);
  return (int)cudaGetLastError();
}
