// K10: intra-chromosome binning of a block of pairs into the per-chromosome
// count matrices of every chromosome group at once (port-only kernel).
//
// Replaces the JAX package's intra scatter-adds (bin_intra /
// bin_intra_single_side, hichap_master_tpu/ops/binning.py:83,98, and the
// accumulator _IntraAcc.add, hichap_master_tpu/pipeline/matrix.py:683),
// which are XLA, not Pallas.  Every group's [G, N, N] block lies in one flat
// float32 buffer; two small tables give, per chromosome label, its matrix's
// offset in that buffer (group base + slot * N * N) and its group's padded
// size N.  A pair (c1, p1, c2, p2) is kept when
//     c1 == c2, 0 <= c1 < n_labels, p1 >= 0, p2 >= 0,
//     b1 = p1 / res < N and b2 = p2 / res < N,
// (the JAX package's rule, with XLA's drop of out-of-bounds updates), and
//   * symmetric rule (r1 == NULL): +1 at [b1, b2], and at [b2, b1] when
//     b1 != b2;
//   * single-side rule: +1 at [b1, b2] for an R1 pair (r1[i] != 0), at
//     [b2, b1] for any other.
//
// Bound on the H100: the scattered float adds.  The four int64 columns are
// read once (32 bytes a pair, a 2^24-pair block 537 MB: 0.16 ms at 3.35
// TB/s); each kept pair makes one or two atomic adds at addresses that follow
// the pairs' order.  The design makes one launch per block and resolution,
// one thread per pair (grid-stride), with no compaction, no count and nothing
// read back to the host: the pairs a host-side select would drop are dropped
// in the thread.  The adds are of 1.0f into cells that hold integers below
// 2^24, so every sum is exact and the same bits come out in any order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

template <bool kSingle>
__global__ void __launch_bounds__(kThreads)
    intra_bin_kernel(const int64_t* __restrict__ c1,
                     const int64_t* __restrict__ p1,
                     const int64_t* __restrict__ c2,
                     const int64_t* __restrict__ p2,
                     const uint8_t* __restrict__ r1,
                     const int64_t* __restrict__ base,
                     const int64_t* __restrict__ npad, int n_labels, int64_t n,
                     int64_t res, float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t c = __ldcs(c1 + i);
    const int64_t d = __ldcs(c2 + i);
    const int64_t a = __ldcs(p1 + i);
    const int64_t b = __ldcs(p2 + i);
    if (c != d || c < 0 || c >= n_labels || a < 0 || b < 0) continue;
    const int64_t N = __ldg(npad + c);
    const int64_t b1 = a / res;
    const int64_t b2 = b / res;
    if (b1 >= N || b2 >= N) continue;
    float* m = out + __ldg(base + c);
    if (kSingle) {
      if (__ldcs(r1 + i))
        atomicAdd(m + b1 * N + b2, 1.0f);
      else
        atomicAdd(m + b2 * N + b1, 1.0f);
    } else {
      atomicAdd(m + b1 * N + b2, 1.0f);
      if (b1 != b2) atomicAdd(m + b2 * N + b1, 1.0f);
    }
  }
}

}  // namespace

// r1 may be NULL (the symmetric rule); n_labels is the length of base and
// npad.  Launches nothing for an empty block.
extern "C" int intra_bin(const int64_t* c1, const int64_t* p1,
                         const int64_t* c2, const int64_t* p2,
                         const uint8_t* r1, const int64_t* base,
                         const int64_t* npad, int n_labels, int64_t n,
                         int64_t res, float* out, cudaStream_t stream) {
  if (n < 0 || res <= 0 || n_labels < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || n_labels == 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (r1)
    intra_bin_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        c1, p1, c2, p2, r1, base, npad, n_labels, n, res, out);
  else
    intra_bin_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        c1, p1, c2, p2, r1, base, npad, n_labels, n, res, out);
  return (int)cudaGetLastError();
}
