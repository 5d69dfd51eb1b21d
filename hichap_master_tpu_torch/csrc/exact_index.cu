// K8: the k-mer index of a genome for FakeAligner's exact search.
//
// Port-only (the JAX package's FakeAligner runs str.find over every
// chromosome for every read, hichap_master_tpu/pipeline/mapping.py:248-267).
// The genome is one uint8 buffer on the card, upper-cased, its chromosomes
// one after the other (start[c], end[c]).  A window of k bases is keyed
// (2 bits a base, A C G T = 0 1 2 3, the first base most significant) when
// it lies inside one chromosome and holds only A, C, G and T.  The index is
//   bucket[4^k + 1]  where each key's positions start (an exclusive scan of
//                    the counts, made by the wrapper),
//   pos[W]           the global positions of the keyed windows, uint32
//                    (hg19's 3.1e9 positions exceed 2^31), grouped by key,
//   side[S]          the positions p whose byte is one of ACGT but whose
//                    window is not keyed (within k - 1 of a chromosome end
//                    or of another byte): where a read shorter than k can
//                    still start.
// Two passes over the genome: exact_index_count counts the keys into the
// 4^k buckets and the side positions, exact_index_scatter writes every
// position into its bucket at an atomic cursor.  The cursors are integer
// atomics, so the order of positions inside a bucket (and of the side
// list) varies from run to run; K9 reduces each read's candidates with a
// minimum and a count, so its output does not depend on that order.
//
// Bound on the H100: the genome is read once per pass (k bytes a window,
// from L1/L2) and pos written once, 4 bytes a window; the 4^k counters
// (268 MB at k = 13) take one atomic a window per pass, scattered.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int base_code(uint8_t c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

// The chromosome holding p: the last c with start[c] <= p.
__device__ __forceinline__ int chrom_of(const int64_t* __restrict__ start,
                                        int C, int64_t p) {
  int lo = 0, hi = C - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The key of the window at p (-1 when it is not keyed), and whether the
// byte at p is one of ACGT.
__device__ __forceinline__ int64_t window_key(
    const uint8_t* __restrict__ g, const int64_t* __restrict__ start,
    const int64_t* __restrict__ end, int C, int k, int64_t p, bool* acgt) {
  *acgt = base_code(g[p]) >= 0;
  if (!*acgt) return -1;
  const int c = chrom_of(start, C, p);
  if (p < start[c] || p + k > end[c]) return -1;
  int64_t key = 0;
  for (int j = 0; j < k; ++j) {
    const int b = base_code(g[p + j]);
    if (b < 0) return -1;
    key = (key << 2) | b;
  }
  return key;
}

__global__ void __launch_bounds__(kThreads)
index_count(const uint8_t* __restrict__ g, int64_t G,
            const int64_t* __restrict__ start, const int64_t* __restrict__ end,
            int C, int k, unsigned int* __restrict__ count,
            unsigned long long* __restrict__ side_n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < G;
       p += stride) {
    bool acgt;
    const int64_t key = window_key(g, start, end, C, k, p, &acgt);
    if (key >= 0) atomicAdd(count + key, 1u);
    else if (acgt) atomicAdd(side_n, 1ull);
  }
}

__global__ void __launch_bounds__(kThreads)
index_scatter(const uint8_t* __restrict__ g, int64_t G,
              const int64_t* __restrict__ start,
              const int64_t* __restrict__ end, int C, int k,
              const int64_t* __restrict__ bucket,
              unsigned int* __restrict__ cursor, unsigned int* __restrict__ pos,
              int64_t* __restrict__ side,
              unsigned long long* __restrict__ side_n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < G;
       p += stride) {
    bool acgt;
    const int64_t key = window_key(g, start, end, C, k, p, &acgt);
    if (key >= 0) {
      const int64_t slot = bucket[key] + atomicAdd(cursor + key, 1u);
      pos[slot] = (unsigned int)p;
    } else if (acgt) {
      side[atomicAdd(side_n, 1ull)] = p;
    }
  }
}

int grid_for(int64_t G) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (G + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sms * 16;
  return (int)(want < most ? (want > 0 ? want : 1) : most);
}

}  // namespace

// Counts of every key (count[4^k], zeroed by the caller) and of the side
// positions (*side_n, zeroed by the caller).
extern "C" int exact_index_count(const uint8_t* g, int64_t G,
                                 const int64_t* start, const int64_t* end,
                                 int C, int k, unsigned int* count,
                                 unsigned long long* side_n,
                                 cudaStream_t stream) {
  index_count<<<grid_for(G), kThreads, 0, stream>>>(g, G, start, end, C, k,
                                                    count, side_n);
  return (int)cudaGetLastError();
}

// Every keyed position into pos[bucket[key] ...] and every side position
// into side[]; cursor[4^k] and *side_n zeroed by the caller.
extern "C" int exact_index_scatter(const uint8_t* g, int64_t G,
                                   const int64_t* start, const int64_t* end,
                                   int C, int k, const int64_t* bucket,
                                   unsigned int* cursor, unsigned int* pos,
                                   int64_t* side, unsigned long long* side_n,
                                   cudaStream_t stream) {
  index_scatter<<<grid_for(G), kThreads, 0, stream>>>(
      g, G, start, end, C, k, bucket, cursor, pos, side, side_n);
  return (int)cudaGetLastError();
}
