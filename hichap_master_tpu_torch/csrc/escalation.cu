// K3: the HICCUPS escalation ladder on packed band prefix maps.
//
// Replaces the Pallas kernel _ladder_kernel / escalation_pallas
// (hichap_master_tpu/kernels/pallas_escalation.py) together with the
// prefix maps it reads (anti_diagonal_prefix, ops/loops_packed.py).  Maps
// are packed bands D[e, x] = M[x, x + e] turned into anti-diagonal prefix
// maps W, on which every rectangle sum of the contact matrix is four reads:
//   rect(e, x; r0, r1, c0, c1) =  W[e + c1 - r0,     x + r0]
//                               - W[e + c1 - r1 - 1, x + r1 + 1]
//                               - W[e + c0 - 1 - r0, x + r0]
//                               + W[e + c0 - 2 - r1, x + r1 + 1]
// with reads outside the map returning 0 (the zero fill of
// ops/loops_packed._shift2).
//
// escalation_prefix builds W for the raw, balanced and expected maps in two
// launches, reading the three maps where they lie:
//   (a) column prefix: one thread per (map, chromosome, column x) walks e
//       in the order of ops/loops_packed._prefix_rows (the order of XLA's
//       CPU cumsum): sequential within blocks of 16 rows, the block totals
//       prefixed by the same rule, then added back.  The 16 loads of a
//       block are issued together, then summed in order;
//   (b) diagonal pass, in place: one thread per (map, chromosome,
//       anti-diagonal d = e + x), the threads stepping e in lockstep so that
//       neighbours touch neighbouring x:
//       W[e, x] = R[e, x] + W[e - 1, x + 1], W[0, x] = R[0, x],
//       W[e, X - 1] = R[e, X - 1].
// Every add is the plain version's, on the same operands in the same order,
// so W is bit for bit anti_diagonal_prefix.  (a) and (b) stay two launches:
// a block of anti-diagonals touches more columns than it owns, so fusing
// would repeat column prefixes.  Bound: bytes, the three maps read twice by
// (a) and W written by (a), then read and written once by (b).
//
// escalation_ladder: for each candidate cell the first level t = w - ww,
// w in [ww, maxww], whose lower-left raw count is >= 16 (127 = unresolved),
// and the four backgrounds at that level (donut and lower-left, balanced and
// expected), written at candidate cells only; a per-chromosome histogram of
// t over distinct cells and the number of candidate cells.  The global <10%
// stop level and the per-pixel gather stay in PyTorch
// (kernels/escalation.py).  One thread owns one cell and reads only what it
// needs: 8 reads per level until the cell resolves, then 64 reads for its
// four backgrounds; neighbouring threads read neighbouring x, so the reads
// coalesce and mostly hit L1/L2.  At chr1 10 kb (E = 305, Xp = 25,088) 3.6 M
// of the 7.7 M cells are candidates and 91% of them resolve at the first
// level, so the raw map's reads are ~1/8 of the ladder's; they are not
// staged in shared memory.  The histogram is built in shared memory and
// flushed with one global atomic per level per block.  Arithmetic is in
// the same order as the plain map-space version, so both give identical
// bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnresolved = 127;
constexpr int kMaxLevels = 127;
constexpr int kScanBase = 16;         // block length of the blocked prefix
constexpr int kMaxBlocks = 256;       // rows: E <= 16 * 256
constexpr int kMaxRows = kScanBase * kMaxBlocks;

// ------------------------------------------------------------ prefix maps

// The kScanBase rows lo .. lo + cnt - 1 of one column (loads issued
// together; rows past cnt read as 0 and are never summed).
__device__ __forceinline__ void load_rows(const float* col, int lo, int cnt,
                                          int X, float (&v)[kScanBase]) {
#pragma unroll
  for (int i = 0; i < kScanBase; ++i)
    v[i] = i < cnt ? __ldg(col + (size_t)(lo + i) * X) : 0.f;
}

// In-place inclusive prefix of v[0 .. n), n <= kMaxBlocks, by the blocked
// rule: sequential when n <= 16; else sequential within blocks of 16, the
// block totals prefixed sequentially, the exclusive totals added back (the
// last block's total is never used).
__device__ void blocked_prefix(float* v, int n) {
  if (n <= kScanBase) {
    for (int i = 1; i < n; ++i) v[i] = v[i - 1] + v[i];
    return;
  }
  const int nb = (n + kScanBase - 1) / kScanBase;
  float tot[kScanBase];
  for (int j = 0; j < nb; ++j) {
    const int lo = j * kScanBase, hi = min(lo + kScanBase, n);
    for (int i = lo + 1; i < hi; ++i) v[i] = v[i - 1] + v[i];
    tot[j] = v[hi - 1];
  }
  for (int j = 1; j < nb; ++j) tot[j] = tot[j - 1] + tot[j];
  for (int j = 0; j < nb; ++j) {
    const int lo = j * kScanBase, hi = min(lo + kScanBase, n);
    const float ex = j ? tot[j - 1] : 0.f;
    for (int i = lo; i < hi; ++i) v[i] = v[i] + ex;
  }
}

// (a) R[m, c, e, x] = prefix over e of D_m[c, e, x] (blocked order); grid
// (ceil(X / kThreads), 3 C), blockIdx.y = m C + c.
__global__ void __launch_bounds__(kThreads)
column_prefix_kernel(const float* __restrict__ D0,
                     const float* __restrict__ D1,
                     const float* __restrict__ D2, float* __restrict__ R,
                     int C, int E, int X) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= X) return;
  const int mc = blockIdx.y, m = mc / C;
  const size_t plane = (size_t)E * X;
  const float* col = (m == 0 ? D0 : (m == 1 ? D1 : D2)) +
                     (size_t)(mc - m * C) * plane + x;
  float* out = R + (size_t)mc * plane + x;
  float v[kScanBase];
  if (E <= kScanBase) {  // one block: plain sequential prefix
    load_rows(col, 0, E, X, v);
    float s = v[0];
    out[0] = s;
#pragma unroll
    for (int i = 1; i < kScanBase; ++i)
      if (i < E) {
        s = s + v[i];
        out[(size_t)i * X] = s;
      }
    return;
  }
  const int nb = (E + kScanBase - 1) / kScanBase;
  float tot[kMaxBlocks];
  for (int j = 0; j < nb; ++j) {  // pass 1: the block totals
    const int lo = j * kScanBase, cnt = min(kScanBase, E - lo);
    load_rows(col, lo, cnt, X, v);
    float s = v[0];
#pragma unroll
    for (int i = 1; i < kScanBase; ++i)
      if (i < cnt) s = s + v[i];
    tot[j] = s;
  }
  blocked_prefix(tot, nb);
  for (int j = 0; j < nb; ++j) {  // pass 2: within-block prefix + total
    const int lo = j * kScanBase, cnt = min(kScanBase, E - lo);
    const float ex = j ? tot[j - 1] : 0.f;
    load_rows(col, lo, cnt, X, v);
    float s = v[0];
    out[(size_t)lo * X] = s + ex;
#pragma unroll
    for (int i = 1; i < kScanBase; ++i)
      if (i < cnt) {
        s = s + v[i];
        out[(size_t)(lo + i) * X] = s + ex;
      }
  }
}

// (b) W = R summed along anti-diagonals, in place; grid
// (ceil((E + X - 1) / kThreads), 3 C).  Rows go in batches of 16: the
// batch's loads first, then the dependent adds and the stores.
__global__ void __launch_bounds__(kThreads)
diagonal_prefix_kernel(float* W, int E, int X) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d > E + X - 2) return;
  // map[e * (X - 1)] is cell (e, d - e)
  float* map = W + (size_t)blockIdx.y * E * X + d;
  const int e0 = max(0, d - (X - 1)), e1 = min(E - 1, d);
  float s = 0.f;
  for (int lo = 0; lo < E; lo += kScanBase) {
    float v[kScanBase];
#pragma unroll
    for (int i = 0; i < kScanBase; ++i) {
      const int e = lo + i;
      v[i] = e >= e0 && e <= e1 ? map[(size_t)e * (X - 1)] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kScanBase; ++i) {
      const int e = lo + i;
      if (e >= e0 && e <= e1) {
        s = e == e0 ? v[i] : v[i] + s;
        map[(size_t)e * (X - 1)] = s;
      }
    }
  }
}

// ----------------------------------------------------------------- ladder
struct Map {
  const float* w;
  int E, X;
  __device__ __forceinline__ float at(int e, int x) const {
    return (e >= 0 && e < E && x >= 0 && x < X) ? __ldg(w + (size_t)e * X + x)
                                                 : 0.f;
  }
  __device__ __forceinline__ float rect(int e, int x, int r0, int r1, int c0,
                                        int c1) const {
    return ((at(e + c1 - r0, x + r0) - at(e + c1 - r1 - 1, x + r1 + 1))
            - at(e + c0 - 1 - r0, x + r0))
           + at(e + c0 - 1 - r1 - 1, x + r1 + 1);
  }
  __device__ __forceinline__ float donut(int e, int x, int w, int pw) const {
    return ((((rect(e, x, -w, w, -w, w) - rect(e, x, 0, 0, -w, w))
              - rect(e, x, -w, w, 0, 0))
             - rect(e, x, -pw, pw, -pw, pw))
            + rect(e, x, 0, 0, -pw, pw))
           + rect(e, x, -pw, pw, 0, 0);
  }
  __device__ __forceinline__ float lowerleft(int e, int x, int w,
                                             int pw) const {
    return rect(e, x, 1, w, -w, -1) - rect(e, x, 1, pw, -pw, -1);
  }
};

// grid (ceil(E X / kThreads), C); outputs at candidate cells only
__global__ void __launch_bounds__(kThreads)
ladder_kernel(const float* __restrict__ Wr, const float* __restrict__ Wb,
              const float* __restrict__ We,
              const uint8_t* __restrict__ mask, uint8_t* __restrict__ t_out,
              float* __restrict__ a0, float* __restrict__ a1,
              float* __restrict__ a2, float* __restrict__ a3,
              int* __restrict__ hist, int* __restrict__ total, int E, int X,
              int ww, int maxww, int pw) {
  __shared__ int sh[kMaxLevels];
  const int n_levels = maxww - ww + 1;
  for (int i = threadIdx.x; i < n_levels; i += kThreads) sh[i] = 0;
  __syncthreads();

  const int c = blockIdx.y;
  const size_t plane = (size_t)E * X;
  const size_t cell = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t off = (size_t)c * plane;
  const bool candidate = cell < plane && mask[off + cell];
  if (candidate) {
    const int e = (int)(cell / X);
    const int x = (int)(cell - (size_t)e * X);
    int t = kUnresolved;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
    const Map raw{Wr + off, E, X};
    for (int li = 0; li < n_levels; ++li) {
      if (raw.lowerleft(e, x, ww + li, pw) >= 16.f) {
        t = li;
        break;
      }
    }
    if (t != kUnresolved) {
      const int w = ww + t;
      const Map bal{Wb + off, E, X};
      const Map exq{We + off, E, X};
      v0 = bal.donut(e, x, w, pw);
      v1 = exq.donut(e, x, w, pw);
      v2 = bal.lowerleft(e, x, w, pw);
      v3 = exq.lowerleft(e, x, w, pw);
      atomicAdd(&sh[t], 1);
    }
    t_out[off + cell] = (uint8_t)t;
    a0[off + cell] = v0;
    a1[off + cell] = v1;
    a2[off + cell] = v2;
    a3[off + cell] = v3;
  }
  const int n_candidates = __syncthreads_count(candidate);
  if (threadIdx.x == 0 && n_candidates) atomicAdd(total + c, n_candidates);
  for (int i = threadIdx.x; i < n_levels; i += kThreads)
    if (sh[i]) atomicAdd(hist + (size_t)c * n_levels + i, sh[i]);
}

}  // namespace

extern "C" int escalation_prefix(const float* D_raw, const float* D_bal,
                                 const float* D_exp, float* W, int C, int E,
                                 int X, cudaStream_t stream) {
  if (C < 1 || E < 1 || X < 1 || E > kMaxRows || 3 * C > 65535)
    return (int)cudaErrorInvalidValue;
  column_prefix_kernel<<<dim3((X + kThreads - 1) / kThreads, 3 * C),
                         kThreads, 0, stream>>>(D_raw, D_bal, D_exp, W, C, E,
                                                X);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  diagonal_prefix_kernel<<<dim3((E + X - 1 + kThreads - 1) / kThreads,
                                3 * C),
                           kThreads, 0, stream>>>(W, E, X);
  return (int)cudaGetLastError();
}

extern "C" int escalation_ladder(const float* Wr, const float* Wb,
                                 const float* We, const uint8_t* mask,
                                 uint8_t* t_out, float* a0, float* a1,
                                 float* a2, float* a3, int* hist, int* total,
                                 int C, int E, int X, int ww, int maxww,
                                 int pw, cudaStream_t stream) {
  const int n_levels = maxww - ww + 1;
  if (n_levels < 1 || n_levels > kMaxLevels || C < 1 || C > 65535 || E < 1 ||
      X < 1)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)E * X;
  const dim3 grid((unsigned)((plane + kThreads - 1) / kThreads), C);
  ladder_kernel<<<grid, kThreads, 0, stream>>>(Wr, Wb, We, mask, t_out, a0,
                                               a1, a2, a3, hist, total, E, X,
                                               ww, maxww, pw);
  return (int)cudaGetLastError();
}
