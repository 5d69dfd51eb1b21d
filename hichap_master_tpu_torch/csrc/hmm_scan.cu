// K4 and K5: the recurrences of the TAD Gaussian-mixture HMM.
//
// Replace the jax.lax.scan bodies of _e_step (scaled forward-backward) and
// _viterbi_padded (max-product with back-pointers) in
// hichap_master_tpu/ops/hmm.py.  These are not Pallas kernels: the JAX
// package scans over time inside one compiled program, and their plain
// PyTorch form, a loop over time steps of a few small launches each, cannot
// run at hg19 length (T = 8,192 at 40 kb, ~260 EM iterations).
//
// Bound on the H100: latency.  Each sequence is one chain of L dependent
// steps of S x S float64 work (S <= 8: 3, 5 or 6 states in the reference's
// priors); the bytes (emissions in, posteriors out) take microseconds.
//
// K4 (forward-backward) is a chunked parallel scan, one block per sequence,
// so the dependent chain is a chunk of ceil(L / P) steps plus log2(P) levels
// of S x S products instead of L steps:
//   1. each of the P threads owns a chunk of consecutive steps and composes
//      its chunk's operators M_t = A diag(b_t), each row renormalised by
//      its own power of two after every product (see Op below), so nothing
//      under- or overflows;
//   2. a block-wide exclusive scan of the chunk operators (warp shuffles,
//      then the warp totals) gives each chunk's start vector;
//   3. each thread replays the sequential recurrence over its chunk from
//      that start, writing alpha_t and c_t step by step as the plain version
//      does (the c guard, the masking and the operand order are the plain
//      version's);
//   4. the backward pass is the same from the right with the operators
//      A diag(b_t) / c_t, carrying the rows' exponents through the suffix
//      scan so that each chunk-end beta has the sequential scaling (xi uses
//      it); gamma and each thread's xi and log c come from the replay
//      (log c as one log of the chunk's product of c, kept as mantissa and
//      exponent), and xi and log c are summed over the block by a
//      fixed-order tree (no atomics: the result is deterministic).
// The emission rows of a tile of P x chunk steps are staged in dynamic
// shared memory by coalesced block-wide loads; a sequence longer than the
// tile the shared memory holds runs tile after tile, the carry vector
// passing from one to the next.  A thread's steps lie 3 Lc doubles apart
// from its neighbour's in the [T, S] layout, so one warp's access there
// touches a line per thread; hence alpha_t and c_t go to a global scratch
// in chunk-interleaved order (the threads of a warp, each at the same step
// of its own chunk, touch neighbouring slots), and gamma_t takes the place
// of b_t in shared memory during the backward pass and leaves in one
// coalesced block-wide store.  The loads of the backward pass are issued
// one step ahead.  Only the association of the xi / log c sums, the
// reciprocal multiplies of the backward pass and the log2(P) rounding steps
// of the chunk starts differ from the sequential order (~1e-15 relative).
//
// K5 (Viterbi) is one block per sequence too, but keeps the plain
// version's arithmetic order, so that paths and scores equal it bit for
// bit (a max-plus chunked scan would start its chunks from values that
// differ by rounding, and an exact tie could then break another way than
// jnp.argmax does).  The forward recurrence is one dependent chain in one
// thread, which reads its emission rows from shared memory, where the other
// warps stage them tile after tile with cp.async, double-buffered; each
// step's back-pointers are one packed map, which the loader warps move
// tile by tile to a scratch in device memory, so that a sequence of any
// length takes the same path (keeping the maps of a sequence that fits in
// shared memory was no faster on an H100).  The backtrace is
// exact and parallel: per-thread composition of the maps of a chunk, a
// block-wide suffix scan of map composition, and a replay of each chunk.
// What bounds it is the chain: L steps of six dependent float64 operations
// each (add, compare, select, compare, select, add for three states; ~55 ns
// a step on an H100), far above what its bytes take.
//
// Masking is the JAX package's: steps t >= L[b] do not exist for the
// recurrence (alpha carried with c = 1, beta = 1, gamma and xi zero), so
// the kernels run to L[b] and K4 writes gamma's zeros past it.  The
// arithmetic follows the JAX expressions term by term: c guarded to 1 when
// not > 0, gamma normalised by max(sum, 1e-300), xi_t = alpha_t[i] A[i][j]
// (b_{t+1}[j] beta_{t+1}[j]) / c_{t+1}; Viterbi takes the first maximum on
// ties, like jnp.argmax.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kViterbiThreads = 256;  // one block per sequence
constexpr int kViterbiTile = 256;     // emission rows per staged tile
constexpr int kMaxSmem = 232448;     // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kLn2 = 0.6931471805599453;

// threads per forward-backward block: one block runs on one SM, and its
// dependent chains need many warps to hide their latency; the S x S
// operators' registers set the limit
template <int S>
__host__ __device__ constexpr int fb_threads() {
  return S <= 3 ? 512 : 128;
}

// An S x S operator with one power-of-two exponent per row: row i is
// m[i] * 2^ex[i].  A product composed from the right keeps each row a
// vector recursion of its own (the row of start state i), so rows are
// renormalised apart: one exponent for the whole matrix loses rows that
// drift more than a double's range below the largest (emissions of 1e-300
// do that within a few steps).
template <int S>
struct Op {
  double m[S][S];
  int ex[S];
};

constexpr int kNoTerm = INT_MIN;  // exponent of an all-zero row or vector

template <int S>
__device__ __forceinline__ Op<S> identity() {
  Op<S> x;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) x.m[i][j] = i == j ? 1.0 : 0.0;
    x.ex[i] = 0;
  }
  return x;
}

// The rare cases of the two below, out of line (inlined at every matrix
// entry they multiply the code, and the build time, many times over).
__device__ __noinline__ int frexp_exponent(double x) {
  int e;
  frexp(x, &e);
  return e;
}

__device__ __noinline__ double ldexp_call(double x, int e) {
  return ldexp(x, e);
}

// frexp's exponent of a finite x != 0 (2^(e-1) <= |x| < 2^e), read from
// the bits for a normal x
__device__ __forceinline__ int exponent_of(double x) {
  const int biased = (__double2hiint(x) >> 20) & 0x7ff;
  return biased != 0 ? biased - 1022 : frexp_exponent(x);
}

// ldexp(x, e): one multiply by an exact power of two when 2^e is a normal
// double (the product rounds as ldexp does)
__device__ __forceinline__ double scale2(double x, int e) {
  if (e >= -1022 && e <= 1023)
    return x * __hiloint2double((e + 1023) << 20, 0);
  return ldexp_call(x, e);
}

// Scale each row by the power of two that brings its largest entry into
// [0.5, 1) (exact: only the exponent moves).
template <int S>
__device__ __forceinline__ void renorm(Op<S>& x) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    double mx = 0.0;
#pragma unroll
    for (int j = 0; j < S; ++j) mx = fmax(mx, fabs(x.m[i][j]));
    if (mx > 0.0 && mx <= DBL_MAX) {
      const int e = exponent_of(mx);
#pragma unroll
      for (int j = 0; j < S; ++j) x.m[i][j] = scale2(x.m[i][j], -e);
      x.ex[i] += e;
    }
  }
}

// The exponent of the largest term v[k] 2^ex[k] (kNoTerm if v is 0).
template <int S>
__device__ __forceinline__ int top_exponent(const double* v, const int* ex) {
  int top = kNoTerm;
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (v[k] != 0.0) top = max(top, exponent_of(v[k]) + ex[k]);
  return top;
}

// w[k] = v[k] 2^(ex[k] - top): the terms on one scale, the largest in
// [0.5, 1) (terms too small to matter underflow to 0).
template <int S>
__device__ __forceinline__ void weights(const double* v, const int* ex,
                                        int top, double* w) {
#pragma unroll
  for (int k = 0; k < S; ++k)
    w[k] = top == kNoTerm ? 0.0 : scale2(v[k], ex[k] - top);
}

// (diag(2^x.ex) x.m)(diag(2^y.ex) y.m), row by row: row i of x weights the
// rows of y by x.m[i][k] 2^y.ex[k], shifted by the largest weight's
// exponent, which joins x.ex[i].
template <int S>
__device__ __forceinline__ Op<S> mul_inline(const Op<S>& x, const Op<S>& y) {
  Op<S> z;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int top = top_exponent<S>(x.m[i], y.ex);
    double w[S];
    weights<S>(x.m[i], y.ex, top, w);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < S; ++k) s += w[k] * y.m[k][j];
      z.m[i][j] = s;
    }
    z.ex[i] = x.ex[i] + (top == kNoTerm ? 0 : top);
  }
  renorm(z);
  return z;
}

template <int S>
__device__ __noinline__ Op<S> mul_call(const Op<S>& x, const Op<S>& y) {
  return mul_inline(x, y);
}

// inline for the reference's 3-state model; a call for larger S, whose
// products are large enough to pay for it
template <int S>
__device__ __forceinline__ Op<S> mul(const Op<S>& x, const Op<S>& y) {
  if constexpr (S <= 3)
    return mul_inline(x, y);
  else
    return mul_call(x, y);
}

// x <- x A diag(b_t) inv_c  (one step's operator applied on the right)
template <int S>
__device__ __forceinline__ void step_right(Op<S>& x, const double (&A)[S][S],
                                           const double* bt, double inv_c) {
  double r[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < S; ++k) s += x.m[i][k] * A[k][j];
      r[i][j] = s * bt[j] * inv_c;
    }
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) x.m[i][j] = r[i][j];
  renorm(x);
}

template <int S>
__device__ __forceinline__ Op<S> shfl_up(const Op<S>& x, int d) {
  Op<S> y;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) y.m[i][j] = __shfl_up_sync(kFull, x.m[i][j], d);
#pragma unroll
  for (int i = 0; i < S; ++i) y.ex[i] = __shfl_up_sync(kFull, x.ex[i], d);
  return y;
}

template <int S>
__device__ __forceinline__ Op<S> shfl_down(const Op<S>& x, int d) {
  Op<S> y;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j)
      y.m[i][j] = __shfl_down_sync(kFull, x.m[i][j], d);
#pragma unroll
  for (int i = 0; i < S; ++i) y.ex[i] = __shfl_down_sync(kFull, x.ex[i], d);
  return y;
}

// scratch slot w holds the S * S entries and the S exponents (as doubles)
template <int S>
__device__ __forceinline__ void put(double* scratch, int w, const Op<S>& x) {
  double* p = scratch + w * (S * S + S);
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) p[i * S + j] = x.m[i][j];
    p[S * S + i] = (double)x.ex[i];
  }
}

template <int S>
__device__ __forceinline__ Op<S> get(const double* scratch, int w) {
  const double* p = scratch + w * (S * S + S);
  Op<S> x;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) x.m[i][j] = p[i * S + j];
    x.ex[i] = (int)p[S * S + i];
  }
  return x;
}

// Exclusive prefix product over the block: thread k gets x_0 ... x_{k-1}
// (the identity for k = 0).  Hillis-Steele within each warp, the same over
// the warp totals, then each warp's prefix on the left.
template <int S, int P>
__device__ Op<S> exclusive_prefix(Op<S> x, double* scratch) {
  constexpr int NW = P / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Op<S> y = shfl_up(x, d);
    if (lane >= d) x = mul(y, x);
  }
  if (lane == 31) put(scratch, w, x);
  __syncthreads();
  if (w == 0) {
    Op<S> t = lane < NW ? get<S>(scratch, lane) : identity<S>();
#pragma unroll
    for (int d = 1; d < NW; d <<= 1) {
      const Op<S> y = shfl_up(t, d);
      if (lane >= d) t = mul(y, t);
    }
    const Op<S> pre = shfl_up(t, 1);
    __syncwarp();
    if (lane >= 1 && lane < NW) put(scratch, lane, pre);
  }
  __syncthreads();
  const Op<S> y = shfl_up(x, 1);
  Op<S> out;
  if (w == 0) {
    out = lane == 0 ? identity<S>() : y;
  } else {
    const Op<S> pre = get<S>(scratch, w);
    out = lane == 0 ? pre : mul(pre, y);
  }
  __syncthreads();
  return out;
}

// Exclusive suffix product over the block: thread k gets x_{k+1} ...
// x_{P-1} (the identity for the last thread); the mirror of the above.
template <int S, int P>
__device__ Op<S> exclusive_suffix(Op<S> x, double* scratch) {
  constexpr int NW = P / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Op<S> y = shfl_down(x, d);
    if (lane + d < 32) x = mul(x, y);
  }
  if (lane == 0) put(scratch, w, x);
  __syncthreads();
  if (w == 0) {
    Op<S> t = lane < NW ? get<S>(scratch, lane) : identity<S>();
#pragma unroll
    for (int d = 1; d < NW; d <<= 1) {
      const Op<S> y = shfl_down(t, d);
      if (lane + d < NW) t = mul(t, y);
    }
    const Op<S> post = shfl_down(t, 1);
    __syncwarp();
    if (lane + 1 < NW) put(scratch, lane, post);
  }
  __syncthreads();
  const Op<S> y = shfl_down(x, 1);
  Op<S> out;
  if (w == NW - 1) {
    out = lane == 31 ? identity<S>() : y;
  } else {
    const Op<S> post = get<S>(scratch, w);
    out = lane == 31 ? post : mul(y, post);
  }
  __syncthreads();
  return out;
}

// Sum over the block in a fixed order (warp tree, then the warp totals);
// the result is valid in thread 0.
template <int P>
__device__ double block_sum(double v, double* scratch) {
  constexpr int NW = P / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) scratch[w] = v;
  __syncthreads();
  double r = 0.0;
  if (w == 0) {
    r = lane < NW ? scratch[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(kFull, r, o);
  }
  __syncthreads();
  return r;
}

// Forward-backward, one block per sequence.
//   b       [B, T, S]  per-step scaled emissions exp(logb - max_s logb)
//   A [S, S], pi [S], L [B]
//   gamma   [B, T, S]  out (0 at t >= L)
//   work    [B, slots * (S + 1)]  scratch: alpha_t [slots, S] and c_t
//                      [slots] of each sequence, chunk-interleaved
//                      (slot below); slots >= T + P * cap
//   xi      [B, S, S]  out: sum over t of xi_t
//   logc    [B]        out: sum over t < L of log c_t
//   cap                most steps per thread that one staged tile holds
// Dynamic shared memory: the tile [P, cap * S + 1] (emissions, then gamma
// in the backward pass; each chunk's rows padded to an odd number of
// doubles, so that the threads' strided accesses fall in distinct banks),
// the scan scratch [P / 32, S * S + S] and the carry vector [S].
template <int S>
__global__ void __launch_bounds__(fb_threads<S>())
fb_scan_kernel(const double* __restrict__ b, const double* __restrict__ A_g,
               const double* __restrict__ pi_g, const int* __restrict__ L,
               double* __restrict__ gamma, double* __restrict__ work,
               double* __restrict__ xi_out, double* __restrict__ logc_out,
               int T, int cap, int slots) {
  constexpr int P = fb_threads<S>();
  constexpr int NW = P / 32;
  extern __shared__ double smem[];
  double* sb = smem;
  double* scratch = sb + (size_t)P * (cap * S + 1);
  double* carry = scratch + NW * (S * S + S);

  const int seq = blockIdx.x, k = threadIdx.x;
  const int n = min(L[seq], T);
  const double* bs = b + (size_t)seq * T * S;
  double* g = gamma + (size_t)seq * T * S;
  double* al = work + (size_t)seq * slots * (S + 1);
  double* cs = al + (size_t)slots * S;
  double A[S][S], xi[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) {
      A[i][j] = A_g[i * S + j];
      xi[i][j] = 0.0;
    }
  // this thread's product of its c_t as cprod 2^cexp: one log at the end
  double cprod = 1.0;
  int cexp = 0;
  for (size_t i = (size_t)max(n, 0) * S + k; i < (size_t)T * S; i += P)
    g[i] = 0.0;

  if (n > 0) {
    const int Lc = min(cap, (n + P - 1) / P);
    const int TS = P * Lc;
    const int ntiles = (n + TS - 1) / TS;
    // chunk k's steps start at sb + k * q, q = Lc * S rounded up to odd:
    // element o of the tile (row-major [step, S]) lies at staged(o)
    const int LS = Lc * S, pad = 1 - (LS & 1), q = LS + pad;
    double* mine = sb + (size_t)k * q;
    auto staged = [&](int o) { return o + (pad ? o / LS : 0); };
    // the scratch slot of step t of this thread's chunk [s, e) in the tile
    // that starts at t0, or of t = s - 1, the last step of the chunk before
    auto slot = [&](int t0, int s, int t) {
      return t >= s ? (size_t)t0 + (size_t)(t - s) * P + k
                    : (s > t0 ? (size_t)t0 + (size_t)(Lc - 1) * P + k - 1
                              : (size_t)t0 - 1);
    };

    // ---- forward: alpha_t = (alpha_{t-1} A) b_t / c_t
    for (int tile = 0; tile < ntiles; ++tile) {
      const int t0 = tile * TS, end = min(t0 + TS, n);
      for (int o = k; o < (end - t0) * S; o += P)
        sb[staged(o)] = bs[(size_t)t0 * S + o];
      __syncthreads();
      if (tile == 0 && k == 0) {
        // alpha_0 = pi b_0 / c_0: the carry into the first chunk
        double raw[S], c = 0.0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          raw[j] = pi_g[j] * sb[j];
          c += raw[j];
        }
        c = c > 0.0 ? c : 1.0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          carry[j] = raw[j] / c;
          al[j] = carry[j];
        }
        cs[0] = c;
        cprod = c;
      }
      const int s = t0 + k * Lc, e = min(s + Lc, end);
      Op<S> x = identity<S>();
      for (int t = max(s, 1); t < e; ++t)
        step_right(x, A, mine + (t - s) * S, 1.0);
      const Op<S> pre = exclusive_prefix<S, P>(x, scratch);
      double a[S];
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < S; ++j) a[j] = carry[j];
      } else {
        // carry diag(2^pre.ex) pre.m on one scale; only the direction counts
        double cr[S], w[S], u[S], sm = 0.0;
#pragma unroll
        for (int i = 0; i < S; ++i) cr[i] = carry[i];
        weights<S>(cr, pre.ex, top_exponent<S>(cr, pre.ex), w);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          double v = 0.0;
#pragma unroll
          for (int i = 0; i < S; ++i) v += w[i] * pre.m[i][j];
          u[j] = v;
          sm += v;
        }
#pragma unroll
        for (int j = 0; j < S; ++j) a[j] = sm > 0.0 ? u[j] / sm : u[j];
      }
      __syncthreads();  // every thread has read the carry
      for (int t = max(s, 1); t < e; ++t) {
        const double* bt = mine + (t - s) * S;
        double raw[S], c = 0.0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          double m = 0.0;
#pragma unroll
          for (int i = 0; i < S; ++i) m += a[i] * A[i][j];
          raw[j] = m * bt[j];
          c += raw[j];
        }
        c = c > 0.0 ? c : 1.0;
        const size_t sl = slot(t0, s, t);
#pragma unroll
        for (int j = 0; j < S; ++j) {
          a[j] = raw[j] / c;
          al[sl * S + j] = a[j];
        }
        cs[sl] = c;
        cprod *= c;
        const int ce = exponent_of(cprod);
        cprod = scale2(cprod, -ce);
        cexp += ce;
      }
      if (s < e && e == end) {  // this chunk holds the tile's last step
#pragma unroll
        for (int j = 0; j < S; ++j) carry[j] = a[j];
      }
      __syncthreads();
    }

    // ---- backward: beta_{t-1} = A (b_t beta_t) / c_t, beta_{L-1} = 1
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < S; ++j) carry[j] = 1.0;
    }
    for (int tile = ntiles - 1; tile >= 0; --tile) {
      const int t0 = tile * TS, end = min(t0 + TS, n);
      if (tile != ntiles - 1) {  // the last tile is still staged
        for (int o = k; o < (end - t0) * S; o += P)
          sb[staged(o)] = bs[(size_t)t0 * S + o];
      }
      __syncthreads();
      const int s = t0 + k * Lc, e = min(s + Lc, end);
      Op<S> x = identity<S>();
      double c_next = max(s, 1) < e ? cs[slot(t0, s, max(s, 1))] : 1.0;
      for (int t = max(s, 1); t < e; ++t) {
        const double ct = c_next;
        if (t + 1 < e) c_next = cs[slot(t0, s, t + 1)];  // one step ahead
        step_right(x, A, mine + (t - s) * S, 1.0 / ct);
      }
      const Op<S> post = exclusive_suffix<S, P>(x, scratch);
      double beta[S];
      if (s < e && e == end) {
#pragma unroll
        for (int j = 0; j < S; ++j) beta[j] = carry[j];
      } else {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          double v = 0.0;
#pragma unroll
          for (int j = 0; j < S; ++j) v += post.m[i][j] * carry[j];
          beta[i] = ldexp(v, post.ex[i]);
        }
      }
      __syncthreads();  // every thread has read the carry
      if (s < e) {
        // gamma_t replaces b_t in the tile once b_t is in registers
        double bt1[S];
        {
          double* gt = mine + (e - 1 - s) * S;
          const size_t sl = slot(t0, s, e - 1);
          double gm[S], sm = 0.0;
#pragma unroll
          for (int j = 0; j < S; ++j) {
            bt1[j] = gt[j];
            gm[j] = al[sl * S + j] * beta[j];
            sm += gm[j];
          }
          sm = fmax(sm, 1e-300);
#pragma unroll
          for (int j = 0; j < S; ++j) gt[j] = gm[j] / sm;
        }
        // alpha_t and c_{t+1} of each step are loaded one step ahead;
        // alpha_{s-1} is the last step of the chunk before
        const int t_last = max(s - 1, 0);
        double at_n[S], c_n = 1.0;
        if (e - 2 >= t_last) {
          c_n = cs[slot(t0, s, e - 1)];
          const size_t sl = slot(t0, s, e - 2);
#pragma unroll
          for (int j = 0; j < S; ++j) at_n[j] = al[sl * S + j];
        }
        for (int t = e - 2; t >= t_last; --t) {
          const double inv_c1 = 1.0 / c_n;
          double at[S], v[S], nbeta[S];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            at[j] = at_n[j];
            v[j] = bt1[j] * beta[j];
          }
          if (t - 1 >= t_last) {
            c_n = cs[slot(t0, s, t)];
            const size_t sl = slot(t0, s, t - 1);
#pragma unroll
            for (int j = 0; j < S; ++j) at_n[j] = al[sl * S + j];
          }
#pragma unroll
          for (int i = 0; i < S; ++i) {
            double m = 0.0;
#pragma unroll
            for (int j = 0; j < S; ++j) m += A[i][j] * v[j];
            nbeta[i] = m * inv_c1;
          }
#pragma unroll
          for (int i = 0; i < S; ++i)
#pragma unroll
            for (int j = 0; j < S; ++j)
              xi[i][j] += at[i] * A[i][j] * v[j] * inv_c1;
          if (t >= s) {
            double* gt = mine + (t - s) * S;
            double gm[S], sm = 0.0;
#pragma unroll
            for (int j = 0; j < S; ++j) {
              bt1[j] = gt[j];
              gm[j] = at[j] * nbeta[j];
              sm += gm[j];
            }
            const double inv_sm = 1.0 / fmax(sm, 1e-300);
#pragma unroll
            for (int j = 0; j < S; ++j) gt[j] = gm[j] * inv_sm;
          }
#pragma unroll
          for (int j = 0; j < S; ++j) beta[j] = nbeta[j];
        }
        if (k == 0) {  // beta_{t0 - 1}: the carry into the tile before
#pragma unroll
          for (int j = 0; j < S; ++j) carry[j] = beta[j];
        }
      }
      __syncthreads();
      for (int o = k; o < (end - t0) * S; o += P)
        g[(size_t)t0 * S + o] = sb[staged(o)];
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const double v = block_sum<P>(xi[i][j], scratch);
      if (k == 0) xi_out[(size_t)seq * S * S + i * S + j] = v;
    }
  const double v = block_sum<P>(log(cprod) + cexp * kLn2, scratch);
  if (k == 0) logc_out[seq] = v;
}

// ---- K5: Viterbi, one block per sequence.

__device__ __forceinline__ void cp_async8(void* dst_shared, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A step's back-pointers are a map from the S states at t to the S states
// at t - 1, packed three bits per entry: entry j is bits [3j, 3j + 3).
template <int S>
__device__ __forceinline__ unsigned identity_map() {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) m |= (unsigned)j << (3 * j);
  return m;
}

__device__ __forceinline__ int apply_map(unsigned f, int x) {
  return (int)((f >> (3 * x)) & 7u);
}

// x -> f[g[x]]: integers, so exactly associative
template <int S>
__device__ __forceinline__ unsigned compose(unsigned f, unsigned g) {
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < S; ++j)
    r |= (unsigned)apply_map(f, apply_map(g, j)) << (3 * j);
  return r;
}

// Forward max-product with back-pointers, then the backtrace, in one
// launch.
//   path [B, T] out: the state path; t >= L[b] carries the end state
//   logprob [B] out: the best path's log-probability
//   bp [B, T] scratch for the back-pointer maps
// Dynamic shared memory: two tiles of `tile` emission rows, the scan
// scratch [P / 32], the end state, and two tiles of maps.
//
// Forward: the warps past the first stage the emission rows of the next
// tile (cp.async, coalesced) while thread 0 runs the recurrence over the
// current one out of shared memory, in the plain version's order per entry
// (cand = delta[i] + lA[i][j], strict > from i = 0 upward, then + logb), so
// paths and scores equal it bit for bit; each step leaves its map in
// shared memory, and the loader warps move each finished tile of maps to
// the scratch.
// Backtrace: state[t - 1] = map_t[state[t]].  Each of the P threads
// composes the maps of its chunk of steps, a block-wide exclusive suffix
// scan of map composition gives every chunk its end state from the
// sequence's end state, and each thread replays its chunk, writing
// state[t - 1] over map_t; the path then leaves in coalesced stores.
template <int S>
__global__ void __launch_bounds__(kViterbiThreads, 1)
viterbi_kernel(const double* __restrict__ logb,
               const double* __restrict__ logA_g,
               const double* __restrict__ logpi, const int* __restrict__ L,
               unsigned* __restrict__ bp, int* __restrict__ path,
               double* __restrict__ logprob, int T, int tile) {
  constexpr int P = kViterbiThreads, NW = P / 32;
  extern __shared__ double smem[];
  double* stage = smem;
  unsigned* wt = reinterpret_cast<unsigned*>(smem + 2 * (size_t)tile * S);
  unsigned* end_state = wt + NW;
  unsigned* smaps = end_state + 2;

  const int seq = blockIdx.x, k = threadIdx.x;
  const int lane = k & 31, w = k >> 5;
  const int n = min(L[seq], T);
  int* p = path + (size_t)seq * T;
  if (n <= 0) {  // block-uniform
    for (int t = k; t < T; t += P) p[t] = 0;
    if (k == 0) logprob[seq] = -INFINITY;
    return;
  }
  unsigned* maps = bp + (size_t)seq * T;
  const double* lb = logb + (size_t)seq * T * S;
  const int ntiles = (n + tile - 1) / tile;

  // the loader warps copy tile i's rows into its half of the stage
  auto load_tile = [&](int i) {
    const int t0 = i * tile, cnt = (min(t0 + tile, n) - t0) * S;
    double* dst = stage + (size_t)(i & 1) * tile * S;
    const double* src = lb + (size_t)t0 * S;
    for (int o = k - 32; o < cnt; o += P - 32) cp_async8(dst + o, src + o);
    cp_async_wait_all();
  };

  double delta[S], lA[S][S];
  if (k == 0) {
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int j = 0; j < S; ++j) lA[a][j] = logA_g[a * S + j];
  }
  if (k >= 32) load_tile(0);
  __syncthreads();
  for (int i = 0; i < ntiles; ++i) {
    const int t0 = i * tile, t1 = min(t0 + tile, n);
    if (k >= 32) {
      if (i > 0) {  // the tile of maps just finished
        const unsigned* src = smaps + ((i - 1) & 1) * tile;
        for (int o = k - 32; o < tile; o += P - 32)
          maps[t0 - tile + o] = src[o];
      }
      if (i + 1 < ntiles) load_tile(i + 1);
    } else if (k == 0) {
      const double* sb = stage + (size_t)(i & 1) * tile * S;
      unsigned* wm = smaps + (i & 1) * tile;
      int t = t0;
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < S; ++j) delta[j] = logpi[j] + sb[j];
        wm[0] = identity_map<S>();
        t = 1;
      }
      double ln[S];  // each step's emission row is read one step ahead
      if (t < t1) {
#pragma unroll
        for (int j = 0; j < S; ++j) ln[j] = sb[(t - t0) * S + j];
      }
      for (; t < t1; ++t) {
        double lt[S];
#pragma unroll
        for (int j = 0; j < S; ++j) lt[j] = ln[j];
        if (t + 1 < t1) {
#pragma unroll
          for (int j = 0; j < S; ++j) ln[j] = sb[(t + 1 - t0) * S + j];
        }
        double nd[S];
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          double best = delta[0] + lA[0][j];
          unsigned arg = 0;
#pragma unroll
          for (int a = 1; a < S; ++a) {
            const double cand = delta[a] + lA[a][j];
            if (cand > best) {
              best = cand;
              arg = a;
            }
          }
          nd[j] = best + lt[j];
          m |= arg << (3 * j);
        }
        wm[t - t0] = m;
#pragma unroll
        for (int j = 0; j < S; ++j) delta[j] = nd[j];
      }
      if (i == ntiles - 1) {
        // first maximum; no delta[s]: a run-time index would move delta
        // out of the registers for the whole recurrence
        unsigned s = 0;
        double lp = delta[0];
#pragma unroll
        for (int j = 1; j < S; ++j)
          if (delta[j] > lp) {
            lp = delta[j];
            s = j;
          }
        logprob[seq] = lp;
        *end_state = s;
      }
    }
    __syncthreads();
  }
  // the last tile of maps
  const int tl = (ntiles - 1) * tile;
  for (int o = k; o < n - tl; o += P)
    maps[tl + o] = smaps[((ntiles - 1) & 1) * tile + o];
  __syncthreads();

  // ---- backtrace over the maps of t = 1 .. n - 1, a chunk of Lc steps
  // per thread
  const int last = (int)*end_state;
  const int Lc = max(1, (n - 1 + P - 1) / P);
  const int s = (int)min((long long)1 + (long long)k * Lc, (long long)n);
  const int e = min(s + Lc, n);
  unsigned x = identity_map<S>();
  for (int t = s; t < e; ++t) x = compose<S>(x, maps[t]);
  // exclusive suffix scan: the composition of the chunks after this one
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_down_sync(kFull, x, d);
    if (lane + d < 32) x = compose<S>(x, y);
  }
  if (lane == 0) wt[w] = x;
  __syncthreads();
  unsigned after = identity_map<S>();
  for (int j = NW - 1; j > w; --j) after = compose<S>(wt[j], after);
  unsigned y = __shfl_down_sync(kFull, x, 1);
  if (lane == 31) y = identity_map<S>();
  int st = apply_map(compose<S>(y, after), last);  // state[e - 1]
  for (int t = e - 1; t >= s; --t) {
    st = apply_map(maps[t], st);
    maps[t] = (unsigned)st;  // state[t - 1]
  }
  __syncthreads();
  for (int t = k; t < T; t += P) p[t] = t < n - 1 ? (int)maps[t + 1] : last;
}

template <int S>
cudaError_t launch_fb(const double* b, const double* A, const double* pi,
                      const int* L, double* gamma, double* work, double* xi,
                      double* logc, int B, int T, int slots,
                      cudaStream_t stream) {
  constexpr int P = fb_threads<S>();
  // the scan scratch and the carry, then as many steps per thread of the
  // tile as the block's shared memory holds (no more than T needs)
  const size_t fixed =
      ((size_t)(P / 32) * (S * S + S) + S + P) * sizeof(double);
  const size_t per_step = (size_t)P * S * sizeof(double);
  const int cap = std::max(1, std::min((T + P - 1) / P,
                                       (int)((kMaxSmem - fixed) / per_step)));
  if ((long long)slots < (long long)T + (long long)P * cap)
    return cudaErrorInvalidValue;
  const size_t smem = fixed + per_step * cap;
  const cudaError_t err = cudaFuncSetAttribute(
      fb_scan_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fb_scan_kernel<S><<<B, P, smem, stream>>>(b, A, pi, L, gamma, work, xi,
                                            logc, T, cap, slots);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_viterbi(const double* logb, const double* logA,
                           const double* logpi, const int* L, unsigned* bp,
                           int* path, double* logprob, int B, int T,
                           cudaStream_t stream) {
  const int tile = std::min(T, kViterbiTile);
  // two tiles of emission rows, the scan scratch and the end state (8-byte
  // aligned), two tiles of maps
  const size_t smem = 2 * (size_t)tile * S * sizeof(double) +
                      (size_t)(kViterbiThreads / 32 + 2 + 2 * tile) *
                          sizeof(unsigned);
  const cudaError_t err = cudaFuncSetAttribute(
      viterbi_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  viterbi_kernel<S><<<B, kViterbiThreads, smem, stream>>>(
      logb, logA, logpi, L, bp, path, logprob, T, tile);
  return cudaGetLastError();
}

}  // namespace

// work: [B, slots * (S + 1)] doubles of scratch; slots = 2 T + 512 always
// suffices (the launch checks what it needs: T + P * cap <= 2 T + P - 1)
extern "C" int hmm_forward_backward(const double* b, const double* A,
                                    const double* pi, const int* L,
                                    double* gamma, double* work, double* xi,
                                    double* logc, int B, int T, int S,
                                    int slots, cudaStream_t stream) {
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  switch (S) {
#define HMM_FB_CASE(s)                                                   \
  case s:                                                                \
    return (int)launch_fb<s>(b, A, pi, L, gamma, work, xi, logc, B, T, \
                             slots, stream);
    HMM_FB_CASE(1) HMM_FB_CASE(2) HMM_FB_CASE(3) HMM_FB_CASE(4)
    HMM_FB_CASE(5) HMM_FB_CASE(6) HMM_FB_CASE(7) HMM_FB_CASE(8)
#undef HMM_FB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bp: [B, T] words of scratch for the back-pointer maps
extern "C" int hmm_viterbi(const double* logb, const double* logA,
                           const double* logpi, const int* L, unsigned* bp,
                           int* path, double* logprob, int B, int T, int S,
                           cudaStream_t stream) {
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  switch (S) {
#define HMM_VIT_CASE(s)                                                   \
  case s:                                                                 \
    return (int)launch_viterbi<s>(logb, logA, logpi, L, bp, path, logprob, \
                                  B, T, stream);
    HMM_VIT_CASE(1) HMM_VIT_CASE(2) HMM_VIT_CASE(3) HMM_VIT_CASE(4)
    HMM_VIT_CASE(5) HMM_VIT_CASE(6) HMM_VIT_CASE(7) HMM_VIT_CASE(8)
#undef HMM_VIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
