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
// K5 (Viterbi) keeps one thread per sequence with the recurrence in
// registers and each step's emission row loaded one step ahead: it runs
// once per TAD call.
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

constexpr int kViterbiThreads = 32;  // one sequence per thread
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

// Viterbi for one sequence per thread: forward max-product with int8
// back-pointers bp [B, T, S], then the backtrace in the same launch.
//   path [B, T] out: the state path; t >= L[b] carries the end state
//   logprob [B] out: the best path's log-probability
template <int S>
__global__ void __launch_bounds__(kViterbiThreads)
viterbi_kernel(const double* __restrict__ logb,
               const double* __restrict__ logA_g,
               const double* __restrict__ logpi, const int* __restrict__ L,
               int8_t* __restrict__ bp, int* __restrict__ path,
               double* __restrict__ logprob, int B, int T) {
  const int seq = blockIdx.x * blockDim.x + threadIdx.x;
  if (seq >= B) return;
  double lA[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) lA[i][j] = logA_g[i * S + j];
  const int n = min(L[seq], T);
  const double* lb = logb + (size_t)seq * T * S;
  int8_t* bps = bp + (size_t)seq * T * S;
  int* p = path + (size_t)seq * T;
  if (n <= 0) {
    for (int t = 0; t < T; ++t) p[t] = 0;
    logprob[seq] = -INFINITY;
    return;
  }

  double delta[S], ln[S];
#pragma unroll
  for (int j = 0; j < S; ++j) delta[j] = logpi[j] + lb[j];
  if (n > 1) {
#pragma unroll
    for (int j = 0; j < S; ++j) ln[j] = lb[S + j];
  }
  for (int t = 1; t < n; ++t) {
    double lt[S];
#pragma unroll
    for (int j = 0; j < S; ++j) lt[j] = ln[j];
    if (t + 1 < n) {
#pragma unroll
      for (int j = 0; j < S; ++j) ln[j] = lb[(size_t)(t + 1) * S + j];
    }
    double nd[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      double best = delta[0] + lA[0][j];
      int arg = 0;
#pragma unroll
      for (int i = 1; i < S; ++i) {
        const double cand = delta[i] + lA[i][j];
        if (cand > best) {
          best = cand;
          arg = i;
        }
      }
      nd[j] = best + lt[j];
      bps[(size_t)t * S + j] = (int8_t)arg;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) delta[j] = nd[j];
  }

  int s = 0;
#pragma unroll
  for (int j = 1; j < S; ++j)
    if (delta[j] > delta[s]) s = j;
  double lp = delta[0];
#pragma unroll
  for (int j = 1; j < S; ++j)
    if (j == s) lp = delta[j];  // delta[s] without a local-memory index
  logprob[seq] = lp;
  for (int t = n; t < T; ++t) p[t] = s;
  p[n - 1] = s;
  for (int t = n - 1; t >= 1; --t) {
    s = bps[(size_t)t * S + s];
    p[t - 1] = s;
  }
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
                           const double* logpi, const int* L, int8_t* bp,
                           int* path, double* logprob, int B, int T,
                           cudaStream_t stream) {
  viterbi_kernel<S><<<(B + kViterbiThreads - 1) / kViterbiThreads,
                      kViterbiThreads, 0, stream>>>(
      logb, logA, logpi, L, bp, path, logprob, B, T);
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

extern "C" int hmm_viterbi(const double* logb, const double* logA,
                           const double* logpi, const int* L, int8_t* bp,
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
