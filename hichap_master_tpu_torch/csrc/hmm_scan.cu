// K4 and K5: the recurrences of the TAD Gaussian-mixture HMM.
//
// Replace the jax.lax.scan bodies of _e_step (scaled forward-backward) and
// _viterbi_padded (max-product with back-pointers) in
// hichap_master_tpu/ops/hmm.py.  These are not Pallas kernels: the JAX
// package scans over time inside one compiled program, and their plain
// PyTorch form, a loop over time steps of a few small launches each, cannot
// run at hg19 length (T = 8,192 at 40 kb, ~90 EM iterations).
//
// Bound on the H100: latency.  Each sequence is one chain of T dependent
// steps of S x S float64 work (S <= 8: 3, 5 or 6 states in the reference's
// priors), and there are a few dozen sequences.  So one thread owns one
// sequence, the S x S transition matrix and the recurrence state live in
// registers, the loop runs to the sequence's own length L[b] (padding costs
// nothing), and each step's emission row is loaded one step ahead so that
// its memory latency overlaps the previous step's arithmetic.  A parallel
// prefix over segments would use more of the card; that is later work.
//
// Masking is the JAX package's: steps t >= L[b] do not exist for the
// recurrence (alpha carried with c = 1, beta = 1, gamma and xi zero), so
// the caller zero-fills gamma and the kernel writes only t < L[b].  The
// arithmetic follows the JAX expressions term by term: c guarded to 1 when
// not > 0, gamma normalised by max(sum, 1e-300), xi_t = alpha_t[i] A[i][j]
// (b_{t+1}[j] beta_{t+1}[j]) / c_{t+1}; Viterbi takes the first maximum on
// ties, like jnp.argmax.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one sequence per thread

// Forward-backward for one sequence per thread.
//   b      [B, T, S]  per-step scaled emissions exp(logb - max_s logb)
//   A [S, S], pi [S], L [B]
//   gamma  [B, T, S]  out (zero-filled by the caller; holds alpha between
//                     the two passes)
//   cbuf   [B, T]     scratch: the scaling constants c_t
//   xi     [B, S, S]  out: sum over t of xi_t
//   logc   [B]        out: sum over t < L of log c_t
template <int S>
__global__ void __launch_bounds__(kThreads)
fb_kernel(const double* __restrict__ b, const double* __restrict__ A_g,
          const double* __restrict__ pi_g, const int* __restrict__ L,
          double* __restrict__ gamma, double* __restrict__ cbuf,
          double* __restrict__ xi_out, double* __restrict__ logc_out, int B,
          int T) {
  const int seq = blockIdx.x * blockDim.x + threadIdx.x;
  if (seq >= B) return;
  double A[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) A[i][j] = A_g[i * S + j];
  double xi[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) xi[i][j] = 0.0;

  const int n = min(L[seq], T);
  const double* bs = b + (size_t)seq * T * S;
  double* g = gamma + (size_t)seq * T * S;
  double* cs = cbuf + (size_t)seq * T;
  double logc = 0.0;

  if (n > 0) {
    // forward: alpha_0 = pi b_0 / c_0, then alpha_t = (alpha A) b_t / c_t
    double alpha[S], bn[S];
    double c = 0.0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      alpha[j] = pi_g[j] * bs[j];
      c += alpha[j];
    }
    c = c > 0.0 ? c : 1.0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      alpha[j] = alpha[j] / c;
      g[j] = alpha[j];
    }
    cs[0] = c;
    logc = log(c);
    if (n > 1) {
#pragma unroll
      for (int j = 0; j < S; ++j) bn[j] = bs[S + j];
    }
    for (int t = 1; t < n; ++t) {
      double bt[S];
#pragma unroll
      for (int j = 0; j < S; ++j) bt[j] = bn[j];
      if (t + 1 < n) {
#pragma unroll
        for (int j = 0; j < S; ++j) bn[j] = bs[(size_t)(t + 1) * S + j];
      }
      double raw[S];
      c = 0.0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        double m = 0.0;
#pragma unroll
        for (int i = 0; i < S; ++i) m += alpha[i] * A[i][j];
        raw[j] = m * bt[j];
        c += raw[j];
      }
      c = c > 0.0 ? c : 1.0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        alpha[j] = raw[j] / c;
        g[(size_t)t * S + j] = alpha[j];
      }
      cs[t] = c;
      logc += log(c);
    }

    // backward: beta_{n-1} = 1, beta_t = A (b_{t+1} beta_{t+1}) / c_{t+1}
    double beta[S];
    {
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        beta[j] = 1.0;
        s += alpha[j];
      }
      s = fmax(s, 1e-300);
#pragma unroll
      for (int j = 0; j < S; ++j) g[(size_t)(n - 1) * S + j] = alpha[j] / s;
    }
    // operands of step t, loaded one step ahead: b_{t+1}, c_{t+1}, alpha_t
    double nb_b[S], nb_a[S], nb_c = 0.0;
    if (n > 1) {
      const int t = n - 2;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        nb_b[j] = bs[(size_t)(t + 1) * S + j];
        nb_a[j] = g[(size_t)t * S + j];
      }
      nb_c = cs[t + 1];
    }
    for (int t = n - 2; t >= 0; --t) {
      double bt1[S], at[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        bt1[j] = nb_b[j];
        at[j] = nb_a[j];
      }
      const double c1 = nb_c;
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          nb_b[j] = bs[(size_t)t * S + j];
          nb_a[j] = g[(size_t)(t - 1) * S + j];
        }
        nb_c = cs[t];
      }
      double v[S], nbeta[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = bt1[j] * beta[j];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        double m = 0.0;
#pragma unroll
        for (int j = 0; j < S; ++j) m += A[i][j] * v[j];
        nbeta[i] = m / c1;
      }
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < S; ++j) xi[i][j] += at[i] * A[i][j] * v[j] / c1;
      double gm[S], s = 0.0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        gm[j] = at[j] * nbeta[j];
        s += gm[j];
        beta[j] = nbeta[j];
      }
      s = fmax(s, 1e-300);
#pragma unroll
      for (int j = 0; j < S; ++j) g[(size_t)t * S + j] = gm[j] / s;
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j)
      xi_out[(size_t)seq * S * S + i * S + j] = xi[i][j];
  logc_out[seq] = logc;
}

// Viterbi for one sequence per thread: forward max-product with int8
// back-pointers bp [B, T, S], then the backtrace in the same launch.
//   path [B, T] out: the state path; t >= L[b] carries the end state
//   logprob [B] out: the best path's log-probability
template <int S>
__global__ void __launch_bounds__(kThreads)
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
                      const int* L, double* gamma, double* cbuf, double* xi,
                      double* logc, int B, int T, cudaStream_t stream) {
  fb_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      b, A, pi, L, gamma, cbuf, xi, logc, B, T);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_viterbi(const double* logb, const double* logA,
                           const double* logpi, const int* L, int8_t* bp,
                           int* path, double* logprob, int B, int T,
                           cudaStream_t stream) {
  viterbi_kernel<S><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      logb, logA, logpi, L, bp, path, logprob, B, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hmm_forward_backward(const double* b, const double* A,
                                    const double* pi, const int* L,
                                    double* gamma, double* cbuf, double* xi,
                                    double* logc, int B, int T, int S,
                                    cudaStream_t stream) {
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  switch (S) {
#define HMM_FB_CASE(s) \
  case s:              \
    return (int)launch_fb<s>(b, A, pi, L, gamma, cbuf, xi, logc, B, T, stream);
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
