// K1: dense ICE iterations for a batch of padded matrices.
//
// Replaces the Pallas kernel _sweep_kernel / pallas_ice_sweeps
// (hichap_master_tpu/kernels/pallas_ice.py).  One ICE iteration is
//   marg = (M @ b) * b ;  mean, var over the nonzero marginals ;
//   b /= marg / mean   (0 -> 1)
// and it repeats until var < tol or max_iters, per matrix.
//
// Bound on the H100: device-memory bandwidth.  Each iteration streams the
// whole [N, N] matrix once (177 MB in f32 for chr1 at 40 kb, padded to
// 6,656) and does two flops per element, far below the card's ridge point.
// Everything else an iteration touches is O(N), so the design keeps it off
// the stream's path:
//
// - One persistent cooperative launch runs a whole block of iterations, as
//   the Pallas grid (iters, row tiles, col tiles) does on the TPU: one
//   block of 1,024 threads per SM, the biases of every matrix of the batch
//   in shared memory for the whole launch (the kernel's VMEM scratch), and
//   one grid-wide barrier per iteration.
// - Matvec phase: the rows of all still-active matrices form one list that
//   is cut into gridDim.x equal contiguous ranges, so every SM streams the
//   same number of rows (chr1: 50 or 51) and a matrix that has converged
//   costs nothing.  A warp takes a row with two independent 16-byte
//   streaming loads in flight per lane (32 KB per SM; four measured no
//   faster and spilled registers), each with its own f32 accumulator; b
//   comes from shared memory.  bf16 matrices halve the
//   stream: b is rounded to bf16 once per iteration into a second shared
//   array (the JAX fast mode's operand), products are exact in f32.
// - After the barrier every block computes the statistics of each active
//   matrix redundantly from the marginals in L2 (staged in shared memory,
//   four matrices to a pass, so a batch pays the trip from L2 and the
//   block-wide barriers once per four), in one fixed order, so all blocks
//   hold bit-identical means, variances, biases, counters and `active`
//   flags: no second barrier, no float atomics, and the whole grid takes
//   the same decision to leave the loop when no matrix is active.
//   Marginals ping-pong between two buffers so a block that runs ahead
//   cannot overwrite what a slower block still reads.
// - The per-matrix `active` flag and iteration counter give the semantics
//   of vmap(while_loop); they are read once at the start of a launch and
//   written once at its end, as are the biases.
//
// ice_matvec is the matvec phase alone (same row loop, ordinary launch);
// it exists to be timed beside a library matvec and nothing else calls it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;       // one block per SM
constexpr int kUnroll = 2;           // 16-byte loads in flight per lane
constexpr int kMaxBatch = 64;        // matrices per launch
constexpr int kGroup = 4;            // matrices whose statistics go together

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float fma4(const float4 m, const float4 x,
                                      float a) {
  a = fmaf(m.x, x.x, a);
  a = fmaf(m.y, x.y, a);
  a = fmaf(m.z, x.z, a);
  return fmaf(m.w, x.w, a);
}

__device__ __forceinline__ float fma8(const uint4 raw, const float4 x0,
                                      const float4 x1, float a) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  a = fma4(make_float4(__low2float(h[0]), __high2float(h[0]),
                       __low2float(h[1]), __high2float(h[1])), x0, a);
  return fma4(make_float4(__low2float(h[2]), __high2float(h[2]),
                          __low2float(h[3]), __high2float(h[3])), x1, a);
}

// One warp's dot product of a matrix row (device memory, read once:
// streaming loads) with x (shared memory).  `vec`: the row is 16-byte
// aligned and N is a multiple of the vector width.  Every lane returns the
// sum.  Order of the sum: lane l, accumulator u takes vector l + 32 u +
// 32 kUnroll t, components in order; leftover vectors go to accumulator 0;
// accumulators add left to right; lanes by an xor butterfly.
__device__ __forceinline__ float row_dot(const float* __restrict__ mr,
                                         const float* __restrict__ x, int N,
                                         bool vec, int lane) {
  float acc[kUnroll] = {};
  if (vec) {
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = N >> 2;
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < n4; k += 32 * kUnroll) {
      float4 m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m[u] = __ldcs(m4 + k + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        acc[u] = fma4(m[u], x4[k + 32 * u], acc[u]);
    }
    for (; k < n4; k += 32) acc[0] = fma4(__ldcs(m4 + k), x4[k], acc[0]);
  } else {
    for (int j = lane; j < N; j += 32) acc[0] = fmaf(mr[j], x[j], acc[0]);
  }
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) s += acc[u];
  return warp_sum(s);
}

// The same for a bf16 row; x holds b already rounded to bf16 (as f32).
__device__ __forceinline__ float row_dot(
    const __nv_bfloat16* __restrict__ mr, const float* __restrict__ x, int N,
    bool vec, int lane) {
  float acc[kUnroll] = {};
  if (vec) {
    const uint4* m8 = reinterpret_cast<const uint4*>(mr);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n8 = N >> 3;
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < n8; k += 32 * kUnroll) {
      uint4 m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m[u] = __ldcs(m8 + k + 32 * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = 2 * (k + 32 * u);
        acc[u] = fma8(m[u], x4[j], x4[j + 1], acc[u]);
      }
    }
    for (; k < n8; k += 32)
      acc[0] = fma8(__ldcs(m8 + k), x4[2 * k], x4[2 * k + 1], acc[0]);
  } else {
    for (int j = lane; j < N; j += 32)
      acc[0] = fmaf(__bfloat162float(mr[j]), x[j], acc[0]);
  }
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) s += acc[u];
  return warp_sum(s);
}

// The block's share of the matvec phase: rows [r0, r1) of the list of the
// `nact` matrices named by `list`, one row per warp at a time.
// marg[c, row] = (M[c, row, :] . x[c]) * b[c, row].  x, b and list are in
// shared memory and only read here (x and b may be one array); marg is
// only written.
template <typename T>
__device__ __forceinline__ void matvec_rows(
    const T* __restrict__ M, const float* __restrict__ x,
    const float* __restrict__ b, float* __restrict__ marg,
    const int* __restrict__ list, int nact, int N, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long total = (long long)nact * N;
  const long long r0 = total * blockIdx.x / gridDim.x;
  const long long r1 = total * (blockIdx.x + 1) / gridDim.x;
  for (long long g = r0 + warp; g < r1; g += nwarps) {
    const size_t at = (size_t)list[g / N] * N + (size_t)(g % N);
    const float s = row_dot(M + at * N, x + (at - at % N), N, vec, lane);
    if (lane == 0) marg[at] = s * b[at];
  }
}

// Per-matrix state of a launch and the slots of its reductions.
struct SweepShared {
  float red_s[kGroup][kThreads / 32], red_q[kGroup][kThreads / 32];
  int red_n[kGroup][kThreads / 32];
  int started[kMaxBatch], act[kMaxBatch], it[kMaxBatch], list[kMaxBatch];
  float var[kMaxBatch], scale[kMaxBatch];
  int nact;
};

// Sum over the warps' slots, in sequence; every thread gets the result.
template <typename A>
__device__ __forceinline__ A slot_sum(const A* slots) {
  A tot = 0;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) tot += slots[w];
  return tot;
}

// Statistics and bias update of up to kGroup matrices (list[0 .. ng)), by
// the whole block: their marginals in `mg` (device memory, written by every
// block before the grid barrier) are staged in `sm` ([kGroup, N]); `sb` and
// `sx` are the biases and matvec operands in shared memory.  The matrices
// go through each pass together, so the group pays the marginals' trip from
// L2 and the two block-wide barriers once.  Per matrix the sums keep one
// fixed order: each thread folds its elements t, t + blockDim, ..., lanes
// add by butterfly, warps in sequence.  Each thread keeps to its own
// elements of sm, sb and sx, so the passes need no barrier between them.
template <bool kBf16>
__device__ __forceinline__ void update_group(const float* mg, float* sm,
                                             float* sb, float* sx,
                                             const int* list, int ng, int N,
                                             float tol, int max_iters,
                                             SweepShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s[kGroup], q[kGroup], mean[kGroup];
  int cnt[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    s[j] = q[j] = 0.f;
    cnt[j] = 0;
    if (j < ng) {
      const float* mgc = mg + (size_t)list[j] * N;
      for (int i = tid; i < N; i += blockDim.x) {
        const float v = __ldcg(mgc + i);
        sm[(size_t)j * N + i] = v;
        if (v != 0.f) { s[j] += v; ++cnt[j]; }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    s[j] = warp_sum(s[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cnt[j] += __shfl_xor_sync(0xffffffffu, cnt[j], o);
    if (lane == 0) { sh.red_s[j][warp] = s[j]; sh.red_n[j][warp] = cnt[j]; }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j < ng) {
      s[j] = slot_sum(sh.red_s[j]);
      cnt[j] = slot_sum(sh.red_n[j]);
      mean[j] = cnt[j] > 0 ? s[j] / (float)cnt[j] : 0.f;
      for (int i = tid; i < N; i += blockDim.x) {
        const float v = sm[(size_t)j * N + i];
        if (v != 0.f) { const float d = v - mean[j]; q[j] += d * d; }
      }
    }
    q[j] = warp_sum(q[j]);
    if (lane == 0) sh.red_q[j][warp] = q[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j < ng) {
      const int c = list[j];
      const float vr = cnt[j] > 0 ? slot_sum(sh.red_q[j]) / (float)cnt[j] : 0.f;
      const float denom = mean[j] != 0.f ? mean[j] : 1.f;
      float* bc = sb + (size_t)c * N;
      for (int i = tid; i < N; i += blockDim.x) {
        float mn = sm[(size_t)j * N + i] / denom;
        if (mn == 0.f) mn = 1.f;
        const float nb = bc[i] / mn;
        bc[i] = nb;
        if (kBf16) sx[(size_t)c * N + i] = round_bf16(nb);
      }
      if (tid == 0) {
        const int done = sh.it[c] + 1;
        sh.it[c] = done;
        sh.var[c] = vr;
        sh.scale[c] = mean[j];
        sh.act[c] = (vr >= tol) && (done < max_iters);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ice_sweep_kernel(const T* M, float* b, float* marg, int* active, int* iters,
                 float* var, float* scale, int C, int N, float tol,
                 int max_iters, int n_iters, int vec) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  // biases, staged marginals, and the matvec operand (b, rounded for bf16)
  float* sb = reinterpret_cast<float*>(smem4);   // [C, N]
  float* sm = sb + (size_t)C * N;                // [min(C, kGroup), N]
  float* sx = kBf16 ? sm + (size_t)min(C, kGroup) * N : sb;  // [C, N]
  __shared__ SweepShared sh;

  const int tid = threadIdx.x;
  cg::grid_group grid = cg::this_grid();

  if (tid < C) {
    sh.started[tid] = sh.act[tid] = active[tid];
    sh.it[tid] = iters[tid];
    sh.var[tid] = var[tid];
    sh.scale[tid] = scale[tid];
  }
  __syncthreads();
  for (size_t i = tid; i < (size_t)C * N; i += blockDim.x) {
    if (!sh.started[i / N]) continue;
    const float v = b[i];
    sb[i] = v;
    if (kBf16) sx[i] = round_bf16(v);
  }

  for (int it = 0; it < n_iters; ++it) {
    if (tid == 0) {
      int n = 0;
      for (int c = 0; c < C; ++c)
        if (sh.act[c]) sh.list[n++] = c;
      sh.nact = n;
    }
    __syncthreads();
    const int nact = sh.nact;
    if (nact == 0) break;  // the same in every block: no barrier is missed
    float* mg = marg + (size_t)(it & 1) * C * N;
    matvec_rows(M, sx, sb, mg, sh.list, nact, N, vec != 0);
    grid.sync();
    for (int a = 0; a < nact; a += kGroup) {
      // the barrier lets a second group reuse sm and the slots
      if (a) __syncthreads();
      update_group<kBf16>(mg, sm, sb, sx, sh.list + a, min(kGroup, nact - a),
                          N, tol, max_iters, sh);
    }
    __syncthreads();
  }

  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * blockDim.x + tid; i < (size_t)C * N;
       i += (size_t)gridDim.x * blockDim.x)
    if (sh.started[i / N]) b[i] = sb[i];
  if (blockIdx.x == 0 && tid < C && sh.started[tid]) {
    active[tid] = sh.act[tid];
    iters[tid] = sh.it[tid];
    var[tid] = sh.var[tid];
    scale[tid] = sh.scale[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ice_matvec_kernel(const T* M, const float* b, const int* active, float* marg,
                  int C, int N, int vec) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  float* sb = reinterpret_cast<float*>(smem4);   // [C, N]
  float* sx = kBf16 ? sb + (size_t)C * N : sb;   // [C, N]
  __shared__ int s_list[kMaxBatch], s_nact;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = 0; c < C; ++c)
      if (active[c]) s_list[n++] = c;
    s_nact = n;
  }
  for (size_t i = threadIdx.x; i < (size_t)C * N; i += blockDim.x) {
    const float v = b[i];
    sb[i] = v;
    if (kBf16) sx[i] = round_bf16(v);
  }
  __syncthreads();
  matvec_rows(M, sx, sb, marg, s_list, s_nact, N, vec != 0);
}

int sm_count(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

size_t sweep_smem(int C, int N, int bf16) {
  return ((size_t)C * (bf16 ? 2 : 1) + (C < kGroup ? C : kGroup)) * N *
         sizeof(float);
}

int vector_path(const void* M, int N, int bf16) {
  return N % (bf16 ? 8 : 4) == 0 &&
         reinterpret_cast<uintptr_t>(M) % 16 == 0;
}

}  // namespace

// The largest batch one launch of ice_sweep takes at this N (0: not even
// one matrix's biases fit the block's shared memory), or -cudaError_t.
extern "C" int ice_sweep_max_batch(int N, int bf16) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(
        &attr, bf16 ? (const void*)ice_sweep_kernel<__nv_bfloat16>
                    : (const void*)ice_sweep_kernel<float>);
  if (err != cudaSuccess) return -(int)err;
  int C = 0;
  while (C < kMaxBatch &&
         sweep_smem(C + 1, N, bf16) + attr.sharedSizeBytes <= (size_t)optin)
    ++C;
  return C;
}

// Up to n_iters ICE iterations on every matrix whose `active` flag is set,
// in one cooperative launch.  marg is scratch of 2 * C * N floats.
extern "C" int ice_sweep(const void* M, float* b, float* marg, int* active,
                         int* iters, float* var, float* scale, int C, int N,
                         int bf16, float tol, int max_iters, int n_iters,
                         cudaStream_t stream) {
  if (C < 1 || C > kMaxBatch || N < 1) return (int)cudaErrorInvalidValue;
  const void* fn = bf16 ? (const void*)ice_sweep_kernel<__nv_bfloat16>
                        : (const void*)ice_sweep_kernel<float>;
  const size_t smem = sweep_smem(C, N, bf16);
  int sms, per_sm;
  int rc = sm_count(&sms);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int vec = vector_path(M, N, bf16);
  void* args[] = {&M, &b, &marg, &active, &iters, &var, &scale, &C, &N, &tol,
                  &max_iters, &n_iters, &vec};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(kThreads), args,
                                          smem, stream);
}

// The matvec phase alone: marg = (M @ b) * b for the active matrices.
extern "C" int ice_matvec(const void* M, const float* b, const int* active,
                          float* marg, int C, int N, int bf16,
                          cudaStream_t stream) {
  if (C < 1 || C > kMaxBatch || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * (bf16 ? 2 : 1) * N * sizeof(float);
  int sms;
  int rc = sm_count(&sms);
  if (rc) return rc;
  const int vec = vector_path(M, N, bf16);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(ice_matvec_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ice_matvec_kernel<__nv_bfloat16><<<sms, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(M), b, active, marg, C, N, vec);
  } else {
    err = cudaFuncSetAttribute(ice_matvec_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ice_matvec_kernel<float><<<sms, kThreads, smem, stream>>>(
        static_cast<const float*>(M), b, active, marg, C, N, vec);
  }
  return (int)cudaGetLastError();
}
