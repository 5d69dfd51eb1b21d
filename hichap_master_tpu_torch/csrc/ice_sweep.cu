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
// Design: ice_matvec gives each row to one warp, which reads the row with
// 16-byte loads (coalesced, one 512-byte row segment per warp instruction)
// and accumulates in f32 FMAs; the batch is gridDim.y.  bf16 matrices halve
// the stream and convert per element (b is rounded to bf16 as the JAX fast
// mode does, products are exact in f32).  ice_update is one block per
// matrix: two reductions over [N] and the bias update.  A per-matrix
// `active` flag and iteration counter live on the device, so a converged
// matrix stops updating (the semantics of vmap(while_loop)) and the host
// needs to look at the flags only every few iterations.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUpdateThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void ice_matvec_f32(const float* __restrict__ M,
                               const float* __restrict__ b,
                               const int* __restrict__ active,
                               float* __restrict__ marg, int N) {
  const int c = blockIdx.y;
  if (!active[c]) return;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* bc = b + (size_t)c * N;
  const float* mr = M + ((size_t)c * N + row) * N;
  float acc = 0.f;
  if ((N & 3) == 0) {
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    const float4* b4 = reinterpret_cast<const float4*>(bc);
    for (int k = lane; k < N / 4; k += 32) {
      const float4 m = __ldg(m4 + k);
      const float4 x = __ldg(b4 + k);
      acc = fmaf(m.x, x.x, acc);
      acc = fmaf(m.y, x.y, acc);
      acc = fmaf(m.z, x.z, acc);
      acc = fmaf(m.w, x.w, acc);
    }
  } else {
    for (int j = lane; j < N; j += 32) acc = fmaf(__ldg(mr + j), __ldg(bc + j), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) marg[(size_t)c * N + row] = acc * bc[row];
}

__global__ void ice_matvec_bf16(const __nv_bfloat16* __restrict__ M,
                                const float* __restrict__ b,
                                const int* __restrict__ active,
                                float* __restrict__ marg, int N) {
  const int c = blockIdx.y;
  if (!active[c]) return;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const float* bc = b + (size_t)c * N;
  const __nv_bfloat16* mr = M + ((size_t)c * N + row) * N;
  float acc = 0.f;
  if ((N & 7) == 0) {
    const uint4* m8 = reinterpret_cast<const uint4*>(mr);
    const float4* b4 = reinterpret_cast<const float4*>(bc);
    for (int k = lane; k < N / 8; k += 32) {
      const uint4 raw = __ldg(m8 + k);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float4 x0 = __ldg(b4 + 2 * k);
      const float4 x1 = __ldg(b4 + 2 * k + 1);
      const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 m = __bfloat1622float2(h[q]);
        acc = fmaf(m.x, round_bf16(xs[2 * q]), acc);
        acc = fmaf(m.y, round_bf16(xs[2 * q + 1]), acc);
      }
    }
  } else {
    for (int j = lane; j < N; j += 32)
      acc = fmaf(__bfloat162float(mr[j]), round_bf16(__ldg(bc + j)), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) marg[(size_t)c * N + row] = acc * bc[row];
}

// Block-wide sum; every thread gets the result.  `sh` holds one slot per
// warp and is reused across calls (the trailing barrier protects it).
template <typename T>
__device__ T block_sum(T v, T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  T tot = 0;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) tot += sh[w];
  __syncthreads();
  return tot;
}

__global__ void ice_update_kernel(const float* __restrict__ marg,
                                  float* __restrict__ b,
                                  int* __restrict__ active,
                                  int* __restrict__ iters,
                                  float* __restrict__ var,
                                  float* __restrict__ scale, int N,
                                  float tol, int max_iters) {
  __shared__ float shf[kUpdateThreads / 32];
  __shared__ int shi[kUpdateThreads / 32];
  const int c = blockIdx.x;
  if (!active[c]) return;  // uniform across the block
  const float* m = marg + (size_t)c * N;
  float* bc = b + (size_t)c * N;

  float s = 0.f;
  int cnt = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = m[i];
    if (v != 0.f) { s += v; ++cnt; }
  }
  s = block_sum(s, shf);
  cnt = block_sum(cnt, shi);
  const float mean = cnt > 0 ? s / (float)cnt : 0.f;

  float q = 0.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float v = m[i];
    if (v != 0.f) { const float d = v - mean; q += d * d; }
  }
  q = block_sum(q, shf);
  const float vr = cnt > 0 ? q / (float)cnt : 0.f;

  const float denom = mean != 0.f ? mean : 1.f;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float mn = m[i] / denom;
    if (mn == 0.f) mn = 1.f;
    bc[i] = bc[i] / mn;
  }
  if (threadIdx.x == 0) {
    const int it = iters[c] + 1;
    iters[c] = it;
    var[c] = vr;
    scale[c] = mean;
    active[c] = (vr >= tol) && (it < max_iters);
  }
}

}  // namespace

extern "C" int ice_matvec(const void* M, const float* b, const int* active,
                          float* marg, int C, int N, int bf16,
                          cudaStream_t stream) {
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock, C);
  const dim3 block(32 * kWarpsPerBlock);
  if (bf16)
    ice_matvec_bf16<<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(M), b, active, marg, N);
  else
    ice_matvec_f32<<<grid, block, 0, stream>>>(
        static_cast<const float*>(M), b, active, marg, N);
  return (int)cudaGetLastError();
}

extern "C" int ice_update(const float* marg, float* b, int* active,
                          int* iters, float* var, float* scale, int C, int N,
                          float tol, int max_iters, cudaStream_t stream) {
  ice_update_kernel<<<C, kUpdateThreads, 0, stream>>>(
      marg, b, active, iters, var, scale, N, tol, max_iters);
  return (int)cudaGetLastError();
}
