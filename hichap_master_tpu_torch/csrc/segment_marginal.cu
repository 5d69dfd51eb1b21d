// K7: the scattered-pixel marginal of the hybrid genome-wide layout
// (port-only kernel).
//
// Replaces _segment_sums / _scattered_marginal
// (hichap_master_tpu/ops/sparse_hybrid.py:210,259): for every row i,
//     out[i] = sum over p in [bounds[i], bounds[i+1]) of vals[p] * b[cols[p]]
// over the row-sorted directed COO of the pixels that sit outside the dense
// tiles.  The JAX package avoids scatter on the TPU with a compensated
// two-float prefix sum differenced at the row bounds; a GPU reduces each
// row directly.
//
// Bound on the H100: memory.  At hg19 10 kb the scattered part holds tens of
// millions of pixels (int32 column + f32 or uint16 count each) and every
// one gathers b[col] at random.  Design: one warp per row, the lanes
// striding over the row's pixels (coalesced column and value loads), each
// product formed and accumulated in float64, a shuffle reduction, and one
// rounding to float32 at the end: deterministic (no atomics), and equal to
// the JAX package's compensated f32 prefix to within f32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per 256-thread block

__device__ __forceinline__ double value(const float* v, int p) {
  return (double)__ldg(v + p);
}

__device__ __forceinline__ double value(const uint16_t* v, int p) {
  return (double)__ldg(reinterpret_cast<const unsigned short*>(v) + p);
}

template <typename V>
__global__ void __launch_bounds__(32 * kWarps)
segment_marginal_kernel(const int* __restrict__ cols,
                        const V* __restrict__ vals,
                        const int* __restrict__ bounds,
                        const float* __restrict__ b, float* __restrict__ out,
                        int N) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // warp-uniform
  const int s = __ldg(bounds + row), e = __ldg(bounds + row + 1);
  double acc = 0.0;
  for (int p = s + lane; p < e; p += 32)
    acc = fma(value(vals, p), (double)__ldg(b + __ldg(cols + p)), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = __double2float_rn(acc);
}

}  // namespace

extern "C" int segment_marginal(const int* cols, const void* vals,
                                const int* bounds, const float* b, float* out,
                                int N, int u16, cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  const int blocks = (N + kWarps - 1) / kWarps;
  if (u16)
    segment_marginal_kernel<uint16_t><<<blocks, 32 * kWarps, 0, stream>>>(
        cols, static_cast<const uint16_t*>(vals), bounds, b, out, N);
  else
    segment_marginal_kernel<float><<<blocks, 32 * kWarps, 0, stream>>>(
        cols, static_cast<const float*>(vals), bounds, b, out, N);
  return (int)cudaGetLastError();
}
