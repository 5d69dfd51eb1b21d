// K2: y = M @ x for the symmetric block-sparse layout of ops/sparse.py.
//
// Replaces the Pallas kernel _marginal_kernel / block_sym_matvec_pallas
// (hichap_master_tpu/kernels/pallas_sparse_ice.py).  Tiles [K, T, T] sit at
// block coordinates brow <= bcol; every tile adds tile @ x[bcol] to block
// row brow, and an off-diagonal tile also adds tile^T @ x[brow] to block row
// bcol (diagonal tiles are stored mirrored-full and contribute once).
//
// Bound on the H100: device-memory bandwidth.  At hg19 10 kb the tiles are
// 9,484 x 128 x 128 f32 = 621 MB per matvec and the work is 4 flops per
// element.  Design: one 256-thread block per tile reads the tile exactly
// once, a 512-byte row per warp instruction (16 bytes per lane: 4 f32 or
// 4 bf16 in 8 bytes), and produces both contributions from that one read:
// the row sums by a warp reduction per row, the column sums in registers
// (4 columns per lane) reduced across the 8 warps through shared memory.
// The block-row reduction across tiles uses f32 atomicAdd into y, which
// the wrapper zeroes first: the order of the adds varies between runs, so
// results agree with the plain version to rounding, not bit for bit.
// bf16 tiles halve the stream; x is rounded to bf16 as the JAX package's
// block_sym_matvec does, and products accumulate in f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;      // tile edge the kernel is written for
constexpr int kWarps = 8;    // 256 threads per tile

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float4 load_row4(const float* tile, int r,
                                            int lane) {
  return __ldg(reinterpret_cast<const float4*>(tile + r * kT) + lane);
}

__device__ __forceinline__ float4 load_row4(const __nv_bfloat16* tile, int r,
                                            int lane) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(tile + r * kT) + lane);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename Tile, bool kRound>
__global__ void __launch_bounds__(32 * kWarps)
sparse_marginal_kernel(const Tile* __restrict__ tiles,
                       const int* __restrict__ brow,
                       const int* __restrict__ bcol,
                       const float* __restrict__ x, float* __restrict__ y) {
  __shared__ float col_part[kWarps][kT];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int br = brow[k], bc = bcol[k];
  const Tile* tile = tiles + (size_t)k * kT * kT;

  // x[bcol] for this lane's 4 columns (row contribution)
  const float4 xcv = __ldg(reinterpret_cast<const float4*>(x + (size_t)bc * kT) + lane);
  float xc[4] = {xcv.x, xcv.y, xcv.z, xcv.w};
  if (kRound) {
#pragma unroll
    for (int q = 0; q < 4; ++q) xc[q] = round_bf16(xc[q]);
  }
  float cc[4] = {0.f, 0.f, 0.f, 0.f};
  const float* xr_base = x + (size_t)br * kT;

  for (int r = warp; r < kT; r += kWarps) {
    const float4 v = load_row4(tile, r, lane);
    float xr = __ldg(xr_base + r);
    if (kRound) xr = round_bf16(xr);
    float p = v.x * xc[0];
    p = fmaf(v.y, xc[1], p);
    p = fmaf(v.z, xc[2], p);
    p = fmaf(v.w, xc[3], p);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) atomicAdd(y + (size_t)br * kT + r, p);
    cc[0] = fmaf(v.x, xr, cc[0]);
    cc[1] = fmaf(v.y, xr, cc[1]);
    cc[2] = fmaf(v.z, xr, cc[2]);
    cc[3] = fmaf(v.w, xr, cc[3]);
  }
  if (br == bc) return;  // diagonal tile: stored full, row term only
#pragma unroll
  for (int q = 0; q < 4; ++q) col_part[warp][4 * lane + q] = cc[q];
  __syncthreads();
  if (threadIdx.x < kT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += col_part[w][threadIdx.x];
    atomicAdd(y + (size_t)bc * kT + threadIdx.x, s);
  }
}

}  // namespace

extern "C" int sparse_marginal(const void* tiles, const int* brow,
                               const int* bcol, const float* x, float* y,
                               int K, int T, int bf16, cudaStream_t stream) {
  if (T != kT) return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaSuccess;
  const dim3 block(32 * kWarps);
  if (bf16)
    sparse_marginal_kernel<__nv_bfloat16, true><<<K, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(tiles), brow, bcol, x, y);
  else
    sparse_marginal_kernel<float, false><<<K, block, 0, stream>>>(
        static_cast<const float*>(tiles), brow, bcol, x, y);
  return (int)cudaGetLastError();
}
