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
// element.  Design, two launches:
//  * sparse_marginal_tiles: one 256-thread block per tile reads the tile
//    exactly once, a 512-byte row per warp instruction (16 bytes per lane:
//    4 f32 or 4 bf16 in 8 bytes), and produces both contributions from that
//    one read: the row sums by a warp reduction per row, the column sums in
//    registers (4 columns per lane) reduced across the 8 warps through
//    shared memory.  Each contribution is a 128-float partial written to
//    its own slot of a scratch [S, T], S = 2K - (diagonal tiles): no two
//    blocks write one address, so nothing is atomic.
//  * sparse_marginal_reduce: one 128-thread block per block row sums that
//    row's slots, which the order (kernels/sparse_marginal.py,
//    sparse_marginal_order) lays out contiguously by (block row, tile), one
//    after the other from 0.  Every y entry is thus a sum in one order that
//    depends only on brow and bcol: the same bits on every run.  y is
//    written whole, so the wrapper does not zero it.
// The partials add 2 S T 4 bytes (~17 MB at hg19 10 kb, ~3% of the tiles).
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

// slots [2, K]: slots[k] is tile k's row-partial slot, slots[K + k] its
// column-partial slot (unused for a diagonal tile)
template <typename Tile, bool kRound>
__global__ void __launch_bounds__(32 * kWarps)
sparse_marginal_tiles(const Tile* __restrict__ tiles,
                      const int* __restrict__ brow,
                      const int* __restrict__ bcol,
                      const int* __restrict__ slots,
                      const float* __restrict__ x,
                      float* __restrict__ part, int K) {
  __shared__ float col_part[kWarps][kT];
  __shared__ float row_part[kT];
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
    if (lane == 0) row_part[r] = p;
    cc[0] = fmaf(v.x, xr, cc[0]);
    cc[1] = fmaf(v.y, xr, cc[1]);
    cc[2] = fmaf(v.z, xr, cc[2]);
    cc[3] = fmaf(v.w, xr, cc[3]);
  }
  const bool off = br != bc;  // a diagonal tile is stored full: row term only
  if (off) {
#pragma unroll
    for (int q = 0; q < 4; ++q) col_part[warp][4 * lane + q] = cc[q];
  }
  __syncthreads();
  // threads 0..127 store the row partial, 128..255 the column partial:
  // 512 contiguous bytes each
  if (threadIdx.x < kT) {
    part[(size_t)slots[k] * kT + threadIdx.x] = row_part[threadIdx.x];
  } else if (off) {
    const int c = threadIdx.x - kT;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += col_part[w][c];
    part[(size_t)slots[K + k] * kT + c] = s;
  }
}

// y[r, :] = sum of part[row_ptr[r] .. row_ptr[r+1]), added in slot order
__global__ void __launch_bounds__(kT)
sparse_marginal_reduce(const float* __restrict__ part,
                       const int* __restrict__ row_ptr,
                       float* __restrict__ y) {
  const int r = blockIdx.x, c = threadIdx.x;
  const int lo = row_ptr[r], hi = row_ptr[r + 1];
  const float* p = part + (size_t)lo * kT + c;
  float acc = 0.f;
  int i = 0;
  // loads four slots ahead of the adds, which stay in order
  for (; i + 4 <= hi - lo; i += 4) {
    const float a = __ldcs(p + (size_t)i * kT);
    const float b = __ldcs(p + (size_t)(i + 1) * kT);
    const float d = __ldcs(p + (size_t)(i + 2) * kT);
    const float e = __ldcs(p + (size_t)(i + 3) * kT);
    acc += a;
    acc += b;
    acc += d;
    acc += e;
  }
  for (; i < hi - lo; ++i) acc += __ldcs(p + (size_t)i * kT);
  y[(size_t)r * kT + c] = acc;
}

}  // namespace

extern "C" int sparse_marginal(const void* tiles, const int* brow,
                               const int* bcol, const int* slots,
                               const int* row_ptr, const float* x,
                               float* part, float* y, int K, int R, int T,
                               int bf16, cudaStream_t stream) {
  if (T != kT) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    const dim3 block(32 * kWarps);
    if (bf16)
      sparse_marginal_tiles<__nv_bfloat16, true><<<K, block, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(tiles), brow, bcol, slots, x,
          part, K);
    else
      sparse_marginal_tiles<float, false><<<K, block, 0, stream>>>(
          static_cast<const float*>(tiles), brow, bcol, slots, x, part, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0)
    sparse_marginal_reduce<<<R, kT, 0, stream>>>(part, row_ptr, y);
  return (int)cudaGetLastError();
}
