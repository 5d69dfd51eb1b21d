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
// one gathers b[col] at random: beside the stream from device memory, a
// 32-byte sector per pixel moves through L2.  A row holds ~64 pixels on
// average, so work split by rows leaves a thread two loads in flight.
//
// Design: the work is split by pixels.
//   1. A block takes a tile of kTile consecutive pixels.  Each thread starts
//      all of its vector loads of cols and vals (streaming, __ldcs: read
//      once), then all of its gathers of b (read-only cached path, __ldg),
//      kPer of them in flight, and leaves the float64 products in shared
//      memory.
//   2. Two binary searches of bounds give the rows that end inside the
//      tile; a loop over those rows marks each row start of the tile as a
//      segment head (bit mask in shared memory, however many empty rows lie
//      between).
//   3. A segmented inclusive scan in float64 in a fixed order (each thread
//      over kPer consecutive pixels, a shuffle scan over the warp's threads,
//      the warps in sequence) turns the products into prefix sums that
//      restart at every head.
//   4. A loop over the tile's rows reads each row's sum at its last pixel.
//      A row that lies wholly inside the tile is rounded to float32 and
//      written (0 for a row with no pixel).  A row that crosses a tile edge
//      is not rounded here: its float64 partial goes to a carry buffer with
//      its row number (two slots per block: the row that began in an
//      earlier tile and ends here, the row that goes on past the tile's
//      end), and a second, tiny launch sums each such row's partials in
//      block order and rounds once.
// So every row is float32(sum in float64) whichever path wrote it, with no
// float atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 16;  // pixels per thread: 4, 8 or 16
constexpr int kTile = kThreads * kPer;
constexpr int kUnits = kPer / 4;  // 4-pixel vector loads per thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Share of an SM's shared memory asked for: room for five blocks' tiles.
// The rest of the SM's 256 KB stays L1, which serves the gathers of b
// that hit (b is ~1.2 MB: every hit is a sector less through L2).
constexpr int kCarveout = 40;
static_assert(kPer % 4 == 0 && 32 % kPer == 0 && kPer < 32,
              "kPer must be 4, 8 or 16");
static_assert((kTile + kThreads) * sizeof(double) <= 46 * 1024,
              "the tile's products must fit in static shared memory");

// Pixel i of the tile lies at sp[slot(i)]: one double of padding after
// each thread's kPer, so that threads reading their own runs fall in
// distinct banks.
__device__ __forceinline__ int slot(int i) { return i + i / kPer; }

struct Quad {
  float v[4];
};

__device__ __forceinline__ Quad load_quad(const float* v) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(v));
  return {{x.x, x.y, x.z, x.w}};
}

__device__ __forceinline__ Quad load_quad(const uint16_t* v) {
  const ushort4 x = __ldcs(reinterpret_cast<const ushort4*>(v));
  return {{(float)x.x, (float)x.y, (float)x.z, (float)x.w}};
}

__device__ __forceinline__ float load_one(const float* v) { return __ldcs(v); }

__device__ __forceinline__ float load_one(const uint16_t* v) {
  return (float)__ldcs(reinterpret_cast<const unsigned short*>(v));
}

// One tile of pixels [k kTile, min((k + 1) kTile, P)).
//   cval [2 blocks], crow [2 blocks]: the carries.  Slot 2k holds the
//   partial of the row that ends in tile k but began before it, slot 2k + 1
//   that of the row that goes on past the tile's end; crow is the row
//   number, or -1.
//   vec: cols and vals are aligned for the vector loads.
template <typename V>
__global__ void __launch_bounds__(kThreads)
segment_tile_kernel(const int* __restrict__ cols, const V* __restrict__ vals,
                    const int* __restrict__ bounds,
                    const float* __restrict__ b, float* __restrict__ out,
                    double* __restrict__ cval, int* __restrict__ crow, int N,
                    int P, int vec) {
  __shared__ double sp[kTile + kThreads];
  __shared__ unsigned heads[kTile / 32];
  __shared__ double wtot[kWarps];
  __shared__ int wflag[kWarps];

  const int k = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  const long long start64 = (long long)k * kTile;
  const int start = (int)start64;
  const int end = (int)min(start64 + kTile, (long long)P);
  const bool full = vec && end - start == kTile;

  // 1a. this thread's columns and values, every load started before any use
  int c[kPer];
  float v[kPer];
  if (full) {
    int4 c4[kUnits];
    Quad v4[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
      c4[u] = __ldcs(reinterpret_cast<const int4*>(
          cols + start + (u * kThreads + t) * 4));
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
      v4[u] = load_quad(vals + start + (u * kThreads + t) * 4);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      c[4 * u] = c4[u].x;
      c[4 * u + 1] = c4[u].y;
      c[4 * u + 2] = c4[u].z;
      c[4 * u + 3] = c4[u].w;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[4 * u + q] = v4[u].v[q];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = start + ((i >> 2) * kThreads + t) * 4 + (i & 3);
      c[i] = p < end ? __ldcs(cols + p) : -1;
      v[i] = p < end ? load_one(vals + p) : 0.f;
    }
  }

  // 2a. the rows that end in (start, end] are [ra, rb): two searches for
  // the number of rows with bounds[r + 1] <= q, run side by side while the
  // loads above are in flight.  The first tile also takes the empty rows
  // before the first pixel, the last one those after the last pixel.
  int lo0 = 0, hi0 = N, lo1 = 0, hi1 = N;
  while (lo0 < hi0 || lo1 < hi1) {
    if (lo0 < hi0) {
      const int m = lo0 + ((hi0 - lo0) >> 1);
      if (__ldg(bounds + m + 1) <= start) lo0 = m + 1; else hi0 = m;
    }
    if (lo1 < hi1) {
      const int m = lo1 + ((hi1 - lo1) >> 1);
      if (__ldg(bounds + m + 1) <= end) lo1 = m + 1; else hi1 = m;
    }
  }
  const int ra = k == 0 ? 0 : lo0;
  const int rb = k == (int)gridDim.x - 1 ? N : lo1;

  for (int i = t; i < kTile / 32; i += kThreads) heads[i] = 0u;
  __syncthreads();

  // 1b. the gathers, all in flight together
  float bv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) bv[i] = c[i] >= 0 ? __ldg(b + c[i]) : 0.f;

  // 2b. a head at every row start inside the tile; row rb, which goes on
  // past the tile's end, may begin here too
  for (int r = ra + t; r <= rb && r < N; r += kThreads) {
    const int s = __ldg(bounds + r);
    if (s > start && s < end)
      atomicOr(&heads[(s - start) >> 5], 1u << ((s - start) & 31));
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i)
    sp[slot(((i >> 2) * kThreads + t) * 4 + (i & 3))] =
        (double)v[i] * (double)bv[i];
  __syncthreads();

  // 3. segmented inclusive scan: this thread's kPer consecutive pixels,
  // then the threads of the warp, then the warps before this one
  const unsigned hb =
      (heads[(t * kPer) >> 5] >> ((t * kPer) & 31)) & ((1u << kPer) - 1u);
  double x[kPer];
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if ((hb >> i) & 1u) run = 0.0;
    run += sp[t * (kPer + 1) + i];
    x[i] = run;
  }
  double agg = run;
  int flag = hb != 0u;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double a2 = __shfl_up_sync(kFull, agg, d);
    const int f2 = __shfl_up_sync(kFull, flag, d);
    if (lane >= d) {
      if (!flag) agg = a2 + agg;
      flag |= f2;
    }
  }
  double ea = __shfl_up_sync(kFull, agg, 1);
  int ef = __shfl_up_sync(kFull, flag, 1);
  if (lane == 0) {
    ea = 0.0;
    ef = 0;
  }
  if (lane == 31) {
    wtot[w] = agg;
    wflag[w] = flag;
  }
  __syncthreads();
  double carry = 0.0;
  for (int j = 0; j < w; ++j) carry = wflag[j] ? wtot[j] : carry + wtot[j];
  carry = ef ? ea : carry + ea;
  const int first = hb ? __ffs(hb) - 1 : kPer;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    sp[t * (kPer + 1) + i] = i < first ? carry + x[i] : x[i];
  __syncthreads();

  // 4. the rows that end here: sp at a row's last pixel is its sum from its
  // start, or from the tile's start for the row that began before it
  for (int r = ra + t; r < rb; r += kThreads) {
    const int s = __ldg(bounds + r), e = __ldg(bounds + r + 1);
    if (s >= start)
      out[r] = e > s ? __double2float_rn(sp[slot(e - 1 - start)]) : 0.f;
  }
  if (t == 0) {
    int row = -1;
    double val = 0.0;
    if (ra < rb && __ldg(bounds + ra) < start) {
      row = ra;
      val = sp[slot(__ldg(bounds + ra + 1) - 1 - start)];
    }
    crow[2 * k] = row;
    cval[2 * k] = val;
    row = -1;
    val = 0.0;
    if (rb < N && end > start && __ldg(bounds + rb) < end) {
      row = rb;
      val = sp[slot(end - 1 - start)];
    }
    crow[2 * k + 1] = row;
    cval[2 * k + 1] = val;
  }
}

// The rows that cross tile edges, one thread per tile in which such a row
// ends: its partials are the "goes on" slots of the tiles before, back to
// the tile it began in, then this tile's "ends here" slot, summed in that
// order and rounded once.
__global__ void segment_carry_kernel(const double* __restrict__ cval,
                                     const int* __restrict__ crow,
                                     float* __restrict__ out, int blocks) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= blocks) return;
  const int r = crow[2 * k];
  if (r < 0) return;
  int j = k;
  while (j > 0 && crow[2 * (j - 1) + 1] == r) --j;
  double s = 0.0;
  for (; j < k; ++j) s += cval[2 * j + 1];
  out[r] = __double2float_rn(s + cval[2 * k]);
}

template <typename V>
cudaError_t launch(const int* cols, const void* vals, const int* bounds,
                   const float* b, float* out, double* cval, int* crow, int N,
                   int P, cudaStream_t stream) {
  const int blocks = P > 0 ? (int)(((long long)P + kTile - 1) / kTile) : 1;
  const int vec = (uintptr_t)cols % 16 == 0 &&
                  (uintptr_t)vals % (4 * sizeof(V)) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      segment_tile_kernel<V>, cudaFuncAttributePreferredSharedMemoryCarveout,
      kCarveout);
  if (err != cudaSuccess) return err;
  segment_tile_kernel<V><<<blocks, kThreads, 0, stream>>>(
      cols, static_cast<const V*>(vals), bounds, b, out, cval, crow, N, P,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return err;
  segment_carry_kernel<<<(blocks + 255) / 256, 256, 0, stream>>>(cval, crow,
                                                                 out, blocks);
  return cudaGetLastError();
}

}  // namespace

// pixels per tile: the caller sizes the carries with it (cval and crow hold
// two entries per tile, at least two)
extern "C" int segment_marginal_tile() { return kTile; }

extern "C" int segment_marginal(const int* cols, const void* vals,
                                const int* bounds, const float* b, float* out,
                                double* cval, int* crow, int N, int P, int u16,
                                cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (P < 0) return (int)cudaErrorInvalidValue;
  return (int)(u16 ? launch<uint16_t>(cols, vals, bounds, b, out, cval, crow,
                                      N, P, stream)
                   : launch<float>(cols, vals, bounds, b, out, cval, crow, N,
                                   P, stream));
}
