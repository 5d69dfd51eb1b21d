// K3: the HICCUPS escalation ladder on packed band prefix maps.
//
// Replaces the Pallas kernel _ladder_kernel / escalation_pallas
// (hichap_master_tpu/kernels/pallas_escalation.py).  Maps are packed bands
// D[e, x] = M[x, x + e] turned into anti-diagonal prefix maps W (computed
// outside the kernel), on which every rectangle sum of the contact matrix
// is four reads:
//   rect(e, x; r0, r1, c0, c1) =  W[e + c1 - r0,     x + r0]
//                               - W[e + c1 - r1 - 1, x + r1 + 1]
//                               - W[e + c0 - 1 - r0, x + r0]
//                               + W[e + c0 - 2 - r1, x + r1 + 1]
// with reads outside the map returning 0 (the zero fill of
// ops/loops_packed._shift2).  For each candidate cell the kernel finds the
// first level t = w - ww, w in [ww, maxww], whose lower-left raw count is
// >= 16, writes t (127 = unresolved) and the four backgrounds at that
// level (donut and lower-left, balanced and expected), and counts t in a
// per-chromosome level histogram.  The global <10% stop level and the
// per-pixel gather stay in PyTorch (kernels/escalation.py).
//
// Bound on the H100: the Pallas kernel evaluated every level's maps on a
// VMEM tile; here one thread owns one cell and reads only what it needs:
// 8 reads per level until the cell resolves, then 64 reads for its four
// backgrounds.  At chr1 10 kb (E = 305, Xp = 25,088, ~5M candidate cells)
// that is a few hundred MB of mostly L2-resident, spatially coherent reads:
// neighbouring threads read neighbouring x.  The histogram is built in
// shared memory and flushed with one global atomic per level per block, so
// it counts distinct cells (each thread is one cell).  Arithmetic is in the
// same order as the plain map-space version, so both give identical bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnresolved = 127;
constexpr int kMaxLevels = 127;

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

__global__ void __launch_bounds__(kThreads)
ladder_kernel(const float* __restrict__ Wr, const float* __restrict__ Wb,
              const float* __restrict__ We,
              const uint8_t* __restrict__ mask, int* __restrict__ t_out,
              float* __restrict__ a0, float* __restrict__ a1,
              float* __restrict__ a2, float* __restrict__ a3,
              int* __restrict__ hist, int E, int X, int ww, int maxww,
              int pw) {
  __shared__ int sh[kMaxLevels];
  const int n_levels = maxww - ww + 1;
  for (int i = threadIdx.x; i < n_levels; i += kThreads) sh[i] = 0;
  __syncthreads();

  const int c = blockIdx.y;
  const size_t plane = (size_t)E * X;
  const size_t cell = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (cell < plane) {
    const size_t off = (size_t)c * plane;
    const int e = (int)(cell / X);
    const int x = (int)(cell - (size_t)e * X);
    int t = kUnresolved;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
    if (mask[off + cell]) {
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
    }
    t_out[off + cell] = t;
    a0[off + cell] = v0;
    a1[off + cell] = v1;
    a2[off + cell] = v2;
    a3[off + cell] = v3;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_levels; i += kThreads)
    if (sh[i]) atomicAdd(hist + (size_t)c * n_levels + i, sh[i]);
}

}  // namespace

extern "C" int escalation_ladder(const float* Wr, const float* Wb,
                                 const float* We, const uint8_t* mask,
                                 int* t_out, float* a0, float* a1, float* a2,
                                 float* a3, int* hist, int C, int E, int X,
                                 int ww, int maxww, int pw,
                                 cudaStream_t stream) {
  const int n_levels = maxww - ww + 1;
  if (n_levels < 1 || n_levels > kMaxLevels || C < 1 || E < 1 || X < 1)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)E * X;
  const dim3 grid((unsigned)((plane + kThreads - 1) / kThreads), C);
  ladder_kernel<<<grid, kThreads, 0, stream>>>(Wr, Wb, We, mask, t_out, a0,
                                               a1, a2, a3, hist, E, X, ww,
                                               maxww, pw);
  return (int)cudaGetLastError();
}
