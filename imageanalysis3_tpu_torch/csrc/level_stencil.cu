// 3^3 max/min stencil + threshold-level classification over two given
// blurred stacks.
//
// Replaces: imageanalysis3_tpu/ops/pallas_kernels.py, level_stencil_pallas
// (kernel body _stencil_kernel).  Takes the foreground and background
// blurred stacks mx, mn (Z, X, Y) f32 and writes
//   level (Z, X, Y) int8   = clip(ceil((1 - diff/th) n), 0, n) where the
//                            voxel qualifies, n elsewhere
//   diff  (Z, X, Y) f32    = mx - mn (every voxel)
//   counts (n_lvl,) int32  = voxels per level below n,
// where a voxel qualifies when mx equals the max of its 3^3 neighbourhood,
// mn differs from the min of its 3^3 neighbourhood, and it lies inside the
// edge margin (d <= i <= n - d on every axis).  Boundaries replicate the
// edge, which for a 3-window equals scipy 'reflect' and equals skipping the
// out-of-range neighbours (what seed_common.cuh's xy_reduce3 does).
//
// What bounds it on an H100: device-memory bytes.  At 60x2048x2048 it must
// read two 1.007 GB stacks and write 1.007 GB of diff and 0.252 GB of
// level (~3.27 GB, ~0.98 ms at 3.35 TB/s); its ~60 operations per voxel
// (~15 GOP) need ~0.23 ms at 67 TFLOP/s f32.  What the design does about
// it: each stack voxel is read from device memory about once.  One block
// owns a 32x64 (x, y) tile and walks z; each step stages the tile plus a
// 1-voxel halo of both planes in shared memory (a 1.14x re-read of the
// halo), reduces each owned voxel's 3x3 xy neighbourhood into a per-thread
// running ring (seed_common.cuh VoxelRing: six floats per voxel), and emits
// the previous plane.
// The TPU kernel's (1, 8, 128)-aligned over-fetch windows and its
// compare-reduce histogram are not carried over: the histogram is a
// shared-memory one added to `counts` with atomics at the end.

#include "seed_common.cuh"

namespace {

constexpr int TX = 32;        // core x rows per block
constexpr int TY = 64;        // core y columns per block
constexpr int NT = 256;       // threads per block
constexpr int M = TX * TY / NT;
constexpr int RX = TX + 2, RY = TY + 2;

struct Args {
  const float* __restrict__ mx;
  const float* __restrict__ mn;
  int8_t* __restrict__ level;
  float* __restrict__ diff;
  int* __restrict__ counts;
  int nz, nx, ny;
  float th;
  int n_lvl, edge;
};

__global__ void __launch_bounds__(NT, 2) level_stencil_kernel(const Args a) {
  __shared__ float pmax[RX * RY];
  __shared__ float pmin[RX * RY];
  __shared__ int hist[ia3::MAX_LVL];
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)a.nx * a.ny;
  for (int i = threadIdx.x; i < a.n_lvl; i += NT) hist[i] = 0;
  ia3::VoxelRing ring[M];

  // classify plane zc of owned voxel m and write its diff and level
  auto emit = [&](int zc, int m, float f, float b, float mx3, float mn3) {
    const int e = threadIdx.x + m * NT;
    const int gx = x0 + e / TY, gy = y0 + e % TY;
    if (gx >= a.nx || gy >= a.ny) return;
    const bool ok = ia3::in_margin(zc, gx, gy, a.nz, a.nx, a.ny, a.edge);
    const ia3::Classified c =
        ia3::classify(f, b, mx3, mn3, ok, a.th, a.n_lvl);
    const size_t o = (size_t)zc * plane + (size_t)gx * a.ny + gy;
    a.diff[o] = c.diff;
    a.level[o] = (int8_t)c.level;
    if (c.level < a.n_lvl) atomicAdd(&hist[c.level], 1);
  };

  for (int z = 0; z < a.nz; ++z) {
    const float* pm = a.mx + (size_t)z * plane;
    const float* pn = a.mn + (size_t)z * plane;
    // one flat loop over the window: its 66-wide rows would leave a third
    // of the lanes idle in a warp-per-row loop (7.8 ms against this loop's
    // 4.6 ms on an H100 at 60x2048x2048)
    for (int e = threadIdx.x; e < RX * RY; e += NT) {
      const int i = e / RY, j = e - i * RY;
      const int gx = min(max(x0 - 1 + i, 0), a.nx - 1);
      const int gy = min(max(y0 - 1 + j, 0), a.ny - 1);
      const size_t o = (size_t)gx * a.ny + gy;
      pmax[e] = __ldg(pm + o);
      pmin[e] = __ldg(pn + o);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = threadIdx.x + m * NT;
      const int i = e / TY, j = e % TY;
      const int gx = x0 + i, gy = y0 + j;
      const float mx3 = ia3::xy_reduce3<true>(pmax, RY, i + 1, j + 1, gx, gy,
                                              a.nx, a.ny);
      const float mn3 = ia3::xy_reduce3<false>(pmin, RY, i + 1, j + 1, gx,
                                               gy, a.nx, a.ny);
      const float f = pmax[(i + 1) * RY + j + 1];
      const float b = pmin[(i + 1) * RY + j + 1];
      if (z == 0) {
        ring[m].start(mx3, mn3, f, b);
      } else {
        emit(z - 1, m, ring[m].fg, ring[m].bg, fmaxf(ring[m].pm, mx3),
             fminf(ring[m].pn, mn3));
        ring[m].advance(mx3, mn3, f, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    emit(a.nz - 1, m, ring[m].fg, ring[m].bg, ring[m].pm, ring[m].pn);
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_lvl; i += NT)
    if (hist[i]) atomicAdd(&a.counts[i], hist[i]);
}

}  // namespace

extern "C" int level_stencil_launch(const void* mx, const void* mn,
                                    void* level, void* diff, void* counts,
                                    int nz, int nx, int ny, float th,
                                    int n_lvl, int edge, void* stream) {
  if (nz < 1 || nx < 1 || ny < 1 || n_lvl < 1 || n_lvl > ia3::MAX_LVL ||
      (nx + TX - 1) / TX > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(mx), static_cast<const float*>(mn),
               static_cast<int8_t*>(level), static_cast<float*>(diff),
               static_cast<int*>(counts), nz, nx, ny, th, n_lvl, edge};
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX);
  level_stencil_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
