// The exact seeding classifier: xy blur of both z-passed stacks + 3^3
// stencil + threshold-level classification, one pass over the stacks.
//
// Replaces: imageanalysis3_tpu/ops/pallas_kernels.py, fused_seed_classify
// (kernel body _blur_stencil_kernel).  The z pass of both stacks stays
// outside, one banded matmul (ops/seed_kernels.py z_pass_pair), as the JAX
// package's einsum does.  This kernel takes the z-passed foreground and
// background stacks fgz, bgz (Z, X, Y) f32 and their 1D taps and writes
//   qdiff (Z, X, Y) f32  = fg - bg where the voxel qualifies, else -inf
//   counts (n_lvl,) int32 = qualifying voxels per threshold-decay level,
// where fg, bg are the x+y 'reflect' blurs of fgz, bgz, a voxel qualifies
// when fg equals the max and bg differs from the min of their in-range
// 3^3 neighbourhoods (the identity-padded window reduce of seeding.py)
// and it lies inside the edge margin (d <= i <= n - d on every axis), and
// level = clip(ceil((1 - diff/th) n), 0, n).
//
// Arithmetic: seed_common.cuh's blur_plane (taps in order, x pass before
// y pass, __fmul_rn/__fadd_rn) as the plain version
// (fused_seed_classify_plain) computes it, so the blurred values, and with
// them the exact-equality plateau test min3 != bg, agree bit for bit.
//
// What bounds it on an H100: operations.  At 60x2048x2048 it must read
// the two z-passed 1.007 GB stacks and write the 1.007 GB qdiff (~3.02 GB,
// ~0.90 ms at 3.35 TB/s), and do ~330 operations per voxel (61- and 7-tap
// x and y passes, 52 stencil compares; ~83 GOP, ~1.24 ms at 67 TFLOP/s).
// What the design does about it: the blurred stacks never reach device
// memory, which is the TPU kernel's point.  One block owns a 32x64 (x, y)
// core tile and walks z (the TPU grid's sequential z ring becomes a loop
// inside the block).  Each step blurs the plane's tile plus a 1-voxel halo
// in shared memory, first bg then fg, reduces each owned voxel's 3x3 xy
// neighbourhood into a per-thread running ring (seed_common.cuh
// VoxelRing), and emits the previous plane.  For the default taps (7 and
// 61) the passes are register blocked (17 rows or 11 columns per thread
// from one strip of shared loads), so the separately rounded multiplies and
// adds, not shared-memory loads, are the work.  Known cost: the separable
// x pass covers the y halo, 34 x 126 outputs for a 32 x 64 tile (2.1x the
// core), and the raw window re-read, (34 + 60) x (66 + 60) / (32 x 64) =
// 5.8x for the background's r = 30 (1.4x for the foreground), served
// mostly from L2.  The histogram is a shared-memory one added to `counts`
// with atomics at the end.

#include "seed_common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 64;
constexpr int NT = 256;
constexpr int M = TX * TY / NT;
constexpr int RX = TX + 2, RY = TY + 2;

struct Args {
  const float* __restrict__ fgz;
  const float* __restrict__ bgz;
  float* __restrict__ qdiff;
  int* __restrict__ counts;
  float taps_fg[ia3::MAX_TAPS];
  float taps_bg[ia3::MAX_TAPS];
  int k_fg, k_bg;
  int nz, nx, ny;
  float th;
  int n_lvl, edge;
};

constexpr int PS = RY + 1;    // odd row stride of the blurred plane
constexpr int MBX = 17;       // x-pass rows per work item (RX = 2 x 17)
constexpr int MBY = 11;       // y-pass columns per work item (RY = 6 x 11)

// the raw window of the larger kernel, which the blurred plane (RX x PS)
// reuses once the x pass has read it, then the x-passed rows
__host__ __device__ inline int window_floats(int k) {
  const int raw = ia3::raw_window_floats(RX, RY, k);
  return raw > RX * PS ? raw : RX * PS;
}
__host__ __device__ inline int smem_floats(int k) {
  return window_floats(k) + ia3::xpass_floats(RX, RY, k);
}

// blur one plane's RX x RY window (tile + 1-voxel halo) into P: the
// register-blocked form for a compiled tap count K, else the run-time one
template <int K, class Store>
__device__ __forceinline__ void blur(const float* plane, const Args& a,
                                     int x0, int y0, const float* taps,
                                     int k, float* S, float* XP,
                                     Store store) {
  if constexpr (K > 0)
    ia3::blur_plane_blocked<K, RX, RY, MBX, MBY, NT>(
        plane, a.nx, a.ny, x0 - 1, y0 - 1, taps, S, XP, store);
  else
    ia3::blur_plane<NT>(plane, a.nx, a.ny, x0 - 1, y0 - 1, RX, RY, taps, k,
                        S, XP, store);
}

template <int KF, int KB>
__global__ void __launch_bounds__(NT, 2)
    seed_classify_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  __shared__ int hist[ia3::MAX_LVL];
  for (int i = threadIdx.x; i < a.n_lvl; i += NT) hist[i] = 0;
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)a.nx * a.ny;
  const int nx = a.nx, ny = a.ny;
  float* S = smem;
  float* P = smem;
  float* XP = smem + window_floats(max(a.k_fg, a.k_bg));
  auto to_p = [&](int i, int j, float v) { P[i * PS + j] = v; };
  ia3::VoxelRing ring[M];
  float mn3[M], bgc[M];

  // classify plane zc of owned voxel m and write its qdiff
  auto emit = [&](int zc, int m, float f, float b, float mx3, float mn3_) {
    const int e = threadIdx.x + m * NT;
    const int gx = x0 + e / TY, gy = y0 + e % TY;
    if (gx >= nx || gy >= ny) return;
    const bool ok = ia3::in_margin(zc, gx, gy, a.nz, nx, ny, a.edge);
    const ia3::Classified c =
        ia3::classify(f, b, mx3, mn3_, ok, a.th, a.n_lvl);
    a.qdiff[(size_t)zc * plane + (size_t)gx * ny + gy] =
        c.qualify ? c.diff : -INFINITY;
    if (c.level < a.n_lvl) atomicAdd(&hist[c.level], 1);
  };

  for (int z = 0; z < a.nz; ++z) {
    blur<KB>(a.bgz + (size_t)z * plane, a, x0, y0, a.taps_bg, a.k_bg, S, XP,
             to_p);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = threadIdx.x + m * NT;
      const int i = e / TY, j = e % TY;
      mn3[m] = ia3::xy_reduce3<false>(P, PS, i + 1, j + 1, x0 + i, y0 + j,
                                      nx, ny);
      bgc[m] = P[(i + 1) * PS + j + 1];
    }
    blur<KF>(a.fgz + (size_t)z * plane, a, x0, y0, a.taps_fg, a.k_fg, S, XP,
             to_p);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = threadIdx.x + m * NT;
      const int i = e / TY, j = e % TY;
      const float mx3 = ia3::xy_reduce3<true>(P, PS, i + 1, j + 1, x0 + i,
                                              y0 + j, nx, ny);
      const float f = P[(i + 1) * PS + j + 1];
      if (z == 0) {
        ring[m].start(mx3, mn3[m], f, bgc[m]);
      } else {
        emit(z - 1, m, ring[m].fg, ring[m].bg, fmaxf(ring[m].pm, mx3),
             fminf(ring[m].pn, mn3[m]));
        ring[m].advance(mx3, mn3[m], f, bgc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    emit(a.nz - 1, m, ring[m].fg, ring[m].bg, ring[m].pm, ring[m].pn);
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_lvl; i += NT)
    if (hist[i]) atomicAdd(&a.counts[i], hist[i]);
}

template <int KF, int KB>
int launch(const Args& a, size_t smem, dim3 grid, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      seed_classify_kernel<KF, KB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  seed_classify_kernel<KF, KB><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seed_classify_launch(const void* fgz, const void* bgz,
                                    void* qdiff, void* counts,
                                    const void* taps_fg, int k_fg,
                                    const void* taps_bg, int k_bg, int nz,
                                    int nx, int ny, float th, int n_lvl,
                                    int edge, void* stream) {
  if (nz < 1 || nx < 1 || ny < 1 || k_fg < 1 || k_bg < 1 ||
      k_fg > ia3::MAX_TAPS || k_bg > ia3::MAX_TAPS || k_fg % 2 == 0 ||
      k_bg % 2 == 0 || n_lvl < 1 || n_lvl > ia3::MAX_LVL ||
      (nx + TX - 1) / TX > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.fgz = static_cast<const float*>(fgz);
  a.bgz = static_cast<const float*>(bgz);
  a.qdiff = static_cast<float*>(qdiff);
  a.counts = static_cast<int*>(counts);
  const float* tf = static_cast<const float*>(taps_fg);
  const float* tb = static_cast<const float*>(taps_bg);
  for (int u = 0; u < k_fg; ++u) a.taps_fg[u] = tf[u];
  for (int u = 0; u < k_bg; ++u) a.taps_bg[u] = tb[u];
  a.k_fg = k_fg;
  a.k_bg = k_bg;
  a.nz = nz;
  a.nx = nx;
  a.ny = ny;
  a.th = th;
  a.n_lvl = n_lvl;
  a.edge = edge;
  const size_t smem =
      smem_floats(k_fg > k_bg ? k_fg : k_bg) * sizeof(float);
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_fg == 7 && k_bg == 61) return launch<7, 61>(a, smem, grid, s);
  return launch<0, 0>(a, smem, grid, s);
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
