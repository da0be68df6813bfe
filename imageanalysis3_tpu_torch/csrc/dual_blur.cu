// Separable x+y Gaussian blur of two z-passed stacks in one launch.
//
// Replaces: imageanalysis3_tpu/ops/pallas_kernels.py, dual_blur_xy_pallas
// (kernel body _dual_blur_kernel; wrapper dual_gaussian_blur, whose z pass
// stays outside the kernel as it does there).  Takes the z-passed
// foreground and background stacks fgz, bgz (Z, X, Y) f32 and their 1D
// taps, and writes fg = y(x(fgz)) and bg = y(x(bgz)) (Z, X, Y) f32 with
// scipy 'reflect' boundaries (repeated reflection for radius > n).
//
// Arithmetic: seed_common.cuh's blur_plane, taps in order with
// __fmul_rn/__fadd_rn, the x pass before the y pass, as the plain version
// (ops/seed_kernels.py dual_blur_xy_plain, filters._shift_add) computes it,
// so the two agree bit for bit.  The TPU kernel's bf16 "dot3" splits and
// its (8, 128) / 128-lane banded weight matrices are not carried over.
//
// What bounds it on an H100: device-memory bytes.  At 60x2048x2048 it must
// read and write two 1.007 GB stacks (~4.03 GB, ~1.20 ms at 3.35 TB/s);
// its (2*7 + 2*61) * 2 operations per voxel pair (~68 GOP) need ~1.02 ms
// at 67 TFLOP/s f32.  What the design does about it: one block owns one
// 32x64 (x, y) tile of one plane of one stack (grid z = 2 * Z), stages the
// tile plus its r-wide halo in shared memory, x-passes it into a second
// shared buffer, y-passes it into a staged output tile and stores that
// coalesced; each output is written once.  For the default taps (7 for fg,
// 61 for bg) the passes are register blocked (16 rows or 8 columns per thread from
// one strip of shared loads).  Known cost: the halo re-read (92x124 /
// 32x64 = 5.6x for the background's r = 30, served mostly from L2) and
// the x pass over the y halo (124 columns for 64 outputs).

#include "seed_common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 64;
constexpr int NT = 256;
constexpr int PS = TY + 1;    // odd row stride of the staged output tile
constexpr int MBX = 16;       // x-pass rows per work item
constexpr int MBY = 8;        // y-pass columns per work item

struct Args {
  const float* __restrict__ src[2];
  float* __restrict__ dst[2];
  float taps[2][ia3::MAX_TAPS];
  int k[2];
  int nz, nx, ny;
};

// the raw window, which the staged output tile (TX x PS) reuses once the x
// pass has read it, then the x-passed rows
__host__ __device__ inline int window_floats(int k) {
  const int raw = ia3::raw_window_floats(TX, TY, k);
  return raw > TX * PS ? raw : TX * PS;
}

// stack SI (0 fg, 1 bg) as a compile-time index, so that with a compiled
// tap count K every tap is a constant-bank operand
template <int K, int SI>
__device__ __forceinline__ void blur_one(const Args& a, float* S, float* XP) {
  constexpr int s = SI;
  const int z = blockIdx.z >> 1;
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)a.nx * a.ny;
  const float* src = a.src[s] + (size_t)z * plane;
  float* P = S;
  auto to_p = [&](int i, int j, float v) { P[i * PS + j] = v; };
  if constexpr (K > 0)
    ia3::blur_plane_blocked<K, TX, TY, MBX, MBY, NT>(src, a.nx, a.ny, x0, y0,
                                                      a.taps[s], S, XP, to_p);
  else
    ia3::blur_plane<NT>(src, a.nx, a.ny, x0, y0, TX, TY, a.taps[s], a.k[s], S,
                        XP, to_p);
  // coalesced store of the staged tile
  float* out = a.dst[s] + (size_t)z * plane;
  for (int e = threadIdx.x; e < TX * TY; e += NT) {
    const int i = e / TY, j = e - i * TY;
    if (x0 + i < a.nx && y0 + j < a.ny)
      out[(size_t)(x0 + i) * a.ny + y0 + j] = P[i * PS + j];
  }
}

__global__ void __launch_bounds__(NT, 2)
    dual_blur_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int s = blockIdx.z & 1;
  const int k = a.k[s];
  float* XP = smem + window_floats(k);
  if (s == 0) {
    if (k == 7) blur_one<7, 0>(a, smem, XP);
    else blur_one<0, 0>(a, smem, XP);
  } else {
    if (k == 61) blur_one<61, 1>(a, smem, XP);
    else blur_one<0, 1>(a, smem, XP);
  }
}

size_t smem_bytes(int k) {
  return sizeof(float) *
         ((size_t)window_floats(k) + (size_t)ia3::xpass_floats(TX, TY, k));
}

}  // namespace

extern "C" int dual_blur_launch(const void* fgz, const void* bgz, void* fg,
                                void* bg, const void* taps_fg, int k_fg,
                                const void* taps_bg, int k_bg, int nz, int nx,
                                int ny, void* stream) {
  if (nz < 1 || nx < 1 || ny < 1 || k_fg < 1 || k_bg < 1 ||
      k_fg > ia3::MAX_TAPS || k_bg > ia3::MAX_TAPS || k_fg % 2 == 0 ||
      k_bg % 2 == 0 || (nx + TX - 1) / TX > 65535 || 2 * nz > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.src[0] = static_cast<const float*>(fgz);
  a.src[1] = static_cast<const float*>(bgz);
  a.dst[0] = static_cast<float*>(fg);
  a.dst[1] = static_cast<float*>(bg);
  const float* tf = static_cast<const float*>(taps_fg);
  const float* tb = static_cast<const float*>(taps_bg);
  for (int u = 0; u < k_fg; ++u) a.taps[0][u] = tf[u];
  for (int u = 0; u < k_bg; ++u) a.taps[1][u] = tb[u];
  a.k[0] = k_fg;
  a.k[1] = k_bg;
  a.nz = nz;
  a.nx = nx;
  a.ny = ny;
  const size_t smem = smem_bytes(k_fg > k_bg ? k_fg : k_bg);
  cudaError_t err = cudaFuncSetAttribute(
      dual_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX, 2 * nz);
  dual_blur_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
