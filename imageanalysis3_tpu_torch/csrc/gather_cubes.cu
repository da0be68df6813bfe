// Cube gather: the (sz, sx, sy) cube of a f32 (Z, X, Y) stack at each of N
// origins.
//
// Replaces: scripts/ab_gather2.py, gather_aligned (kernel body
// _aligned_kernel), the Pallas form of the cube step of
// imageanalysis3_tpu/ops/gaussian_fit.py gather_blocks (its vmapped
// dynamic_slice).  Takes im (Z, X, Y) f32 and origins (N, 3) int32 and writes
//   out (N, sz, sx, sy) f32,  out[n, a, b, c] = im[oz + a, ox + b, oy + c]
// where (oz, ox, oy) is origins[n] clipped into [0, dim - side] on each axis.
// The kernel clips every origin itself, so it never reads outside the stack
// whatever the origins hold (gather_blocks can be handed non-finite centres,
// whose integer conversion is undefined in C++).
//
// What bounds it on an H100: device-memory bytes, N*sz*sx*sy*4 read and the
// same written (2048 cubes of 10^3 voxels: 16.4 MB, ~5 us at 3.35 TB/s); at
// that size a launch costs about as much as the copy.  What the design does
// about it: one block per cube, threads walking the cube with y fastest, so
// a warp's loads fall in runs of sy contiguous floats of one row and its
// stores are contiguous; plain loads and stores, no staging.  The TPU
// kernel's (8, 128)-aligned (sz, 24, 256) DMA windows and its two
// pltpu.rolls exist only because Mosaic needs aligned HBM slices; a CUDA
// thread loads any address, so they are not carried over.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

struct Args {
  const float* im;
  const int* origins;
  float* out;
  int nz, nx, ny;
  int sz, sx, sy;
};

__device__ __forceinline__ int clip(int v, int hi) {
  return min(max(v, 0), hi);
}

__global__ void __launch_bounds__(NT) gather_cubes_kernel(const Args a) {
  const int n = blockIdx.x;
  const int oz = clip(a.origins[3 * n + 0], a.nz - a.sz);
  const int ox = clip(a.origins[3 * n + 1], a.nx - a.sx);
  const int oy = clip(a.origins[3 * n + 2], a.ny - a.sy);
  const int plane = a.sx * a.sy;
  const int vol = a.sz * plane;
  const float* src = a.im + ((size_t)oz * a.nx + ox) * a.ny + oy;
  float* dst = a.out + (size_t)n * vol;
  for (int t = threadIdx.x; t < vol; t += NT) {
    const int i = t / plane;
    const int r = t - i * plane;
    const int j = r / a.sy;
    const int k = r - j * a.sy;
    dst[t] = src[((size_t)i * a.nx + j) * a.ny + k];
  }
}

}  // namespace

extern "C" int gather_cubes_launch(const void* im, const void* origins,
                                   void* out, int n, int nz, int nx, int ny,
                                   int sz, int sx, int sy, void* stream) {
  if (n < 0 || nz < 1 || nx < 1 || ny < 1 || sz < 1 || sx < 1 || sy < 1 ||
      sz > nz || sx > nx || sy > ny ||
      (int64_t)sz * sx * sy > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Args a{static_cast<const float*>(im), static_cast<const int*>(origins),
               static_cast<float*>(out), nz, nx, ny, sz, sx, sy};
  gather_cubes_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
