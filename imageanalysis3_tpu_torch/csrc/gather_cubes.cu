// Pixel gathers of the Gaussian fit: the (sz, sx, sy) cube of a f32
// (Z, X, Y) stack at each of N origins, and the fit's in-ball pixels of
// each of N seeds, written directly.
//
// Replaces: scripts/ab_gather2.py, gather_aligned (kernel body
// _aligned_kernel), the Pallas form of the cube step of
// imageanalysis3_tpu/ops/gaussian_fit.py gather_blocks (its vmapped
// dynamic_slice).  Two entries:
//
// gather_cubes_launch: im (Z, X, Y) f32 and origins (N, 3) int32 ->
//   out (N, sz, sx, sy) f32, out[n, a, b, c] = im[oz + a, ox + b, oy + c]
//   where (oz, ox, oy) is origins[n] clipped into [0, dim - side] per axis.
// gather_ball_launch: im, the seeds (N, 3) (f32, converted to int32 as
//   XLA's astype(int32) converts, or int32: the integer positions base) and
//   the ball offsets offs (P, 3) int32 of radius r -> what gather_blocks
//   packs out of those cubes, with no cube array:
//     pixels (N, P) f32 = im[origin + clip(pos - origin, 0, side - 1)]
//     coords (N, P, 3) f32 = pos = base + offs
//     inb    (N, P) bool  = 0 <= pos < (Z, X, Y) on every axis
//   with origin = base - r clipped as above and every sum in int32,
//   wrapping, as in the JAX package (gaussian_fit.py:394-409): every
//   in-bounds ball pixel reads its own voxel, an out-of-bounds one the same
//   cube voxel as the JAX package, also for seeds saturated at the int32
//   range (gather_blocks converts non-finite centres so).
// Both clip every origin themselves, so they never read outside the stack
// whatever the origins hold.
//
// What bounds them on an H100: device-memory bytes, each value read once
// and written once (cubes: 2048 of 10^3 voxels, 16.4 MB, ~5 us at 3.35
// TB/s; ball: 2048 seeds x 512 pixels, 4 bytes read and 17 written a
// pixel, 21.5 MB, ~6.4 us); at that size a launch costs about as much as
// the copy.  What the design does about it: one launch (for the ball entry
// the seed conversion too, so gather_blocks is this launch alone); the
// output's elements flattened over the threads, four a thread, each step of
// the threads on consecutive elements, so every store is coalesced and a
// thread's four loads are in flight together (its cube or seed found by a
// multiply-shift division; the origin loads hit L1, which the elements of
// one cube or seed share); plain loads and stores, no staging.  A warp per
// cube or seed (eight a block, origins read once, rows spread over the
// lanes) measured slower, 0.0277 ms for 2048 cubes of 10^3 on an NVIDIA
// H100 80GB HBM3 at 700 W (one block per cube: 0.0179): each lane's chain
// of 16 to 34 dependent steps left too few loads in flight.  The TPU
// kernel's (8, 128)-aligned (sz, 24, 256) DMA windows and its two
// pltpu.rolls exist only because Mosaic needs aligned HBM slices; a CUDA
// thread loads any address, so they are not carried over.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int ITEMS = 4;   // elements a thread: loads issued together

struct Dims {
  int nz, nx, ny;
  int sz, sx, sy;
};

// floor(x / d) for 0 <= x < 2^31 by a multiply and a shift (Granlund and
// Montgomery's round-up method, as PyTorch's IntDivider): s = ceil(log2 d),
// m = 2^32 (2^s - d) / d + 1; then t = mulhi(x, m) <= x and t + x < 2^32
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ int operator()(int x) const {
    return (int)((__umulhi((unsigned)x, m) + (unsigned)x) >> s);
  }
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = (((uint64_t)1 << 32) * ((1ull << s) - d)) / d + 1;
  return {d, (unsigned)m, s};
}

// the origin o of a cube clipped into [0, dim - side] on each axis
__device__ __forceinline__ void clip_origin(const int (&o)[3], const Dims& d,
                                            int (&out)[3]) {
  out[0] = min(max(o[0], 0), d.nz - d.sz);
  out[1] = min(max(o[1], 0), d.nx - d.sx);
  out[2] = min(max(o[2], 0), d.ny - d.sy);
}

__device__ __forceinline__ size_t offset(const Dims& d, int z, int x, int y) {
  return ((size_t)z * d.nx + x) * d.ny + y;
}

// element k of this thread: ITEMS strided elements of a block's NT * ITEMS
// consecutive ones, so each step of the threads is coalesced
__device__ __forceinline__ int element(int k) {
  return blockIdx.x * (NT * ITEMS) + k * NT + threadIdx.x;
}

// out[c, a, b, e] = im[oz + a, ox + b, oy + e], element t of cube c
__global__ void __launch_bounds__(NT)
    gather_cubes_kernel(const float* __restrict__ im,
                        const int* __restrict__ origins,
                        float* __restrict__ out, int total, Dims d,
                        FastDiv div_vol, FastDiv div_plane, FastDiv div_sy) {
  size_t src[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = min(element(k), total - 1);
    const int c = div_vol(e), t = e - c * (int)div_vol.d;
    const int a = div_plane(t), u = t - a * (int)div_plane.d;
    const int b = div_sy(u), w = u - b * d.sy;
    const int o0[3] = {__ldg(origins + 3 * c), __ldg(origins + 3 * c + 1),
                       __ldg(origins + 3 * c + 2)};
    int o[3];
    clip_origin(o0, d, o);
    src[k] = offset(d, o[0] + a, o[1] + b, o[2] + w);
  }
  float v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) v[k] = __ldg(im + src[k]);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (element(k) < total) out[element(k)] = v[k];
}

// a + b and a - b in int32, wrapping as XLA's int32 arithmetic does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// astype(int32) as XLA converts a float: NaN to 0, truncation toward zero,
// out-of-range values saturated
__device__ __forceinline__ int to_int32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return (int)x;
}

// pixel q of seed s, element e = s * p + q
__global__ void __launch_bounds__(NT)
    gather_ball_kernel(const float* __restrict__ im,
                       const void* __restrict__ seeds, bool seeds_f32,
                       const int* __restrict__ offs,
                       float* __restrict__ pixels, float* __restrict__ coords,
                       bool* __restrict__ inb, int total, FastDiv div_p,
                       int r, Dims d) {
  const int side[3] = {d.sz, d.sx, d.sy};
  int pos[ITEMS][3];
  size_t src[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = min(element(k), total - 1);
    const int s = div_p(e), q = e - s * (int)div_p.d;
    int b[3], lo[3], o[3];
    for (int a = 0; a < 3; ++a) {
      b[a] = seeds_f32
                 ? to_int32(__ldg(static_cast<const float*>(seeds) + 3 * s + a))
                 : __ldg(static_cast<const int*>(seeds) + 3 * s + a);
      lo[a] = wrap_sub(b[a], r);
      pos[k][a] = wrap_add(b[a], __ldg(offs + 3 * q + a));
    }
    clip_origin(lo, d, o);
    int rel[3];
    for (int a = 0; a < 3; ++a)
      rel[a] = o[a] + min(max(wrap_sub(pos[k][a], o[a]), 0), side[a] - 1);
    src[k] = offset(d, rel[0], rel[1], rel[2]);
  }
  float v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) v[k] = __ldg(im + src[k]);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = element(k);
    if (e >= total) break;
    const int* p = pos[k];
    pixels[e] = v[k];
    coords[3 * (size_t)e] = (float)p[0];
    coords[3 * (size_t)e + 1] = (float)p[1];
    coords[3 * (size_t)e + 2] = (float)p[2];
    inb[e] = p[0] >= 0 && p[0] < d.nz && p[1] >= 0 && p[1] < d.nx &&
             p[2] >= 0 && p[2] < d.ny;
  }
}

bool dims_ok(const Dims& d) {
  return d.nz >= 1 && d.nx >= 1 && d.ny >= 1 && d.sz >= 1 && d.sx >= 1 &&
         d.sy >= 1 && d.sz <= d.nz && d.sx <= d.nx && d.sy <= d.ny;
}

// elements one launch takes: an int index, and the last block's padding
bool total_ok(int64_t total) {
  return total <= (int64_t)INT_MAX - NT * ITEMS;
}

unsigned blocks_for(int total) {
  return (unsigned)((total + NT * ITEMS - 1) / (NT * ITEMS));
}

}  // namespace

extern "C" int gather_cubes_launch(const void* im, const void* origins,
                                   void* out, int n, int nz, int nx, int ny,
                                   int sz, int sx, int sy, void* stream) {
  const Dims d{nz, nx, ny, sz, sx, sy};
  const int64_t vol = (int64_t)sz * sx * sy;
  if (n < 0 || !dims_ok(d) || !total_ok(vol * n))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int total = (int)(vol * n);
  gather_cubes_kernel<<<blocks_for(total), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(im), static_cast<const int*>(origins),
      static_cast<float*>(out), total, d, fast_div((unsigned)vol),
      fast_div((unsigned)(sx * sy)), fast_div((unsigned)sy));
  return (int)cudaGetLastError();
}

// seeds: (N, 3) f32 (converted as XLA's astype(int32)) if seeds_f32, else
// int32; offs: the P ball offsets of radius r (ops/gather_kernel.py
// ball_offsets), each in [-r, r) per axis; sides: the cube sides
// min(2r, dim)
extern "C" int gather_ball_launch(const void* im, const void* seeds,
                                  int seeds_f32, const void* offs,
                                  void* pixels, void* coords, void* inb,
                                  int n, int p, int r, int nz, int nx, int ny,
                                  int sz, int sx, int sy, void* stream) {
  const Dims d{nz, nx, ny, sz, sx, sy};
  if (n < 0 || p < 1 || r < 1 || !dims_ok(d) || sz > 2 * r || sx > 2 * r ||
      sy > 2 * r || !total_ok((int64_t)n * p))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int total = n * p;
  gather_ball_kernel<<<blocks_for(total), NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(im), seeds, seeds_f32 != 0,
      static_cast<const int*>(offs), static_cast<float*>(pixels),
      static_cast<float*>(coords), static_cast<bool*>(inb), total,
      fast_div((unsigned)p), r, d);
  return (int)cudaGetLastError();
}

// resident blocks per SM and threads per block of the cube (ball = 0) or
// ball (ball = 1) entry's kernel, as the card grants them
extern "C" int gather_cubes_occupancy(int ball, int* blocks, int* threads) {
  *threads = NT;
  return (int)(ball ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, gather_ball_kernel, NT, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, gather_cubes_kernel, NT, 0));
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
