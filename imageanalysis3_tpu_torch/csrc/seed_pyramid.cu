// Pyramid-background seeding classifier: fg blur + bg upsample + 3^3 max
// stencil + threshold-level classification, one pass over the stack.
//
// Replaces: imageanalysis3_tpu/ops/pallas_kernels.py,
// fused_seed_classify_pyramid (kernel body _pyramid_stencil_kernel).  The
// host prep (4x4 mean pool, bg blur, plateau sentinel) stays in PyTorch
// (ops/seed_kernels.py pyramid_background); this kernel takes the corrected
// stack im (Z, X, Y) f32 and the pooled, blurred, sentinel-marked bg
// (Z, X/4, Y/4) f32, and writes
//   qdiff (Z, X, Y) f32  = fg - bg where the voxel qualifies, else -inf
//   counts (n_lvl,) int32 = qualifying voxels per threshold-decay level,
// where fg is the separable Gaussian blur of im (scipy 'reflect' on every
// axis, repeated reflection for thin stacks), bg is the half-pixel bilinear
// 4x upsample of the pooled bg (edge-clamped: the TPU kernel's two lead-in
// edge rows and columns), a voxel qualifies when fg equals the max of its
// in-range 3^3 neighbourhood and it lies inside the edge margin
// (d <= i <= n - d on every axis), and level = clip(ceil((1 - diff/th) n),
// 0, n).
//
// Arithmetic is written with __fmul_rn/__fadd_rn in the order of the plain
// version (fused_seed_classify_pyramid_plain): taps summed in tap order, the
// y interpolation before the x interpolation.  Neither side contracts to
// FMA, so kernel and plain version agree bit for bit on fg, bg and qdiff.
//
// What bounds it on an H100: device-memory bytes.  At 60x2048x2048 it must
// read the 1.007 GB stack and the 63 MB pooled bg and write the 1.007 GB
// qdiff (~2.08 GB, ~0.62 ms at 3.35 TB/s); its ~76 flop per voxel
// (~19 GFLOP) need ~0.29 ms at 67 TFLOP/s f32.  What the design does about
// it: the blurred fg and the upsampled bg never reach device memory.  One
// block owns a 16x64 (x, y) tile and walks z: each step z-blurs the tile
// plus halo, x- and y-blurs it in shared memory into a 3-plane ring, and
// emits the previous plane's stencil, classification and qdiff.  The TPU
// kernel's sequential grid becomes the loop inside the block; its per-block
// histogram becomes a shared-memory histogram added to `counts` with
// atomics at the end.  For fg radius <= 3 (the default sigma 0.75) each
// thread keeps the 2r+1 raw planes of its z-pass positions in registers
// and loads one new plane per step, prefetched before the step's
// arithmetic, so a block reads each raw voxel of its tile once; larger
// radii z-blur from L1/L2 with 2r+1 reads per voxel (the generic kernel).
// Remaining known cost: neighbouring blocks re-read the (r+1)-wide halo.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;        // core x rows per block
constexpr int TY = 64;        // core y columns per block
constexpr int NTHREADS = 256;
constexpr int MAX_R = 12;     // largest fg kernel radius
constexpr int WINDOW_R = 3;   // largest radius of the register z-window
constexpr int MAX_LVL = 128;

// scipy 'reflect' (symmetric: 1,0|0,1), repeated for radius > n, as
// filters._map_boundary_index
__device__ __forceinline__ int reflect_index(int i, int n) {
  for (int it = 0; it < 64; ++it) {
    if (i >= 0 && i < n) return i;
    i = (i < 0) ? -i - 1 : 2 * n - 1 - i;
  }
  return min(max(i, 0), n - 1);
}

__host__ __device__ inline size_t smem_floats(int r) {
  const int hx = TX + 2 + 2 * r, hy = TY + 2 + 2 * r;
  return (size_t)hx * hy + (size_t)(TX + 2) * hy + 3 * (size_t)(TX + 2) * (TY + 2) +
         32 + MAX_LVL;
}

// half-pixel bilinear source of fine index g on a 4x-pooled axis of n cells:
// pooled coordinate (g + 0.5)/4 - 0.5, indices edge-clamped; weights are
// multiples of 1/8 and exact in f32
__device__ __forceinline__ void bilinear(int g, int n, int& i0, int& i1,
                                         float& w0, float& w1) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn((float)g, 0.5f), 0.25f), 0.5f);
  const float f = floorf(s);
  w1 = __fsub_rn(s, f);
  w0 = __fsub_rn(1.0f, w1);
  const int i = (int)f;
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
}

struct Args {
  const float* __restrict__ im;
  const float* __restrict__ bgs;
  const float* __restrict__ taps;
  float* __restrict__ qdiff;
  int* __restrict__ counts;
  int nz, nx, ny, r;
  float th;
  int n_lvl, edge;
};

// Shared-memory layout of one block: z-passed tile + halo, x-passed rows,
// the 3-plane fg ring, the taps and the level histogram.
struct Tile {
  float* zp;
  float* xp;
  float* ring;
  float* taps;
  int* hist;
  int k, HX, HY, RX, RY, x0, y0;

  __device__ Tile(float* smem, int r) {
    k = 2 * r + 1;
    HX = TX + 2 + 2 * r;   // z-passed rows (tile + 1 + r halo)
    HY = TY + 2 + 2 * r;   // z-passed / x-passed columns
    RX = TX + 2;           // fg ring plane (tile + 1 halo)
    RY = TY + 2;
    zp = smem;
    xp = zp + HX * HY;
    ring = xp + RX * HY;
    taps = ring + 3 * RX * RY;
    hist = reinterpret_cast<int*>(taps + 32);
    x0 = blockIdx.y * TX;
    y0 = blockIdx.x * TY;
  }
};

__device__ void load_taps_and_clear(const Tile& t, const Args& a) {
  for (int i = threadIdx.x; i < t.k; i += NTHREADS) t.taps[i] = a.taps[i];
  for (int i = threadIdx.x; i < a.n_lvl; i += NTHREADS) t.hist[i] = 0;
}

// x-pass of the z-passed tile (ring row i <-> global x0 - 1 + i reads zp
// rows i .. i + 2r), then y-pass into ring slot `slot` (col j <-> global
// y0 - 1 + j); ends synchronised.
__device__ void blur_xy(const Tile& t, int slot) {
  for (int e = threadIdx.x; e < t.RX * t.HY; e += NTHREADS) {
    const int i = e / t.HY, j = e - i * t.HY;
    const float* src = t.zp + i * t.HY + j;
    float acc = __fmul_rn(t.taps[0], src[0]);
    for (int u = 1; u < t.k; ++u)
      acc = __fadd_rn(acc, __fmul_rn(t.taps[u], src[u * t.HY]));
    t.xp[e] = acc;
  }
  __syncthreads();
  float* dst = t.ring + slot * t.RX * t.RY;
  for (int e = threadIdx.x; e < t.RX * t.RY; e += NTHREADS) {
    const int i = e / t.RY, j = e - i * t.RY;
    const float* src = t.xp + i * t.HY + j;
    float acc = __fmul_rn(t.taps[0], src[0]);
    for (int u = 1; u < t.k; ++u) acc = __fadd_rn(acc, __fmul_rn(t.taps[u], src[u]));
    dst[e] = acc;
  }
  __syncthreads();
}

// stencil, bg upsample, classification and qdiff of plane zc from ring
// planes zc - 1, zc, zc + 1
__device__ void emit(const Tile& t, const Args& a, int zc) {
  const int plane_rr = t.RX * t.RY;
  const float* cur = t.ring + (zc % 3) * plane_rr;
  const float* prv = zc > 0 ? t.ring + ((zc + 2) % 3) * plane_rr : nullptr;
  const float* nxt = zc + 1 < a.nz ? t.ring + ((zc + 1) % 3) * plane_rr : nullptr;
  const int xs = a.nx / 4, ys = a.ny / 4;
  const float* bplane = a.bgs + (size_t)zc * xs * ys;
  const size_t plane = (size_t)a.nx * a.ny;
  const bool z_ok = zc >= a.edge && zc <= a.nz - a.edge;
  const float nl = (float)a.n_lvl;
  for (int e = threadIdx.x; e < TX * TY; e += NTHREADS) {
    const int i = e / TY, j = e - i * TY;
    const int gx = t.x0 + i, gy = t.y0 + j;
    if (gx >= a.nx || gy >= a.ny) continue;
    const int o = (i + 1) * t.RY + (j + 1);
    const float fg = cur[o];
    float m = fg;
    for (int dx = -1; dx <= 1; ++dx) {
      if (gx + dx < 0 || gx + dx >= a.nx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        if (gy + dy < 0 || gy + dy >= a.ny) continue;
        const int oo = o + dx * t.RY + dy;
        m = fmaxf(m, cur[oo]);
        if (prv) m = fmaxf(m, prv[oo]);
        if (nxt) m = fmaxf(m, nxt[oo]);
      }
    }
    const bool qualify = (m == fg) && z_ok && gx >= a.edge &&
                         gx <= a.nx - a.edge && gy >= a.edge && gy <= a.ny - a.edge;
    int ix0, ix1, iy0, iy1;
    float wx0, wx1, wy0, wy1;
    bilinear(gx, xs, ix0, ix1, wx0, wx1);
    bilinear(gy, ys, iy0, iy1, wy0, wy1);
    const float t0 = __fadd_rn(__fmul_rn(__ldg(bplane + (size_t)ix0 * ys + iy0), wy0),
                               __fmul_rn(__ldg(bplane + (size_t)ix0 * ys + iy1), wy1));
    const float t1 = __fadd_rn(__fmul_rn(__ldg(bplane + (size_t)ix1 * ys + iy0), wy0),
                               __fmul_rn(__ldg(bplane + (size_t)ix1 * ys + iy1), wy1));
    const float bg = __fadd_rn(__fmul_rn(t0, wx0), __fmul_rn(t1, wx1));
    const float diff = __fsub_rn(fg, bg);
    a.qdiff[(size_t)zc * plane + (size_t)gx * a.ny + gy] = qualify ? diff : -INFINITY;
    if (qualify) {
      const float frac = __fsub_rn(1.0f, __fdiv_rn(diff, a.th));
      const float lv = fminf(fmaxf(ceilf(__fmul_rn(frac, nl)), 0.0f), nl);
      const int level = (int)lv;
      if (level < a.n_lvl) atomicAdd(&t.hist[level], 1);
    }
  }
}

__device__ void flush_hist(const Tile& t, const Args& a) {
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_lvl; i += NTHREADS)
    if (t.hist[i]) atomicAdd(&a.counts[i], t.hist[i]);
}

// Generic radius: the z-pass reads its 2r+1 raw planes through L1/L2.
__global__ void __launch_bounds__(NTHREADS) seed_pyramid_kernel(Args a) {
  extern __shared__ float smem[];
  const Tile t(smem, a.r);
  load_taps_and_clear(t, a);
  const size_t plane = (size_t)a.nx * a.ny;
  __syncthreads();
  for (int step = 0; step <= a.nz; ++step) {
    if (step < a.nz) {
      for (int e = threadIdx.x; e < t.HX * t.HY; e += NTHREADS) {
        const int i = e / t.HY, j = e - i * t.HY;
        const int gx = reflect_index(t.x0 - 1 - a.r + i, a.nx);
        const int gy = reflect_index(t.y0 - 1 - a.r + j, a.ny);
        const float* col = a.im + (size_t)gx * a.ny + gy;
        float acc = __fmul_rn(t.taps[0],
                              __ldg(col + (size_t)reflect_index(step - a.r, a.nz) * plane));
        for (int u = 1; u < t.k; ++u)
          acc = __fadd_rn(acc, __fmul_rn(t.taps[u],
                __ldg(col + (size_t)reflect_index(step + u - a.r, a.nz) * plane)));
        t.zp[e] = acc;
      }
      __syncthreads();
      blur_xy(t, step % 3);
    }
    if (step >= 1) emit(t, a, step - 1);
  }
  flush_hist(t, a);
}

// Radius R <= WINDOW_R: each thread owns z-pass positions e = tid + m *
// NTHREADS and keeps their raw planes step - R .. step + R in registers.
template <int R>
__global__ void __launch_bounds__(NTHREADS) seed_pyramid_window_kernel(Args a) {
  constexpr int K = 2 * R + 1;
  constexpr int HX = TX + 2 + 2 * R, HY = TY + 2 + 2 * R;
  constexpr int NPOS = HX * HY;
  constexpr int M = (NPOS + NTHREADS - 1) / NTHREADS;
  extern __shared__ float smem[];
  const Tile t(smem, R);
  load_taps_and_clear(t, a);
  const size_t plane = (size_t)a.nx * a.ny;
  float tp[K];
#pragma unroll
  for (int u = 0; u < K; ++u) tp[u] = a.taps[u];
  int off[M];
  float win[M][K];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int e = threadIdx.x + m * NTHREADS;
    const int i = e / HY, j = e - i * HY;
    off[m] = e < NPOS ? reflect_index(t.x0 - 1 - R + i, a.nx) * a.ny +
                            reflect_index(t.y0 - 1 - R + j, a.ny)
                      : 0;
#pragma unroll
    for (int u = 0; u < K; ++u)
      win[m][u] = __ldg(a.im + (size_t)reflect_index(u - R, a.nz) * plane + off[m]);
  }
  __syncthreads();
  for (int step = 0; step <= a.nz; ++step) {
    if (step < a.nz) {
      // prefetch raw plane step + 1 + R before this step's arithmetic
      float nxt[M];
      const float* pn = a.im + (size_t)reflect_index(step + 1 + R, a.nz) * plane;
#pragma unroll
      for (int m = 0; m < M; ++m) nxt[m] = __ldg(pn + off[m]);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int e = threadIdx.x + m * NTHREADS;
        float acc = __fmul_rn(tp[0], win[m][0]);
#pragma unroll
        for (int u = 1; u < K; ++u) acc = __fadd_rn(acc, __fmul_rn(tp[u], win[m][u]));
        if (e < NPOS) t.zp[e] = acc;
#pragma unroll
        for (int u = 0; u < K - 1; ++u) win[m][u] = win[m][u + 1];
        win[m][K - 1] = nxt[m];
      }
      __syncthreads();
      blur_xy(t, step % 3);
    }
    if (step >= 1) emit(t, a, step - 1);
  }
  flush_hist(t, a);
}

}  // namespace

extern "C" int seed_pyramid_launch(const void* im, const void* bgs,
                                   const void* taps, void* qdiff, void* counts,
                                   int nz, int nx, int ny, int r, float th,
                                   int n_lvl, int edge, void* stream) {
  if (nz < 1 || nx < 4 || ny < 4 || nx % 4 || ny % 4 || r < 0 || r > MAX_R ||
      n_lvl < 1 || n_lvl > MAX_LVL || (nx + TX - 1) / TX > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(im), static_cast<const float*>(bgs),
               static_cast<const float*>(taps), static_cast<float*>(qdiff),
               static_cast<int*>(counts), nz, nx, ny, r, th, n_lvl, edge};
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX);
  const size_t smem = smem_floats(r) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 0: seed_pyramid_window_kernel<0><<<grid, NTHREADS, smem, s>>>(a); break;
    case 1: seed_pyramid_window_kernel<1><<<grid, NTHREADS, smem, s>>>(a); break;
    case 2: seed_pyramid_window_kernel<2><<<grid, NTHREADS, smem, s>>>(a); break;
    case WINDOW_R: seed_pyramid_window_kernel<WINDOW_R><<<grid, NTHREADS, smem, s>>>(a); break;
    default: seed_pyramid_kernel<<<grid, NTHREADS, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
