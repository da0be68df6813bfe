// Shared device code of the exact seeding kernels (level_stencil.cu,
// dual_blur.cu, seed_classify.cu): the scipy 'reflect' index map, the
// separable x+y Gaussian pass of one plane window in shared memory (run-time
// tap count, and the register-blocked passes of a compile-time one), and the
// 3^3 stencil + threshold-level classification of one voxel from a running
// ring of the planes it has seen.
//
// Every product and sum is written with __fmul_rn/__fadd_rn in the plain
// PyTorch versions' order (ops/seed_kernels.py: taps in order, the x pass
// before the y pass, filters._shift_add), so no FMA contraction differs and
// kernel and plain version agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ia3 {

constexpr int MAX_RADIUS = 36;               // largest Gaussian radius taken
constexpr int MAX_TAPS = 2 * MAX_RADIUS + 1;
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

// Stage the sr x sc raw window whose first element is global (x_lo, y_lo)
// in S (row stride sc), reflected at the plane's edges: warps take rows,
// lanes take columns, and a window inside the plane skips the reflection.
// Starts and ends synchronised.
template <int NT>
__device__ __forceinline__ void stage_window(const float* __restrict__ plane,
                                             int nx, int ny, int x_lo,
                                             int y_lo, int sr, int sc,
                                             float* S) {
  constexpr int NW = NT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (x_lo >= 0 && x_lo + sr <= nx && y_lo >= 0 && y_lo + sc <= ny) {
    const float* src = plane + (size_t)x_lo * ny + y_lo;
    for (int i = warp; i < sr; i += NW) {
      const float* row = src + (size_t)i * ny;
      float* dst = S + i * sc;
#pragma unroll 4
      for (int j = lane; j < sc; j += 32) dst[j] = __ldg(row + j);
    }
  } else {
    for (int i = warp; i < sr; i += NW) {
      const float* row = plane + (size_t)reflect_index(x_lo + i, nx) * ny;
      float* dst = S + i * sc;
      for (int j = lane; j < sc; j += 32)
        dst[j] = __ldg(row + reflect_index(y_lo + j, ny));
    }
  }
  __syncthreads();
}

// Separable correlation of one plane window, run-time tap count k = 2r + 1:
// x pass, then y pass, scipy 'reflect' boundaries.  Output element (i, j),
// 0 <= i < ro, 0 <= j < co, is the blurred value at global (gx0 + i,
// gy0 + j); positions outside the plane get finite values from the
// reflected data and are the caller's to ignore.  S holds the raw window,
// XP the ro x (co + 2r) x-passed rows; store(i, j, value) receives every
// output.  Starts and ends synchronised.
template <int NT, class Store>
__device__ __forceinline__ void blur_plane(const float* __restrict__ plane,
                                           int nx, int ny, int gx0, int gy0,
                                           int ro, int co,
                                           const float* __restrict__ taps,
                                           int k, float* S, float* XP,
                                           Store store) {
  const int r = k / 2;
  const int sc = co + 2 * r;
  stage_window<NT>(plane, nx, ny, gx0 - r, gy0 - r, ro + 2 * r, sc, S);
  for (int e = threadIdx.x; e < ro * sc; e += NT) {
    const int i = e / sc, j = e - i * sc;
    const float* src = S + i * sc + j;
    float acc = __fmul_rn(src[0], taps[0]);
    for (int u = 1; u < k; ++u)
      acc = __fadd_rn(acc, __fmul_rn(src[u * sc], taps[u]));
    XP[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ro * co; e += NT) {
    const int i = e / co, j = e - i * co;
    const float* src = XP + i * sc + j;
    float acc = __fmul_rn(src[0], taps[0]);
    for (int u = 1; u < k; ++u)
      acc = __fadd_rn(acc, __fmul_rn(src[u], taps[u]));
    store(i, j, acc);
  }
  __syncthreads();
}

// The tap-ordered x pass of a compile-time K-tap blur of an RO x CO window,
// register blocked: a raw window staged in S (row stride SS >= CO + K - 1)
// and visible to the block, into the x-passed rows XP (row stride
// (CO + K - 1) | 1).  A work item computes MBX consecutive rows of one
// column from MBX + K - 1 shared loads; each output still sums its taps in
// order, so the result equals blur_plane's bit for bit.  No barrier.
template <int K, int RO, int CO, int MBX, int NT, int SS = CO + K - 1>
__device__ __forceinline__ void blur_staged_x(const float* __restrict__ taps,
                                              const float* S, float* XP) {
  static_assert(RO % MBX == 0, "blocks must tile");
  constexpr int SC = CO + K - 1;
  constexpr int XS = SC | 1;
  static_assert(SS >= SC, "raw rows hold the window");
  for (int e = threadIdx.x; e < (RO / MBX) * SC; e += NT) {
    const int g = e / SC, j = e - g * SC;
    const float* src = S + g * MBX * SS + j;
    float acc[MBX];
#pragma unroll
    for (int s = 0; s < MBX + K - 1; ++s) {
      const float v = src[s * SS];
#pragma unroll
      for (int m = 0; m < MBX; ++m) {
        const int u = s - m;
        if (u < 0 || u >= K) continue;
        const float p = __fmul_rn(v, taps[u]);
        acc[m] = u == 0 ? p : __fadd_rn(acc[m], p);
      }
    }
#pragma unroll
    for (int m = 0; m < MBX; ++m) XP[(g * MBX + m) * XS + j] = acc[m];
  }
}

// The y pass over the x-passed rows XP (row stride (CO + K - 1) | 1),
// visible to the block: a work item computes MBY consecutive columns of one
// row (neighbouring threads take neighbouring rows, hence the odd stride)
// and hands them to store(i, j0, acc), acc[m] the output at (i, j0 + m).
// No barrier.
template <int K, int RO, int CO, int MBY, int NT, class Store>
__device__ __forceinline__ void blur_staged_y(const float* __restrict__ taps,
                                              const float* XP, Store store) {
  static_assert(CO % MBY == 0, "blocks must tile");
  constexpr int XS = (CO + K - 1) | 1;
  for (int e = threadIdx.x; e < RO * (CO / MBY); e += NT) {
    const int h = e / RO, i = e - h * RO;
    const float* src = XP + i * XS + h * MBY;
    float acc[MBY];
#pragma unroll
    for (int s = 0; s < MBY + K - 1; ++s) {
      const float v = src[s];
#pragma unroll
      for (int m = 0; m < MBY; ++m) {
        const int u = s - m;
        if (u < 0 || u >= K) continue;
        const float p = __fmul_rn(v, taps[u]);
        acc[m] = u == 0 ? p : __fadd_rn(acc[m], p);
      }
    }
    store(i, h * MBY, acc);
  }
}

// shared floats blur_plane uses for a k-tap kernel on a ro x co window: the
// raw window, then the x-passed rows (odd stride)
__host__ __device__ inline int raw_window_floats(int ro, int co, int k) {
  return (ro + k - 1) * (co + k - 1);
}
__host__ __device__ inline int xpass_floats(int ro, int co, int k) {
  return ro * ((co + k - 1) | 1);
}

// Max (MAX) or min of the in-range 3x3 xy neighbourhood of ring-plane cell
// (pi, pj) (row stride ps), whose global position is (gx, gy).  Out-of-range
// neighbours are skipped: the reduction's identity, which for a 3-window
// equals scipy 'reflect' / edge replication.
template <bool MAX>
__device__ __forceinline__ float xy_reduce3(const float* P, int ps, int pi,
                                            int pj, int gx, int gy, int nx,
                                            int ny) {
  const float* c = P + pi * ps + pj;
  float m = c[0];
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    if (gx + dx < 0 || gx + dx >= nx) continue;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      if (gy + dy < 0 || gy + dy >= ny) continue;
      const float v = c[dx * ps + dy];
      m = MAX ? fmaxf(m, v) : fminf(m, v);
    }
  }
  return m;
}

// What one voxel keeps of the planes it has seen, after plane z: the max
// of the fg xy max3 over planes {z-1, z} (pm; z alone at z = 0) and plane
// z's own (cm), the same for the bg xy min3 (pn, cn), and plane z's centre
// values.  When plane z+1's reductions (mx, mn) arrive, plane z's 3^3 max
// is max(pm, mx) and its 3^3 min min(pn, mn); after the last plane they are
// pm and pn.  Max and min are exact, so the order does not matter.
struct VoxelRing {
  float pm, cm, pn, cn, fg, bg;

  __device__ __forceinline__ void start(float mx, float mn, float f,
                                        float b) {
    pm = cm = mx;
    pn = cn = mn;
    fg = f;
    bg = b;
  }
  __device__ __forceinline__ void advance(float mx, float mn, float f,
                                          float b) {
    pm = fmaxf(cm, mx);
    cm = mx;
    pn = fminf(cn, mn);
    cn = mn;
    fg = f;
    bg = b;
  }
};

struct Classified {
  float diff;
  int level;       // n_lvl where the voxel does not qualify
  bool qualify;
};

// local max = (max3(fg) == fg) & (min3(bg) != bg); qualify = local max &
// in_margin; level = clip(ceil((1 - diff/th) * n), 0, n) where it
// qualifies.
__device__ __forceinline__ Classified classify(float fg, float bg, float mx3,
                                               float mn3, bool in_margin,
                                               float th, int n_lvl) {
  Classified c;
  c.diff = __fsub_rn(fg, bg);
  c.qualify = (mx3 == fg) && (mn3 != bg) && in_margin;
  const float nl = (float)n_lvl;
  const float frac = __fsub_rn(1.0f, __fdiv_rn(c.diff, th));
  const float lv = fminf(fmaxf(ceilf(__fmul_rn(frac, nl)), 0.0f), nl);
  c.level = c.qualify ? (int)lv : n_lvl;
  return c;
}

// d <= i <= n - d on every axis (seeding.py's edge mask)
__device__ __forceinline__ bool in_margin(int gz, int gx, int gy, int nz,
                                          int nx, int ny, int d) {
  return gz >= d && gz <= nz - d && gx >= d && gx <= nx - d && gy >= d &&
         gy <= ny - d;
}

}  // namespace ia3
