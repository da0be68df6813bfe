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
// version (fused_seed_classify_pyramid_plain): taps summed in tap order
// along z, then x, then y; the y interpolation before the x interpolation.
// Neither side contracts to FMA, so kernel and plain version agree bit for
// bit on fg, bg and qdiff.  The max is exact in any order.
//
// What bounds it on an H100: device-memory bytes.  At 60x2048x2048 it must
// read the 1.007 GB stack and the 63 MB pooled bg and write the 1.007 GB
// qdiff (~2.08 GB, ~0.62 ms at 3.35 TB/s); its 39 flop per voxel need
// ~0.15 ms at 67 TFLOP/s f32.  The blurred fg and the upsampled bg never
// reach device memory: one block owns a 16x64 (x, y) tile and walks z, and
// each step z-blurs the tile plus halo, x- and y-blurs it in shared memory
// into one fg plane, and emits the previous plane.  The TPU kernel's
// sequential grid becomes the loop inside the block; its per-block
// histogram becomes a shared-memory histogram added to `counts` with
// atomics at the end.
//
// What the design does about the instruction and shared-memory budget that
// then decides the time (at the byte bound the card issues ~73 thread
// instructions a voxel; the tap-ordered blurs alone need ~54 FMUL/FADD):
//  * z pass: for fg radius <= 3 (the default sigma 0.75) each thread keeps
//    the 2r+1 raw planes of its z-pass positions in registers and loads the
//    next plane after its arithmetic, so a block reads each raw voxel of its
//    window once and the load's latency hides behind the other phases;
//    larger radii z-blur from L1/L2 (the generic kernel);
//  * x and y passes: each thread computes RUN consecutive outputs along the
//    pass axis from one loaded run of RUN + 2r values;
//  * stencil: each thread owns ROWS rows of one column; per plane it forms
//    the 3x3 (x, y) max of its voxels once from the fg plane, where rows
//    and columns outside the image hold -inf (so no bounds tests), and
//    keeps the 3x3 maxima of planes z - 1, z and the fg of plane z in
//    registers: the 3^3 max of plane z is two fmaxf when plane z + 1
//    arrives;
//  * bg: the y interpolation of the <= 6 pooled rows under the tile is
//    computed once per plane into shared memory from per-block column
//    tables, its pooled values loaded before the z pass so that their
//    latency hides behind it; a voxel does the x interpolation from two
//    shared loads with its row's weights (multiples of 1/8 that depend on
//    the row alone);
//  * qdiff leaves with streaming stores, so it does not push the raw planes
//    that neighbouring blocks re-read out of L2;
//  * 512 threads a block and <= 64 registers a thread: two blocks, 32 warps,
//    per SM.
// What limits it then: instruction issue and the latency of the short
// phases between the three barriers of a step, not bytes (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;        // core x rows per block
constexpr int TY = 64;        // core y columns per block
constexpr int NTHREADS = 512;
constexpr int MIN_BLOCKS = 2; // blocks per SM the register budget allows
constexpr int MAX_R = 12;     // largest fg kernel radius
constexpr int WINDOW_R = 3;   // largest radius of the register z-window
constexpr int MAX_LVL = 128;
constexpr int RX = TX + 2;    // fg plane rows (core + 1 halo)
constexpr int RY = TY + 2;    // fg plane columns
constexpr int RUN = 3;        // outputs per thread in the x and y passes
constexpr int ROWS = 2;       // core rows per thread in the stencil
constexpr int BG_ROWS = TX / 4 + 2;  // pooled rows under a core's rows
static_assert(RX % RUN == 0 && RY % RUN == 0, "pass runs tile the plane");
static_assert(TY * (TX / ROWS) == NTHREADS, "one stencil column a thread");

// scipy 'reflect' (symmetric: 1,0|0,1), repeated for radius > n, as
// filters._map_boundary_index
__device__ __forceinline__ int reflect_index(int i, int n) {
  for (int it = 0; it < 64; ++it) {
    if (i >= 0 && i < n) return i;
    i = (i < 0) ? -i - 1 : 2 * n - 1 - i;
  }
  return min(max(i, 0), n - 1);
}

// half-pixel bilinear source of fine index g on a 4x-pooled axis: pooled
// coordinate s = (g + 0.5)/4 - 0.5; returns floor(s) (not clamped) and the
// weights, multiples of 1/8 and exact in f32
__device__ __forceinline__ int half_pixel(int g, float& w0, float& w1) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn((float)g, 0.5f), 0.25f), 0.5f);
  const float f = floorf(s);
  w1 = __fsub_rn(s, f);
  w0 = __fsub_rn(1.0f, w1);
  return (int)f;
}

__host__ __device__ inline int halo_rows(int r) { return TX + 2 + 2 * r; }
__host__ __device__ inline int halo_cols(int r) { return TY + 2 + 2 * r; }

__host__ __device__ inline size_t smem_floats(int r) {
  return (size_t)halo_rows(r) * halo_cols(r) + (size_t)RX * halo_cols(r) +
         (size_t)RX * RY + BG_ROWS * TY + 4 * TY + 32 + MAX_LVL;
}

struct Args {
  const float* __restrict__ im;
  const float* __restrict__ bgs;
  float* __restrict__ qdiff;
  int* __restrict__ counts;
  int nz, nx, ny, r;
  float th;
  int n_lvl, edge;
  float taps[2 * MAX_R + 1];
};

// Shared-memory layout of one block: z-passed window, x-passed rows, the fg
// plane, the bg strip, the column tables of the y interpolation, the taps
// and the level histogram.
struct Tile {
  float* zp;
  float* xp;
  float* fg;
  float* strip;
  int* iy0;
  int* iy1;
  float* wy0;
  float* wy1;
  float* taps;
  int* hist;
  int k, HX, HY, x0, y0;

  __device__ Tile(float* smem, int r) {
    k = 2 * r + 1;
    HX = halo_rows(r);   // z-passed rows (core + 1 + r halo)
    HY = halo_cols(r);   // z-passed / x-passed columns
    zp = smem;
    xp = zp + HX * HY;
    fg = xp + RX * HY;
    strip = fg + RX * RY;
    iy0 = reinterpret_cast<int*>(strip + BG_ROWS * TY);
    iy1 = iy0 + TY;
    wy0 = reinterpret_cast<float*>(iy1 + TY);
    wy1 = wy0 + TY;
    taps = wy1 + TY;
    hist = reinterpret_cast<int*>(taps + 32);
    x0 = blockIdx.y * TX;
    y0 = blockIdx.x * TY;
  }
};

// Per-thread state of the stencil and emit: column j of the core, rows
// ROWS * rp .. + ROWS - 1 (both from the thread index, recomputed where
// used, to keep registers for the z window).  m2p / m2c are the 3x3 (x, y)
// maxima of planes z - 1 and z at the thread's voxels, fgc the fg of
// plane z.
struct Emit {
  unsigned flags;   // bit q: voxel q in the image; bit ROWS + q: in the margin
  float m2p[ROWS], m2c[ROWS], fgc[ROWS];
  __device__ static int j() { return threadIdx.x % TY; }
  __device__ static int row(int q) { return ROWS * (threadIdx.x / TY) + q; }
};

// The x interpolation of core row i (x0 is a multiple of 4): its pooled
// rows floor(s), floor(s) + 1 are strip rows (i + 2) / 4 and one more, and
// its weight w1 = s - floor(s) is 5/8, 7/8, 1/8, 3/8 for i % 4 = 0..3, the
// values half_pixel() gives (multiples of 1/8, exact in f32).
__device__ __forceinline__ int strip_row(int i) { return (i + 2) >> 2; }
__device__ __forceinline__ float weight1(int i) {
  return (float)((2 * (i & 3) + 5) & 7) * 0.125f;
}

// Clear the histogram, copy the taps, fill the y interpolation's column
// tables and this thread's edge flags.
__device__ __forceinline__ void setup(const Tile& t, const Args& a, Emit& st) {
  for (int i = threadIdx.x; i < a.n_lvl; i += NTHREADS) t.hist[i] = 0;
  for (int i = threadIdx.x; i < t.k; i += NTHREADS) t.taps[i] = a.taps[i];
  const int ys = a.ny / 4;
  for (int j = threadIdx.x; j < TY; j += NTHREADS) {
    float w0, w1;
    const int f = half_pixel(t.y0 + j, w0, w1);
    t.iy0[j] = min(max(f, 0), ys - 1);
    t.iy1[j] = min(max(f + 1, 0), ys - 1);
    t.wy0[j] = w0;
    t.wy1[j] = w1;
  }
  const int gy = t.y0 + Emit::j();
  const bool col_ok = gy < a.ny;
  const bool col_edge = gy >= a.edge && gy <= a.ny - a.edge;
  st.flags = 0;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int gx = t.x0 + Emit::row(q);
    if (col_ok && gx < a.nx) st.flags |= 1u << q;
    if (col_edge && gx >= a.edge && gx <= a.nx - a.edge)
      st.flags |= 1u << (ROWS + q);
    st.m2p[q] = -INFINITY;
    st.m2c[q] = -INFINITY;
    st.fgc[q] = 0.0f;
  }
}

// Generic z pass: each z-passed position reads its 2r+1 raw planes through
// L1/L2.
__device__ __forceinline__ void zpass_generic(const Tile& t, const Args& a, int step) {
  const size_t plane = (size_t)a.nx * a.ny;
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
}

// Generic x pass (fg row i <-> global x0 - 1 + i reads z-passed rows
// i .. i + 2r), one output a thread.
__device__ __forceinline__ void xpass_generic(const Tile& t) {
  for (int e = threadIdx.x; e < RX * t.HY; e += NTHREADS) {
    const int i = e / t.HY, j = e - i * t.HY;
    const float* src = t.zp + i * t.HY + j;
    float acc = __fmul_rn(t.taps[0], src[0]);
    for (int u = 1; u < t.k; ++u)
      acc = __fadd_rn(acc, __fmul_rn(t.taps[u], src[u * t.HY]));
    t.xp[e] = acc;
  }
}

__device__ __forceinline__ float fg_or_outside(float v, int i, int j,
                                               const Tile& t, const Args& a) {
  const int gx = t.x0 - 1 + i, gy = t.y0 - 1 + j;
  return (gx >= 0 && gx < a.nx && gy >= 0 && gy < a.ny) ? v : -INFINITY;
}

// Generic y pass into the fg plane (column j <-> global y0 - 1 + j); -inf
// outside the image.
__device__ __forceinline__ void ypass_generic(const Tile& t, const Args& a) {
  for (int e = threadIdx.x; e < RX * RY; e += NTHREADS) {
    const int i = e / RY, j = e - i * RY;
    const float* src = t.xp + i * t.HY + j;
    float acc = __fmul_rn(t.taps[0], src[0]);
    for (int u = 1; u < t.k; ++u) acc = __fadd_rn(acc, __fmul_rn(t.taps[u], src[u]));
    t.fg[e] = fg_or_outside(acc, i, j, t, a);
  }
}

// Register-blocked x pass: RUN consecutive fg rows of one column from one
// loaded run of RUN + 2R z-passed values, taps in order.
template <int R>
__device__ __forceinline__ void xpass_blocked(const Tile& t, const Args& a) {
  constexpr int K = 2 * R + 1, HY = TY + 2 + 2 * R;
  constexpr int ITEMS = (RX / RUN) * HY;
  for (int e = threadIdx.x; e < ITEMS; e += NTHREADS) {
    const int run = e / HY, j = e - run * HY;
    const float* src = t.zp + run * RUN * HY + j;
    float v[RUN + K - 1];
#pragma unroll
    for (int u = 0; u < RUN + K - 1; ++u) v[u] = src[u * HY];
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      float acc = __fmul_rn(a.taps[0], v[q]);
#pragma unroll
      for (int u = 1; u < K; ++u) acc = __fadd_rn(acc, __fmul_rn(a.taps[u], v[q + u]));
      t.xp[(run * RUN + q) * HY + j] = acc;
    }
  }
}

// Register-blocked y pass: RUN consecutive fg columns of one row.
template <int R>
__device__ __forceinline__ void ypass_blocked(const Tile& t, const Args& a) {
  constexpr int K = 2 * R + 1, HY = TY + 2 + 2 * R;
  constexpr int NRUN = RY / RUN, ITEMS = RX * NRUN;
  for (int e = threadIdx.x; e < ITEMS; e += NTHREADS) {
    const int i = e / NRUN, j0 = (e - i * NRUN) * RUN;
    const float* src = t.xp + i * HY + j0;
    float v[RUN + K - 1];
#pragma unroll
    for (int u = 0; u < RUN + K - 1; ++u) v[u] = src[u];
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      float acc = __fmul_rn(a.taps[0], v[q]);
#pragma unroll
      for (int u = 1; u < K; ++u) acc = __fadd_rn(acc, __fmul_rn(a.taps[u], v[q + u]));
      t.fg[i * RY + j0 + q] = fg_or_outside(acc, i, j0 + q, t, a);
    }
  }
}

// The y interpolation of the pooled rows under the tile, plane zc: strip
// row r <- pooled row clamp(x0/4 - 1 + r), y-interpolated at each core
// column (the plain version's order: y before x).  The two pooled values of
// a thread's strip entry are loaded at the start of a step (load_strip) and
// combined after the z pass (store_strip), so their latency hides behind
// the z pass instead of stalling the barrier after the x pass.
struct StripLoad {
  float b0, b1;
};
static_assert(BG_ROWS * TY <= NTHREADS, "one strip entry a thread");

__device__ __forceinline__ StripLoad load_strip(const Tile& t, const Args& a,
                                                int zc) {
  StripLoad v{0.0f, 0.0f};
  const int e = threadIdx.x;
  if (zc >= 0 && e < BG_ROWS * TY) {
    const int xs = a.nx / 4, ys = a.ny / 4;
    const int r = e / TY, j = e - r * TY;
    const float* br = a.bgs + (size_t)zc * xs * ys +
                      (size_t)min(max(t.x0 / 4 - 1 + r, 0), xs - 1) * ys;
    v.b0 = __ldg(br + t.iy0[j]);
    v.b1 = __ldg(br + t.iy1[j]);
  }
  return v;
}

__device__ __forceinline__ void store_strip(const Tile& t, const StripLoad& v) {
  const int e = threadIdx.x;
  if (e < BG_ROWS * TY) {
    const int j = e % TY;
    t.strip[e] = __fadd_rn(__fmul_rn(v.b0, t.wy0[j]), __fmul_rn(v.b1, t.wy1[j]));
  }
}

// The 3x3 (x, y) maxima (m2n) and fg (fgn) of this thread's voxels in the
// fg plane just made.  Core row i is fg row i + 1; outside rows and
// columns hold -inf.
__device__ __forceinline__ void plane_max(const Tile& t, const Emit& st,
                                          float* m2n, float* fgn) {
  const float* f = t.fg + Emit::row(0) * RY + Emit::j();
  float h[ROWS + 2];
#pragma unroll
  for (int rr = 0; rr < ROWS + 2; ++rr)
    h[rr] = fmaxf(fmaxf(f[rr * RY], f[rr * RY + 1]), f[rr * RY + 2]);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    m2n[q] = fmaxf(fmaxf(h[q], h[q + 1]), h[q + 2]);
    fgn[q] = f[(q + 1) * RY + 1];
  }
}

// Stencil, bg and classification of plane zc from the 3x3 maxima of planes
// zc - 1 (st.m2p), zc (st.m2c), zc + 1 (m2n) and its fg (st.fgc).
__device__ __forceinline__ void emit(const Tile& t, const Args& a,
                                     const Emit& st, const float* m2n, int zc) {
  const bool z_ok = zc >= a.edge && zc <= a.nz - a.edge;
  const size_t plane = (size_t)a.nx * a.ny;
  const float nl = (float)a.n_lvl;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    if (!(st.flags >> q & 1u)) continue;
    const float fg = st.fgc[q];
    const float m = fmaxf(fmaxf(st.m2p[q], st.m2c[q]), m2n[q]);
    const int i = Emit::row(q), j = Emit::j();
    const float w1 = weight1(i);
    const float* sp = t.strip + strip_row(i) * TY + j;
    const float bg = __fadd_rn(__fmul_rn(sp[0], __fsub_rn(1.0f, w1)),
                               __fmul_rn(sp[TY], w1));
    const float diff = __fsub_rn(fg, bg);
    const bool qualify = (m == fg) && z_ok && (st.flags >> (ROWS + q) & 1u);
    __stcs(a.qdiff + (size_t)zc * plane + (size_t)(t.x0 + i) * a.ny + t.y0 + j,
           qualify ? diff : -INFINITY);
    if (qualify) {
      const float frac = __fsub_rn(1.0f, __fdiv_rn(diff, a.th));
      const float lv = fminf(fmaxf(ceilf(__fmul_rn(frac, nl)), 0.0f), nl);
      const int level = (int)lv;
      if (level < a.n_lvl) atomicAdd(&t.hist[level], 1);
    }
  }
}

// The tail of one z step, shared by both kernels: the strip of plane
// step - 1 (loaded into `sl` before the z pass) beside the x pass, the y pass, the plane's maxima, and the emit
// of plane step - 1.  `xpass` / `ypass` run the passes of the new plane.
template <class XPass, class YPass>
__device__ __forceinline__ void finish_step(const Tile& t, const Args& a,
                                            Emit& st, int step,
                                            const StripLoad& sl, XPass xpass,
                                            YPass ypass) {
  const bool produce = step < a.nz;
  __syncthreads();                 // z-passed window ready
  if (produce) xpass();
  if (step >= 1) store_strip(t, sl);
  __syncthreads();                 // x-passed rows and strip ready
  if (produce) ypass();
  __syncthreads();                 // fg plane ready
  float m2n[ROWS], fgn[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    m2n[q] = -INFINITY;
    fgn[q] = 0.0f;
  }
  if (produce) plane_max(t, st, m2n, fgn);
  if (step >= 1) emit(t, a, st, m2n, step - 1);
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    st.m2p[q] = st.m2c[q];
    st.m2c[q] = m2n[q];
    st.fgc[q] = fgn[q];
  }
}

__device__ __forceinline__ void flush_hist(const Tile& t, const Args& a) {
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_lvl; i += NTHREADS)
    if (t.hist[i]) atomicAdd(&a.counts[i], t.hist[i]);
}

// Generic radius: the z pass reads its 2r+1 raw planes through L1/L2.
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) seed_pyramid_kernel(Args a) {
  extern __shared__ float smem[];
  const Tile t(smem, a.r);
  Emit st;
  setup(t, a, st);
  __syncthreads();
  for (int step = 0; step <= a.nz; ++step) {
    const StripLoad sl = load_strip(t, a, step - 1);
    if (step < a.nz) zpass_generic(t, a, step);
    finish_step(t, a, st, step, sl, [&] { xpass_generic(t); },
                [&] { ypass_generic(t, a); });
  }
  flush_hist(t, a);
}

// Radius R <= WINDOW_R: each thread owns z-pass positions e = tid + m *
// NTHREADS and keeps their raw planes step - R .. step + R in registers.
template <int R>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) seed_pyramid_window_kernel(Args a) {
  constexpr int K = 2 * R + 1;
  constexpr int HY = TY + 2 + 2 * R;
  constexpr int NPOS = (TX + 2 + 2 * R) * HY;
  constexpr int M = (NPOS + NTHREADS - 1) / NTHREADS;
  extern __shared__ float smem[];
  const Tile t(smem, R);
  Emit st;
  setup(t, a, st);
  const size_t plane = (size_t)a.nx * a.ny;
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
    const StripLoad sl = load_strip(t, a, step - 1);
    if (step < a.nz) {
      const float* pn = a.im + (size_t)reflect_index(step + 1 + R, a.nz) * plane;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int e = threadIdx.x + m * NTHREADS;
        float acc = __fmul_rn(a.taps[0], win[m][0]);
#pragma unroll
        for (int u = 1; u < K; ++u) acc = __fadd_rn(acc, __fmul_rn(a.taps[u], win[m][u]));
        if (e < NPOS) t.zp[e] = acc;
#pragma unroll
        for (int u = 0; u < K - 1; ++u) win[m][u] = win[m][u + 1];
        win[m][K - 1] = __ldg(pn + off[m]);
      }
    }
    finish_step(t, a, st, step, sl, [&] { xpass_blocked<R>(t, a); },
                [&] { ypass_blocked<R>(t, a); });
  }
  flush_hist(t, a);
}

template <class Kernel>
int launch(Kernel kernel, const Args& a, cudaStream_t s) {
  const dim3 grid((a.ny + TY - 1) / TY, (a.nx + TX - 1) / TX);
  const size_t smem = smem_floats(a.r) * sizeof(float);
  kernel<<<grid, NTHREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

const void* kernel_for(int r) {
  switch (r) {
    case 0: return (const void*)seed_pyramid_window_kernel<0>;
    case 1: return (const void*)seed_pyramid_window_kernel<1>;
    case 2: return (const void*)seed_pyramid_window_kernel<2>;
    case WINDOW_R: return (const void*)seed_pyramid_window_kernel<WINDOW_R>;
    default: return (const void*)seed_pyramid_kernel;
  }
}

}  // namespace

// taps: host pointer to the 2r+1 fg taps (copied into the launch's
// arguments)
extern "C" int seed_pyramid_launch(const void* im, const void* bgs,
                                   const void* taps, void* qdiff, void* counts,
                                   int nz, int nx, int ny, int r, float th,
                                   int n_lvl, int edge, void* stream) {
  if (nz < 1 || nx < 4 || ny < 4 || nx % 4 || ny % 4 || r < 0 || r > MAX_R ||
      n_lvl < 1 || n_lvl > MAX_LVL || (nx + TX - 1) / TX > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(im), static_cast<const float*>(bgs),
         static_cast<float*>(qdiff), static_cast<int*>(counts),
         nz, nx, ny, r, th, n_lvl, edge, {}};
  const float* tp = static_cast<const float*>(taps);
  for (int u = 0; u < 2 * r + 1; ++u) a.taps[u] = tp[u];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 0: return launch(seed_pyramid_window_kernel<0>, a, s);
    case 1: return launch(seed_pyramid_window_kernel<1>, a, s);
    case 2: return launch(seed_pyramid_window_kernel<2>, a, s);
    case WINDOW_R: return launch(seed_pyramid_window_kernel<WINDOW_R>, a, s);
    default: return launch(seed_pyramid_kernel, a, s);
  }
}

// Resident blocks per SM of the kernel that fg radius r launches, its
// threads and dynamic shared-memory bytes per block (the occupancy the
// card grants, for logging).
extern "C" int seed_pyramid_occupancy(int r, int* blocks, int* threads,
                                      int* smem_bytes) {
  if (r < 0 || r > MAX_R) return (int)cudaErrorInvalidValue;
  *threads = NTHREADS;
  *smem_bytes = (int)(smem_floats(r) * sizeof(float));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for(r), NTHREADS, *smem_bytes);
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
