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
// Arithmetic.  The foreground (7 taps by default) is seed_common.cuh's
// blur_staged_x / blur_staged_y: taps in order, x pass before y pass,
// __fmul_rn/__fadd_rn, bit for bit the plain version's
// (fused_seed_classify_plain), because max3 == fg is an exact comparison
// of identically computed values.  The background's default 61 taps run
// on the tensor cores, as the TPU kernel runs them on its matrix unit:
// each pass is a banded product (x pass XP = A S with A[i][i+u] = t[u];
// y pass P = XP A^T), every operand split into two TF32 values (hi = v
// rounded to 10 mantissa bits, to nearest, ties away; lo = v - hi rounded
// the same: cvt.rna.tf32.f32's results) and three mma.sync.m16n8k8
// products lo*hi + hi*lo + hi*hi summed in f32 (lo*lo, <= 2^-22 relative,
// is dropped, as the TPU kernel's dot3 drops it; band_mma.cuh, shared with
// dual_blur.cu, holds this product and the window copies).  So the default path
// agrees with the plain version within the JAX tests' tolerances
// (qualification on > 1 - 1e-5 of voxels, qdiff within rtol 1e-4 / atol
// 0.05, counts within 2), not bit for bit: at 60x2048x2048 a handful of
// 251.7 M voxels qualify differently and qdiff differs by < 1e-3 (< 1e-2
// on data that fill the uint16 range).  min3 != bg compares values this
// kernel computed itself, and a flat region that now passes it has diff
// ~ 0, which is level n_lvl and never counted.  Any other tap counts take
// the run-time-radius kernel (blur_plane for both stacks), which stays
// bit-identical with the plain version.
//
// What bounds it on an H100: bytes.  At 60x2048x2048 it reads the two
// z-passed 1.007 GB stacks and writes the 1.007 GB qdiff (~3.02 GB, ~0.90
// ms at 3.35 TB/s); the blur's ~330 useful operations per voxel would take
// ~1.2 ms on the CUDA cores at their peak, where a tap-ordered sum cannot
// use FMA and needs ~415 instructions per voxel (~3.6 ms at the full
// dispatch rate).  What the design does about it: the blurred stacks never
// reach device memory, which is the TPU kernel's point, and the 61-tap
// passes leave the CUDA cores.  One block of 16 warps per SM owns a 30x126
// (x, y) core tile and walks z (the TPU grid's sequential z ring becomes a
// loop inside the block); with its 1-voxel stencil halo the blurred window
// is 32x128, two 16-row and sixteen 8-column mma tiles.  While plane z is
// computed, plane z + 1's raw windows (bg 96x192, fg 38x134) land in second
// buffers by cp.async: 16 bytes a copy for a bg window inside the plane
// (its columns start up to 3 floats into their rows, so that every piece is
// aligned), else 4 bytes from source offsets reflected once per block.  The
// bg's raw row stride is 200 floats and the x-passed rows' 196, so the
// B-operand and A-operand fragment reads hit 32 distinct banks.  The band
// is Toeplitz, so one float4 per band chunk and lane (ops/seed_kernels.py
// band_fragments) holds every fragment of both passes.  The x pass (ten
// 8-deep chunks per 16-row tile) gives a warp one row tile and three
// column tiles per chunk's band fragments; the y pass (nine chunks per
// 8-column tile) gives it two neighbouring column tiles, so each split
// data fragment serves both.  The fg's x pass runs on the CUDA cores in the
// bg y pass's barrier phase, its y pass after it, both blurred planes and
// the fg's x-passed rows lying in the raw bg window the x pass has
// consumed.  Then each thread reduces the 3x3 xy neighbourhoods of the 8
// rows of one column it owns (each plane row's three columns reduced once)
// into a running ring (seed_common.cuh VoxelRing) and emits the previous
// plane: four barriers a plane.  Known cost: in this loop the products run
// at about 40 % of the rate the instruction sustains alone
// (seed_classify_mma_rate), and they, the splits and the CUDA-core phases
// add up rather than overlap: with four warps per scheduler the kernel is
// bound by the instructions it executes, so what shortens it is fewer
// instructions; the separable x pass covers the y halo, 32x192 outputs for
// a 30x126 tile (1.6x the core); the band's zero padding (80 or 72 columns
// for 61 taps); the raw window re-read, 96 x 192 / (30 x 126) = 4.9x for the bg
// (1.3x for the fg), served mostly from L2; the shared memory (226 KB)
// and the registers (128) leave one block per SM.  The histogram is a
// shared-memory one added to `counts` with atomics at the end.

#include "band_mma.cuh"
#include "seed_common.cuh"

namespace {

// blurred window (tile + 1-voxel halo): two 16-row, sixteen 8-column tiles
constexpr int RX = 32, RY = 128;
constexpr int TX = RX - 2, TY = RY - 2;
constexpr int NT = 512;
constexpr int M = (TX * TY + NT - 1) / NT;   // voxels a thread owns
constexpr int PS = RY + 6;   // row stride of the blurred plane: even, for
                             // float2 stores, and 6 (mod 32), so that the
                             // fg y pass's row-strided stores spread

// the tap counts whose bg passes run on the tensor cores, and their tiling
// (band_mma.cuh BandTile)
constexpr int KF_MMA = 7, KB_MMA = 61;
using BG = ia3::BandTile<RX, RY, KB_MMA, NT>;
constexpr int SR = BG::SR, SCM = BG::SCM, SS = BG::SS, SC4 = BG::SC4;
constexpr int XS = BG::XS, BAND = BG::BAND;
static_assert(PS % 2 == 0, "float2 stores of the blurred plane");
// the fg's raw window and blocking (seed_common.cuh blur_staged_x, blur_staged_y)
constexpr int FR = RX + KF_MMA - 1, FC = RY + KF_MMA - 1;
constexpr int FMBX = 4, FMBY = 8;
constexpr int SFW = (FR * FC + 3) / 4 * 4;   // floats of one raw fg window
// stencil strips: a thread owns SM rows of one column
constexpr int STRIPS = NT / TY;
constexpr int SM_ROWS = (TX + STRIPS - 1) / STRIPS;
static_assert(SM_ROWS <= M && STRIPS >= 1, "strips must cover the tile");

struct Args {
  const float* __restrict__ fgz;
  const float* __restrict__ bgz;
  float* __restrict__ qdiff;
  int* __restrict__ counts;
  const float* __restrict__ band;   // BAND floats (tensor-core path)
  bool aligned16;                   // bgz and its row pitch, to 16 bytes
  float taps_fg[ia3::MAX_TAPS];
  float taps_bg[ia3::MAX_TAPS];
  int k_fg, k_bg;
  int nz, nx, ny;
  float th;
  int n_lvl, edge;
};

// classify voxel (zc, gx, gy) from its blurred values and 3^3 extrema,
// write its qdiff and count its level
__device__ __forceinline__ void emit_voxel(const Args& a, int* hist, int zc,
                                           int gx, int gy, float f, float b,
                                           float mx3, float mn3) {
  const bool ok = ia3::in_margin(zc, gx, gy, a.nz, a.nx, a.ny, a.edge);
  const ia3::Classified c = ia3::classify(f, b, mx3, mn3, ok, a.th, a.n_lvl);
  a.qdiff[((size_t)zc * a.nx + gx) * a.ny + gy] =
      c.qualify ? c.diff : -INFINITY;
  if (c.level < a.n_lvl) atomicAdd(&hist[c.level], 1);
}

// ---- run-time tap counts: both blurs in tap order -----------------------

// shared floats: the raw window of the larger kernel, which the blurred
// plane (RX x PS) reuses once the x pass has read it, then the x-passed rows
__host__ __device__ inline int window_floats(int k) {
  const int raw = ia3::raw_window_floats(RX, RY, k);
  return raw > RX * PS ? raw : RX * PS;
}
__host__ __device__ inline int smem_floats(int k) {
  return window_floats(k) + ia3::xpass_floats(RX, RY, k);
}

__global__ void __launch_bounds__(NT, 1)
    seed_classify_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
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

  auto emit = [&](int zc, int m, float f, float b, float mx3, float mn3_) {
    const int e = threadIdx.x + m * NT;
    const int gx = x0 + e / TY, gy = y0 + e % TY;
    if (e < TX * TY && gx < nx && gy < ny)
      emit_voxel(a, hist, zc, gx, gy, f, b, mx3, mn3_);
  };

  for (int z = 0; z < a.nz; ++z) {
    ia3::blur_plane<NT>(a.bgz + (size_t)z * plane, nx, ny, x0 - 1, y0 - 1, RX,
                        RY, a.taps_bg, a.k_bg, S, XP, to_p);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = min((int)threadIdx.x + m * NT, TX * TY - 1);
      const int i = e / TY, j = e % TY;
      mn3[m] = ia3::xy_reduce3<false>(P, PS, i + 1, j + 1, x0 + i, y0 + j,
                                      nx, ny);
      bgc[m] = P[(i + 1) * PS + j + 1];
    }
    ia3::blur_plane<NT>(a.fgz + (size_t)z * plane, nx, ny, x0 - 1, y0 - 1, RX,
                        RY, a.taps_fg, a.k_fg, S, XP, to_p);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = min((int)threadIdx.x + m * NT, TX * TY - 1);
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

// ---- the default taps: bg on the tensor cores (band_mma.cuh) ----------

// Max (MAX) or min over the in-range 3x3 xy neighbourhoods of the SM_ROWS
// voxels a thread owns, rows i0 .. i0 + SM_ROWS - 1 of tile column j (plane
// cells (i + 1, j + 1)), and their centre values: each plane row's three
// columns are reduced once and shared by the three voxels that touch it.
// Out-of-range neighbours are skipped, as xy_reduce3 skips them.
template <bool MAX>
__device__ __forceinline__ void strip_reduce3(const float* P, int i0, int j,
                                              int gx0, int gy, int nx, int ny,
                                              float (&out)[SM_ROWS],
                                              float (&centre)[SM_ROWS]) {
  const bool left = gy - 1 >= 0, right = gy + 1 < ny;
  float h[SM_ROWS + 2];
#pragma unroll
  for (int r = 0; r < SM_ROWS + 2; ++r) {
    const float* row = P + min(i0 + r, RX - 1) * PS + j;
    float v = row[1];
    if (r >= 1 && r <= SM_ROWS) centre[r - 1] = v;
    if (left) v = MAX ? fmaxf(v, row[0]) : fminf(v, row[0]);
    if (right) v = MAX ? fmaxf(v, row[2]) : fminf(v, row[2]);
    h[r] = v;
  }
#pragma unroll
  for (int m = 0; m < SM_ROWS; ++m) {
    const int gx = gx0 + m;
    float v = h[m + 1];
    if (gx - 1 >= 0) v = MAX ? fmaxf(v, h[m]) : fminf(v, h[m]);
    if (gx + 1 < nx) v = MAX ? fmaxf(v, h[m + 2]) : fminf(v, h[m + 2]);
    out[m] = v;
  }
}

__global__ void __launch_bounds__(NT, 1)
    seed_classify_mma_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int hist[ia3::MAX_LVL];
  for (int i = threadIdx.x; i < a.n_lvl; i += NT) hist[i] = 0;
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)a.nx * a.ny;
  const int nx = a.nx, ny = a.ny;
  // two raw bg and two raw fg windows (plane z computes in one while plane
  // z + 1 lands in the other), the x-passed rows, the band table, the
  // windows' source offsets
  float* SB = smem;
  float* SF = SB + 2 * SR * SS;
  float* XP = SF + 2 * SFW;
  float* BT = XP + RX * XS;
  int* off_b = reinterpret_cast<int*>(BT + BAND);   // SR rows, SCM columns
  int* off_f = off_b + SR + SCM;                    // FR rows, FC columns
  for (int i = threadIdx.x; i < BAND; i += NT) BT[i] = a.band[i];
  const float4* band = reinterpret_cast<const float4*>(BT);
  constexpr int RB = KB_MMA / 2, RF = KF_MMA / 2;
  // the bg window's columns start `sh` floats into their rows, so that a
  // window inside the plane is copied in aligned 16-byte pieces
  const int xb = x0 - 1 - RB, yb = y0 - 1 - RB, sh = yb & 3;
  const bool wide = a.aligned16 && xb >= 0 && xb + SR <= nx && yb - sh >= 0 &&
                    yb - sh + 4 * SC4 <= ny;
  ia3::window_offsets<NT>(SR, SCM, xb, yb, nx, ny, off_b, off_b + SR);
  ia3::window_offsets<NT>(FR, FC, x0 - 1 - RF, y0 - 1 - RF, nx, ny, off_f,
                          off_f + FR);
  __syncthreads();
  auto prefetch = [&](int z) {
    float* dst = SB + (z & 1) * SR * SS;
    if (wide)
      ia3::prefetch_window16<NT, SR, SC4, SS>(
          a.bgz + (size_t)z * plane + (size_t)xb * ny + (yb - sh), ny, dst);
    else
      ia3::prefetch_window<NT, SR, SCM, SS>(a.bgz + (size_t)z * plane, off_b,
                                   off_b + SR, dst + sh);
    ia3::prefetch_window<NT, FR, FC, FC>(a.fgz + (size_t)z * plane, off_f,
                                         off_f + FR, SF + (z & 1) * SFW);
    ia3::cp_async_commit();
  };

  // the strip of the tile this thread owns
  const int j = threadIdx.x % TY, i0 = threadIdx.x / TY * SM_ROWS;
  const bool owner = threadIdx.x < STRIPS * TY && y0 + j < ny;
  ia3::VoxelRing ring[SM_ROWS];
  auto emit = [&](int zc, int m, float f, float b, float mx3, float mn3_) {
    if (owner && i0 + m < TX && x0 + i0 + m < nx)
      emit_voxel(a, hist, zc, x0 + i0 + m, y0 + j, f, b, mx3, mn3_);
  };

  prefetch(0);
  for (int z = 0; z < a.nz; ++z) {
    // once the x pass has read the raw bg window its buffer takes the
    // blurred bg plane, the blurred fg plane and the fg's x-passed rows
    float* S = SB + (z & 1) * SR * SS;
    float* PB = S;
    float* PF = PB + RX * PS;
    float* XF = PF + RX * PS;
    const float* SFz = SF + (z & 1) * SFW;
    // plane z's windows have landed, and the other buffers, the bg one of
    // which held plane z - 1's blurred planes, are free for plane z + 1's
    ia3::cp_async_wait_all();
    __syncthreads();
    if (z + 1 < a.nz) prefetch(z + 1);
    // the fg's x pass, on the CUDA cores, runs beside the bg's y pass
    ia3::blur_bg_mma<BG, PS>(S + sh, XP, PB, band, [&] {
      ia3::blur_staged_x<KF_MMA, RX, RY, FMBX, NT>(a.taps_fg, SFz, XF);
    });
    ia3::blur_staged_y<KF_MMA, RX, RY, FMBY, NT>(
        a.taps_fg, XF, [&](int i, int j0, const float (&v)[FMBY]) {
#pragma unroll
          for (int m = 0; m < FMBY; ++m) PF[i * PS + j0 + m] = v[m];
        });
    __syncthreads();
    if (owner) {
      float mn3[SM_ROWS], bgc[SM_ROWS], mx3[SM_ROWS], fgc[SM_ROWS];
      strip_reduce3<false>(PB, i0, j, x0 + i0, y0 + j, nx, ny, mn3, bgc);
      strip_reduce3<true>(PF, i0, j, x0 + i0, y0 + j, nx, ny, mx3, fgc);
#pragma unroll
      for (int m = 0; m < SM_ROWS; ++m) {
        if (z == 0) {
          ring[m].start(mx3[m], mn3[m], fgc[m], bgc[m]);
        } else {
          emit(z - 1, m, ring[m].fg, ring[m].bg, fmaxf(ring[m].pm, mx3[m]),
               fminf(ring[m].pn, mn3[m]));
          ring[m].advance(mx3[m], mn3[m], fgc[m], bgc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SM_ROWS; ++m)
    emit(a.nz - 1, m, ring[m].fg, ring[m].bg, ring[m].pm, ring[m].pn);
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_lvl; i += NT)
    if (hist[i]) atomicAdd(&a.counts[i], hist[i]);
}

constexpr int MMA_SMEM_FLOATS =
    2 * SR * SS + 2 * SFW + RX * XS + BAND + SR + SCM + FR + FC;
static_assert(SR * SS >= 2 * RX * PS + RX * (FC | 1) &&
                  MMA_SMEM_FLOATS * 4 <= 232448 - 1024,
              "tensor-core path's shared layout");

template <class Kernel>
int launch(Kernel kernel, const Args& a, size_t smem, dim3 grid,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// one warp: d (16x8) = a (16x8, row-major) b (8x8, row-major [k][n]) by
// mma3, the fragment indices as blur_bg_mma uses them
__global__ void mma_selftest_kernel(const float* a, const float* b,
                                    float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  using ia3::split;
  const ia3::Split fa[4] = {split(a[g * 8 + t]), split(a[(g + 8) * 8 + t]),
                            split(a[g * 8 + t + 4]),
                            split(a[(g + 8) * 8 + t + 4])};
  const ia3::Split fb[2] = {split(b[t * 8 + g]), split(b[(t + 4) * 8 + g])};
  float acc[4] = {};
  ia3::mma3(acc, fa, fb);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// what mma_tf32 sustains: every warp runs `iters` rounds of 8 independent
// accumulators; out[global warp] keeps the products alive
__global__ void __launch_bounds__(NT, 1)
    mma_rate_kernel(int iters, float* out) {
  const uint32_t a = ia3::to_tf32(1.0f + threadIdx.x), b = ia3::to_tf32(0.5f);
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) ia3::mma_tf32(acc[k], a, a, a, a, b, b);
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += acc[k][0] + acc[k][3];
  if (threadIdx.x % 32 == 0)
    out[(blockIdx.x * NT + threadIdx.x) / 32] = sum;
}

}  // namespace

// band: the device table of ops/seed_kernels.py band_fragments(taps_bg)
// for the default taps (7, 61), which take the tensor-core path; null for
// any other tap counts, which take the run-time-radius path
extern "C" int seed_classify_launch(const void* fgz, const void* bgz,
                                    void* qdiff, void* counts,
                                    const void* taps_fg, int k_fg,
                                    const void* taps_bg, int k_bg,
                                    const void* band, int nz, int nx, int ny,
                                    float th, int n_lvl, int edge,
                                    void* stream) {
  const bool mma = k_fg == KF_MMA && k_bg == KB_MMA;
  if (nz < 1 || nx < 1 || ny < 1 || k_fg < 1 || k_bg < 1 ||
      k_fg > ia3::MAX_TAPS || k_bg > ia3::MAX_TAPS || k_fg % 2 == 0 ||
      k_bg % 2 == 0 || n_lvl < 1 || n_lvl > ia3::MAX_LVL ||
      (nx + TX - 1) / TX > 65535 || (size_t)nx * ny > 0x7fffffffu ||
      mma != (band != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.fgz = static_cast<const float*>(fgz);
  a.bgz = static_cast<const float*>(bgz);
  a.qdiff = static_cast<float*>(qdiff);
  a.counts = static_cast<int*>(counts);
  a.band = static_cast<const float*>(band);
  a.aligned16 = reinterpret_cast<uintptr_t>(bgz) % 16 == 0 && ny % 4 == 0;
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
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma)
    return launch(seed_classify_mma_kernel, a,
                  MMA_SMEM_FLOATS * sizeof(float), grid, s);
  return launch(seed_classify_kernel, a,
                smem_floats(k_fg > k_bg ? k_fg : k_bg) * sizeof(float), grid,
                s);
}

// the fragment-layout proof: d = a b on one warp (device pointers, 16x8,
// 8x8, 16x8 f32)
extern "C" int seed_classify_mma_selftest(const void* a, const void* b,
                                          void* d, void* stream) {
  mma_selftest_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(d));
  return (int)cudaGetLastError();
}

// the tensor cores' sustained rate for this kernel's instruction: `blocks`
// blocks of NT threads, each warp 8 * iters mma.sync.m16n8k8 TF32 products
// on independent accumulators; out holds blocks * NT / 32 floats
extern "C" int seed_classify_mma_rate(int blocks, int iters, void* out,
                                      void* stream) {
  mma_rate_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
