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
// out-of-range neighbours.  Max and min are exact, so the order in which
// they are taken is free, and diff and level are the plain version's
// arithmetic (seed_common.cuh classify): the outputs agree with
// ops/seed_kernels.py level_stencil_plain bit for bit.
//
// What bounds it on an H100: device-memory bytes.  At 60x2048x2048 it must
// read two 1.007 GB stacks and write 1.007 GB of diff and 0.252 GB of
// level (~3.27 GB, ~0.98 ms at 3.35 TB/s); its ~60 operations per voxel
// (~15 GOP) need ~0.23 ms at 67 TFLOP/s f32.  What the design does about
// it:
// * One 512-thread block (one per SM) owns a 16x256 (x, y) tile and walks
//   z.  A ring of four stages in shared memory holds both stacks'
//   (16 + 2) x (256 + 8) windows of a plane.  The copies of planes z + 1
//   and z + 2 (16-byte cp.async.cg, ~38 KB each) are in flight while
//   plane z is reduced and plane z - 1, whose centres stay in its stage,
//   is emitted; one barrier a plane both publishes plane z and frees the
//   stage of plane z - 2, which plane z + 2 then fills.  One plane in
//   flight streams as fast as three; a tile 256 columns wide (1 KB row
//   pieces) streams ~2 % faster than one 128 wide.
// * Edges replicate inside the window: rows and planes come from clamped
//   indices, and the columns y = -1 and y = ny, which no aligned 16-byte
//   piece can clamp, by one 4-byte copy each.
// * A thread owns 2 x rows of 4 consecutive y columns.  It reads each
//   window row once (one float4 and its two neighbours by shuffles), takes
//   the 3x3 max/min separably in registers (y then x: ~4.5 max a voxel),
//   and the z direction from a per-voxel running ring of the last planes'
//   xy reductions (as seed_common.cuh VoxelRing: 2 more).  The level's
//   division runs only for qualifying voxels, which are rare.
// * diff leaves as one 16-byte streaming store per row and plane, level as
//   four int8 packed into one 32-bit store; the histogram counts in shared
//   memory and adds one atomic per level per block at the end.
// A stack whose ny is no multiple of 4, or whose data does not start on a
// 16-byte boundary, takes the instance with 4-byte copies and scalar
// stores (VEC = false); everything else is the same code.

#include "band_mma.cuh"
#include "seed_common.cuh"

namespace {

constexpr int NT = 512;           // threads per block
constexpr int MIN_BLOCKS = 1;     // resident blocks per SM asked of ptxas
constexpr int NW = NT / 32;
constexpr int WPR = 2;            // warps across a tile row, 128 columns each
constexpr int RB = 2;             // x rows a thread owns
constexpr int TX = NW / WPR * RB; // 16 core x rows per block
constexpr int TY = 128 * WPR;     // core y columns: 4 a lane
constexpr int RX = TX + 2;        // window rows: a 1-row halo each side
constexpr int ST = TY + 8;        // window row: y0 - 4 .. y0 + TY + 3
constexpr int WIN = RX * ST;      // floats of one stack's window
constexpr int STAGES = 4;
constexpr size_t SMEM = (size_t)STAGES * 2 * WIN * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <bool MAX>
__device__ __forceinline__ float mm(float a, float b) {
  return MAX ? fmaxf(a, b) : fminf(a, b);
}

// Start the copies of plane z of both stacks into one stage (two windows).
// Window element (i, s) is global (x0 - 1 + i, y0 - 4 + s), rows clamped
// to the plane; s = 3 .. TY + 4 are read, the columns past ny + 1 are left
// unset (no output reads them).  Warps take rows, lanes 16-byte pieces.
template <bool VEC>
__device__ __forceinline__ void fetch_plane(const Args& a, int z, int x0,
                                            int y0, float* W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = (size_t)z * a.nx * a.ny;
  for (int t = warp; t < 2 * RX; t += NW) {
    const int stack = t >= RX, i = t - stack * RX;
    const int gx = min(max(x0 - 1 + i, 0), a.nx - 1);
    const float* row = (stack ? a.mn : a.mx) + plane + (size_t)gx * a.ny;
    float* dst = W + stack * WIN + i * ST + 4;   // column y0
    if (VEC) {
#pragma unroll
      for (int k = 4 * lane; k < TY; k += 128)
        if (y0 + k < a.ny) ia3::cp_async16(dst + k, row + y0 + k);
      if (lane == 0) ia3::cp_async4(dst - 1, row + max(y0 - 1, 0));
      if (lane == 1) {   // column y0 + TY, or ny replicating ny - 1
        const int gy = min(y0 + TY, a.ny);
        ia3::cp_async4(dst + gy - y0, row + min(gy, a.ny - 1));
      }
    } else {
      for (int j = lane - 1; j <= TY; j += 32)
        ia3::cp_async4(dst + j, row + min(max(y0 + j, 0), a.ny - 1));
    }
  }
}

// The 3x3 xy max (MAX) or min of a thread's RB x 4 voxels from one
// stack's window P; the thread's first voxel lies at window row i0 + 1,
// column j0 of the core.
template <bool MAX>
__device__ __forceinline__ void plane_xy(const float* P, int i0, int j0,
                                         int lane, float (&red)[RB][4]) {
  float ys[RB + 2][4];
#pragma unroll
  for (int i = 0; i < RB + 2; ++i) {
    const float* r = P + (i0 + i) * ST + 4 + j0 - 4 * lane;
    const float4 c = *reinterpret_cast<const float4*>(r + 4 * lane);
    float left = __shfl_up_sync(FULL, c.w, 1);
    float right = __shfl_down_sync(FULL, c.x, 1);
    if (lane == 0) left = r[-1];
    if (lane == 31) right = r[128];
    const float m12 = mm<MAX>(c.x, c.y), m34 = mm<MAX>(c.z, c.w);
    ys[i][0] = mm<MAX>(left, m12);
    ys[i][1] = mm<MAX>(m12, c.z);
    ys[i][2] = mm<MAX>(c.y, m34);
    ys[i][3] = mm<MAX>(m34, right);
  }
  static_assert(RB == 2, "the x pass below is written for 2 rows");
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float m = mm<MAX>(ys[1][c], ys[2][c]);
    red[0][c] = mm<MAX>(ys[0][c], m);
    red[1][c] = mm<MAX>(m, ys[3][c]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    level_stencil_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ int hist[ia3::MAX_LVL];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  // the thread's voxels: rows i0 .. i0 + RB - 1, columns j0 .. j0 + 3 of
  // the tile
  const int i0 = warp / WPR * RB, j0 = warp % WPR * 128 + 4 * lane;
  const int gx0 = x0 + i0, gy0 = y0 + j0;
  const size_t plane = (size_t)a.nx * a.ny;
  for (int i = threadIdx.x; i < a.n_lvl; i += NT) hist[i] = 0;

  bool xok[RB], yok[4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    xok[r] = gx0 + r >= a.edge && gx0 + r <= a.nx - a.edge;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    yok[c] = gy0 + c >= a.edge && gy0 + c <= a.ny - a.edge;

  // classify plane zc, whose windows lie in stage W, of the owned voxels
  // and write diff and level
  auto emit = [&](int zc, const float* W, const float (&mx3)[RB][4],
                  const float (&mn3)[RB][4]) {
    const bool zok = zc >= a.edge && zc <= a.nz - a.edge;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (gx0 + r >= a.nx || gy0 >= a.ny) continue;
      const float* ctr = W + (i0 + 1 + r) * ST + 4 + j0;
      const float4 f4 = *reinterpret_cast<const float4*>(ctr);
      const float4 b4 = *reinterpret_cast<const float4*>(ctr + WIN);
      const float fg[4] = {f4.x, f4.y, f4.z, f4.w};
      const float bg[4] = {b4.x, b4.y, b4.z, b4.w};
      float d[4];
      int lv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        d[c] = __fsub_rn(fg[c], bg[c]);
        lv[c] = a.n_lvl;
        if (zok && xok[r] && yok[c] && mx3[r][c] == fg[c] &&
            mn3[r][c] != bg[c]) {
          lv[c] = ia3::classify(fg[c], bg[c], mx3[r][c], mn3[r][c], true,
                                a.th, a.n_lvl).level;
          if (lv[c] < a.n_lvl) atomicAdd(&hist[lv[c]], 1);
        }
      }
      const size_t o = (size_t)zc * plane + (size_t)(gx0 + r) * a.ny + gy0;
      if (VEC) {
        __stcs(reinterpret_cast<float4*>(a.diff + o),
               make_float4(d[0], d[1], d[2], d[3]));
        const unsigned pk = (unsigned)(lv[0] & 0xff) |
                            (unsigned)(lv[1] & 0xff) << 8 |
                            (unsigned)(lv[2] & 0xff) << 16 |
                            (unsigned)(lv[3] & 0xff) << 24;
        __stcs(reinterpret_cast<unsigned*>(a.level + o), pk);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (gy0 + c >= a.ny) break;
          a.diff[o + c] = d[c];
          a.level[o + c] = (int8_t)lv[c];
        }
      }
    }
  };

  // planes z + 1 .. z + STAGES - 2 are in flight while plane z is reduced
  // and plane z - 1 emitted
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < a.nz) fetch_plane<VEC>(a, s, x0, y0, ring + s * 2 * WIN);
    ia3::cp_async_commit();
  }
  // per owned voxel: the max of the xy max3 over the last two planes (pm)
  // and the last one's (cm), the same minima (pn, cn)
  float pm[RB][4], cm[RB][4], pn[RB][4], cn[RB][4];
  const float* last = ring;   // the stage of plane z - 1
  for (int z = 0; z < a.nz; ++z) {
    // plane z landed (this thread's copies), then visible to all; the
    // stage of plane z - 2, read at z - 1, is free
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    const int zn = z + STAGES - 2;
    if (zn < a.nz)
      fetch_plane<VEC>(a, zn, x0, y0, ring + zn % STAGES * 2 * WIN);
    ia3::cp_async_commit();

    const float* W = ring + z % STAGES * 2 * WIN;
    float mx[RB][4], mn[RB][4];
    plane_xy<true>(W, i0, j0, lane, mx);
    plane_xy<false>(W + WIN, i0, j0, lane, mn);
    if (z > 0) {
      float mx3[RB][4], mn3[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          mx3[r][c] = fmaxf(pm[r][c], mx[r][c]);
          mn3[r][c] = fminf(pn[r][c], mn[r][c]);
        }
      emit(z - 1, last, mx3, mn3);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pm[r][c] = z > 0 ? fmaxf(cm[r][c], mx[r][c]) : mx[r][c];
        pn[r][c] = z > 0 ? fminf(cn[r][c], mn[r][c]) : mn[r][c];
        cm[r][c] = mx[r][c];
        cn[r][c] = mn[r][c];
      }
    last = W;
  }
  emit(a.nz - 1, last, pm, pn);
  __syncthreads();
  for (int i = threadIdx.x; i < a.n_lvl; i += NT)
    if (hist[i]) atomicAdd(&a.counts[i], hist[i]);
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <bool VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(level_stencil_kernel<VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
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
  const bool vec = ny % 4 == 0 && aligned(mx, 16) && aligned(mn, 16) &&
                   aligned(diff, 16) && aligned(level, 4);
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = vec ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    level_stencil_kernel<true><<<grid, NT, SMEM, s>>>(a);
  else
    level_stencil_kernel<false><<<grid, NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads and dynamic shared-memory bytes per block
// and the (x, y) tile of the 16-byte-copy (vec != 0) or the 4-byte-copy
// instance, as the card grants them
extern "C" int level_stencil_occupancy(int vec, int* blocks, int* threads,
                                       int* smem_bytes, int* tile_x,
                                       int* tile_y) {
  *threads = NT;
  *smem_bytes = (int)SMEM;
  *tile_x = TX;
  *tile_y = TY;
  cudaError_t err = vec ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return (int)err;
  return vec ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, level_stencil_kernel<true>, NT, SMEM)
             : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, level_stencil_kernel<false>, NT, SMEM);
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
