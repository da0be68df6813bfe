// Separable x+y Gaussian blur of two z-passed stacks in one launch.
//
// Replaces: imageanalysis3_tpu/ops/pallas_kernels.py, dual_blur_xy_pallas
// (kernel body _dual_blur_kernel; wrapper dual_gaussian_blur, whose z pass
// stays outside the kernel as it does there).  Takes the z-passed
// foreground and background stacks fgz, bgz (Z, X, Y) f32 and their 1D
// taps, and writes fg = y(x(fgz)) and bg = y(x(bgz)) (Z, X, Y) f32 with
// scipy 'reflect' boundaries (repeated reflection for radius > n).
//
// Arithmetic.  The foreground is summed in tap order with
// __fmul_rn/__fadd_rn, the x pass before the y pass, as the plain version
// (ops/seed_kernels.py dual_blur_xy_plain, filters._shift_add) sums it, so
// fg agrees with it bit for bit: the downstream stencil compares fg
// exactly (maximum_filter(fg) == fg).  For the default taps (7 for fg, 61
// for bg) the background runs on the tensor cores, as the TPU kernel runs
// both blurs on its matrix unit: band_mma.cuh's banded split-TF32
// mma.sync products (three per 8-deep band chunk, lo*lo dropped), the code
// seed_classify.cu runs, so bg agrees with the plain version within the
// JAX tests' tolerance between the Pallas dual blur and XLA (rtol 2e-5,
// atol 2e-2), not bit for bit.  A flat region's bg values may then differ
// by rounding, so some flat voxels pass minimum_filter(bg) != bg; their
// diff is ~0, which is level n_lvl and never counted.  Any other tap
// counts take the run-time-radius kernel (seed_common.cuh blur_plane for
// each stack), bit-identical with the plain version.
//
// What bounds it on an H100: device-memory bytes.  At 60x2048x2048 it must
// read and write two 1.007 GB stacks (~4.03 GB, ~1.20 ms at 3.35 TB/s);
// the tap-ordered sums of all 136 taps a voxel pair would need ~68 GOP
// (~1.02 ms at 67 TFLOP/s f32) and about twice that in instructions, as no
// product can fuse into an FMA.  What the design does about it: the bg's
// 122 multiply-adds a voxel leave the CUDA cores.  One 16-warp block per SM
// owns a 32x128 (x, y) output tile of both stacks and walks z over its
// planes (one launch covers both stacks): while plane z is computed, plane
// z + 1's raw windows (bg 96x192, fg 38x134) land in second buffers by
// cp.async (16-byte copies for a window inside the plane, else 4-byte
// copies from source offsets reflected once per block).  The bg's x and y
// passes are two banded products (band_mma.cuh blur_bg_mma); the fg's x
// pass runs on the CUDA cores beside the bg's y pass, its y pass after it.
// Both blurred tiles are staged in the consumed raw bg buffer (rows of 132
// floats, 16-byte aligned) and written once, as 16-byte coalesced stores,
// while the next plane starts: four barriers a plane.  Known cost: the bg
// window re-read, 96 x 192 / (32 x 128) = 4.5x (1.2x for the fg), served
// mostly from L2; the band's zero padding and the x pass over the y halo
// (192 columns for 128 outputs); the shared memory (226 KB) leaves one
// block per SM.

#include "band_mma.cuh"
#include "seed_common.cuh"

namespace {

struct Args {
  const float* __restrict__ src[2];   // fgz, bgz
  float* __restrict__ dst[2];         // fg, bg
  const float* __restrict__ band;     // BAND floats (tensor-core path)
  bool aligned16;                     // fgz, bgz, their row pitch: 16 bytes
  bool vec_out;                       // fg, bg and their row pitch, the same
  float taps[2][ia3::MAX_TAPS];
  int k[2];
  int nz, nx, ny;
};

// ---- the default taps: bg on the tensor cores ---------------------------

constexpr int RX = 32, RY = 128;   // output tile (x, y)
constexpr int NT = 512;
constexpr int KF_MMA = 7, KB_MMA = 61;
using BG = ia3::BandTile<RX, RY, KB_MMA, NT>;
constexpr int SR = BG::SR, SCM = BG::SCM, SS = BG::SS, SC4 = BG::SC4;
constexpr int XS = BG::XS, BAND = BG::BAND;
// row stride of the staged blurred tiles: 16-byte rows, and 4 (mod 32), so
// that the fg y pass's float4 stores (8 lanes on 8 rows) and the store
// phase's row reads are free of bank conflicts
constexpr int PS = RY + 4;
// the fg's raw window (FR x FC, its columns starting up to 3 floats into
// rows of FS, so that a window inside the plane is copied in 16-byte
// pieces) and blocking (seed_common.cuh blur_staged_x/_y)
constexpr int FR = RX + KF_MMA - 1, FC = RY + KF_MMA - 1;
constexpr int FC4 = (FC + 3 + 3) / 4;   // float4 per raw row, any shift
constexpr int FS = 4 * FC4;
constexpr int FMBX = 4, FMBY = 8;
constexpr int SFW = FR * FS;            // floats of one raw fg window
constexpr int MMA_SMEM_FLOATS =
    2 * SR * SS + 2 * SFW + RX * XS + BAND + SR + SCM + FR + FC;
static_assert(PS % 4 == 0 && PS % 32 == 4 && FMBY == 8 &&
                  SR * SS >= 2 * RX * PS + RX * (FC | 1) &&
                  MMA_SMEM_FLOATS * 4 <= 232448 - 1024,
              "tensor-core path's shared layout");

// Write the staged RX x RY tiles PB (bg) and PF (fg) of plane z: a warp
// takes one row's 32 float4, each output written once
__device__ __forceinline__ void store_tiles(const Args& a, const float* PB,
                                            const float* PF, int x0, int y0,
                                            int z) {
  const size_t plane_off = (size_t)z * a.nx * a.ny;
  for (int e = threadIdx.x; e < RX * RY / 4; e += NT) {
    const int i = e / (RY / 4), c = e - i * (RY / 4);
    const int gx = x0 + i, gy = y0 + 4 * c;
    if (gx >= a.nx || gy >= a.ny) continue;
    const float4 vb = *reinterpret_cast<const float4*>(PB + i * PS + 4 * c);
    const float4 vf = *reinterpret_cast<const float4*>(PF + i * PS + 4 * c);
    const size_t o = plane_off + (size_t)gx * a.ny + gy;
    if (a.vec_out) {
      *reinterpret_cast<float4*>(a.dst[1] + o) = vb;
      *reinterpret_cast<float4*>(a.dst[0] + o) = vf;
    } else {
      const float b[4] = {vb.x, vb.y, vb.z, vb.w};
      const float f[4] = {vf.x, vf.y, vf.z, vf.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (gy + m >= a.ny) break;
        a.dst[1][o + m] = b[m];
        a.dst[0][o + m] = f[m];
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
    dual_blur_mma_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.y * RX, y0 = blockIdx.x * RY;
  const size_t plane = (size_t)a.nx * a.ny;
  const int nx = a.nx, ny = a.ny;
  // two raw bg and two raw fg windows (plane z computes in one while plane
  // z + 1 lands in the other), the x-passed bg rows, the band table, the
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
  const int xb = x0 - RB, yb = y0 - RB, sh = yb & 3;
  const bool wide = a.aligned16 && xb >= 0 && xb + SR <= nx && yb - sh >= 0 &&
                    yb - sh + 4 * SC4 <= ny;
  // the same for the fg window
  const int xf = x0 - RF, yf = y0 - RF, shf = yf & 3;
  const bool wide_f = a.aligned16 && xf >= 0 && xf + FR <= nx &&
                      yf - shf >= 0 && yf - shf + FS <= ny;
  ia3::window_offsets<NT>(SR, SCM, xb, yb, nx, ny, off_b, off_b + SR);
  ia3::window_offsets<NT>(FR, FC, xf, yf, nx, ny, off_f, off_f + FR);
  __syncthreads();
  auto prefetch = [&](int z) {
    float* dst = SB + (z & 1) * SR * SS;
    if (wide)
      ia3::prefetch_window16<NT, SR, SC4, SS>(
          a.src[1] + (size_t)z * plane + (size_t)xb * ny + (yb - sh), ny,
          dst);
    else
      ia3::prefetch_window<NT, SR, SCM, SS>(a.src[1] + (size_t)z * plane,
                                            off_b, off_b + SR, dst + sh);
    float* dst_f = SF + (z & 1) * SFW;
    if (wide_f)
      ia3::prefetch_window16<NT, FR, FC4, FS>(
          a.src[0] + (size_t)z * plane + (size_t)xf * ny + (yf - shf), ny,
          dst_f);
    else
      ia3::prefetch_window<NT, FR, FC, FS>(a.src[0] + (size_t)z * plane,
                                           off_f, off_f + FR, dst_f + shf);
    ia3::cp_async_commit();
  };

  prefetch(0);
  for (int z = 0; z < a.nz; ++z) {
    // once the x pass has read the raw bg window its buffer takes the
    // blurred bg tile, the blurred fg tile and the fg's x-passed rows
    float* S = SB + (z & 1) * SR * SS;
    float* PB = S;
    float* PF = PB + RX * PS;
    float* XF = PF + RX * PS;
    const float* SFz = SF + (z & 1) * SFW + shf;
    // plane z's windows have landed, and the other buffers, the bg one of
    // which held plane z - 1's blurred tiles, are free for plane z + 1's
    ia3::cp_async_wait_all();
    __syncthreads();
    if (z + 1 < a.nz) prefetch(z + 1);
    // the fg's x pass, on the CUDA cores, runs beside the bg's y pass
    ia3::blur_bg_mma<BG, PS>(S + sh, XP, PB, band, [&] {
      ia3::blur_staged_x<KF_MMA, RX, RY, FMBX, NT, FS>(a.taps[0], SFz, XF);
    });
    ia3::blur_staged_y<KF_MMA, RX, RY, FMBY, NT>(
        a.taps[0], XF, [&](int i, int j0, const float (&v)[FMBY]) {
          float4* d = reinterpret_cast<float4*>(PF + i * PS + j0);
          d[0] = make_float4(v[0], v[1], v[2], v[3]);
          d[1] = make_float4(v[4], v[5], v[6], v[7]);
        });
    __syncthreads();
    store_tiles(a, PB, PF, x0, y0, z);
  }
}

// ---- any other tap counts: both blurs in tap order ----------------------

constexpr int TX = 32, TY = 64;   // output tile of one plane of one stack
constexpr int NT_G = 256;
constexpr int PS_G = TY + 1;      // odd row stride of the staged output tile

// the raw window, which the staged output tile (TX x PS_G) reuses once the
// x pass has read it, then the x-passed rows
__host__ __device__ inline int window_floats(int k) {
  const int raw = ia3::raw_window_floats(TX, TY, k);
  return raw > TX * PS_G ? raw : TX * PS_G;
}

size_t generic_smem_bytes(int k) {
  return sizeof(float) *
         ((size_t)window_floats(k) + (size_t)ia3::xpass_floats(TX, TY, k));
}

// one block: one TX x TY tile of one plane of one stack (grid z = 2 * Z)
__global__ void __launch_bounds__(NT_G, 2)
    dual_blur_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int s = blockIdx.z & 1, z = blockIdx.z >> 1;
  const int x0 = blockIdx.y * TX, y0 = blockIdx.x * TY;
  const size_t plane = (size_t)a.nx * a.ny;
  float* P = smem;
  float* XP = smem + window_floats(max(a.k[0], a.k[1]));
  ia3::blur_plane<NT_G>(a.src[s] + (size_t)z * plane, a.nx, a.ny, x0, y0, TX,
                        TY, a.taps[s], a.k[s], smem, XP,
                        [&](int i, int j, float v) { P[i * PS_G + j] = v; });
  // coalesced store of the staged tile
  float* out = a.dst[s] + (size_t)z * plane;
  for (int e = threadIdx.x; e < TX * TY; e += NT_G) {
    const int i = e / TY, j = e - i * TY;
    if (x0 + i < a.nx && y0 + j < a.ny)
      out[(size_t)(x0 + i) * a.ny + y0 + j] = P[i * PS_G + j];
  }
}

bool mma_taps(int k_fg, int k_bg) {
  return k_fg == KF_MMA && k_bg == KB_MMA;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// band: the device table of ops/seed_kernels.py band_fragments(taps_bg) for
// the default taps (7, 61), which take the tensor-core path; null for any
// other tap counts, which take the run-time-radius path
extern "C" int dual_blur_launch(const void* fgz, const void* bgz, void* fg,
                                void* bg, const void* taps_fg, int k_fg,
                                const void* taps_bg, int k_bg,
                                const void* band, int nz, int nx, int ny,
                                void* stream) {
  const bool mma = mma_taps(k_fg, k_bg);
  if (nz < 1 || nx < 1 || ny < 1 || k_fg < 1 || k_bg < 1 ||
      k_fg > ia3::MAX_TAPS || k_bg > ia3::MAX_TAPS || k_fg % 2 == 0 ||
      k_bg % 2 == 0 || (size_t)nx * ny > 0x7fffffffu ||
      mma != (band != nullptr) ||
      (!mma && ((nx + TX - 1) / TX > 65535 || 2 * nz > 65535)) ||
      (mma && (nx + RX - 1) / RX > 65535))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.src[0] = static_cast<const float*>(fgz);
  a.src[1] = static_cast<const float*>(bgz);
  a.dst[0] = static_cast<float*>(fg);
  a.dst[1] = static_cast<float*>(bg);
  a.band = static_cast<const float*>(band);
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.aligned16 = al16(fgz) && al16(bgz) && ny % 4 == 0;
  a.vec_out = al16(fg) && al16(bg) && ny % 4 == 0;
  const float* tf = static_cast<const float*>(taps_fg);
  const float* tb = static_cast<const float*>(taps_bg);
  for (int u = 0; u < k_fg; ++u) a.taps[0][u] = tf[u];
  for (int u = 0; u < k_bg; ++u) a.taps[1][u] = tb[u];
  a.k[0] = k_fg;
  a.k[1] = k_bg;
  a.nz = nz;
  a.nx = nx;
  a.ny = ny;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    const size_t smem = MMA_SMEM_FLOATS * sizeof(float);
    cudaError_t err = allow_smem(dual_blur_mma_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((ny + RY - 1) / RY, (nx + RX - 1) / RX);
    dual_blur_mma_kernel<<<grid, NT, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = generic_smem_bytes(k_fg > k_bg ? k_fg : k_bg);
  cudaError_t err = allow_smem(dual_blur_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ny + TY - 1) / TY, (nx + TX - 1) / TX, 2 * nz);
  dual_blur_kernel<<<grid, NT_G, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// resident blocks per SM, threads and dynamic shared-memory bytes per block
// of the kernel that taps (k_fg, k_bg) launch, as the card grants them
extern "C" int dual_blur_occupancy(int k_fg, int k_bg, int* blocks,
                                   int* threads, int* smem_bytes) {
  if (k_fg < 1 || k_bg < 1 || k_fg > ia3::MAX_TAPS || k_bg > ia3::MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (mma_taps(k_fg, k_bg)) {
    *threads = NT;
    *smem_bytes = (int)(MMA_SMEM_FLOATS * sizeof(float));
    err = allow_smem(dual_blur_mma_kernel, *smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, dual_blur_mma_kernel, NT, *smem_bytes);
  } else {
    *threads = NT_G;
    *smem_bytes = (int)generic_smem_bytes(k_fg > k_bg ? k_fg : k_bg);
    err = allow_smem(dual_blur_kernel, *smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, dual_blur_kernel, NT_G, *smem_bytes);
  }
  return (int)err;
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
