// The banded split-TF32 blur on the tensor cores, shared by seed_classify.cu
// and dual_blur.cu: the TF32 split, the mma.sync.m16n8k8 product, the
// per-lane band table, the cp.async window copies with their reflected
// source offsets, and the two-pass blur of one plane window.
//
// A 'reflect' correlation of K taps along one axis is a banded product: the
// x pass XP = A S with A[i][i+u] = t[u], the y pass P = XP A^T.  Every
// operand is split into two TF32 values (hi = v rounded to 10 mantissa bits,
// to nearest, ties away; lo = v - hi rounded the same: cvt.rna.tf32.f32's
// results) and three mma.sync.m16n8k8 products lo*hi + hi*lo + hi*hi are
// summed in f32 (lo*lo, <= 2^-22 relative, is dropped, as the TPU kernels'
// bf16 dot3 drops its lo*lo).  The result is within the JAX tests'
// tolerances of the tap-ordered sum, not bit for bit equal to it
// (ops/seed_kernels.py blur_xy_split_tf32_plain is its arithmetic model).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "seed_common.cuh"

namespace ia3 {

// mma.sync.m16n8k8 fragments (g = lane >> 2, t = lane & 3): A (16x8, row)
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8x8,
// col) b0 = B[t][g], b1 = B[t+4][g]; C/D (16x8) c0 = C[g][2t],
// c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1].

struct Split {
  uint32_t hi, lo;
};

// v rounded to TF32's 10 mantissa bits, to nearest, ties away from zero:
// cvt.rna.tf32.f32's result for every finite v, in two integer
// instructions (the conversion instruction runs at a lower rate and was
// measured slower here)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo up to 2^-22 relative; the subtraction is exact
__device__ __forceinline__ Split split(float v) {
  Split s;
  s.hi = to_tf32(v);
  s.lo = to_tf32(__fsub_rn(v, __uint_as_float(s.hi)));
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b with both operands split: lo*hi, hi*lo, then hi*hi
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// The band table, band[c][lane] = (d.hi, e.hi, d.lo, e.lo) with
// d = t[8c + t - g], e = t[8c + t - g + 4] (0 outside the taps).  The band
// is Toeplitz, so these two values are every fragment: the x pass's A
// operand A[i][k] = t[8c + k - i] has (a0, a1, a2, a3) = (d_c, d_{c-1}, e_c,
// e_{c-1}) and the y pass's B operand B[k][n] = t[8c + k - n] has
// (b0, b1) = (d_c, e_c); d and e of chunk -1 are 0.  The host builds it:
// ops/seed_kernels.py band_fragments.
struct BandPair {
  Split d, e;
};
__device__ __forceinline__ BandPair band_pair(const float4* band, int c,
                                              int lane) {
  const float4 f = band[c * 32 + lane];
  return {{__float_as_uint(f.x), __float_as_uint(f.z)},
          {__float_as_uint(f.y), __float_as_uint(f.w)}};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Start the copy of one plane's ROWS x COLS raw window into S (row stride
// STRIDE): element (i, j) comes from plane[row_off[i] + col_off[j]], the
// offsets reflected at the plane's edges once per block (window_offsets).
// Warps of an NT-thread block take rows, lanes take columns.  No barrier:
// the caller commits, waits and synchronises.
template <int NT, int ROWS, int COLS, int STRIDE>
__device__ __forceinline__ void prefetch_window(
    const float* __restrict__ plane, const int* row_off, const int* col_off,
    float* S) {
  constexpr int NW = NT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < ROWS; i += NW) {
    const float* row = plane + row_off[i];
    float* dst = S + i * STRIDE;
#pragma unroll
    for (int j = lane; j < COLS; j += 32) cp_async4(dst + j, row + col_off[j]);
  }
}

// prefetch_window for a window that lies inside the plane with a 16-byte
// aligned first element (first: the plane's element under S[0]) and row
// pitch: ROWS rows of COLS4 float4
template <int NT, int ROWS, int COLS4, int STRIDE>
__device__ __forceinline__ void prefetch_window16(
    const float* __restrict__ first, int ny, float* S) {
  constexpr int NW = NT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < ROWS; i += NW) {
    const float* row = first + (size_t)i * ny;
    float* dst = S + i * STRIDE;
#pragma unroll
    for (int k = lane; k < COLS4; k += 32) cp_async16(dst + 4 * k, row + 4 * k);
  }
}

// row_off[i] = reflect(x_lo + i) * ny, col_off[j] = reflect(y_lo + j)
template <int NT>
__device__ __forceinline__ void window_offsets(int rows, int cols, int x_lo,
                                               int y_lo, int nx, int ny,
                                               int* row_off, int* col_off) {
  for (int i = threadIdx.x; i < rows; i += NT)
    row_off[i] = reflect_index(x_lo + i, nx) * ny;
  for (int j = threadIdx.x; j < cols; j += NT)
    col_off[j] = reflect_index(y_lo + j, ny);
}

// The tiling of a K-tap banded blur of an RX x RY output window by an
// NT-thread block: 16-row tiles (MT of them) for the x pass, 8-column tiles
// for both passes, XCH (YCH) 8-deep band chunks under a 16-row (8-column)
// tile.  The raw window is SR x SCM (rows x columns) at row stride SS
// (= 8 mod 32), the x-passed rows SCM wide at stride XS (= 4 mod 8), so the
// B-operand and A-operand fragment reads hit 32 distinct banks; SC4 float4
// cover a raw row whose first column sits up to 3 floats into it.  The x
// pass gives a warp one row tile and NXW column tiles, the y pass one row
// tile and NYW neighbouring column tiles.  BAND floats hold the band table.
template <int RX_, int RY_, int K_, int NT_>
struct BandTile {
  static constexpr int RX = RX_, RY = RY_, K = K_, NT = NT_, NW = NT / 32;
  static constexpr int XCH = (16 + K - 1 + 7) / 8;
  static constexpr int YCH = (8 + K - 1 + 7) / 8;
  static constexpr int MT = RX / 16;
  static constexpr int SR = 16 * (MT - 1) + 8 * XCH;
  static constexpr int SCM = (RY + K - 1 + 7) / 8 * 8;
  static constexpr int SS = SCM + 8;
  static constexpr int SC4 = (SCM + 3 + 3) / 4;
  static constexpr int XS = SCM + 4;
  static constexpr int NXT = SCM / 8;
  static constexpr int NYT = RY / 8;
  static constexpr int NXW = NXT * MT / NW;
  static constexpr int NYW = NYT * MT / NW;
  static constexpr int BAND = XCH * 32 * 4;
  static_assert(RX % 16 == 0 && RY % 8 == 0 && 4 * SC4 <= SS &&
                    SS % 32 == 8 && XS % 8 == 4 && NXT * MT % NW == 0 &&
                    NYT * MT % NW == 0 && 8 * (NYT - 1 + YCH) <= SCM &&
                    YCH <= XCH,
                "mma tiling");
};

// The K-tap blur of the RX x RY window whose SR x SCM raw window lies in S,
// into P (row stride PS, even; may overlap S), as two banded split-TF32
// products through the x-passed rows XP.  beside_y() runs between the y
// pass's products and its stores (CUDA-core work that overlaps them).
// Starts with S visible to the block, ends synchronised.
template <class G, int PS, class BesideY>
__device__ __forceinline__ void blur_bg_mma(const float* S, float* XP,
                                            float* P, const float4* band,
                                            BesideY beside_y) {
  static_assert(PS % 2 == 0, "float2 stores");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mi = warp % G::MT;

  // x pass: XP[i][j] = sum_u t[u] S[i + u][j].  A warp takes row tile mi
  // and NXW column tiles; each band chunk's fragments serve all of them.
  {
    const int n0 = warp / G::MT * G::NXW;
    float acc[G::NXW][4] = {};
    const float* col = S + (16 * mi + t) * G::SS + n0 * 8 + g;
    BandPair prev = {};
#pragma unroll
    for (int c = 0; c < G::XCH; ++c) {
      const BandPair cur = band_pair(band, c, lane);
      const Split a[4] = {cur.d, prev.d, cur.e, prev.e};
#pragma unroll
      for (int j = 0; j < G::NXW; ++j) {
        const Split b[2] = {split(col[8 * c * G::SS + 8 * j]),
                            split(col[(8 * c + 4) * G::SS + 8 * j])};
        mma3(acc[j], a, b);
      }
      prev = cur;
    }
#pragma unroll
    for (int j = 0; j < G::NXW; ++j) {
      float* out = XP + (16 * mi + g) * G::XS + (n0 + j) * 8 + 2 * t;
      *reinterpret_cast<float2*>(out) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + 8 * G::XS) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();

  // y pass: P[i][j] = sum_u t[u] XP[i][j + u].  A warp takes row tile mi
  // and NYW neighbouring column tiles, so the data's column chunk q is
  // split once and serves band chunk q - jj of each tile jj.
  {
    const int nb = warp / G::MT * G::NYW;
    float acc[G::NYW][4] = {};
    const float* row = XP + (16 * mi + g) * G::XS + nb * 8 + t;
    BandPair bp[G::NYW] = {};   // bp[jj]: the band chunk q - jj
#pragma unroll
    for (int q = 0; q < G::NYW - 1 + G::YCH; ++q) {
      const Split a[4] = {split(row[8 * q]), split(row[8 * G::XS + 8 * q]),
                          split(row[8 * q + 4]),
                          split(row[8 * G::XS + 8 * q + 4])};
#pragma unroll
      for (int jj = G::NYW - 1; jj > 0; --jj) bp[jj] = bp[jj - 1];
      if (q < G::YCH) bp[0] = band_pair(band, q, lane);
#pragma unroll
      for (int jj = 0; jj < G::NYW; ++jj) {
        const int c = q - jj;
        if (c < 0 || c >= G::YCH) continue;
        const Split b[2] = {bp[jj].d, bp[jj].e};
        mma3(acc[jj], a, b);
      }
    }
    beside_y();
#pragma unroll
    for (int jj = 0; jj < G::NYW; ++jj) {
      float* out = P + (16 * mi + g) * PS + (nb + jj) * 8 + 2 * t;
      *reinterpret_cast<float2*>(out) = make_float2(acc[jj][0], acc[jj][1]);
      *reinterpret_cast<float2*>(out + 8 * PS) =
          make_float2(acc[jj][2], acc[jj][3]);
    }
  }
  __syncthreads();
}

}  // namespace ia3
