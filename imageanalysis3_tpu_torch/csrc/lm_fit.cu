// Fused constrained 3D-Gaussian Levenberg-Marquardt fit, one warp per spot.
//
// Replaces: imageanalysis3_tpu/ops/pallas_lm.py, lm_fit_pallas (kernel body
// _lm_kernel).  Same inputs and outputs: pixels (N, P) f32, coords (N, P, 3)
// f32, mask (N, P) bool, centres (N, 3), delta (N,), params0 (N, 10) ->
// params (N, 10), eps (N,).  N needs no padding: every spot is one warp, so
// there are no padded lanes (the TPU kernel pads N to 128 lanes and gives the
// padding delta = 1; here nothing is padded).
//
// Arithmetic, per LM iteration and spot:
//   geometry   coff = delta*tanh(-c/2), ws = min_ws + (max_ws-min_ws)*
//              sigmoid(-w), p/t = tanh(-./2), A6 = rotated quadform of 1/ws;
//              its 9x10 Jacobian written out by hand (the TPU kernel gets it
//              from jax.linearize at trace time);
//   per pixel  d = (coords - centre) - coff, q = A6 . basis6(d),
//              peak = exp(h - q/2), r = (exp(clip(bk, +-70)) + peak - px)*mk,
//              J^T rows 0/1 closed form (row 0 masked by bk in [-70, 70]),
//              rows 2..9 = -peak/2 * mk * (GA . basis6 - 2 (M GC) . d);
//   reduce     g (10) and the 55 entries of H by __shfl_xor_sync butterflies
//              (every lane ends with bitwise-identical sums);
//   solve      (H + lam*diag H + 1e-8 I) dx = -g by 12-step CG with the
//              1e-20 guards of gaussian_fit._cg_solve_spd, run redundantly
//              in every lane, the matrix in shared memory;
//   accept     one more pixel pass for the trial cost; accept when it drops
//              and the step is finite; lam /3 or *3 clamped to [1e-7, 1e7].
//
// What bounds it on an H100: arithmetic.  The main path's round 0 moves
// ~21 MB (pixels, coords, mask, params) but does ~270 flop per pixel per
// iteration plus the per-spot CG (2048 spots x 512 pixels x 8 iterations
// ~ 2.4 GFLOP, chip_smoke.py's count); the data are read once into
// registers (P/32 pixels, their
// coordinates and mask per lane) and never re-read from device memory.
// The design keeps every per-pixel term in registers and reduces with warp
// shuffles, so device memory is touched only for the one load and the
// final store.  Later work: several spots per warp for small P, and the
// exp on the SFU path of a tuned kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// max(x, floor) keeping NaN, as jnp.maximum does
__device__ __forceinline__ float nan_max(float x, float floor) {
  return (isnan(x) || x > floor) ? x : floor;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Per-spot geometry at params: A6, centre offset; with `jac`, also the
// pixel-independent coefficients of J^T rows 2..9:
//   rows 2..4 (centre): dq = cd[i] . d       (cd = -2 M GC column)
//   rows 5..9 (widths, angles): dq = ga[t] . basis6
struct Geometry {
  float a[6];
  float c[3];
  float cd[3][3];   // [centre param i][component of d]
  float ga[5][6];   // [param 5+t][basis term]
};

__device__ void geometry(const float* prm, float dl, float min_ws, float max_ws,
                         bool jac, Geometry& g) {
  float th[3];
  for (int i = 0; i < 3; ++i) {
    th[i] = tanhf(-prm[2 + i] / 2.0f);
    g.c[i] = dl * th[i];
  }
  float sig[3], ws[3], s[3];
  for (int i = 0; i < 3; ++i) {
    sig[i] = sigmoid(-prm[5 + i]);
    ws[i] = min_ws + (max_ws - min_ws) * sig[i];
    s[i] = 1.0f / ws[i];
  }
  const float p = tanhf(-prm[8] / 2.0f);
  const float t = tanhf(-prm[9] / 2.0f);
  const float s1 = s[0], s2 = s[1], s3 = s[2];
  const float p2 = p * p, t2 = t * t;
  const float tc2 = 1.0f - t2, pc2 = 1.0f - p2;
  const float tc = sqrtf(fmaxf(tc2, 0.0f));
  const float pc = sqrtf(fmaxf(pc2, 0.0f));
  const float m12 = pc2 * s1 - s2 + p2 * s3;
  const float s31 = s3 - s1;
  g.a[0] = pc2 * tc2 * s1 + t2 * s2 + p2 * tc2 * s3;
  g.a[1] = pc2 * t2 * s1 + tc2 * s2 + p2 * t2 * s3;
  g.a[2] = p2 * s1 + pc2 * s3;
  g.a[3] = 2.0f * tc * t * m12;
  g.a[4] = 2.0f * p * pc * tc * s31;
  g.a[5] = 2.0f * p * pc * t * s31;
  if (!jac) return;

  // centre columns: GC[i][2+i] = -delta/2 (1 - tanh^2); cd = -2 M GC
  const float m[3][3] = {{g.a[0], 0.5f * g.a[3], 0.5f * g.a[4]},
                         {0.5f * g.a[3], g.a[1], 0.5f * g.a[5]},
                         {0.5f * g.a[4], 0.5f * g.a[5], g.a[2]}};
  for (int i = 0; i < 3; ++i) {
    const float gc = -0.5f * dl * (1.0f - th[i] * th[i]);
    for (int j = 0; j < 3; ++j) g.cd[i][j] = -2.0f * (m[j][i] * gc);
  }
  // width columns: dA/ds_i * ds_i/dw_i, ds/dw = (max-min) sig (1-sig) s^2
  const float d_s[3][6] = {
      {pc2 * tc2, pc2 * t2, p2, 2.0f * tc * t * pc2, -2.0f * p * pc * tc,
       -2.0f * p * pc * t},
      {t2, tc2, 0.0f, -2.0f * tc * t, 0.0f, 0.0f},
      {p2 * tc2, p2 * t2, pc2, 2.0f * tc * t * p2, 2.0f * p * pc * tc,
       2.0f * p * pc * t}};
  for (int i = 0; i < 3; ++i) {
    const float ds = (max_ws - min_ws) * sig[i] * (1.0f - sig[i]) * s[i] * s[i];
    for (int k = 0; k < 6; ++k) g.ga[i][k] = d_s[i][k] * ds;
  }
  // angle columns; d sqrt(max(u, 0)) as JAX forms it (half on the tie)
  const float dpc2 = -2.0f * p, dtc2 = -2.0f * t;
  const float dpc = (pc2 > 0.0f ? dpc2 : (pc2 == 0.0f ? 0.5f * dpc2 : 0.0f))
                    * (0.5f / pc);
  const float dtc = (tc2 > 0.0f ? dtc2 : (tc2 == 0.0f ? 0.5f * dtc2 : 0.0f))
                    * (0.5f / tc);
  const float dp = -0.5f * (1.0f - p2);
  const float dt = -0.5f * (1.0f - t2);
  const float d_p[6] = {2.0f * p * tc2 * s31, 2.0f * p * t2 * s31,
                        -2.0f * p * s31, 4.0f * p * tc * t * s31,
                        2.0f * (pc + p * dpc) * tc * s31,
                        2.0f * (pc + p * dpc) * t * s31};
  const float d_t[6] = {-2.0f * t * m12, 2.0f * t * m12, 0.0f,
                        2.0f * (dtc * t + tc) * m12, 2.0f * p * pc * dtc * s31,
                        2.0f * p * pc * s31};
  for (int k = 0; k < 6; ++k) {
    g.ga[3][k] = d_p[k] * dp;
    g.ga[4][k] = d_t[k] * dt;
  }
}

template <int NPL>
struct Pixels {
  float px[NPL], d0[NPL], d1[NPL], d2[NPL], mk[NPL];
};

// sum of squared (jac = false: nothing else) masked residuals at params
template <int NPL>
__device__ float cost_at(const Pixels<NPL>& pix, const float* prm, float dl,
                         float min_ws, float max_ws) {
  Geometry g;
  geometry(prm, dl, min_ws, max_ws, false, g);
  const float ebk = expf(fminf(fmaxf(prm[0], -70.0f), 70.0f));
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const float d0 = pix.d0[i] - g.c[0], d1 = pix.d1[i] - g.c[1],
                d2 = pix.d2[i] - g.c[2];
    const float q = g.a[0] * d0 * d0 + g.a[1] * d1 * d1 + g.a[2] * d2 * d2 +
                    g.a[3] * d0 * d1 + g.a[4] * d0 * d2 + g.a[5] * d1 * d2;
    const float r = (ebk + expf(prm[1] - 0.5f * q) - pix.px[i]) * pix.mk[i];
    acc += r * r;
  }
  return warp_sum(acc);
}

template <int NPL>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
lm_fit_kernel(const float* __restrict__ pixels, const float* __restrict__ coords,
              const unsigned char* __restrict__ mask,
              const float* __restrict__ centers, const float* __restrict__ delta,
              const float* __restrict__ params0, float* __restrict__ params_out,
              float* __restrict__ eps_out, int n, int p, int lm_iters,
              int cg_iters, float min_w, float max_w) {
  __shared__ float amat[WARPS_PER_BLOCK][10][10];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int spot = blockIdx.x * WARPS_PER_BLOCK + wib;
  if (spot >= n) return;  // the whole warp leaves together
  float (*A)[10] = amat[wib];
  const float min_ws = min_w * min_w, max_ws = max_w * max_w;

  Pixels<NPL> pix;
  const float c0 = centers[3 * spot], c1 = centers[3 * spot + 1],
              c2 = centers[3 * spot + 2];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int q = lane + 32 * i;
    if (q < p) {
      const size_t o = (size_t)spot * p + q;
      pix.px[i] = pixels[o];
      pix.mk[i] = mask[o] ? 1.0f : 0.0f;
      pix.d0[i] = coords[3 * o] - c0;
      pix.d1[i] = coords[3 * o + 1] - c1;
      pix.d2[i] = coords[3 * o + 2] - c2;
    } else {
      pix.px[i] = 0.0f;
      pix.mk[i] = 0.0f;
      pix.d0[i] = pix.d1[i] = pix.d2[i] = 0.0f;
    }
  }
  const float dl = delta[spot];
  float prm[10];
  for (int k = 0; k < 10; ++k) prm[k] = params0[10 * spot + k];
  float cost = cost_at<NPL>(pix, prm, dl, min_ws, max_ws);
  float lam = 1e-3f;

  for (int it = 0; it < lm_iters; ++it) {
    Geometry g;
    geometry(prm, dl, min_ws, max_ws, true, g);
    const float bk = prm[0];
    const float ebk = expf(fminf(fmaxf(bk, -70.0f), 70.0f));
    const float in_range = (bk >= -70.0f && bk <= 70.0f) ? 1.0f : 0.0f;
    float gs[10], hs[55];
#pragma unroll
    for (int k = 0; k < 10; ++k) gs[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 55; ++k) hs[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const float d0 = pix.d0[i] - g.c[0], d1 = pix.d1[i] - g.c[1],
                  d2 = pix.d2[i] - g.c[2];
      const float b[6] = {d0 * d0, d1 * d1, d2 * d2, d0 * d1, d0 * d2, d1 * d2};
      const float q = g.a[0] * b[0] + g.a[1] * b[1] + g.a[2] * b[2] +
                      g.a[3] * b[3] + g.a[4] * b[4] + g.a[5] * b[5];
      const float mk = pix.mk[i];
      const float peak = expf(prm[1] - 0.5f * q);
      const float r = (ebk + peak - pix.px[i]) * mk;
      const float hp = -0.5f * peak * mk;
      float jt[10];
      jt[0] = ebk * in_range * mk;
      jt[1] = peak * mk;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        jt[2 + c] = hp * (g.cd[c][0] * d0 + g.cd[c][1] * d1 + g.cd[c][2] * d2);
#pragma unroll
      for (int c = 0; c < 5; ++c)
        jt[5 + c] = hp * (g.ga[c][0] * b[0] + g.ga[c][1] * b[1] +
                          g.ga[c][2] * b[2] + g.ga[c][3] * b[3] +
                          g.ga[c][4] * b[4] + g.ga[c][5] * b[5]);
      int h = 0;
#pragma unroll
      for (int a = 0; a < 10; ++a) {
        gs[a] += jt[a] * r;
#pragma unroll
        for (int c = a; c < 10; ++c) hs[h++] += jt[a] * jt[c];
      }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) gs[k] = warp_sum(gs[k]);
    {
      int h = 0;
#pragma unroll
      for (int a = 0; a < 10; ++a) {
#pragma unroll
        for (int c = a; c < 10; ++c) {
          const float v = warp_sum(hs[h++]);
          if (lane == 0) {
            A[a][c] = (a == c) ? v + lam * v + 1e-8f : v;
            A[c][a] = A[a][c];
          }
        }
      }
    }
    __syncwarp();

    // CG on A x = -g, redundantly in every lane
    float x[10], rr[10], pp[10], ap[10];
    float rs = 0.0f;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      x[k] = 0.0f;
      rr[k] = -gs[k];
      pp[k] = rr[k];
      rs += rr[k] * rr[k];
    }
    for (int c = 0; c < cg_iters; ++c) {
      float pap = 0.0f;
#pragma unroll
      for (int a = 0; a < 10; ++a) {
        float v = 0.0f;
#pragma unroll
        for (int k = 0; k < 10; ++k) v += A[a][k] * pp[k];
        ap[a] = v;
        pap += pp[a] * v;
      }
      const float alpha = rs / nan_max(pap, 1e-20f);
      float rs_new = 0.0f;
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        x[k] += alpha * pp[k];
        rr[k] -= alpha * ap[k];
        rs_new += rr[k] * rr[k];
      }
      const float beta = rs_new / nan_max(rs, 1e-20f);
#pragma unroll
      for (int k = 0; k < 10; ++k) pp[k] = rr[k] + beta * pp[k];
      rs = rs_new;
    }
    __syncwarp();  // A is rewritten next iteration

    float trial[10];
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      trial[k] = prm[k] + x[k];
      finite = finite && isfinite(trial[k]);
    }
    const float new_cost = cost_at<NPL>(pix, trial, dl, min_ws, max_ws);
    const bool ok = (new_cost < cost) && finite;
    if (ok) {
#pragma unroll
      for (int k = 0; k < 10; ++k) prm[k] = trial[k];
      cost = new_cost;
      lam = fmaxf(lam / 3.0f, 1e-7f);
    } else {
      lam = fminf(lam * 3.0f, 1e7f);
    }
  }

  // eps = mean |residual| over the mask
  Geometry g;
  geometry(prm, dl, min_ws, max_ws, false, g);
  const float ebk = expf(fminf(fmaxf(prm[0], -70.0f), 70.0f));
  float sabs = 0.0f, npx = 0.0f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const float d0 = pix.d0[i] - g.c[0], d1 = pix.d1[i] - g.c[1],
                d2 = pix.d2[i] - g.c[2];
    const float q = g.a[0] * d0 * d0 + g.a[1] * d1 * d1 + g.a[2] * d2 * d2 +
                    g.a[3] * d0 * d1 + g.a[4] * d0 * d2 + g.a[5] * d1 * d2;
    const float r = (ebk + expf(prm[1] - 0.5f * q) - pix.px[i]) * pix.mk[i];
    sabs += fabsf(r);
    npx += pix.mk[i];
  }
  sabs = warp_sum(sabs);
  npx = warp_sum(npx);
  if (lane == 0) {
    for (int k = 0; k < 10; ++k) params_out[10 * spot + k] = prm[k];
    eps_out[spot] = sabs / fmaxf(npx, 1.0f);
  }
}

template <int NPL>
cudaError_t launch(const float* pixels, const float* coords,
                   const unsigned char* mask, const float* centers,
                   const float* delta, const float* params0, float* params,
                   float* eps, int n, int p, int lm_iters, int cg_iters,
                   float min_w, float max_w, cudaStream_t stream) {
  const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  lm_fit_kernel<NPL><<<blocks, WARPS_PER_BLOCK * 32, 0, stream>>>(
      pixels, coords, mask, centers, delta, params0, params, eps, n, p,
      lm_iters, cg_iters, min_w, max_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lm_fit_launch(const void* pixels, const void* coords,
                             const void* mask, const void* centers,
                             const void* delta, const void* params0,
                             void* params, void* eps, int n, int p,
                             int lm_iters, int cg_iters, float min_w,
                             float max_w, void* stream) {
  if (n <= 0 || p <= 0 || p > 1024 || lm_iters < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  const float* px = static_cast<const float*>(pixels);
  const float* co = static_cast<const float*>(coords);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const float* ce = static_cast<const float*>(centers);
  const float* dl = static_cast<const float*>(delta);
  const float* p0 = static_cast<const float*>(params0);
  float* out = static_cast<float*>(params);
  float* ep = static_cast<float*>(eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p <= 128)
    e = launch<4>(px, co, mk, ce, dl, p0, out, ep, n, p, lm_iters, cg_iters,
                  min_w, max_w, s);
  else if (p <= 256)
    e = launch<8>(px, co, mk, ce, dl, p0, out, ep, n, p, lm_iters, cg_iters,
                  min_w, max_w, s);
  else if (p <= 512)
    e = launch<16>(px, co, mk, ce, dl, p0, out, ep, n, p, lm_iters, cg_iters,
                   min_w, max_w, s);
  else
    e = launch<32>(px, co, mk, ce, dl, p0, out, ep, n, p, lm_iters, cg_iters,
                   min_w, max_w, s);
  return (int)e;
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
