// Fused constrained 3D-Gaussian Levenberg-Marquardt fit, one block of G
// warps per spot.
//
// Replaces: imageanalysis3_tpu/ops/pallas_lm.py, lm_fit_pallas (kernel body
// _lm_kernel).  Same inputs and outputs: pixels (N, P) f32, coords (N, P, 3)
// f32, mask (N, P) bool, centres (N, 3), delta (N,), params0 (N, 10) ->
// params (N, 10), eps (N,).  N needs no padding: every spot is one block.
//
// Arithmetic, per LM iteration and spot (as lm_kernel.lm_fit_plain):
//   geometry   coff = delta*tanh(-c/2), ws = min_ws + (max_ws-min_ws)*
//              sigmoid(-w), p/t = tanh(-./2), A6 = rotated quadform of 1/ws;
//              its 9x10 Jacobian written out by hand (the TPU kernel gets it
//              from jax.linearize at trace time);
//   per pixel  d = (coords - centre) - coff, q = A6 . basis6(d),
//              peak = exp(h - q/2), r = (exp(clip(bk, +-70)) + peak - px)*mk,
//              J^T rows 0/1 closed form (row 0 masked by bk in [-70, 70]),
//              rows 2..9 = -peak/2 * mk * (GA . basis6 - 2 (M GC) . d);
//   solve      (H + lam*diag H + 1e-8 I) dx = -g by 12-step CG with the
//              1e-20 guards of gaussian_fit._cg_solve_spd;
//   accept     when the trial cost drops and the step is finite; lam /3 or
//              *3 clamped to [1e-7, 1e7]; eps = mean |residual| over the mask.
//
// What bounds it on an H100.  The work is arithmetic (~160 instructions a
// pixel and iteration, ~21 MB read once for the main path's 2048 x 512
// round 0), but a spot's iterations form one serial chain: pixel pass ->
// reduction -> 12 dependent CG steps -> the trial's geometry -> the next
// pass.  The CG is the longest link, and only one warp of the spot runs it.
// So the time is the chain's latency times the number of waves of spots the
// card holds, and the design shortens the chain and holds more spots:
//   * a spot is one block of G = ceil(P / 256) warps (1, 2 or 4; 2 at the
//     main path's P = 512), so a thread walks at most 8 of its pixels; the
//     pixels, relative coordinates and mask sit in shared memory (20 B a
//     pixel); registers hold the 67 running sums of g, H, cost and sum |r|
//     and one pixel's terms, and the J^T-row coefficients are read per
//     pixel from shared memory by 16-byte loads, which keeps a thread at 128
//     registers: 8 spots (16 warps) per SM at P = 512;
//   * one pixel pass per iteration, at the trial point: it yields the trial
//     cost and sum |r| together with the trial's g and H.  A rejected step
//     keeps the previous g and H (the parameters did not move), an accepted
//     one has its new g and H already, and eps is the accepted pass's
//     sum |r|: the same LM trajectory in exact arithmetic as the reference's
//     J pass + cost pass + eps pass;
//   * a reduce-scatter over the warp: each shuffle step halves the set of
//     sums a lane carries (62 shuffles leave lane l with sums 2l, 2l+1 of
//     g and H, 3 butterflies add the rest), then the G warps' partial sums
//     add through shared memory in a fixed order;
//   * the 10x10 CG in warp 0, row-parallel: lane a holds row a of the damped
//     matrix, computes (A p)_a, and 10 shuffles give every lane all of A p;
//     p, r, x and the dot products (pairwise trees) are replicated in every
//     lane, so a CG step has no reduction over lanes.  The other warps wait
//     at the block's barrier;
//   * the trial's geometry in warp 0 too: one transcendental per lane
//     (5 tanh, 3 sigmoids), shuffled to every lane, which forms the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// running sums of a pass: g (10), H packed upper triangle row by row (55),
// cost, sum |r|
constexpr int NG = 10, NH = 55, I_COST = NG + NH, I_ABS = I_COST + 1;
constexpr int NSUM = I_ABS + 1;   // 67
constexpr int NSCAT = 64;         // the reduce-scatter's share; 64..66 apart
constexpr int NRED = 68;          // padded row of the cross-warp buffer
// resident warps each SM should hold, for the register budget
constexpr int TARGET_WARPS = 16;

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

// index of H[i][j], i <= j, in the packed upper triangle
__host__ __device__ constexpr int hidx(int i, int j) {
  return NG + i * (19 - i) / 2 + j;
}

// Per-spot geometry at params: A6, centre offset and the pixel-independent
// coefficients of J^T rows 2..9:
//   rows 2..4 (centre): dq = cd[i] . d       (cd = -2 M GC column)
//   rows 5..9 (widths, angles): dq = ga[t] . basis6
struct __align__(16) Geometry {
  float ga[5][8];   // [param 5+t][basis term], rows padded to 8
  float cd[3][4];   // [centre param i][component of d], padded to 4
  float a[6];
  float c[3];
};

// The geometry from its transcendental scalars: th = tanh(-c/2) of the
// centre params, sig = sigmoid(-w) and s = 1/ws of the width params,
// p, t = tanh(-./2) of the angle params.
__device__ __forceinline__ void geometry(const float (&th)[3],
                                         const float (&sig)[3],
                                         const float (&s)[3], float p, float t,
                                         float dl, float min_ws, float max_ws,
                                         Geometry& g) {
#pragma unroll
  for (int i = 0; i < 3; ++i) g.c[i] = dl * th[i];
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

  // centre columns: GC[i][2+i] = -delta/2 (1 - tanh^2); cd = -2 M GC
  const float m[3][3] = {{g.a[0], 0.5f * g.a[3], 0.5f * g.a[4]},
                         {0.5f * g.a[3], g.a[1], 0.5f * g.a[5]},
                         {0.5f * g.a[4], 0.5f * g.a[5], g.a[2]}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float gc = -0.5f * dl * (1.0f - th[i] * th[i]);
#pragma unroll
    for (int j = 0; j < 3; ++j) g.cd[i][j] = -2.0f * (m[j][i] * gc);
  }
  // width columns: dA/ds_i * ds_i/dw_i, ds/dw = (max-min) sig (1-sig) s^2
  const float d_s[3][6] = {
      {pc2 * tc2, pc2 * t2, p2, 2.0f * tc * t * pc2, -2.0f * p * pc * tc,
       -2.0f * p * pc * t},
      {t2, tc2, 0.0f, -2.0f * tc * t, 0.0f, 0.0f},
      {p2 * tc2, p2 * t2, pc2, 2.0f * tc * t * p2, 2.0f * p * pc * tc,
       2.0f * p * pc * t}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ds = (max_ws - min_ws) * sig[i] * (1.0f - sig[i]) * s[i] * s[i];
#pragma unroll
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
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    g.ga[3][k] = d_p[k] * dp;
    g.ga[4][k] = d_t[k] * dt;
  }
}

// a 16-byte shared-memory load the compiler keeps where it is
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

// What the block shares besides the pixels: the G warps' partial sums, the
// summed g/H/cost of the current point and of the trial, and the trial's
// geometry and scalars.
template <int G>
struct Shared {
  float red[G][NRED];
  float tot[2][NRED];
  Geometry geo;
  float h, ebk, in_range;   // log-height, exp(clip(bk)), bk in [-70, 70]
  float npx;                // pixels under the mask
  float prm[10], trial[10]; // the current point and the trial
};

// One pass over the spot's pixels at the geometry in `sh`: this thread's
// share of g, H, cost and sum |r| in s.
template <int G>
__device__ __forceinline__ void pixel_pass(const Shared<G>& sh,
                                           const float* __restrict__ spx,
                                           const float* __restrict__ sd0,
                                           const float* __restrict__ sd1,
                                           const float* __restrict__ sd2,
                                           const float* __restrict__ smk,
                                           int p, float (&s)[NSUM]) {
#pragma unroll
  for (int k = 0; k < NSUM; ++k) s[k] = 0.0f;
  const Geometry& g = sh.geo;
  const float hh = sh.h, ebk = sh.ebk, jt0 = sh.ebk * sh.in_range;
#pragma unroll 1
  for (int q = threadIdx.x; q < p; q += G * 32) {
    const float d0 = sd0[q] - g.c[0], d1 = sd1[q] - g.c[1],
                d2 = sd2[q] - g.c[2];
    const float b[6] = {d0 * d0, d1 * d1, d2 * d2, d0 * d1, d0 * d2, d1 * d2};
    const float qf = g.a[0] * b[0] + g.a[1] * b[1] + g.a[2] * b[2] +
                     g.a[3] * b[3] + g.a[4] * b[4] + g.a[5] * b[5];
    const float mk = smk[q];
    const float peak = expf(hh - 0.5f * qf);
    const float r = (ebk + peak - spx[q]) * mk;
    s[I_COST] += r * r;
    s[I_ABS] += fabsf(r);
    const float hp = -0.5f * peak * mk;
    float jt[10];
    jt[0] = jt0 * mk;
    jt[1] = peak * mk;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = lds4(&g.cd[c][0]);
      jt[2 + c] = hp * (v.x * d0 + v.y * d1 + v.z * d2);
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float4 u = lds4(&g.ga[c][0]), v = lds4(&g.ga[c][4]);
      jt[5 + c] = hp * (u.x * b[0] + u.y * b[1] + u.z * b[2] + u.w * b[3] +
                        v.x * b[4] + v.y * b[5]);
    }
#pragma unroll
    for (int a = 0; a < 10; ++a) {
      s[a] += jt[a] * r;
#pragma unroll
      for (int c = a; c < 10; ++c) s[hidx(a, c)] += jt[a] * jt[c];
    }
  }
}

// c ? a : b as a value select: the running sums must stay in registers,
// and a select between two array elements may otherwise become a computed
// address into local memory.
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// One step of the reduce-scatter: lanes HALF / 2 apart swap halves of
// s[0, 2 HALF), each keeping the half its lane bit selects, summed.  (A
// template so that every index is a constant and s stays in registers.)
template <int HALF>
__device__ __forceinline__ void scatter_step(float (&s)[NSUM], int lane) {
  const bool up = lane & (HALF / 2);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = pick(up, s[i], s[i + HALF]);
    const float keep = pick(up, s[i + HALF], s[i]);
    s[i] = keep + __shfl_xor_sync(FULL, send, HALF / 2);
  }
}

// Sum s over the block into tot: a reduce-scatter in each warp (lane l ends
// with sums 2l and 2l+1 of the first 64, every lane with the last 3), the
// warps' shares through red, added in warp order by warp 0.  Ends with
// warp 0 synchronised; the caller's barrier comes before.
template <int G>
__device__ __forceinline__ void block_sum(Shared<G>& sh, float (&s)[NSUM],
                                          float* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  scatter_step<32>(s, lane);
  scatter_step<16>(s, lane);
  scatter_step<8>(s, lane);
  scatter_step<4>(s, lane);
  scatter_step<2>(s, lane);
#pragma unroll
  for (int k = NSCAT; k < NSUM; ++k) s[k] = warp_sum(s[k]);
  float* out = G == 1 ? tot : sh.red[w];
  out[2 * lane] = s[0];
  out[2 * lane + 1] = s[1];
  if (lane < NSUM - NSCAT)
    out[NSCAT + lane] = pick(lane == 0, s[NSCAT],
                             pick(lane == 1, s[NSCAT + 1], s[NSCAT + 2]));
  if (G == 1) {
    __syncwarp();
    return;
  }
  __syncthreads();
  if (w == 0) {
    for (int k = lane; k < NSUM; k += 32) {
      float v = sh.red[0][k];
#pragma unroll
      for (int j = 1; j < G; ++j) v += sh.red[j][k];
      tot[k] = v;
    }
    __syncwarp();
  }
}

// a pairwise sum of 10 values (depth 4)
__device__ __forceinline__ float sum10(const float (&t)[10]) {
  return (((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7])))
         + (t[8] + t[9]);
}

// CG on (H + lam diag H + 1e-8 I) x = -g in one warp: lane a < 10 holds row
// a of the matrix; p, r, x replicated in every lane.  Returns x in every
// lane.
__device__ __forceinline__ void cg_solve(const float* tot, float lam,
                                         int cg_iters, float (&x)[10]) {
  const int lane = threadIdx.x & 31;
  float arow[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    float v = 0.0f;
    if (lane < 10) {
      v = tot[lane <= k ? hidx(lane, k) : hidx(k, lane)];
      if (k == lane) v = v + lam * v + 1e-8f;
    }
    arow[k] = v;
  }
  float r[10], pp[10], t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    x[k] = 0.0f;
    r[k] = -tot[k];
    pp[k] = r[k];
    t[k] = r[k] * r[k];
  }
  float rs = sum10(t);
  for (int c = 0; c < cg_iters; ++c) {
    float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 10; k += 2) {
      m0 += arow[k] * pp[k];
      m1 += arow[k + 1] * pp[k + 1];
    }
    const float mine = m0 + m1;
    float ap[10], t[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) ap[k] = __shfl_sync(FULL, mine, k);
#pragma unroll
    for (int k = 0; k < 10; ++k) t[k] = pp[k] * ap[k];
    const float pap = sum10(t);
    const float alpha = rs / nan_max(pap, 1e-20f);
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      x[k] += alpha * pp[k];
      r[k] -= alpha * ap[k];
      t[k] = r[k] * r[k];
    }
    const float rs_new = sum10(t);
    const float beta = rs_new / nan_max(rs, 1e-20f);
#pragma unroll
    for (int k = 0; k < 10; ++k) pp[k] = r[k] + beta * pp[k];
    rs = rs_new;
  }
}

// The geometry and scalars of `prm` (in shared memory) into sh, by warp 0:
// one transcendental scalar per lane (tanh of params 2, 3, 4, 8, 9 in lanes
// 0-4, the width sigmoids and 1/ws in lanes 0-2), shuffled to every lane,
// which forms the rest; lane 0 stores it.
template <int G>
__device__ __forceinline__ void set_point(Shared<G>& sh, const float* prm,
                                          float dl, float min_ws,
                                          float max_ws) {
  const int lane = threadIdx.x & 31;
  const float th_l = tanhf(-prm[lane < 3 ? 2 + lane : lane == 3 ? 8 : 9] /
                           2.0f);
  const float sig_l = sigmoid(-prm[5 + min(lane, 2)]);
  const float s_l = 1.0f / (min_ws + (max_ws - min_ws) * sig_l);
  float th[3], sig[3], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    th[i] = __shfl_sync(FULL, th_l, i);
    sig[i] = __shfl_sync(FULL, sig_l, i);
    s[i] = __shfl_sync(FULL, s_l, i);
  }
  const float p = __shfl_sync(FULL, th_l, 3), t = __shfl_sync(FULL, th_l, 4);
  Geometry g;
  geometry(th, sig, s, p, t, dl, min_ws, max_ws, g);
  if (lane == 0) {
    sh.geo = g;
    sh.h = prm[1];
    sh.ebk = expf(fminf(fmaxf(prm[0], -70.0f), 70.0f));
    sh.in_range = (prm[0] >= -70.0f && prm[0] <= 70.0f) ? 1.0f : 0.0f;
  }
}

template <int G>
__global__ void __launch_bounds__(G * 32, TARGET_WARPS / G)
lm_fit_kernel(const float* __restrict__ pixels, const float* __restrict__ coords,
              const unsigned char* __restrict__ mask,
              const float* __restrict__ centers, const float* __restrict__ delta,
              const float* __restrict__ params0, float* __restrict__ params_out,
              float* __restrict__ eps_out, int p, int lm_iters, int cg_iters,
              float min_w, float max_w) {
  __shared__ Shared<G> sh;
  extern __shared__ float spix[];   // px, d0, d1, d2, mk: P each
  float* spx = spix;
  float* sd0 = spix + p;
  float* sd1 = spix + 2 * p;
  float* sd2 = spix + 3 * p;
  float* smk = spix + 4 * p;
  const int spot = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float min_ws = min_w * min_w, max_ws = max_w * max_w;
  const float dl = delta[spot];

  if (threadIdx.x == 0) sh.npx = 0.0f;
  const float c0 = centers[3 * spot], c1 = centers[3 * spot + 1],
              c2 = centers[3 * spot + 2];
  float nmk = 0.0f;
  for (int q = threadIdx.x; q < p; q += G * 32) {
    const size_t o = (size_t)spot * p + q;
    spx[q] = pixels[o];
    const float m = mask[o] ? 1.0f : 0.0f;
    smk[q] = m;
    nmk += m;
    sd0[q] = coords[3 * o] - c0;
    sd1[q] = coords[3 * o + 1] - c1;
    sd2[q] = coords[3 * o + 2] - c2;
  }
  nmk = warp_sum(nmk);
  __syncthreads();
  // integer counts: exact in any order
  if (lane == 0) atomicAdd(&sh.npx, nmk);

  // warp 0 carries the state: the points in sh, the rest in its lanes
  float cost = 0.0f, sabs = 0.0f, lam = 1e-3f;
  int cur = 0;
  if (threadIdx.x < 10) sh.prm[threadIdx.x] = params0[10 * spot + threadIdx.x];
  __syncwarp();
  if (w == 0) set_point(sh, sh.prm, dl, min_ws, max_ws);
  __syncthreads();
  float s[NSUM];
  pixel_pass(sh, spx, sd0, sd1, sd2, smk, p, s);
  block_sum(sh, s, sh.tot[0]);
  if (w == 0) {
    cost = sh.tot[0][I_COST];
    sabs = sh.tot[0][I_ABS];
  }

  for (int it = 0; it < lm_iters; ++it) {
    bool finite = true;
    if (w == 0) {
      float x[10];
      cg_solve(sh.tot[cur], lam, cg_iters, x);
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        const float t = sh.prm[k] + x[k];
        finite = finite && isfinite(t);
        if (lane == 0) sh.trial[k] = t;
      }
      __syncwarp();
      set_point(sh, sh.trial, dl, min_ws, max_ws);
    }
    __syncthreads();   // the trial's geometry; red is free
    pixel_pass(sh, spx, sd0, sd1, sd2, smk, p, s);
    block_sum(sh, s, sh.tot[cur ^ 1]);
    if (w == 0) {
      const float new_cost = sh.tot[cur ^ 1][I_COST];
      if (new_cost < cost && finite) {
        if (lane < 10) sh.prm[lane] = sh.trial[lane];
        __syncwarp();
        cost = new_cost;
        sabs = sh.tot[cur ^ 1][I_ABS];
        cur ^= 1;
        lam = fmaxf(lam / 3.0f, 1e-7f);
      } else {
        lam = fminf(lam * 3.0f, 1e7f);
      }
    }
  }

  if (threadIdx.x < 10) params_out[10 * spot + threadIdx.x] = sh.prm[threadIdx.x];
  if (threadIdx.x == 0) eps_out[spot] = sabs / fmaxf(sh.npx, 1.0f);
}

// warps per spot for P pixels: at most 8 pixels a thread
int group_warps(int p) {
  return p <= 256 ? 1 : p <= 512 ? 2 : 4;
}

const void* kernel_for(int g) {
  return g == 1 ? reinterpret_cast<const void*>(&lm_fit_kernel<1>)
       : g == 2 ? reinterpret_cast<const void*>(&lm_fit_kernel<2>)
                : reinterpret_cast<const void*>(&lm_fit_kernel<4>);
}

template <int G>
cudaError_t launch(const float* pixels, const float* coords,
                   const unsigned char* mask, const float* centers,
                   const float* delta, const float* params0, float* params,
                   float* eps, int n, int p, int lm_iters, int cg_iters,
                   float min_w, float max_w, cudaStream_t stream) {
  const size_t smem = 5 * sizeof(float) * (size_t)p;
  lm_fit_kernel<G><<<n, G * 32, smem, stream>>>(
      pixels, coords, mask, centers, delta, params0, params, eps, p,
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
  const int g = group_warps(p);
  return (int)(g == 1 ? launch<1>(px, co, mk, ce, dl, p0, out, ep, n, p,
                                  lm_iters, cg_iters, min_w, max_w, s)
             : g == 2 ? launch<2>(px, co, mk, ce, dl, p0, out, ep, n, p,
                                  lm_iters, cg_iters, min_w, max_w, s)
                      : launch<4>(px, co, mk, ce, dl, p0, out, ep, n, p,
                                  lm_iters, cg_iters, min_w, max_w, s));
}

// Resident blocks (spots) per SM of the kernel P pixels launch, its threads
// and dynamic shared-memory bytes per block, as the card grants them (for
// logging).
extern "C" int lm_fit_occupancy(int p, int* blocks, int* threads,
                                int* smem_bytes) {
  if (p <= 0 || p > 1024) return (int)cudaErrorInvalidValue;
  const int g = group_warps(p);
  *threads = 32 * g;
  *smem_bytes = (int)(5 * sizeof(float) * (size_t)p);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for(g), *threads, *smem_bytes);
}

extern "C" const char* ia3_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
