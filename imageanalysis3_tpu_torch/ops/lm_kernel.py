"""The fused constrained-Gaussian LM fit: CUDA kernel and its plain version.

The counterpart of ``imageanalysis3_tpu/ops/pallas_lm.py:lm_fit_pallas``
(``_lm_kernel``).  :func:`lm_fit` takes gathered pixel blocks and runs the
whole `lm_iters`-iteration constrained Levenberg-Marquardt fit of every
spot:

  * model exp(clip(bk, +-70)) + exp(h - q/2), with q the rotated quadratic
    form of the sigmoid-boxed widths and the tanh-boxed centre offset;
  * J^T rows 0/1 in closed form, rows 2..9 from the hand-written 9x10
    Jacobian of the per-spot geometry (:func:`geometry_jacobian`, where
    the TPU kernel traces ``jax.linearize``);
  * the damped normal equations (H + lam*diag(H) + 1e-8 I) solved by
    12-step CG, a step accepted when the cost drops and the result is
    finite, lam /3 or *3 clamped to [1e-7, 1e7];
  * eps = mean |residual| over the mask.

A CUDA tensor goes to ``csrc/lm_fit.cu`` (one warp per spot); a CPU tensor
to :func:`lm_fit_plain`, the batched PyTorch engine the CPU path uses.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

#: kernel launches made by :func:`lm_fit_cuda` (reset by callers that
#: check which path ran)
launches = 0


# ---------------------------------------------------------------------------
# Per-spot geometry and its hand-written Jacobian
# ---------------------------------------------------------------------------


def _nan_max(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) that keeps NaN (jnp.maximum semantics)."""
    return torch.where(torch.isnan(x) | (x > floor), x,
                       torch.full_like(x, floor))


def quadform_coeffs(t, p, s1, s2, s3):
    """Coefficients of the rotated precision quadratic form
    (reference calc_f :268-283); s_i = 1/width_i^2."""
    p2, t2 = p * p, t * t
    tc2, pc2 = 1 - t2, 1 - p2
    tc = torch.sqrt(tc2.clamp_min(0.0))
    pc = torch.sqrt(pc2.clamp_min(0.0))
    a11 = pc2 * tc2 * s1 + t2 * s2 + p2 * tc2 * s3
    a22 = pc2 * t2 * s1 + tc2 * s2 + p2 * t2 * s3
    a33 = p2 * s1 + pc2 * s3
    a12 = 2 * tc * t * (pc2 * s1 - s2 + p2 * s3)
    a13 = 2 * p * pc * tc * (s3 - s1)
    a23 = 2 * p * pc * t * (s3 - s1)
    return a11, a22, a33, a12, a13, a23


def _sqrt_clamped_jvp(u: torch.Tensor, du: torch.Tensor,
                      root: torch.Tensor) -> torch.Tensor:
    """Tangent of sqrt(max(u, 0)) as JAX forms it: max passes du where
    u > 0, half of it on the tie u == 0, none below; sqrt scales by
    0.5 / root."""
    dmax = torch.where(u > 0, du, torch.where(u == 0, 0.5 * du,
                                              torch.zeros_like(du)))
    return dmax * (0.5 / root)


def to_ws(wp, min_ws, max_ws):
    """Sigmoid box of the squared widths: (max-min)/(1+e^w) + min."""
    return min_ws + (max_ws - min_ws) * torch.sigmoid(-wp)


def to_sine(tp):
    """Tanh box of the centre offsets (times delta) and the sine angles:
    2/(1+e^x) - 1 == tanh(-x/2), numerically stable."""
    return torch.tanh(-tp / 2.0)


def geometry_jacobian(params: torch.Tensor, delta: torch.Tensor,
                      min_w: float, max_w: float):
    """The per-spot geometry -- quadratic-form coefficients A6 and centre
    offset -- of constrained params (N, 10), and its hand-written Jacobian.

    Returns (A6 (N, 6), coff (N, 3), GA (N, 6, 10), GC (N, 3, 10)).
    Columns 0/1 (log-bk, log-h) are zero; column 2+i moves only the
    centre offset i, 5+i only s_i = 1/ws_i, 8 only p, 9 only t, so each
    column is a chain of one scalar derivative into the partials of the
    quadratic form.
    """
    n = params.shape[0]
    min_ws, max_ws = min_w * min_w, max_w * max_w
    th = to_sine(params[:, 2:5])
    coff = delta[:, None] * th
    sig = torch.sigmoid(-params[:, 5:8])
    s = 1.0 / to_ws(params[:, 5:8], min_ws, max_ws)
    p = to_sine(params[:, 8])
    t = to_sine(params[:, 9])
    s1, s2, s3 = s[:, 0], s[:, 1], s[:, 2]
    a6 = torch.stack(quadform_coeffs(t, p, s1, s2, s3), dim=1)

    p2, t2 = p * p, t * t
    tc2, pc2 = 1 - t2, 1 - p2
    tc = torch.sqrt(tc2.clamp_min(0.0))
    pc = torch.sqrt(pc2.clamp_min(0.0))
    zero = torch.zeros_like(p)
    # partials of (a11, a22, a33, a12, a13, a23) w.r.t. s1, s2, s3
    d_s1 = [pc2 * tc2, pc2 * t2, p2, 2 * tc * t * pc2, -2 * p * pc * tc,
            -2 * p * pc * t]
    d_s2 = [t2, tc2, zero, -2 * tc * t, zero, zero]
    d_s3 = [p2 * tc2, p2 * t2, pc2, 2 * tc * t * p2, 2 * p * pc * tc,
            2 * p * pc * t]
    # ... w.r.t. p (pc2 = 1 - p^2, pc = sqrt(max(pc2, 0)))
    dpc = _sqrt_clamped_jvp(pc2, -2 * p, pc)
    s31 = s3 - s1
    d_p = [2 * p * tc2 * s31, 2 * p * t2 * s31, -2 * p * s31,
           4 * p * tc * t * s31, 2 * (pc + p * dpc) * tc * s31,
           2 * (pc + p * dpc) * t * s31]
    # ... w.r.t. t (tc2 = 1 - t^2, tc = sqrt(max(tc2, 0)))
    dtc = _sqrt_clamped_jvp(tc2, -2 * t, tc)
    m12 = pc2 * s1 - s2 + p2 * s3
    d_t = [-2 * t * m12, 2 * t * m12, zero,
           2 * (dtc * t + tc) * m12, 2 * p * pc * dtc * s31,
           2 * p * pc * s31]
    # scalar chains: d s_i / d w_i, d p / d param8, d t / d param9
    ds = (max_ws - min_ws) * sig * (1 - sig) * s * s          # (N, 3)
    dp = -0.5 * (1 - p2)
    dt = -0.5 * (1 - t2)
    ga = torch.zeros((n, 6, 10), dtype=params.dtype, device=params.device)
    for row in range(6):
        ga[:, row, 5] = d_s1[row] * ds[:, 0]
        ga[:, row, 6] = d_s2[row] * ds[:, 1]
        ga[:, row, 7] = d_s3[row] * ds[:, 2]
        ga[:, row, 8] = d_p[row] * dp
        ga[:, row, 9] = d_t[row] * dt
    gc = torch.zeros((n, 3, 10), dtype=params.dtype, device=params.device)
    for i in range(3):
        gc[:, i, 2 + i] = -0.5 * delta * (1 - th[:, i] * th[:, i])
    return a6, coff, ga, gc


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _model_residual(params, rel, px, mk, delta, min_w, max_w):
    """(peak, masked residual, d, basis6, exp(bk)) at `params` for relative
    coordinates `rel` (N, P, 3)."""
    a6, coff, _, _ = geometry_jacobian(params, delta, min_w, max_w)
    return _residual_from_geometry(params, a6, coff, rel, px, mk)


def _residual_from_geometry(params, a6, coff, rel, px, mk):
    d = rel - coff[:, None, :]
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    basis6 = torch.stack([d0 * d0, d1 * d1, d2 * d2, d0 * d1, d0 * d2,
                          d1 * d2], dim=1)                      # (N, 6, P)
    q = (a6[:, :, None] * basis6).sum(dim=1)
    peak = torch.exp(params[:, 1:2] - 0.5 * q)
    ebk = torch.exp(params[:, 0:1].clamp(-70.0, 70.0))
    r = (ebk + peak - px) * mk
    return peak, r, d, basis6, ebk


def cg_solve_spd(a: torch.Tensor, b: torch.Tensor,
                 iters: int = 12) -> torch.Tensor:
    """Solve batched SPD `a @ x = b` ((N, 10, 10), (N, 10)) by unrolled
    conjugate gradient with the 1e-20 guards of the JAX engine."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum(dim=1)
    for _ in range(iters):
        ap = torch.einsum("nij,nj->ni", a, p)
        alpha = rs / _nan_max((p * ap).sum(dim=1), 1e-20)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rs_new = (r * r).sum(dim=1)
        p = r + (rs_new / _nan_max(rs, 1e-20))[:, None] * p
        rs = rs_new
    return x


def lm_fit_plain(pixels: torch.Tensor, coords: torch.Tensor,
                 mask: torch.Tensor, centers: torch.Tensor,
                 delta: torch.Tensor, params0: torch.Tensor,
                 min_w: float, max_w: float, lm_iters: int = 8,
                 cg_iters: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched constrained LM fit in plain PyTorch -> (params (N, 10),
    eps (N,)); the same arithmetic as ``csrc/lm_fit.cu``."""
    f32 = torch.float32
    px = pixels.to(f32)
    mk = mask.to(f32)
    rel = coords.to(f32) - centers.to(f32)[:, None, :]
    delta = delta.to(f32)
    params = params0.to(f32)
    n = params.shape[0]

    def cost_of(prm):
        _, r, _, _, _ = _model_residual(prm, rel, px, mk, delta, min_w,
                                        max_w)
        return (r * r).sum(dim=1)

    cost = cost_of(params)
    lam = torch.full((n,), 1e-3, dtype=f32, device=params.device)
    eye = torch.eye(10, dtype=f32, device=params.device)
    for _ in range(lm_iters):
        a6, coff, ga, gc = geometry_jacobian(params, delta, min_w, max_w)
        peak, r, d, basis6, ebk = _residual_from_geometry(
            params, a6, coff, rel, px, mk)
        # Cd = -2 M Gc with M the symmetric quadform matrix
        a11, a22, a33, a12, a13, a23 = a6.unbind(dim=1)
        mm = torch.stack([torch.stack([a11, 0.5 * a12, 0.5 * a13], -1),
                          torch.stack([0.5 * a12, a22, 0.5 * a23], -1),
                          torch.stack([0.5 * a13, 0.5 * a23, a33], -1)],
                         dim=1)                                # (N, 3, 3)
        cd = -2.0 * torch.bmm(mm, gc)                          # (N, 3, 10)
        dq = torch.bmm(ga.transpose(1, 2), basis6) \
            + torch.bmm(cd.transpose(1, 2), d.transpose(1, 2))  # (N, 10, P)
        jt = (-0.5 * peak * mk)[:, None, :] * dq
        in_range = ((params[:, 0] >= -70.0)
                    & (params[:, 0] <= 70.0)).to(f32)
        jt[:, 0] = (ebk * in_range[:, None]) * mk
        jt[:, 1] = peak * mk
        g = torch.einsum("nip,np->ni", jt, r)
        h = torch.einsum("nip,njp->nij", jt, jt)
        diag = torch.diagonal(h, dim1=1, dim2=2)
        a = h + (lam[:, None] * diag)[:, :, None] * eye + 1e-8 * eye
        new_params = params + cg_solve_spd(a, -g, cg_iters)
        new_cost = cost_of(new_params)
        ok = (new_cost < cost) & torch.isfinite(new_params).all(dim=1)
        params = torch.where(ok[:, None], new_params, params)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.where(ok, (lam / 3.0).clamp_min(1e-7),
                          (lam * 3.0).clamp_max(1e7))
    _, r, _, _, _ = _model_residual(params, rel, px, mk, delta, min_w,
                                    max_w)
    eps = r.abs().sum(dim=1) / mk.sum(dim=1).clamp_min(1.0)
    return params, eps


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_MAX_P = 1024       # 32 pixels per lane


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"lm_fit_cuda: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"lm_fit_cuda: {name} must be {dtype}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lm_fit_cuda: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lm_fit_cuda: {name} must be contiguous")


def lm_fit_cuda(pixels: torch.Tensor, coords: torch.Tensor,
                mask: torch.Tensor, centers: torch.Tensor,
                delta: torch.Tensor, params0: torch.Tensor,
                min_w: float, max_w: float, lm_iters: int = 8,
                cg_iters: int = 12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/lm_fit.cu`` on the current stream."""
    global launches
    n, p = pixels.shape
    _check(pixels, "pixels", torch.float32, (n, p))
    _check(coords, "coords", torch.float32, (n, p, 3))
    _check(mask, "mask", torch.bool, (n, p))
    _check(centers, "centers", torch.float32, (n, 3))
    _check(delta, "delta", torch.float32, (n,))
    _check(params0, "params0", torch.float32, (n, 10))
    if not 1 <= p <= _MAX_P:
        raise ValueError(f"lm_fit_cuda: P={p} pixels per spot, the "
                         f"kernel takes 1..{_MAX_P}")
    params = torch.empty((n, 10), dtype=torch.float32, device=pixels.device)
    eps = torch.empty((n,), dtype=torch.float32, device=pixels.device)
    if n == 0:
        return params, eps
    lib = _build.load("lm_fit")
    fn = lib.lm_fit_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    rc = fn(pixels.data_ptr(), coords.data_ptr(), mask.data_ptr(),
            centers.data_ptr(), delta.data_ptr(), params0.data_ptr(),
            params.data_ptr(), eps.data_ptr(), n, p, int(lm_iters),
            int(cg_iters), float(min_w), float(max_w),
            torch.cuda.current_stream(pixels.device).cuda_stream)
    if rc != 0:
        err = lib.ia3_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"lm_fit kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    launches += 1
    return params, eps


def lm_fit(pixels: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
           centers: torch.Tensor, delta: torch.Tensor,
           params0: torch.Tensor, min_w: float, max_w: float,
           lm_iters: int = 8, cg_iters: int = 12
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched constrained LM fit -> (params (N, 10), eps (N,)): the CUDA
    kernel for CUDA tensors, :func:`lm_fit_plain` for CPU tensors."""
    if pixels.is_cuda:
        return lm_fit_cuda(pixels.to(torch.float32).contiguous(),
                           coords.to(torch.float32).contiguous(),
                           mask.to(torch.bool).contiguous(),
                           centers.to(torch.float32).contiguous(),
                           delta.to(torch.float32).contiguous(),
                           params0.to(torch.float32).contiguous(),
                           min_w, max_w, lm_iters, cg_iters)
    if pixels.device.type != "cpu":
        raise ValueError(f"lm_fit: no kernel for device {pixels.device}")
    return lm_fit_plain(pixels, coords, mask, centers, delta, params0,
                        min_w, max_w, lm_iters, cg_iters)
