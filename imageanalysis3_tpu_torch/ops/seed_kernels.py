"""Seeding classifier kernels: four CUDA kernels and their plain versions.

The counterparts of the four seeding functions of
``imageanalysis3_tpu/ops/pallas_kernels.py`` that reach ``pl.pallas_call``:

* :func:`fused_seed_classify_pyramid` (``csrc/seed_pyramid.cu``): the
  pyramid-background classifier.  The background Gaussian (sigma ~7.5, a
  61-tap reach) runs on a 4x4 xy-pooled grid at sigma/4 and is bilinearly
  upsampled inside the classifier; the host prep (:func:`pyramid_background`:
  mean pool, bg blur, plateau sentinel) stays in PyTorch.
* :func:`fused_seed_classify` (``csrc/seed_classify.cu``): the exact
  classifier.  Both z passes run as one banded matmul (:func:`z_pass_pair`);
  the kernel xy-blurs both stacks plane by plane on chip and emits the 3^3
  stencil and classification, so the blurred stacks never reach device
  memory.
* :func:`dual_gaussian_blur` (``csrc/dual_blur.cu``): the x+y blur of two
  z-passed stacks in one launch, for configs the exact classifier cannot
  take.
* :func:`level_stencil` (``csrc/level_stencil.cu``): the 3^3 max/min
  stencil and level map over two given blurred stacks.

The classifiers return ``(qdiff, counts)``: the fg-bg signal where the voxel
qualifies (3^3 local max inside the edge margin, -inf elsewhere) and the
per-level histogram of those voxels.  Each dispatcher runs the CUDA kernel
for a CUDA tensor and the plain version for a CPU tensor, and raises on any
other device.  Kernel and plain version sum every blur in the same tap
order, so they agree bit for bit, with one exception: for the default taps
(7 and 61) ``seed_classify.cu`` and ``dual_blur.cu`` compute the
background's x and y passes on the tensor cores as banded split-TF32
products (``csrc/band_mma.cuh``, :func:`band_fragments`; its arithmetic
model is :func:`blur_xy_split_tf32_plain`), and are held to the JAX tests'
tolerances (the fused classifier's, the dual blur's) instead.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build
from .filters import (_band_matrix, _conv1d_along_axis, _pad_axis,
                      _shift_add, _window_reduce, full_f32_matmul,
                      gaussian_kernel1d)

#: launches of each kernel's CUDA wrapper since the last reset
launches: Dict[str, int] = {"seed_pyramid": 0, "seed_classify": 0,
                            "dual_blur": 0, "level_stencil": 0}

MAX_FG_RADIUS = 12     # seed_pyramid
MAX_RADIUS = 36        # seed_classify / dual_blur (csrc/seed_common.cuh)
MAX_LEVELS = 128


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _check(kernel: str, t: torch.Tensor, name: str, shape,
           dtype=torch.float32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _launch(kernel: str, argtypes, *args) -> None:
    """Call ``<kernel>_launch`` of ``csrc/<kernel>.cu`` on the current
    stream (the last argument), raise on a nonzero rc, count the launch."""
    lib = _build.load(kernel)
    fn = getattr(lib, f"{kernel}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    rc = fn(*args)
    if rc != 0:
        err = lib.ia3_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    launches[kernel] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _host_taps(kernel: np.ndarray) -> np.ndarray:
    taps = np.ascontiguousarray(kernel, np.float32)
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) // 2 > MAX_RADIUS:
        raise ValueError(f"taps must be an odd-length 1D kernel of radius "
                         f"<= {MAX_RADIUS}, got shape {taps.shape}")
    return taps


def _edge_ok(shape, d: int, device) -> torch.Tensor:
    z, x, y = shape
    zi = torch.arange(z, device=device)[:, None, None]
    xi = torch.arange(x, device=device)[None, :, None]
    yi = torch.arange(y, device=device)[None, None, :]
    return ((zi >= d) & (zi <= z - d) & (xi >= d) & (xi <= x - d)
            & (yi >= d) & (yi <= y - d))


def _levels(diff: torch.Tensor, th: float, n_lvl: int) -> torch.Tensor:
    """clip(ceil((1 - diff/th) n), 0, n) in the kernels' f32 arithmetic."""
    th_t = torch.tensor(th, dtype=torch.float32, device=diff.device)
    return torch.ceil((1.0 - diff / th_t) * float(n_lvl)).clamp(0, n_lvl)


def _histogram(level: torch.Tensor, n_lvl: int) -> torch.Tensor:
    return torch.bincount(level.to(torch.int64).reshape(-1),
                          minlength=n_lvl + 1)[:n_lvl].to(torch.int32)


def _clamped_th(th_seed) -> float:
    return float(max(np.float32(float(th_seed)), np.float32(1e-6)))


def _dispatch(t: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor (run the kernel), False for a CPU tensor (run
    the plain version); raises on any other device."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return False


def _blur_xy(im: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """x then y 'reflect' pass by shift-add: the order the kernels sum in."""
    return _shift_add(_shift_add(im, kernel, 1, "reflect"), kernel, 2,
                      "reflect")


# ---------------------------------------------------------------------------
# Pyramid-background classifier (seed_pyramid.cu)
# ---------------------------------------------------------------------------


def pyramid_background(im: torch.Tensor, sigma_bg: float) -> torch.Tensor:
    """Pooled, blurred, plateau-marked background (Z, X/4, Y/4) f32.

    4x4 mean pool; z blur with the full sigma_bg kernel, xy blur at
    sigma_bg/4 (pooling's own bandlimit makes up the rest).  Plateau guard:
    the exact classifier rejects voxels where min3(bg) == bg, i.e. flat
    background plateaus; here cells whose 3^3 neighbourhood has a range
    <= 4e-5 * max(|max|, 1) get the finite sentinel 1e9, which drives the
    signal far below any threshold.
    """
    z, x, y = im.shape
    pooled = im.to(torch.float32).reshape(z, x // 4, 4, y // 4, 4) \
        .sum(dim=(2, 4)) / 16.0
    k_bg = gaussian_kernel1d(sigma_bg)
    k_bgs = gaussian_kernel1d(float(sigma_bg) / 4.0)
    bgs = _conv1d_along_axis(pooled, k_bg, 0, "reflect")
    bgs = _conv1d_along_axis(bgs, k_bgs, 1, "reflect")
    bgs = _conv1d_along_axis(bgs, k_bgs, 2, "reflect")
    bmax = _window_reduce(bgs, 3, "nearest", "max")
    bmin = _window_reduce(bgs, 3, "nearest", "min")
    flat = (bmax - bmin) <= 4e-5 * bmax.abs().clamp_min(1.0)
    return torch.where(flat, torch.full_like(bgs, 1e9), bgs).contiguous()


def _blur_in_tap_order(im: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable 'reflect' blur along z, x, y by shift-add on every axis
    (also where gaussian_filter would take a band matmul, e.g. z <= 7):
    the kernel's exact arithmetic."""
    return _blur_xy(_shift_add(im, kernel, 0, "reflect"), kernel)


def _bilinear_axis(n_fine: int, n_pooled: int, device):
    """(i0, i1, w0, w1) of the half-pixel bilinear 4x upsample along one
    axis: source (g + 0.5)/4 - 0.5, indices edge-clamped."""
    s = (np.arange(n_fine) + 0.5) / 4.0 - 0.5
    f = np.floor(s)
    w1 = (s - f).astype(np.float32)
    i = f.astype(np.int64)
    i0 = np.clip(i, 0, n_pooled - 1)
    i1 = np.clip(i + 1, 0, n_pooled - 1)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(1.0 - w1).to(device),
            torch.from_numpy(w1).to(device))


def upsample_background(bgs: torch.Tensor, x: int, y: int) -> torch.Tensor:
    """Half-pixel bilinear 4x upsample of the pooled bg to (Z, X, Y): the y
    interpolation first, then x, as the kernel computes it."""
    iy0, iy1, wy0, wy1 = _bilinear_axis(y, bgs.shape[2], bgs.device)
    ix0, ix1, wx0, wx1 = _bilinear_axis(x, bgs.shape[1], bgs.device)
    by = bgs[:, :, iy0] * wy0 + bgs[:, :, iy1] * wy1
    return by[:, ix0, :] * wx0[:, None] + by[:, ix1, :] * wx1[:, None]


def fused_seed_classify_pyramid_plain(im: torch.Tensor, bgs: torch.Tensor,
                                      k_fg: np.ndarray, th: float,
                                      n_lvl: int, min_edge_distance: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/seed_pyramid.cu`` on the same inputs
    -> (qdiff (Z, X, Y) f32, counts (n_lvl,) int32)."""
    fg = _blur_in_tap_order(im.to(torch.float32), k_fg)
    local_max = _window_reduce(fg, 3, "reflect", "max") == fg
    bg = upsample_background(bgs, im.shape[1], im.shape[2])
    diff = fg - bg
    qualify = local_max & _edge_ok(im.shape, min_edge_distance, im.device)
    counts = _histogram(_levels(diff[qualify], th, n_lvl), n_lvl)
    return torch.where(qualify, diff, float("-inf")), counts


def fused_seed_classify_pyramid_cuda(im: torch.Tensor, bgs: torch.Tensor,
                                     k_fg: np.ndarray, th: float,
                                     n_lvl: int, min_edge_distance: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/seed_pyramid.cu`` on the current stream."""
    if im.ndim != 3:
        raise ValueError(f"seed_pyramid: im must be (Z, X, Y), got "
                         f"{tuple(im.shape)}")
    z, x, y = im.shape
    if x % 4 or y % 4:
        raise ValueError(f"seed_pyramid: X and Y must be multiples of 4, "
                         f"got {tuple(im.shape)}")
    _check("seed_pyramid", im, "im", (z, x, y))
    _check("seed_pyramid", bgs, "bgs", (z, x // 4, y // 4))
    r = len(k_fg) // 2
    if r > MAX_FG_RADIUS or not 1 <= n_lvl <= MAX_LEVELS:
        raise ValueError(f"seed_pyramid: fg radius {r} (max "
                         f"{MAX_FG_RADIUS}) / n_lvl {n_lvl} (max "
                         f"{MAX_LEVELS}) out of range")
    taps = np.ascontiguousarray(k_fg, np.float32)
    qdiff = torch.empty_like(im)
    counts = torch.zeros(n_lvl, dtype=torch.int32, device=im.device)
    _launch("seed_pyramid",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p],
            im.data_ptr(), bgs.data_ptr(), taps.ctypes.data, qdiff.data_ptr(),
            counts.data_ptr(), z, x, y, r, float(th), int(n_lvl),
            int(min_edge_distance), _stream(im))
    return qdiff, counts


def pyramid_occupancy_cuda(r: int) -> Tuple[int, int, int]:
    """(resident blocks per SM, threads per block, dynamic shared memory
    bytes per block) of the ``csrc/seed_pyramid.cu`` kernel that fg radius
    `r` launches, as the card grants them."""
    out = [ctypes.c_int(0) for _ in range(3)]
    fn = _build.load("seed_pyramid").seed_pyramid_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    rc = fn(int(r), *(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"seed_pyramid occupancy query failed ({rc})")
    return tuple(v.value for v in out)


def _pyramid_kernel_takes(shape, gfilt_size: float,
                          min_edge_distance: int) -> bool:
    """What the pyramid classifier itself needs: a (Z >= 2, X, Y) stack with
    X, Y multiples of 4, edge margin >= 1, fg radius <= 12."""
    r_fg = int(4.0 * float(gfilt_size) + 0.5)
    return (len(shape) == 3 and shape[0] >= 2 and min_edge_distance >= 1
            and r_fg <= MAX_FG_RADIUS
            and shape[1] % 4 == 0 and shape[2] % 4 == 0)


def pyramid_supported(shape, gfilt_size: float, background_gfilt_size: float,
                      filt_size: int, min_edge_distance: int,
                      slab_x: int) -> bool:
    """Whether ``get_seeds`` takes the pyramid classifier for this config:
    the JAX package's semantic conditions, which include every condition of
    the exact fused classifier (:func:`fused_supported`: both radii <= 36,
    ``x <= 2 * slab_x``); the TPU-only tiling gates are not copied."""
    return (fused_supported(shape, gfilt_size, background_gfilt_size,
                            filt_size, min_edge_distance, slab_x)
            and _pyramid_kernel_takes(shape, gfilt_size, min_edge_distance))


def fused_seed_classify_pyramid(im: torch.Tensor, sigma_fg: float,
                                sigma_bg: float, th_seed, n_lvl: int,
                                min_edge_distance: int = 2
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid-background classifier -> (qdiff, counts): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    imf = im.to(torch.float32).contiguous()
    if not (sigma_fg and sigma_bg
            and _pyramid_kernel_takes(imf.shape, sigma_fg, min_edge_distance)):
        raise ValueError("fused_seed_classify_pyramid: unsupported "
                         f"shape/config {tuple(imf.shape)}, sigma_fg "
                         f"{sigma_fg}, min_edge_distance "
                         f"{min_edge_distance}")
    k_fg = gaussian_kernel1d(sigma_fg)
    th = _clamped_th(th_seed)
    bgs = pyramid_background(imf, sigma_bg)
    if _dispatch(imf, "seed_pyramid"):
        return fused_seed_classify_pyramid_cuda(imf, bgs, k_fg, th, n_lvl,
                                                min_edge_distance)
    return fused_seed_classify_pyramid_plain(imf, bgs, k_fg, th, n_lvl,
                                             min_edge_distance)


# ---------------------------------------------------------------------------
# Exact classifier (seed_classify.cu)
# ---------------------------------------------------------------------------


def z_pass_pair(im: torch.Tensor, k_fg: np.ndarray, k_bg: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both 'reflect' z passes as ONE f32 banded matmul (2Z, Z) @ (Z, X*Y),
    the einsum the JAX package runs outside its kernel -> (fgz, bgz), two
    contiguous (Z, X, Y) views of one (2, Z, X, Y) buffer.  The product
    runs in full f32 whatever the caller's TF32 setting."""
    z, x, y = im.shape
    w = np.concatenate([_band_matrix(z, tuple(k_fg.tolist()), "reflect"),
                        _band_matrix(z, tuple(k_bg.tolist()), "reflect")])
    w = torch.from_numpy(w).to(im.device)
    with full_f32_matmul():
        out = torch.matmul(w, im.reshape(z, x * y)).reshape(2, z, x, y)
    return out[0], out[1]


def fused_seed_classify_plain(fgz: torch.Tensor, bgz: torch.Tensor,
                              k_fg: np.ndarray, k_bg: np.ndarray, th: float,
                              n_lvl: int, min_edge_distance: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/seed_classify.cu`` on the same
    z-passed inputs -> (qdiff (Z, X, Y) f32, counts (n_lvl,) int32)."""
    return classify_blurred(_blur_xy(fgz, k_fg), _blur_xy(bgz, k_bg), th,
                            n_lvl, min_edge_distance)


def classify_blurred(fg: torch.Tensor, bg: torch.Tensor, th: float,
                     n_lvl: int, min_edge_distance: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact classifier's in-range 3^3 stencil and level histogram on
    two blurred stacks -> (qdiff, counts)."""
    local_max = ((_window_reduce(fg, 3, "constant", "max") == fg)
                 & (_window_reduce(bg, 3, "constant", "min") != bg))
    diff = fg - bg
    qualify = local_max & _edge_ok(fg.shape, min_edge_distance, fg.device)
    counts = _histogram(_levels(diff[qualify], th, n_lvl), n_lvl)
    return torch.where(qualify, diff, float("-inf")), counts


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 `x` as two TF32 values (hi, lo), x = hi + lo up to 2^-22
    relative: hi rounds x to 10 mantissa bits (to nearest, ties away from
    zero, PTX ``cvt.rna.tf32.f32``), lo rounds the exact remainder."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


#: the tap counts (fg, bg) whose bg passes seed_classify.cu and dual_blur.cu
#: run on the tensor cores (KF_MMA, KB_MMA there)
MMA_TAPS = (7, 61)


def band_chunks(k: int, width: int) -> int:
    """8-deep chunks of the k-tap band under `width` outputs."""
    return -(-(width + k - 1) // 8)


def band_fragments(taps: np.ndarray) -> np.ndarray:
    """The constant band of `taps` as the per-lane ``mma.sync.m16n8k8`` TF32
    fragment table (chunks, 32, 4) ``band_mma.cuh`` reads: for 8-deep band
    chunk c and lane (g = lane >> 2, t = lane & 3) the values
    d = taps[8c + t - g] and e = taps[8c + t - g + 4] (0 outside the taps),
    stored (d.hi, e.hi, d.lo, e.lo).  The band is Toeplitz, so these are
    every fragment: the x pass's A operand (a 16-row tile of A[i][k] =
    taps[k - i]) has (a0, a1, a2, a3) = (d_c, d_{c-1}, e_c, e_{c-1}), the
    y pass's B operand (an 8-column tile of B[k][n] = taps[k - n]) has
    (b0, b1) = (d_c, e_c), and every row or column tile sees the same
    band."""
    taps = np.ascontiguousarray(taps, np.float32)
    k = len(taps)
    lane = np.arange(32)
    u = (8 * np.arange(band_chunks(k, 16))[:, None, None]
         + np.stack([(lane & 3) - (lane >> 2),
                     (lane & 3) - (lane >> 2) + 4], axis=1))
    inside = (u >= 0) & (u < k)
    return np.concatenate(
        [np.where(inside, part.numpy()[np.clip(u, 0, k - 1)], np.float32(0))
         for part in tf32_split(torch.from_numpy(taps))],
        axis=2).astype(np.float32)


def _banded_split_tf32(im: torch.Tensor, kernel: np.ndarray, axis: int
                       ) -> torch.Tensor:
    """'reflect' correlation along `axis` as one banded product with both
    operands split in TF32 halves: hi*hi + hi*lo + lo*hi, summed in f32."""
    n, r = im.shape[axis], len(kernel) // 2
    padded = _pad_axis(im, axis, r, r, "reflect").movedim(axis, -1)
    band = np.zeros((n + 2 * r, n), np.float32)
    for u, w in enumerate(np.asarray(kernel, np.float32)):
        band[np.arange(n) + u, np.arange(n)] = w
    bh, bl = tf32_split(torch.from_numpy(band).to(im.device))
    dh, dl = tf32_split(padded)
    with full_f32_matmul():
        out = dl @ bh + dh @ bl + dh @ bh
    return out.movedim(-1, axis)


def blur_xy_split_tf32_plain(im: torch.Tensor, kernel: np.ndarray
                             ) -> torch.Tensor:
    """Arithmetic model of the tensor-core bg blur of seed_classify.cu and
    dual_blur.cu (``band_mma.cuh``): the x then the y 'reflect' pass, each a
    banded split-TF32 product.  It sums in another order than the kernels'
    8-deep chunks, so it bounds their error and does not reproduce their
    bits; tests use it and no path does."""
    return _banded_split_tf32(_banded_split_tf32(im, kernel, 1), kernel, 2)


_band_tables: Dict[tuple, torch.Tensor] = {}


def _band_table(taps: np.ndarray, device) -> torch.Tensor:
    """band_fragments(taps) as one flat device tensor, made once per (taps,
    device)."""
    key = (taps.tobytes(), str(device))
    table = _band_tables.get(key)
    if table is None:
        table = torch.from_numpy(band_fragments(taps).ravel()).to(device)
        _band_tables[key] = table
    return table


def fused_seed_classify_cuda(fgz: torch.Tensor, bgz: torch.Tensor,
                             k_fg: np.ndarray, k_bg: np.ndarray, th: float,
                             n_lvl: int, min_edge_distance: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/seed_classify.cu`` on the current stream."""
    if fgz.ndim != 3:
        raise ValueError(f"seed_classify: fgz must be (Z, X, Y), got "
                         f"{tuple(fgz.shape)}")
    _check("seed_classify", fgz, "fgz", fgz.shape)
    _check("seed_classify", bgz, "bgz", fgz.shape)
    if not 1 <= n_lvl <= MAX_LEVELS:
        raise ValueError(f"seed_classify: n_lvl {n_lvl} out of range")
    tf, tb = _host_taps(k_fg), _host_taps(k_bg)
    z, x, y = fgz.shape
    qdiff = torch.empty_like(fgz)
    counts = torch.zeros(n_lvl, dtype=torch.int32, device=fgz.device)
    band = (_band_table(tb, fgz.device).data_ptr()
            if (len(tf), len(tb)) == MMA_TAPS else None)
    _launch("seed_classify",
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2
            + [ctypes.c_void_p],
            fgz.data_ptr(), bgz.data_ptr(), qdiff.data_ptr(),
            counts.data_ptr(), tf.ctypes.data, len(tf), tb.ctypes.data,
            len(tb), band, z, x, y, float(th), int(n_lvl),
            int(min_edge_distance), _stream(fgz))
    return qdiff, counts


def mma_selftest_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (16, 8) @ b (8, 8) on one warp through seed_classify.cu's
    split-TF32 ``mma.sync`` helper: the proof of its fragment layout."""
    _check("seed_classify", a, "a", (16, 8))
    _check("seed_classify", b, "b", (8, 8))
    d = torch.empty_like(a)
    fn = _build.load("seed_classify").seed_classify_mma_selftest
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4
    rc = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), _stream(a))
    if rc != 0:
        raise RuntimeError(f"seed_classify mma selftest failed ({rc})")
    return d


def mma_rate_cuda(device, iters: int = 4096) -> Tuple[int, float]:
    """(products, ms): what seed_classify.cu's ``mma.sync.m16n8k8`` TF32
    instruction sustains with one 16-warp block on every SM, each warp
    running 8 * iters products on independent accumulators."""
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * 16, dtype=torch.float32, device=device)
    fn = _build.load("seed_classify").seed_classify_mma_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for timed in (False, True):
        if timed:
            ev[0].record()
        rc = fn(blocks, iters, out.data_ptr(), _stream(out))
        if rc != 0:
            raise RuntimeError(f"seed_classify mma rate kernel failed ({rc})")
    ev[1].record()
    torch.cuda.synchronize(device)
    return blocks * 16 * 8 * iters, ev[0].elapsed_time(ev[1])


def fused_supported(shape, gfilt_size: float, background_gfilt_size: float,
                    filt_size: int, min_edge_distance: int,
                    slab_x: int) -> bool:
    """Whether the exact fused classifier takes this config (the JAX
    package's semantic conditions, without its TPU tiling gates)."""
    if not (gfilt_size and background_gfilt_size):
        return False
    r = max(int(4.0 * float(s) + 0.5)
            for s in (gfilt_size, background_gfilt_size))
    return (filt_size == 3 and min_edge_distance >= 1 and shape[0] >= 2
            and r <= MAX_RADIUS and shape[1] <= 2 * slab_x)


def fused_seed_classify(im: torch.Tensor, sigma_fg: float, sigma_bg: float,
                        th_seed, n_lvl: int, min_edge_distance: int = 2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact seeding classifier -> (qdiff, counts): z passes as one banded
    matmul, then the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    imf = im.to(torch.float32).contiguous()
    if min_edge_distance < 1 or imf.ndim != 3 or imf.shape[0] < 2:
        raise ValueError("fused_seed_classify: needs a (Z >= 2, X, Y) stack "
                         f"and min_edge_distance >= 1, got "
                         f"{tuple(imf.shape)}, {min_edge_distance}")
    k_fg, k_bg = gaussian_kernel1d(sigma_fg), gaussian_kernel1d(sigma_bg)
    th = _clamped_th(th_seed)
    cuda = _dispatch(imf, "seed_classify")
    fgz, bgz = z_pass_pair(imf, k_fg, k_bg)
    fn = fused_seed_classify_cuda if cuda else fused_seed_classify_plain
    return fn(fgz, bgz, k_fg, k_bg, th, n_lvl, min_edge_distance)


# ---------------------------------------------------------------------------
# Dual x+y blur (dual_blur.cu)
# ---------------------------------------------------------------------------


def dual_blur_xy_plain(fgz: torch.Tensor, bgz: torch.Tensor,
                       k_fg: np.ndarray, k_bg: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/dual_blur.cu``: the x then y
    'reflect' passes of each z-passed stack, taps in order.  The kernel's
    fg equals it bit for bit; for the default taps (:data:`MMA_TAPS`) its
    bg is the banded split-TF32 product (arithmetic model
    :func:`blur_xy_split_tf32_plain`), within the JAX tests' rtol 2e-5 /
    atol 2e-2 of this one."""
    return _blur_xy(fgz, k_fg), _blur_xy(bgz, k_bg)


def dual_blur_xy_cuda(fgz: torch.Tensor, bgz: torch.Tensor,
                      k_fg: np.ndarray, k_bg: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/dual_blur.cu`` on the current stream: the default taps
    (:data:`MMA_TAPS`) take its tensor-core kernel, any others its
    run-time-radius kernel."""
    if fgz.ndim != 3:
        raise ValueError(f"dual_blur: fgz must be (Z, X, Y), got "
                         f"{tuple(fgz.shape)}")
    _check("dual_blur", fgz, "fgz", fgz.shape)
    _check("dual_blur", bgz, "bgz", fgz.shape)
    tf, tb = _host_taps(k_fg), _host_taps(k_bg)
    z, x, y = fgz.shape
    fg, bg = torch.empty_like(fgz), torch.empty_like(bgz)
    band = (_band_table(tb, fgz.device).data_ptr()
            if (len(tf), len(tb)) == MMA_TAPS else None)
    _launch("dual_blur",
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            fgz.data_ptr(), bgz.data_ptr(), fg.data_ptr(), bg.data_ptr(),
            tf.ctypes.data, len(tf), tb.ctypes.data, len(tb), band, z, x, y,
            _stream(fgz))
    return fg, bg


def dual_blur_occupancy_cuda(k_fg: int, k_bg: int) -> Tuple[int, int, int]:
    """(resident blocks per SM, threads per block, dynamic shared memory
    bytes per block) of the ``csrc/dual_blur.cu`` kernel that tap counts
    (k_fg, k_bg) launch, as the card grants them."""
    out = [ctypes.c_int(0) for _ in range(3)]
    fn = _build.load("dual_blur").dual_blur_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    rc = fn(int(k_fg), int(k_bg), *(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"dual_blur occupancy query failed ({rc})")
    return tuple(v.value for v in out)


def dual_gaussian_blur(im: torch.Tensor, sigma_fg: float, sigma_bg: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gaussian(im, sigma_fg), gaussian(im, sigma_bg)), scipy 'reflect':
    the z passes as filters._conv1d_along_axis (as the JAX wrapper does),
    then the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    imf = im.to(torch.float32)
    cuda = _dispatch(imf, "dual_blur")
    k_fg, k_bg = gaussian_kernel1d(sigma_fg), gaussian_kernel1d(sigma_bg)
    fgz = _conv1d_along_axis(imf, k_fg, 0, "reflect").contiguous()
    bgz = _conv1d_along_axis(imf, k_bg, 0, "reflect").contiguous()
    fn = dual_blur_xy_cuda if cuda else dual_blur_xy_plain
    return fn(fgz, bgz, k_fg, k_bg)


# ---------------------------------------------------------------------------
# Level stencil (level_stencil.cu)
# ---------------------------------------------------------------------------


def level_stencil_plain(max_im: torch.Tensor, min_im: torch.Tensor,
                        th: float, n_lvl: int, min_edge_distance: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/level_stencil.cu`` -> (level
    (Z, X, Y) int8, diff (Z, X, Y) f32, counts (n_lvl,) int32); edges
    replicate, which for a 3-window equals scipy 'reflect'."""
    local_max = ((_window_reduce(max_im, 3, "nearest", "max") == max_im)
                 & (_window_reduce(min_im, 3, "nearest", "min") != min_im))
    diff = max_im - min_im
    qualify = local_max & _edge_ok(max_im.shape, min_edge_distance,
                                   max_im.device)
    level = torch.where(qualify, _levels(diff, th, n_lvl),
                        float(n_lvl)).to(torch.int8)
    return level, diff, _histogram(level, n_lvl)


def level_stencil_cuda(max_im: torch.Tensor, min_im: torch.Tensor,
                       th: float, n_lvl: int, min_edge_distance: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/level_stencil.cu`` on the current stream."""
    if max_im.ndim != 3:
        raise ValueError(f"level_stencil: max_im must be (Z, X, Y), got "
                         f"{tuple(max_im.shape)}")
    _check("level_stencil", max_im, "max_im", max_im.shape)
    _check("level_stencil", min_im, "min_im", max_im.shape)
    if not 1 <= n_lvl < 127:
        raise ValueError(f"level_stencil: n_lvl {n_lvl} must be in [1, 127)")
    z, x, y = max_im.shape
    level = torch.empty(max_im.shape, dtype=torch.int8, device=max_im.device)
    diff = torch.empty_like(max_im)
    counts = torch.zeros(n_lvl, dtype=torch.int32, device=max_im.device)
    _launch("level_stencil",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p],
            max_im.data_ptr(), min_im.data_ptr(), level.data_ptr(),
            diff.data_ptr(), counts.data_ptr(), z, x, y, float(th),
            int(n_lvl), int(min_edge_distance), _stream(max_im))
    return level, diff, counts


def level_stencil_occupancy_cuda(vec: bool) -> Tuple[int, int, int, int,
                                                      int]:
    """(resident blocks per SM, threads per block, dynamic shared memory
    bytes per block, tile rows, tile columns) of the ``csrc/level_stencil.cu``
    instance with 16-byte copies (`vec`) or with 4-byte copies, as the card
    grants them."""
    out = [ctypes.c_int(0) for _ in range(5)]
    fn = _build.load("level_stencil").level_stencil_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    rc = fn(int(bool(vec)), *(ctypes.addressof(v) for v in out))
    if rc != 0:
        raise RuntimeError(f"level_stencil occupancy query failed ({rc})")
    return tuple(v.value for v in out)


def level_stencil(max_im: torch.Tensor, min_im: torch.Tensor, th_seed,
                  n_lvl: int, min_edge_distance: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3^3 stencil + level map of two blurred stacks -> (level int8, diff,
    counts): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    mx = max_im.to(torch.float32).contiguous()
    mn = min_im.to(torch.float32).contiguous()
    fn = (level_stencil_cuda if _dispatch(mx, "level_stencil")
          else level_stencil_plain)
    return fn(mx, mn, _clamped_th(th_seed), n_lvl, min_edge_distance)
