"""Learned cell segmentation: a small 3D UNet predicting cellpose-style
outputs (centre-directed flow field + cell probability) and a
flow-following mask reconstruction.

The counterpart of ``imageanalysis3_tpu/segmentation/learned.py``.
Behavior target: the reference's production segmentation is Cellpose 3D
on polyT+DAPI followed by random-walker refinement
(segmentation_tools/cell.py:192-362); here the same computation is

  * :class:`UNet3D` / :func:`unet_apply` -- an anisotropy-aware 3D UNet
    ((1,2,2) pooling, so z stays unpooled at 8-60 plane stacks) emitting a
    3-vector flow per voxel plus a cell-probability logit.  Weights are
    (O, I, kz, kx, ky), the JAX package's ZXYIO transposed; instance norm
    uses the population variance; the pooling is the JAX package's SAME
    window, ``ceil_mode=True``; the decoder's nearest resize is
    ``nearest-exact``, which is ``jax.image.resize(..., "nearest")``
    (``nearest`` picks other rows wherever a pooled size is odd);
  * :func:`masks_from_flows` -- cellpose's dynamics: foreground voxels are
    advected along the flow (trilinear sampling), landings are
    histogrammed, basin peaks become cells (ranked by score, then index,
    as ``lax.top_k`` ranks ties), and each voxel joins its landing's cell;
  * :func:`labels_to_flows`, :func:`unet_loss`, :func:`fit_unet` --
    training targets and fine-tuning with autograd and :class:`Adam`, a
    ``torch.optim.Optimizer`` with ``optax.adam``'s defaults and float32
    arithmetic;
  * :func:`save_weights` / :func:`load_weights` -- ``.npz`` files in the
    JAX package's layout (keys are its ``keystr`` paths, convolution
    weights ZXYIO), so a file written by either package loads into the
    other.

Convolutions run in full float32 on the card (cuDNN's TF32 is switched off
for their call and restored after); a 3x3x3 convolution's weight gradient
is 27 per-tap matrix products in place of cuDNN's float32 3D kernels.
NumPy inputs go to the network's device.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import as_tensor, host_array, resolve_device
from ..ops.filters import full_f32_conv
from .nuclei import propagate_labels


# ---------------------------------------------------------------------------
# Small 3D UNet
# ---------------------------------------------------------------------------


class _Conv3x3x3(torch.autograd.Function):
    """A 3x3x3 SAME convolution: cuDNN's forward and data gradient, and the
    weight gradient as 27 per-tap matrix products (shifted input x output
    gradient).  cuDNN's float32 3D weight-gradient kernels, with TF32 off,
    took 130 of a training step's 161 ms on an H100 (chip_smoke.py phase
    12)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv3d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with full_f32_conv():
            gx = (torch.nn.grad.conv3d_input(x.shape, w, g, padding=1)
                  if ctx.needs_input_grad[0] else None)
            c, (z, nx, ny) = x.shape[1], x.shape[2:]
            xp = F.pad(x, (1,) * 6)
            gm = g.transpose(0, 1).reshape(w.shape[0], -1)
            gw = torch.empty_like(w)
            for dz, dx, dy in itertools.product(range(3), repeat=3):
                xs = xp[:, :, dz:dz + z, dx:dx + nx, dy:dy + ny]
                gw[:, :, dz, dx, dy] = gm @ xs.transpose(0, 1).reshape(
                    c, -1).T
        return gx, gw, g.sum(dim=(0, 2, 3, 4))


def _conv(m: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    return _Conv3x3x3.apply(x, m.weight, m.bias)


class _ConvPair(nn.Module):
    """Two 3x3x3 SAME convolutions (``a`` then ``b``)."""

    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.a = nn.Conv3d(c_in, c, 3, padding=1)
        self.b = nn.Conv3d(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_norm(_conv(self.a, x)))
        return F.relu(_norm(_conv(self.b, x)))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Channel-wise instance norm (no learned affine -- the conv biases
    absorb the shift), population variance."""
    dims = tuple(range(2, x.ndim))
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5)


class UNet3D(nn.Module):
    """(C, Z, X, Y) image -> (flow (3, Z, X, Y), cellprob logits (Z, X, Y)).

    Encoder levels of widths base * 2**i, each two conv + instance norm +
    ReLU, (1, 2, 2) max-pooling between levels; decoder levels nearest-
    resized to their skip, concatenated [up, skip], two convs each; a
    1x1x1 head of 4 channels."""

    def __init__(self, in_channels: int = 1, base: int = 16,
                 levels: int = 3):
        super().__init__()
        widths = [base * 2 ** i for i in range(levels)]
        self.enc = nn.ModuleList()
        c_prev = in_channels
        for c in widths:
            self.enc.append(_ConvPair(c_prev, c))
            c_prev = c
        self.dec = nn.ModuleList()
        for i in reversed(range(levels - 1)):
            self.dec.append(_ConvPair(c_prev + widths[i], widths[i]))
            c_prev = widths[i]
        self.head = nn.Conv3d(c_prev, 4, 1)

    def forward(self, im: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = im.to(self.head.weight.dtype)
        x = ((x - x.mean()) / (x.std(correction=0) + 1e-6))[None]
        skips: List[torch.Tensor] = []
        with full_f32_conv():
            for i, lvl in enumerate(self.enc):
                x = lvl(x)
                if i < len(self.enc) - 1:
                    skips.append(x)
                    x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2),
                                     ceil_mode=True)
            for lvl in self.dec:
                skip = skips.pop()
                x = F.interpolate(x, size=skip.shape[2:],
                                  mode="nearest-exact")
                x = lvl(torch.cat([x, skip], dim=1))
            out = self.head(x)[0]
        return out[:3], out[3]


def init_unet_params(rng=0, in_channels: int = 1, base: int = 16,
                     levels: int = 3, device=None) -> UNet3D:
    """He-initialized :class:`UNet3D` on `device` (default the card).
    `rng` is a seed or a CPU ``torch.Generator``; the weights are drawn
    layer by layer (encoder, decoder, head), biases zero."""
    gen = rng if isinstance(rng, torch.Generator) \
        else torch.Generator().manual_seed(int(rng))
    net = UNet3D(in_channels, base, levels)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv3d):
                fan_in = m.in_channels * int(np.prod(m.kernel_size))
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * np.sqrt(2.0 / fan_in))
                m.bias.zero_()
    return net.to(resolve_device(device))


def _device_of(net: nn.Module) -> torch.device:
    return next(net.parameters()).device


def unet_apply(net: UNet3D, im) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, Z, X, Y) image -> (flow (3, Z, X, Y), cellprob logits
    (Z, X, Y)) on the network's device."""
    return net(as_tensor(im, _device_of(net)).to(_device_of(net)))


# ---------------------------------------------------------------------------
# Flow dynamics -> masks (cellpose dynamics)
# ---------------------------------------------------------------------------


def _trilinear(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Sample (C, Z, X, Y) at (N, 3) float points, clamped -> (C, N); the
    corners summed in the JAX package's order."""
    dims = vol.shape[1:]
    shape_f = torch.tensor(dims, dtype=torch.float32, device=vol.device)
    shape_i = torch.tensor(dims, dtype=torch.int64, device=vol.device)
    p = torch.minimum(pts.clamp_min(0.0), shape_f - 1.0)
    lo = torch.floor(p).to(torch.int64)
    hi = torch.minimum(lo + 1, shape_i - 1)
    f = p - lo.to(torch.float32)
    flat = vol.reshape(vol.shape[0], -1)
    out = None
    for dz in (0, 1):
        for dx in (0, 1):
            for dy in (0, 1):
                iz = (hi if dz else lo)[:, 0]
                ix = (hi if dx else lo)[:, 1]
                iy = (hi if dy else lo)[:, 2]
                w = ((f[:, 0] if dz else 1 - f[:, 0])
                     * (f[:, 1] if dx else 1 - f[:, 1])
                     * (f[:, 2] if dy else 1 - f[:, 2]))
                term = w[None] * flat[:, (iz * dims[1] + ix) * dims[2] + iy]
                out = term if out is None else out + term
    return out


def follow_flows(flow, fg, n_iters: int = 40, step: float = 1.0,
                 device=None) -> torch.Tensor:
    """Advect every voxel centre along `flow` (3, Z, X, Y) for `n_iters`
    Euler steps; background voxels stay put.  Returns the landing
    positions as a (Z, X, Y, 3) float32 tensor on `flow`'s device."""
    flow = as_tensor(flow, device).to(torch.float32)
    shape = tuple(flow.shape[1:])
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=flow.device)
          for s in shape], indexing="ij"), dim=-1)
    pts = grid.reshape(-1, 3)
    move = as_tensor(fg, flow.device).to(flow.device).reshape(-1) \
        .to(torch.float32)[:, None]
    for _ in range(n_iters):
        pts = pts + step * _trilinear(flow, pts).T * move
    return pts.reshape(shape + (3,))


def masks_from_flows(flow, cellprob, prob_threshold: float = 0.0,
                     n_iters: int = 40,
                     max_cells: int = 64,
                     min_count: int = 20,
                     merge_iters: int = 16,
                     bin_zxy: Tuple[int, int, int] = (2, 4, 4),
                     device=None) -> torch.Tensor:
    """Cellpose dynamics: foreground voxels flow to their cell's
    attractor; landing-density peaks become cells (capped at
    `max_cells`), and each voxel takes the label of the basin its
    trajectory lands in.  Returns (Z, X, Y) int32 labels (0 = bg) on
    `flow`'s device.

    Landings are histogrammed on a grid coarsened by `bin_zxy` (a trained
    flow lands a cell's voxels in a cloud a few voxels wide); each bin's
    score is its count plus a ramp that breaks ties; 5^3 local maxima of
    at least `min_count` are peaks, ranked by (-score, index) as
    ``lax.top_k`` ranks them; a peak within Chebyshev distance 2 of a
    stronger one is dropped, and the rest of each cloud joins its peak by
    `merge_iters` sweeps of label propagation over the nonzero bins."""
    flow = as_tensor(flow, device).to(torch.float32)
    dev = flow.device
    prob = as_tensor(cellprob, dev).to(dev)
    shape = tuple(prob.shape)
    fg = prob > prob_threshold
    land = follow_flows(flow, fg, n_iters=n_iters)
    idx = torch.round(land).to(torch.int64)
    idx = torch.minimum(idx.clamp_min(0),
                        torch.tensor(shape, device=dev) - 1)
    cs = tuple(-(-s // b) for s, b in zip(shape, bin_zxy))
    cidx = idx // torch.tensor(bin_zxy, device=dev)
    flat = ((cidx[..., 0] * cs[1] + cidx[..., 1]) * cs[2]
            + cidx[..., 2]).reshape(-1)
    size = int(np.prod(cs))
    counts = torch.bincount(torch.where(fg.reshape(-1), flat, size),
                            minlength=size + 1)[:size]
    counts3 = counts.reshape(cs)
    ramp = (torch.arange(size, device=dev) % 997).to(torch.float32) / 997.0
    score3 = counts.to(torch.float32).reshape(cs) + ramp.reshape(cs) * 0.5
    r = 2  # 5^3 peak footprint, matching cellpose's size-5 max filter
    neigh_max = F.max_pool3d(F.pad(score3[None, None], (r,) * 6,
                                   value=-1.0), 2 * r + 1, stride=1)[0, 0]
    is_peak = (score3 >= neigh_max) & (counts3 >= min_count)
    peak_scores = torch.where(is_peak, score3, 0.0).reshape(-1)
    if max_cells > size:
        raise ValueError(f"max_cells {max_cells} exceeds the {size} "
                         f"landing bins")
    order = torch.sort(peak_scores, descending=True, stable=True)
    top_v, top_i = order.values[:max_cells], order.indices[:max_cells]
    pc = torch.stack([top_i // (cs[1] * cs[2]), (top_i // cs[2]) % cs[1],
                      top_i % cs[2]], dim=-1)
    cheb = (pc[:, None] - pc[None, :]).abs().amax(dim=-1)
    dominated = ((top_v[None, :] > top_v[:, None]) & (cheb <= r)).any(dim=1)
    valid = (top_v > 0) & ~dominated
    seeds = torch.zeros(size, dtype=torch.int32, device=dev)
    lab_ids = torch.arange(1, max_cells + 1, dtype=torch.int32, device=dev)
    seeds[top_i] = torch.where(valid, lab_ids, 0)
    sink = propagate_labels(seeds.reshape(cs), counts3 > 0,
                            max_iters=merge_iters)
    labels = sink.reshape(-1)[flat].reshape(shape)
    return torch.where(fg, labels, 0).to(torch.int32)


def segment_cells_learned(im, net: UNet3D, prob_threshold: float = 0.0,
                          n_iters: int = 40,
                          max_cells: int = 64,
                          min_count: int = 20,
                          bin_zxy: Tuple[int, int, int] = (2, 4, 4)
                          ) -> torch.Tensor:
    """(C, Z, X, Y) image (e.g. polyT + DAPI channels) -> (Z, X, Y)
    int32 cell labels via the learned flow model (the replacement for
    the reference's Cellpose 3D call, segmentation_tools/cell.py:192-270).
    `bin_zxy` is the landing histogram's bin size; it bounds the minimum
    resolvable cell-centre separation (~2 bins)."""
    with torch.no_grad():
        flow, logits = unet_apply(net, im)
    return masks_from_flows(flow, logits, prob_threshold=prob_threshold,
                            n_iters=n_iters, max_cells=max_cells,
                            min_count=min_count, bin_zxy=bin_zxy)


def segment_fov_learned(im, net: UNet3D,
                        downsample: Tuple[int, int, int] = (1, 4, 4),
                        **kwargs) -> torch.Tensor:
    """Full-FOV learned segmentation: average-pool the (C, Z, X, Y) stack
    by `downsample`, segment on the coarse grid, and nearest-upsample the
    labels back to full resolution (edge rows repeated where a size does
    not divide) -- the reference's resize round trip
    (segmentation_tools/cell.py:214-240).  `net` must be trained at the
    pooled resolution.  Unless overridden, the landing bins shrink with
    the pooling so the resolvable cell-centre separation stays constant
    in full-resolution pixels."""
    im = as_tensor(im, _device_of(net)).to(_device_of(net), torch.float32)
    dz, dx, dy = downsample
    if "bin_zxy" not in kwargs:
        kwargs["bin_zxy"] = tuple(
            max(1, b // d) for b, d in zip((2, 4, 4), downsample))
    c, z, x, y = im.shape
    zc, xc, yc = z // dz, x // dx, y // dy
    pooled = im[:, :zc * dz, :xc * dx, :yc * dy].reshape(
        c, zc, dz, xc, dx, yc, dy).mean(dim=(2, 4, 6))
    labels = segment_cells_learned(pooled, net, **kwargs)
    dev = labels.device
    iz = (torch.arange(z, device=dev) // dz).clamp_max(zc - 1)
    ix = (torch.arange(x, device=dev) // dx).clamp_max(xc - 1)
    iy = (torch.arange(y, device=dev) // dy).clamp_max(yc - 1)
    return labels[iz][:, ix][:, :, iy]


# ---------------------------------------------------------------------------
# Training targets + fine-tuning
# ---------------------------------------------------------------------------


def labels_to_flows(labels, max_labels: int = 256
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth (flow (3, Z, X, Y), fg (Z, X, Y)) from an int label
    volume, on the host: each labeled voxel gets the unit vector toward
    its cell's centre of mass (the stand-in for cellpose's heat-diffusion
    flows -- identical fixed point for convex cells)."""
    labels = np.asarray(host_array(labels))
    flow = np.zeros((3,) + labels.shape, np.float32)
    zz, xx, yy = np.meshgrid(*[np.arange(s) for s in labels.shape],
                             indexing="ij")
    coords = np.stack([zz, xx, yy], -1).astype(np.float32)
    for l in range(1, min(int(labels.max()), max_labels) + 1):
        m = labels == l
        if not m.any():
            continue
        center = coords[m].mean(0)
        vec = center[None] - coords[m]
        norm = np.linalg.norm(vec, axis=1, keepdims=True)
        vec = vec / np.maximum(norm, 1e-6)
        for a in range(3):
            flow[a][m] = vec[:, a]
    return flow, (labels > 0)


def unet_loss(net: UNet3D, im, flow_t, fg_t) -> torch.Tensor:
    """MSE on flows inside cells + class-balanced sigmoid BCE on cell
    probability (foreground and background voxels averaged apart, so the
    background term does not dominate)."""
    dev = _device_of(net)
    flow, logits = unet_apply(net, im)
    m = as_tensor(fg_t, dev).to(dev, torch.float32)
    flow_t = as_tensor(flow_t, dev).to(dev, torch.float32)
    mse = (((flow - flow_t) ** 2) * m[None]).sum() \
        / (3.0 * torch.clamp(m.sum(), min=1.0))
    # a logit of exactly 0 (a voxel whose head inputs are all zero) takes
    # JAX's derivatives: jnp.maximum splits a tie in half, as torch.maximum
    # does (clamp passes it whole); jnp.abs has slope 1 at 0 (torch.abs 0)
    abs_l = torch.where(logits >= 0, logits, -logits)
    bce_vox = (torch.maximum(logits, torch.zeros_like(logits)) - logits * m
               + torch.log1p(torch.exp(-abs_l)))
    n_fg = torch.clamp(m.sum(), min=1.0)
    n_bg = torch.clamp((1.0 - m).sum(), min=1.0)
    bce = 0.5 * ((bce_vox * m).sum() / n_fg
                 + (bce_vox * (1.0 - m)).sum() / n_bg)
    return mse + bce


class Adam(torch.optim.Optimizer):
    """Adam with ``optax.adam``'s float32 arithmetic (b1 0.9, b2 0.999,
    eps 1e-8 by default): mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 +
    b2 nu, the bias corrections 1 - b**t in float32, and p += -lr *
    mu_hat / (sqrt(nu_hat) + eps).  ``torch.optim.Adam`` computes the
    bias corrections in float64 on the host; optax's 1 - f32(0.999) is
    4.7e-5 above 0.001, so their first updates differ by 2.3e-5 relative,
    and a parameter that starts at 0 (every bias) carries that over."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, lr = group["b1"], group["b2"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                g = p.grad
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                # float32 on the host, then divided as device scalars (a
                # tensor over a Python number multiplies by its reciprocal)
                bc1, bc2 = (torch.full((), float(
                    np.float32(1) - np.float32(b) ** st["count"]),
                    dtype=p.dtype, device=p.device) for b in (b1, b2))
                upd = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2)
                                          + group["eps"])
                p.add_(upd * (-lr))


def fit_unet(net: UNet3D, images, label_volumes, n_steps: int = 200,
             lr: float = 1e-3,
             rng: Optional[np.random.Generator] = None) -> UNet3D:
    """Fine-tune a copy of `net` on (image, labels) pairs with Adam;
    targets come once from :func:`labels_to_flows`, and each step takes
    the pair ``rng.integers(len(pairs))`` draws (default
    ``np.random.default_rng(0)``).  `net` itself is left as it was."""
    net = copy.deepcopy(net)
    dev = _device_of(net)
    data = []
    for im, lb in zip(images, label_volumes):
        flow_t, fg_t = labels_to_flows(lb)
        data.append((as_tensor(im, dev).to(dev, torch.float32),
                     torch.as_tensor(flow_t, device=dev),
                     torch.as_tensor(fg_t, device=dev)))
    opt = Adam(net.parameters(), lr)
    rng = rng or np.random.default_rng(0)
    with full_f32_conv():
        for _ in range(n_steps):
            im, fl, fgm = data[int(rng.integers(len(data)))]
            opt.zero_grad(set_to_none=True)
            unet_loss(net, im, fl, fgm).backward()
            opt.step()
    return net


# ---------------------------------------------------------------------------
# Weight I/O in the JAX package's .npz layout
# ---------------------------------------------------------------------------


def jax_key(name: str) -> str:
    """The JAX package's ``keystr`` path of a :class:`UNet3D` parameter
    name, e.g. ``enc.0.a.weight`` -> ``['enc'][0]['a']['w']``."""
    parts = name.split(".")
    leaf = {"weight": "w", "bias": "b"}[parts[-1]]
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in parts[:-1]) + f"['{leaf}']"


def _jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    """A parameter as the JAX package holds it (conv weights ZXYIO)."""
    a = host_array(t).astype(np.float32)
    return a.transpose(2, 3, 4, 1, 0) if name.endswith("weight") else a


def _from_jax_layout(name: str, a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.array(
        a.transpose(4, 3, 0, 1, 2) if name.endswith("weight") else a))


def save_weights(net: UNet3D, path: str) -> None:
    """Write `net`'s weights as the JAX package's ``save_weights`` does."""
    np.savez(path, **{jax_key(k): _jax_layout(k, v)
                      for k, v in net.state_dict().items()})


def load_weights_from(arrays: Dict[str, np.ndarray], like: UNet3D
                      ) -> UNet3D:
    """A copy of `like` holding the JAX-layout `arrays` (keyed by
    ``keystr`` paths); a missing key raises KeyError, a shape that differs
    ValueError, each naming the key."""
    sd = {}
    for k, v in like.state_dict().items():
        key = jax_key(k)
        if key not in arrays:
            raise KeyError(f"missing weight {key}")
        arr = np.asarray(arrays[key])
        want = _jax_layout(k, v).shape
        if arr.shape != want:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {want}")
        sd[k] = _from_jax_layout(k, arr)
    net = copy.deepcopy(like)
    net.load_state_dict(sd)
    return net


def load_weights(path: str, like: UNet3D) -> UNet3D:
    """Load a ``.npz`` written by either package's ``save_weights`` into
    a copy of `like` (shapes checked)."""
    with np.load(path) as data:
        return load_weights_from({k: data[k] for k in data.files}, like)
