"""Cellpose's CPnet as an ``nn.Module``, its checkpoint loader and the
3D orthogonal-slice driver.

The counterpart of ``imageanalysis3_tpu/segmentation/cellpose_net.py``.
The reference's production segmentation calls the torch ``cellpose``
package with pretrained weights (``model_type='nuclei'``,
segmentation_tools/cell.py:192-252).  :class:`CPnet` is cellpose 2.x's
architecture (``resnet_torch.py``: a residual 2D UNet with global style
vectors) with cellpose's own module names, so a cellpose ``state_dict``
loads into it directly:

  * ``batchconv(i,o,sz)``   = BatchNorm2d -> ReLU -> Conv2d(sz, pad same)
  * ``batchconv0(i,o,sz)``  = BatchNorm2d -> Conv2d (no ReLU; residual proj)
  * ``resdown(i,o)``: x = proj(x) + conv1(conv0(x)); x = x + conv3(conv2(x))
  * ``downsample``: resdown per level, 2x2 max-pool between levels
  * style: global average of the deepest feature, L2-normalized
  * ``batchconvstyle``: x (+ skip y) + Linear(style)[:, :, None, None] ->
    batchconv
  * ``resup(i,o)``: x = proj(x) + conv1(style, conv0(x), y=skip);
    x = x + conv3(style, conv2(style, x))
  * ``upsample``: the deepest resup takes itself as skip; then nearest-2x
    upsample + resup per level
  * ``output``: batchconv(nbase_up[0], 3, 1) -> [dY, dX, cellprob]

BatchNorm runs in inference mode from the running statistics.  The
convolutions and the style ``Linear`` run in full float32 on the card
(TF32 switched off for their call).  As in the JAX package, the port is
written against cellpose 2.x's published architecture and is held against
a replica of it with cellpose's module names (tests/test_cellpose_net.py),
not against a specific upstream release; a drifted key or shape fails
loudly, naming the key.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import as_tensor, resolve_device
from ..ops.filters import full_f32_conv, nanquantile
from .learned import _device_of, masks_from_flows

#: cellpose 'nuclei'/'cyto' geometry: 2 input channels (image, zeros for
#: nuclei), 4 levels, 3 outputs [dY, dX, cellprob]
DEFAULT_NBASE = (2, 32, 64, 128, 256)
BN_EPS = 1e-5
#: checkpoint keys that carry no weight of the forward
_IGNORED = ("diam_mean", "diam_labels")
#: slice pixels a chunk of the 3D driver holds (bounds its activations)
CHUNK_PX = 1 << 22


def _batchconv(i: int, o: int, sz: int) -> nn.Sequential:
    return nn.Sequential(nn.BatchNorm2d(i, eps=BN_EPS), nn.ReLU(),
                         nn.Conv2d(i, o, sz, padding=sz // 2))


def _batchconv0(i: int, o: int, sz: int) -> nn.Sequential:
    return nn.Sequential(nn.BatchNorm2d(i, eps=BN_EPS),
                         nn.Conv2d(i, o, sz, padding=sz // 2))


class _ResDown(nn.Module):
    def __init__(self, i: int, o: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        for t in range(4):
            self.conv.add_module(f"conv_{t}",
                                 _batchconv(i if t == 0 else o, o, sz))
        self.proj = _batchconv0(i, o, 1)

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class _Downsample(nn.Module):
    def __init__(self, nbase: Sequence[int], sz: int):
        super().__init__()
        self.down = nn.Sequential()
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}",
                                 _ResDown(nbase[n], nbase[n + 1], sz))

    def forward(self, x):
        xd = []
        for n in range(len(self.down)):
            xd.append(self.down[n](F.max_pool2d(xd[-1], 2, 2) if n else x))
        return xd


class _BatchConvStyle(nn.Module):
    def __init__(self, i: int, o: int, style_ch: int, sz: int):
        super().__init__()
        self.conv = _batchconv(i, o, sz)
        self.full = nn.Linear(style_ch, o)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        return self.conv(x + self.full(style)[:, :, None, None])


class _ResUp(nn.Module):
    def __init__(self, i: int, o: int, style_ch: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", _batchconv(i, o, sz))
        for t in (1, 2, 3):
            self.conv.add_module(f"conv_{t}",
                                 _BatchConvStyle(o, o, style_ch, sz))
        self.proj = _batchconv0(i, o, 1)

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


class _Upsample(nn.Module):
    def __init__(self, nbaseup: Sequence[int], sz: int):
        super().__init__()
        self.up = nn.Sequential()
        for n in range(1, len(nbaseup)):
            self.up.add_module(f"res_up_{n - 1}",
                               _ResUp(nbaseup[n], nbaseup[n - 1],
                                      nbaseup[-1], sz))

    def forward(self, style, xd):
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self.up[n](x, xd[n], style)
        return x


class CPnet(nn.Module):
    """cellpose 2.x ``CPnet(nbase, nout=3, sz=3)``: (B, C, H, W) ->
    (B, nout, H, W); H and W must divide 2**(levels-1)."""

    def __init__(self, nbase: Sequence[int] = DEFAULT_NBASE, nout: int = 3,
                 sz: int = 3):
        super().__init__()
        nbase = list(nbase)
        self.nbase, self.nout, self.sz = nbase, nout, sz
        self.downsample = _Downsample(nbase, sz)
        nbaseup = nbase[1:] + [nbase[-1]]
        self.upsample = _Upsample(nbaseup, sz)
        self.output = _batchconv(nbaseup[0], nout, sz=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_f32_conv():
            xd = self.downsample(x)
            style = xd[-1].mean(dim=(2, 3))
            style = style / torch.clamp(
                torch.linalg.vector_norm(style, dim=1, keepdim=True),
                min=1e-6)
            return self.output(self.upsample(style, xd))


def _run_slices(net: CPnet, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, C, H, W) slices -> ((S, 2, H, W) flow, (S, H, W) cellprob), in
    inference mode."""
    net.eval()
    with torch.no_grad():
        out = net(x.to(torch.float32))
    return out[:, :2], out[:, 2]


def cpnet_apply(net: CPnet, im) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, H, W) image -> ((2, H, W) flow [dY, dX], (H, W) cellprob
    logits) on the network's device.  H and W must divide
    2**(levels-1) (see :func:`pad_to_cpnet`)."""
    dev = _device_of(net)
    flow, prob = _run_slices(net, as_tensor(im, dev).to(dev)[None])
    return flow[0], prob[0]


def pad_to_cpnet(im: np.ndarray, levels: int
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Edge-pad (C, H, W) so H, W divide 2**(levels-1); returns the pad
    amounts for cropping outputs back."""
    div = 2 ** (levels - 1)
    ph = (-im.shape[1]) % div
    pw = (-im.shape[2]) % div
    if ph or pw:
        im = np.pad(im, ((0, 0), (0, ph), (0, pw)), mode="edge")
    return im, (ph, pw)


# ---------------------------------------------------------------------------
# Checkpoint loading
# ---------------------------------------------------------------------------


def _ignored(key: str) -> bool:
    return key.endswith("num_batches_tracked") or key in _IGNORED


def convert_cellpose_state_dict(state_dict: Dict,
                                nbase: Sequence[int] = DEFAULT_NBASE,
                                nout: int = 3, sz: int = 3,
                                device=None) -> CPnet:
    """A cellpose CPnet ``state_dict`` (tensors or NumPy arrays) -> a
    :class:`CPnet` on `device` (default the card), by a strict load.

    Layer mapping (cellpose 2.x resnet_torch.py module names, which are
    this module's own):

      downsample.down.res_down_{n}.conv.conv_{t}.{0,2}   t=0..3  (BN, Conv)
      downsample.down.res_down_{n}.proj.{0,1}                    (BN, Conv 1x1)
      upsample.up.res_up_{n}.conv.conv_0.{0,2}                   (plain batchconv)
      upsample.up.res_up_{n}.conv.conv_{t}.conv.{0,2}    t=1..3  (style batchconv)
      upsample.up.res_up_{n}.conv.conv_{t}.full          t=1..3  (style Linear)
      upsample.up.res_up_{n}.proj.{0,1}
      output.{0,2}                                                (BN, Conv 1x1)

    ``*.num_batches_tracked`` and the diameter buffers are ignored; a
    missing key raises KeyError, a shape that differs ValueError, and a key
    the architecture does not have KeyError, each naming the key."""
    net = CPnet(nbase, nout=nout, sz=sz)
    want = net.state_dict()
    given = {k: v for k, v in state_dict.items() if not _ignored(k)}
    sd = {}
    for key, ref in want.items():
        if _ignored(key):
            sd[key] = ref
            continue
        if key not in given:
            raise KeyError(f"cellpose checkpoint missing {key}")
        v = given[key]
        arr = (v.detach().to("cpu", torch.float32) if hasattr(v, "detach")
               else torch.as_tensor(np.array(v, np.float32)))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= expected {tuple(ref.shape)}")
        sd[key] = arr
    extra = sorted(set(given) - set(want))
    if extra:
        raise KeyError(f"cellpose checkpoint has keys CPnet lacks: {extra}")
    net.load_state_dict(sd, strict=True)
    return net.to(resolve_device(device)).eval()


def load_cellpose_checkpoint(path: str,
                             nbase: Sequence[int] = DEFAULT_NBASE,
                             device=None) -> CPnet:
    """Load a cellpose ``.pt`` / ``*_torch_*`` checkpoint file (tensors
    only, ``weights_only=True``) into a :class:`CPnet`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd \
            and not any("." in k for k in sd):
        sd = sd["state_dict"]
    return convert_cellpose_state_dict(sd, nbase=nbase, device=device)


# ---------------------------------------------------------------------------
# 3D driver: orthogonal-slice flow assembly (cellpose do_3D)
# ---------------------------------------------------------------------------


def _normalize99(x: torch.Tensor) -> torch.Tensor:
    """Cellpose's percentile normalization (1st..99th -> 0..1), through
    ``ops.filters.nanquantile`` (``torch.quantile`` refuses more than
    2**24 elements)."""
    lo = nanquantile(x, 0.01)
    hi = nanquantile(x, 0.99)
    return (x - lo) / torch.clamp(hi - lo, min=1e-6)


def _run_view(net: CPnet, slices: torch.Tensor):
    """Yield (start, stop, flow, prob) over chunks of (S, C, H, W) slices
    holding at most CHUNK_PX slice pixels each (one slice at least)."""
    per = max(1, CHUNK_PX // (slices.shape[2] * slices.shape[3]))
    for s0 in range(0, slices.shape[0], per):
        s1 = min(s0 + per, slices.shape[0])
        f, p = _run_slices(net, slices[s0:s1].contiguous())
        yield s0, s1, f, p


def cellpose_flows_3d(net: CPnet, vol) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, Z, X, Y) volume -> ((3, Z, X, Y) flow, (Z, X, Y) cellprob)
    by running CPnet over the three orthogonal slice stacks and averaging
    each flow component over its two contributing views -- cellpose's
    ``do_3D=True`` flow assembly.  The volume is percentile-normalized;
    spatial dims should divide 2**(levels-1) (:func:`pad_to_cpnet`).  Each
    view runs in chunks of at most CHUNK_PX slice pixels; the views are
    summed in the JAX package's order."""
    dev = _device_of(net)
    vol = _normalize99(as_tensor(vol, dev).to(dev, torch.float32))
    c, z, x, y = vol.shape
    flow = torch.zeros((3, z, x, y), dtype=torch.float32, device=dev)
    prob = torch.zeros((z, x, y), dtype=torch.float32, device=dev)
    # view 1: xy planes along z -> dY along x, dX along y
    for s0, s1, f, p in _run_view(net, vol.movedim(1, 0)):
        flow[1, s0:s1] += f[:, 0]
        flow[2, s0:s1] += f[:, 1]
        prob[s0:s1] += p
    # view 2: zy planes along x -> dY along z, dX along y
    for s0, s1, f, p in _run_view(net, vol.movedim(2, 0)):
        flow[0, :, s0:s1] += f[:, 0].movedim(0, 1)
        flow[2, :, s0:s1] += f[:, 1].movedim(0, 1)
        prob[:, s0:s1] += p.movedim(0, 1)
    # view 3: zx planes along y -> dY along z, dX along x
    for s0, s1, f, p in _run_view(net, vol.movedim(3, 0)):
        flow[0, :, :, s0:s1] += f[:, 0].movedim(0, 2)
        flow[1, :, :, s0:s1] += f[:, 1].movedim(0, 2)
        prob[:, :, s0:s1] += p.movedim(0, 2)
    return flow / 2.0, prob / 3.0


def segment_cells_cellpose(vol, net: CPnet, prob_threshold: float = 0.0,
                           n_iters: int = 40, max_cells: int = 64,
                           min_count: int = 20,
                           bin_zxy: Tuple[int, int, int] = (2, 4, 4)
                           ) -> torch.Tensor:
    """(C, Z, X, Y) -> (Z, X, Y) int32 cell labels from cellpose weights:
    orthogonal-slice CPnet flows + the flow dynamics of
    ``learned.masks_from_flows`` -- the path for the reference's
    pretrained-cellpose production segmentation
    (segmentation_tools/cell.py:192-252)."""
    flow, prob = cellpose_flows_3d(net, vol)
    return masks_from_flows(flow, prob, prob_threshold=prob_threshold,
                            n_iters=n_iters, max_cells=max_cells,
                            min_count=min_count, bin_zxy=bin_zxy)
