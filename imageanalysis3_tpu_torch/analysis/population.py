"""Population-level analysis: genomic-annotation overlap, compartment
assignment from domain clusters, cell typing.

The counterpart of ``imageanalysis3_tpu/analysis/population.py``.
Behavior targets (reference ImageAnalysis3): BED/ChIP overlap with imaged
regions (postanalysis.py:21-157), domain clusters -> compartment labels
(postanalysis.py:393-664), the cell-type classifier
(celltype_tools/classifier.py:8-164).

The JAX package's classifier is scikit-learn's ``MLPClassifier``; so that
the port runs where scikit-learn is not installed, :class:`CellTypeClassifier`
is a native ``nn.Module`` MLP trained in float64 with scikit-learn's
defaults (ReLU, Adam at lr 1e-3, L2 ``alpha`` 1e-4 over the batch, batches
of min(200, n), stop after more than 10 epochs without a loss improvement
of ``tol`` 1e-4, ``max_iter`` epochs), its initial weights and batch order
from a ``torch.Generator`` seeded with `seed`.  Weights fitted by
scikit-learn cross over through ``convert.classifier_from_arrays``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import as_tensor, host_array, resolve_device

f64 = torch.float64


def load_bed(path: str) -> np.ndarray:
    """BED intervals -> object array of (chr, start, end) rows."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            out.append((parts[0], float(parts[1]), float(parts[2])))
    return np.array(out, dtype=object)


def region_overlap_fraction(region_positions: Dict[int, dict],
                            bed: np.ndarray) -> Dict[int, float]:
    """Fraction of each imaged region covered by BED intervals."""
    by_chr: Dict[str, List[Tuple[float, float]]] = {}
    for c, s, e in bed:
        by_chr.setdefault(str(c), []).append((float(s), float(e)))
    out: Dict[int, float] = {}
    for rid, info in region_positions.items():
        chrom = str(info.get("chr", ""))
        start = float(info.get("start", np.nan))
        end = float(info.get("end", np.nan))
        if not np.isfinite(start) or not np.isfinite(end) or end <= start:
            out[rid] = np.nan
            continue
        covered = 0.0
        for s, e in by_chr.get(chrom, []):
            covered += max(0.0, min(end, e) - max(start, s))
        out[rid] = min(covered / (end - start), 1.0)
    return out


def assign_compartments_from_domains(zxys, starts: Sequence[int],
                                     a_marker_fraction: Optional[
                                         Dict[int, float]] = None,
                                     n_iters: int = 32, device=None
                                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster domains into two compartments by their separation profiles,
    orient by marker overlap -> (domain labels (D,), region labels (R,)).
    The separation matrix comes from ``domains.domain_pdists`` on the
    device; the 2-means over its D rows starts from NumPy's
    ``default_rng(0).integers(0, 2, D)`` labels, as in the JAX package, and
    runs on the host (D is the number of domains)."""
    from .domains import domain_pdists

    zxys = as_tensor(zxys, device).to(f64)
    n = zxys.shape[0]
    starts = np.asarray(sorted(int(s) for s in starts), int)
    ends = np.append(starts[1:], n)
    d = len(starts)
    if d < 2:
        return np.zeros(d, int), np.zeros(n, int)
    pd_vec = host_array(domain_pdists(zxys, starts))
    mat = np.zeros((d, d))
    iu = np.triu_indices(d, 1)
    mat[iu] = pd_vec
    mat[(iu[1], iu[0])] = pd_vec
    labels = np.random.default_rng(0).integers(0, 2, d)
    labels[0] = 0
    for _ in range(n_iters):
        c0 = mat[labels == 0].mean(axis=0) if (labels == 0).any() else 0
        c1 = mat[labels == 1].mean(axis=0) if (labels == 1).any() else 0
        new = (np.linalg.norm(mat - c1, axis=1)
               < np.linalg.norm(mat - c0, axis=1)).astype(int)
        if (new == labels).all():
            break
        labels = new
    if a_marker_fraction:
        fr = np.zeros(d)
        for k in range(d):
            vals = [a_marker_fraction.get(r, np.nan)
                    for r in range(starts[k], ends[k])]
            fr[k] = np.nanmean(vals) if len(vals) else np.nan
        if np.nanmean(fr[labels == 1]) > np.nanmean(fr[labels == 0]):
            labels = 1 - labels
    region_labels = np.zeros(n, int)
    for k in range(d):
        region_labels[starts[k]:ends[k]] = labels[k]
    return labels, region_labels


class CellTypeClassifier(nn.Module):
    """Gene-count cell typing: an MLP on log-normalised, z-scored counts
    (the normalisation float64 NumPy on the host, as in the JAX package).
    Two classes use one logistic output, more a softmax, as
    scikit-learn's ``MLPClassifier`` does."""

    alpha = 1e-4
    learning_rate = 1e-3
    tol = 1e-4
    n_iter_no_change = 10

    def __init__(self, hidden: Tuple[int, ...] = (64,), max_iter: int = 500,
                 seed: int = 0, device=None):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.max_iter = int(max_iter)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.layers = nn.ModuleList()
        self.classes_: Optional[np.ndarray] = None
        self._norm: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.n_iter_ = 0

    @staticmethod
    def _lognorm(counts) -> np.ndarray:
        c = np.asarray(counts, float)
        tot = np.maximum(c.sum(axis=1, keepdims=True), 1.0)
        return np.log1p(c / tot * 1e4)

    def set_layers(self, coefs: Sequence[np.ndarray],
                   intercepts: Sequence[np.ndarray]) -> None:
        """Layers from (fan_in, fan_out) weight and (fan_out,) bias arrays,
        scikit-learn's ``coefs_`` / ``intercepts_`` layout."""
        self.layers = nn.ModuleList()
        for w, b in zip(coefs, intercepts):
            lin = nn.Linear(w.shape[0], w.shape[1], dtype=f64,
                            device=self.device)
            with torch.no_grad():
                lin.weight.copy_(torch.as_tensor(np.asarray(w).T))
                lin.bias.copy_(torch.as_tensor(np.asarray(b)))
            self.layers.append(lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k, lin in enumerate(self.layers):
            x = lin(x)
            if k < len(self.layers) - 1:
                x = torch.relu(x)
        return x

    def _inputs(self, counts) -> torch.Tensor:
        mu, sd = self._norm
        return torch.as_tensor((self._lognorm(counts) - mu) / sd,
                               device=self.device)

    def _proba(self, x: torch.Tensor) -> torch.Tensor:
        out = self(x)
        if out.shape[1] == 1:
            p = torch.sigmoid(out[:, 0])
            return torch.stack([1.0 - p, p], dim=1)
        return torch.softmax(out, dim=1)

    def fit(self, counts, labels: Sequence) -> None:
        x = self._lognorm(counts)
        mu, sd = x.mean(0), x.std(0) + 1e-6
        self._norm = (mu, sd)
        xs = torch.as_tensor((x - mu) / sd, device=self.device)
        self.classes_, y = np.unique(np.asarray(labels), return_inverse=True)
        n_out = 1 if len(self.classes_) == 2 else len(self.classes_)
        yt = torch.as_tensor(y, device=self.device)
        gen = torch.Generator().manual_seed(self.seed)
        sizes = [xs.shape[1], *self.hidden, n_out]
        coefs, intercepts = [], []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
            coefs.append((torch.rand((fan_in, fan_out), generator=gen,
                                     dtype=f64) * 2 - 1) * bound)
            intercepts.append((torch.rand(fan_out, generator=gen, dtype=f64)
                               * 2 - 1) * bound)
        self.set_layers([c.numpy() for c in coefs],
                        [b.numpy() for b in intercepts])
        opt = torch.optim.Adam(self.parameters(), lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        n = xs.shape[0]
        batch = min(200, n)
        best, stall = float("inf"), 0
        for epoch in range(self.max_iter):
            order = torch.randperm(n, generator=gen).to(self.device)
            total = torch.zeros((), dtype=f64, device=self.device)
            for b0 in range(0, n, batch):
                idx = order[b0:b0 + batch]
                out = self(xs[idx])
                if n_out == 1:
                    loss = nn.functional.binary_cross_entropy_with_logits(
                        out[:, 0], yt[idx].to(f64))
                else:
                    loss = nn.functional.cross_entropy(out, yt[idx])
                penalty = sum((lin.weight * lin.weight).sum()
                              for lin in self.layers)
                loss = loss + 0.5 * self.alpha * penalty / idx.numel()
                opt.zero_grad()
                loss.backward()
                opt.step()
                total = total + loss.detach() * idx.numel()
            epoch_loss = float(total) / n
            stall = stall + 1 if epoch_loss > best - self.tol else 0
            best = min(best, epoch_loss)
            self.n_iter_ = epoch + 1
            if stall > self.n_iter_no_change:
                break

    @torch.no_grad()
    def predict_proba(self, counts) -> np.ndarray:
        """(n, n_classes) class probabilities, classes in sorted order."""
        return host_array(self._proba(self._inputs(counts)))

    def predict(self, counts) -> np.ndarray:
        """The most probable class (for two classes: p > 0.5, since 1 - p
        is exact for p >= 0.5)."""
        return self.classes_[np.argmax(self.predict_proba(counts), axis=1)]

    def score(self, counts, labels: Sequence) -> float:
        return float(np.mean(self.predict(counts) == np.asarray(labels)))
