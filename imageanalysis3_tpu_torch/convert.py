"""Carry a pipeline's and a decoder's state across from their NumPy form.

The pipeline has no learned weights.  A ``FovPipeline``'s state is the
per-FOV arrays it holds (illumination and bleed profiles, chromatic
constants and centre, per-channel seed thresholds, drift crop boxes) plus
the prepared reference spectra; a ``DNAMerfishDecoder``'s state is its
codebook tables and pixel sizes.  :func:`pipeline_from_arrays` and
:func:`decoder_from_arrays` rebuild the port's objects from those arrays
as NumPy (e.g. ``np.asarray`` of the JAX package's attributes), so the two
packages compute the same thing.  The learned models cross over too: the
cell-type classifier by :func:`classifier_from_arrays` from a fitted
scikit-learn ``MLPClassifier``'s ``coefs_`` and ``intercepts_``, the
segmentation UNet by :func:`unet_from_params` and cellpose's CPnet by
:func:`cpnet_from_params`, each from the JAX package's parameter pytree
(nested dicts and lists of NumPy arrays).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .analysis.population import CellTypeClassifier
from .config import config_from_dict
from .decode.dna_decoder import DNAMerfishDecoder
from .device import resolve_device
from .pipeline.fov import FovPipeline
from .segmentation.cellpose_net import CPnet, convert_cellpose_state_dict
from .segmentation.learned import UNet3D, load_weights_from

#: structural keys (small integer arrays) and the optional state arrays
STRUCTURE_KEYS = ("image_shape", "drift_idx", "fit_idx")
STATE_KEYS = ("illumination", "bleed", "chromatic", "chrom_center",
              "seed_thresholds", "crops", "ref_spectra")
#: a decoder's codebook tables (``Codebook.matrix``, ``ids``,
#: ``bit_values``), its per-region chromosome names and its pixel sizes
DECODER_KEYS = ("matrix", "ids", "bit_values", "chr", "pixel_sizes")


def pipeline_from_arrays(cfg_dict: dict, arrays: Dict[str, np.ndarray],
                         device=None
                         ) -> Tuple[FovPipeline, Optional[torch.Tensor]]:
    """Build a port ``FovPipeline`` (and its prepared reference) from
    NumPy arrays.

    `arrays` holds ``image_shape`` (3,), ``drift_idx`` (), ``fit_idx`` (F,),
    ``chromatic`` (C, 3, M), ``chrom_center`` (3,), ``seed_thresholds``
    (C,), ``crops`` (K, 3, 2), and optionally ``illumination`` (C, X, Y),
    ``bleed`` (C, C, X, Y) and ``ref_spectra`` (K, z, x, y//2+1) complex.
    Returns (pipeline, reference spectra on the device or None).
    """
    unknown = set(arrays) - set(STRUCTURE_KEYS) - set(STATE_KEYS)
    if unknown:
        raise KeyError(f"pipeline_from_arrays: unknown arrays {sorted(unknown)}")
    cfg = config_from_dict(cfg_dict)
    th = np.asarray(arrays["seed_thresholds"], np.float32)
    pipe = FovPipeline(
        cfg, n_channels=th.shape[0],
        drift_channel_index=int(arrays["drift_idx"]),
        fit_channel_indices=tuple(int(i) for i in
                                  np.atleast_1d(arrays["fit_idx"])),
        illumination=arrays.get("illumination"),
        bleed=arrays.get("bleed"),
        chromatic_constants=arrays["chromatic"],
        chromatic_ref_center=arrays["chrom_center"],
        image_shape=tuple(int(s) for s in arrays["image_shape"]),
        seed_thresholds=th, device=device)
    crops = np.asarray(arrays["crops"]).astype(int)
    pipe.crops = tuple(tuple(tuple(int(v) for v in ax) for ax in b)
                       for b in crops)
    spectra = arrays.get("ref_spectra")
    if spectra is not None:
        spectra = torch.as_tensor(np.array(spectra, np.complex64),
                                  device=pipe.device)
    return pipe, spectra


def decoder_from_arrays(arrays: Dict[str, np.ndarray],
                        pair_search_radius: float = 250.0,
                        num_homologs: int = 2, keep_ratio_th: float = 0.5,
                        device=None) -> DNAMerfishDecoder:
    """Build a port ``DNAMerfishDecoder`` from NumPy codebook tables.

    `arrays` holds ``matrix`` (G, B) on-bits, ``ids`` (G,) region ids,
    ``bit_values`` (B,) bit labels, ``chr`` (G,) chromosome names and
    ``pixel_sizes`` (3,) nm, e.g. the JAX decoder's ``codebook`` fields,
    ``codebook_df["chr"]`` and ``pixel_sizes``.  The scalars are the
    decoder's own parameters (the JAX decoder's
    ``decoder.search_th``, ``num_homologs`` and ``keep_ratio_th``).
    """
    if set(arrays) != set(DECODER_KEYS):
        raise KeyError(f"decoder_from_arrays: expected {DECODER_KEYS}, got "
                       f"{sorted(arrays)}")
    matrix = np.asarray(arrays["matrix"])
    columns = {"id": np.asarray(arrays["ids"], np.int64),
               "chr": np.asarray(arrays["chr"]).astype(str)}
    for b, label in enumerate(np.asarray(arrays["bit_values"])):
        columns[str(int(label))] = matrix[:, b]
    return DNAMerfishDecoder(columns, pixel_sizes=np.asarray(
        arrays["pixel_sizes"], np.float32),
        pair_search_radius=pair_search_radius, num_homologs=num_homologs,
        keep_ratio_th=keep_ratio_th, device=device)


def classifier_from_arrays(coefs, intercepts, classes, norm,
                           device=None) -> CellTypeClassifier:
    """Build a port ``CellTypeClassifier`` from a fitted classifier's NumPy
    arrays: ``coefs`` and ``intercepts`` per layer in scikit-learn's layout
    ((fan_in, fan_out) and (fan_out,), ``MLPClassifier.coefs_`` /
    ``intercepts_``), its ``classes`` in sorted order and the count
    normalisation ``norm`` = (mean, std) of the log-normalised counts (the
    JAX classifier's ``_norm``)."""
    clf = CellTypeClassifier(hidden=tuple(np.shape(c)[1]
                                          for c in coefs[:-1]),
                             device=device)
    clf.set_layers([np.asarray(c, np.float64) for c in coefs],
                   [np.asarray(b, np.float64) for b in intercepts])
    clf.classes_ = np.asarray(classes)
    clf._norm = tuple(np.asarray(a, np.float64) for a in norm)
    return clf


def _flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A pytree of dicts and lists -> {``jax.tree_util.keystr`` path:
    NumPy leaf}."""
    if isinstance(tree, dict):
        items = ((f"['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten_tree(v, prefix + k))
    return out


def unet_from_params(params, device=None) -> UNet3D:
    """The port's ``UNet3D`` holding the JAX package's
    ``init_unet_params`` / ``fit_unet`` pytree (``{"enc": [...], "dec":
    [...], "head": ...}``, convolution weights ZXYIO); its width, depth
    and input channels come from the shapes."""
    w = np.asarray(params["enc"][0]["a"]["w"])
    like = UNet3D(in_channels=w.shape[3], base=w.shape[4],
                  levels=len(params["enc"]))
    return load_weights_from(_flatten_tree(params), like).to(
        resolve_device(device))


def _cellpose_keys(tree, prefix: str) -> Dict[str, np.ndarray]:
    """One JAX ``batchconv`` / ``batchconv0`` entry (``bn``, ``conv`` and,
    for a style batchconv, ``full``) -> cellpose state_dict entries."""
    bn, conv = tree["bn"], tree["conv"]
    conv_at = "1" if prefix.endswith(".proj") else "2"
    body = prefix + (".conv" if "full" in tree else "")
    out = {f"{body}.0.weight": bn["gamma"], f"{body}.0.bias": bn["beta"],
           f"{body}.0.running_mean": bn["mean"],
           f"{body}.0.running_var": bn["var"],
           f"{body}.{conv_at}.weight":
               np.transpose(np.asarray(conv["w"]), (3, 2, 0, 1)),
           f"{body}.{conv_at}.bias": conv["b"]}
    if "full" in tree:
        out[f"{prefix}.full.weight"] = np.transpose(
            np.asarray(tree["full"]["w"]))
        out[f"{prefix}.full.bias"] = tree["full"]["b"]
    return out


def cpnet_from_params(params, device=None) -> CPnet:
    """The port's ``CPnet`` holding the JAX package's ``cpnet_apply``
    pytree (``convert_cellpose_state_dict``'s output: HWIO convolutions,
    (in, out) style Linears, BatchNorm as gamma / beta / mean / var); its
    nbase, outputs and kernel size come from the shapes."""
    down, up = params["down"], params["up"]
    w0 = np.asarray(down[0]["conv"][0]["conv"]["w"])
    nbase = [w0.shape[2]] + [int(np.shape(d["conv"][0]["conv"]["w"])[3])
                             for d in down]
    nout = int(np.shape(params["output"]["conv"]["w"])[3])
    sd = {}
    for n, lvl in enumerate(down):
        pre = f"downsample.down.res_down_{n}"
        sd.update(_cellpose_keys(lvl["proj"], f"{pre}.proj"))
        for t, bc in enumerate(lvl["conv"]):
            sd.update(_cellpose_keys(bc, f"{pre}.conv.conv_{t}"))
    for n, lvl in enumerate(up):
        pre = f"upsample.up.res_up_{n}"
        sd.update(_cellpose_keys(lvl["proj"], f"{pre}.proj"))
        for t, bc in enumerate(lvl["conv"]):
            sd.update(_cellpose_keys(bc, f"{pre}.conv.conv_{t}"))
    sd.update(_cellpose_keys(params["output"], "output"))
    return convert_cellpose_state_dict(sd, nbase=nbase, nout=nout,
                                       sz=w0.shape[0], device=device)
