"""Experiment metadata: Color_Usage tables and hybridization folder layout.

The port's own copy of ``imageanalysis3_tpu/io/color_usage.py`` (csv,
glob and re only; no tensors).

Behavior targets (reference ImageAnalysis3):
  * Color_Usage CSV parsing   get_img_info.py:96-167 (Load_Color_Usage)
  * hyb folder scanning       io_tools/data.py:20-55 / get_img_info.py:12-33
    (H*-prefixed folders containing per-FOV .dax files)
  * channel roles             get_img_info.py:496-524 (find_bead_channel,
    find_dapi_channel)

A Color_Usage table maps hyb-folder name -> per-channel content (region ids
like 'u101', 'c5', gene names, 'beads', 'DAPI', or empty), with the header
row naming the laser channels.
"""

from __future__ import annotations

import csv
import glob
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class ColorUsage:
    """Parsed Color_Usage: channels + per-hyb-folder channel contents."""

    channels: List[str]
    usage: Dict[str, List[str]]          # folder -> contents per channel
    has_dapi: bool = False

    def folders(self) -> List[str]:
        return list(self.usage.keys())

    def bead_channel_index(self, bead_name: str = "beads") -> Optional[int]:
        """Index of the channel carrying fiducial beads.

        Reference semantics (get_img_info.py:496-508 find_bead_channel):
        the bead channel must be the SAME in every hyb folder that carries
        beads — a non-unique bead channel raises rather than silently
        picking the first, since registering against the wrong channel
        corrupts every drift downstream.  Returns None when no folder
        carries beads (the reference unconditionally indexes and throws;
        absence is a valid bead-free configuration here).
        """
        return self._unique_channel_of(bead_name, "bead")

    def dapi_channel_index(self) -> Optional[int]:
        """DAPI channel index, uniqueness-checked across the folders that
        carry DAPI (reference get_img_info.py:510-524 find_dapi_channel)."""
        return self._unique_channel_of("DAPI", "dapi")

    def _unique_channel_of(self, mark: str, what: str) -> Optional[int]:
        found = set()
        for contents in self.usage.values():
            for i, c in enumerate(contents):
                if c.lower() == mark.lower():
                    found.add(i)
        if not found:
            return None
        if len(found) > 1:
            raise ValueError(f"{what} channel not unique across hyb "
                             f"folders: {sorted(found)}")
        return found.pop()

    def regions_of(self, folder: str) -> Dict[int, str]:
        """channel index -> region/content id for data channels (excluding
        beads/DAPI/empty)."""
        out = {}
        for i, c in enumerate(self.usage.get(folder, [])):
            if c and c.lower() not in ("beads", "dapi", "null", "nan"):
                out[i] = c
        return out


def load_color_usage(path_or_folder: str,
                     filename: str = "Color_Usage",
                     fmt: str = "csv") -> ColorUsage:
    """Load a Color_Usage table (reference get_img_info.py:96-167)."""
    if os.path.isdir(path_or_folder):
        path = os.path.join(path_or_folder, f"{filename}.{fmt}")
    else:
        path = path_or_folder
    delim = "\t" if path.endswith((".tsv", ".txt")) else ","
    usage: Dict[str, List[str]] = {}
    with open(path, "r") as fh:
        reader = csv.reader(fh, delimiter=delim)
        header = next(reader)
        for row in reader:
            while row and row[-1] == "":
                row = row[:-1]
            if len(row) > 1:
                usage[row[0]] = row[1:]
    channels = [c for c in header[1:]]
    has_dapi = any("dapi" in (c.lower() for c in v) for v in usage.values())
    return ColorUsage(channels=channels, usage=usage, has_dapi=has_dapi)


def load_encoding_scheme(master_folder: str,
                         encoding_filename: str = "Encoding_Scheme",
                         fmt: str = "csv"):
    """Combinatorial encoding scheme: hyb folder -> encoding matrix rows.

    Behavior target: get_img_info.py:526-631 (Load_Encoding_Scheme): a CSV
    whose rows are hyb-folder names with per-channel encoded region ids
    ('' -> -1), plus num_hyb / num_reg / num_color header rows.  Returns
    (scheme dict folder -> list[int], info dict).
    """
    path = os.path.join(master_folder, f"{encoding_filename}.{fmt}")
    delim = "\t" if fmt in ("tsv", "txt") else ","
    scheme: Dict[str, List[int]] = {}
    info: Dict[str, int] = {}
    with open(path, "r") as fh:
        reader = csv.reader(fh, delimiter=delim)
        next(reader)                      # header
        for row in reader:
            if not row:
                continue
            key = row[0]
            vals = [(-1 if v == "" else v) for v in row[1:]]
            if key in ("num_hyb", "num_reg", "num_color", "num_group"):
                info[key] = int(vals[0])
            else:
                scheme[key] = [int(v) for v in vals]
    return scheme, info


def load_region_positions(analysis_folder: str,
                          filename: str = "Region_Positions",
                          fmt: str = "csv"):
    """Region id -> genomic position table (reference get_img_info.py:
    169-233 Load_Region_Positions): columns region, chr, start, end."""
    path = os.path.join(analysis_folder, f"{filename}.{fmt}")
    delim = "\t" if fmt in ("tsv", "txt") else ","
    out: Dict[int, Dict[str, object]] = {}
    with open(path, "r") as fh:
        reader = csv.reader(fh, delimiter=delim)
        header = [h.strip().lower() for h in next(reader)]
        for row in reader:
            if not row or not row[0].strip():
                continue
            rec = {h: v for h, v in zip(header, row)}
            rid = int(rec.get("region", rec.get(header[0])))
            entry: Dict[str, object] = {}
            for k in ("chr", "chromosome"):
                if k in rec:
                    entry["chr"] = rec[k]
            for k in ("start", "end", "midpoint"):
                if k in rec and rec[k] != "":
                    entry[k] = float(rec[k])
            out[rid] = entry
    return out


def _load_keyed_table(path: str, key_cast=int,
                      int_fields: Tuple[str, ...] = (),
                      float_fields: Tuple[str, ...] = ()) -> Dict:
    """Shared loader for the analysis-folder keyed CSV/TSV tables
    (RNA_Info / Gene_Info / Region_Positions style): first column is the
    record key, remaining header columns become a per-record dict with
    the named fields cast (reference get_img_info.py:169-434 repeats
    this parse loop per table; trailing empty cells are stripped)."""
    delim = "\t" if path.endswith((".tsv", ".txt")) else ","
    out: Dict = {}
    with open(path, "r") as fh:
        reader = csv.reader(fh, delimiter=delim)
        header = [h.strip() for h in next(reader)]
        for row in reader:
            while row and row[-1] == "":
                row = row[:-1]
            if len(row) <= 1:
                continue
            key = key_cast(row[0])
            rec = {h: v for h, v in zip(header[1:], row[1:])}
            for f in int_fields:
                if f in rec and rec[f] != "":
                    rec[f] = int(rec[f])
            for f in float_fields:
                if f in rec and rec[f] != "":
                    rec[f] = float(rec[f])
            out[key] = rec
    return out


def load_rna_info(analysis_folder: str, filename: str = "RNA_Info",
                  fmt: str = "csv") -> Dict[str, Dict]:
    """RNA_Info table: rna_id -> {gene_name, chr, strand, start, end,
    midpoint} (reference get_img_info.py:293-362 Load_RNA_Info)."""
    return _load_keyed_table(
        os.path.join(analysis_folder, f"{filename}.{fmt}"),
        key_cast=str, int_fields=("start", "end"),
        float_fields=("midpoint",))


def load_gene_info(analysis_folder: str, filename: str = "Gene_Info",
                   fmt: str = "csv") -> Dict[int, Dict]:
    """Gene_Info table: gene_id -> {gene_name, chr, TSS_position, ...}
    (reference get_img_info.py:364-434 Load_Gene_Info)."""
    return _load_keyed_table(
        os.path.join(analysis_folder, f"{filename}.{fmt}"),
        key_cast=int, int_fields=("start", "end", "TSS_position"),
        float_fields=("midpoint",))


def load_chip_data(analysis_folder: str, gene_name: str,
                   postfix: str = "ChIP-Seq_chr21",
                   fmt: str = "csv") -> List[Dict]:
    """ChIP-seq peak list for one factor: [{chr, start, end, midpoint,
    fold}, ...] (reference get_img_info.py:230-291 Load_ChIP_Data; the
    file is `<gene>_<postfix>.csv` in the analysis folder)."""
    path = os.path.join(analysis_folder, f"{gene_name}_{postfix}.{fmt}")
    delim = "\t" if fmt in ("tsv", "txt") else ","
    peaks: List[Dict] = []
    with open(path, "r") as fh:
        reader = csv.reader(fh, delimiter=delim)
        header = [h.strip() for h in next(reader)]
        for row in reader:
            while row and row[-1] == "":
                row = row[:-1]
            if len(row) <= 1:
                continue
            rec = {h: v for h, v in zip(header, row)}
            for f in ("start", "end"):
                if f in rec:
                    rec[f] = int(rec[f])
            for f in ("midpoint", "fold"):
                if f in rec:
                    rec[f] = float(rec[f])
            peaks.append(rec)
    return peaks


def match_peaks_to_regions(region_dic: Dict[int, Dict],
                           peak_list: List[Dict],
                           return_arrays: bool = True):
    """Sum ChIP peak fold-enrichment into the imaged region containing
    each peak midpoint (reference get_img_info.py:436-454
    match_peak_to_region, including its first-containing-region-wins
    break and the dense id axis of the array form)."""
    import numpy as np

    records = {rid: 0.0 for rid in region_dic}
    for peak in peak_list:
        for rid, region in region_dic.items():
            if (region.get("chr") == peak.get("chr")
                    and region["start"] <= peak["midpoint"]
                    <= region["end"]):
                records[rid] += peak.get("fold", 1.0)
                break
    if not return_arrays:
        return records
    rids = list(records)
    rx = np.arange(int(min(rids)), int(max(rids)) + 1)
    ry = np.zeros(len(rx))
    for rid, signal in records.items():
        ry[rx == rid] = signal
    return rx, ry


def match_rna_to_dna(rna_dic: Dict[str, Dict],
                     region_dic: Dict[int, Dict]) -> Dict[str, Dict]:
    """Annotate each RNA with the DNA region id whose interval contains
    its transcription start (reference get_img_info.py:457-467
    match_RNA_to_DNA: containment of `start`, same chromosome; the last
    matching region wins as in the reference loop)."""
    out = {k: dict(v) for k, v in rna_dic.items()}
    for rec in out.values():
        for rid, region in region_dic.items():
            if (rec.get("chr") == region.get("chr")
                    and region["start"] <= rec["start"] <= region["end"]):
                rec["DNA_id"] = rid
    return out


def match_gene_to_dna(gene_dic: Dict[int, Dict],
                      region_dic: Dict[int, Dict]) -> Dict[int, Dict]:
    """Annotate each gene with the DNA region containing its TSS
    (reference get_img_info.py:470-480 match_Gene_to_DNA; half-open
    [start, end) as in the reference comparison)."""
    out = {k: dict(v) for k, v in gene_dic.items()}
    for rec in out.values():
        for rid, region in region_dic.items():
            if (rec.get("chr") == region.get("chr")
                    and region["start"] <= rec["TSS_position"]
                    < region["end"]):
                rec["DNA_id"] = rid
    return out


def match_enhancers_to_dna(enhancer_dic: Dict, region_dic: Dict[int, Dict]
                           ) -> Dict[int, Dict]:
    """Per-region enhancer_count = sum of overlap fractions of enhancers
    intersecting the region (reference get_img_info.py:482-493
    match_Enhancer_to_DNA, including its endpoint-containment test)."""
    out = {rid: dict(v, enhancer_count=0.0)
           for rid, v in region_dic.items()}
    for region in out.values():
        for enh in enhancer_dic.values():
            s, e = enh["start"], enh["end"]
            if (region["start"] <= s < region["end"]
                    or region["start"] <= e < region["end"]):
                overlap = (min(e, region["end"])
                           - max(s, region["start"]))
                region["enhancer_count"] += overlap / float(e - s)
    return out


_HYB_RE = re.compile(r"^H(\d+)")


def find_hyb_folders(master_folder: str,
                     fov_pattern: str = "*.dax") -> Tuple[List[str], List[str]]:
    """(sorted hyb folders containing .dax files, sorted fov basenames).

    Reference behavior: folders starting with 'H' holding .dax movies;
    fov filenames shared across folders (io_tools/data.py:20-55).
    """
    folders = []
    for d in sorted(os.listdir(master_folder)):
        full = os.path.join(master_folder, d)
        if os.path.isdir(full) and _HYB_RE.match(d) \
                and glob.glob(os.path.join(full, fov_pattern)):
            folders.append(full)

    def hyb_key(f):
        m = _HYB_RE.match(os.path.basename(f))
        return (int(m.group(1)), os.path.basename(f))

    folders.sort(key=hyb_key)
    fovs: List[str] = []
    if folders:
        fovs = sorted(os.path.basename(p)
                      for p in glob.glob(os.path.join(folders[0],
                                                      fov_pattern)))
    return folders, fovs
