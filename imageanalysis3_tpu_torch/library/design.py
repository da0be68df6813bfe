"""Probe-library design: off-target count tables and probe selection.

The port's copy of ``imageanalysis3_tpu/library/design.py``, host NumPy
with no tensors, kept here so the port never imports the JAX package.

Behavior targets (reference library_tools/design.py):
  * countTable                :54-268 (dense 4^word uint16 vector or
    sparse map; consume fasta sequences; query per-kmer counts)
  * OTmap facade              :248-268 (count-table wrapper choosing the
    representation)
  * probe candidate reports   :270-948 (pb_reports_class: sliding
    candidate probes scored by GC, Tm, off-target maps; greedy
    non-overlapping pick)
  * assembly                  library_tools/assemble.py:285+
    (Assemble_probes: primer + readouts + target concatenation)
  * quality screens           library_tools/quality_check.py
    (GC bounds, homopolymer runs, internal repeats)

The hot kernel (k-mer packing / counting) is the native C++ seqint module;
everything above it is plain NumPy — an offline workload, not a device path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .seqint import count_kmers_dense, seq_to_kmer_ints

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def read_fasta(path: str) -> Dict[str, str]:
    """Minimal fasta reader (reference library_tools/sequences.py)."""
    out: Dict[str, List[str]] = {}
    name = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                out[name] = []
            elif name is not None:
                out[name].append(line)
    return {k: "".join(v) for k, v in out.items()}


class KmerCountTable:
    """Genome-scale k-mer occurrence map (reference countTable/OTmap).

    word <= 12 uses a dense 4^word uint16 vector (reference dense mode);
    larger words use a dictionary of observed k-mers (the reference's
    sparse mode without the int32 scipy contortions).
    """

    def __init__(self, word: int = 17, sparse: Optional[bool] = None):
        self.word = int(word)
        self.sparse = (self.word > 12) if sparse is None else bool(sparse)
        if self.sparse:
            self._counts: Dict[int, int] = {}
            self.table = None
        else:
            self.table = np.zeros(4 ** self.word, np.uint16)

    def consume(self, seq, count_rc: bool = True) -> None:
        """Add every k-mer of `seq` (and its reverse complement)."""
        fw, rc = seq_to_kmer_ints(seq, self.word, with_rc=count_rc)
        if self.sparse:
            for arr in (fw, rc) if count_rc else (fw,):
                pos, cts = np.unique(arr, return_counts=True)
                for p, c in zip(pos.tolist(), cts.tolist()):
                    self._counts[p] = min(self._counts.get(p, 0) + c, 65535)
        else:
            count_kmers_dense(fw, self.table)
            if count_rc and rc is not None:
                count_kmers_dense(rc, self.table)

    def consume_fasta(self, path: str, count_rc: bool = True) -> None:
        for seq in read_fasta(path).values():
            self.consume(seq, count_rc=count_rc)

    def get(self, kmers: np.ndarray) -> np.ndarray:
        kmers = np.asarray(kmers, np.uint64)
        if self.sparse:
            return np.array([self._counts.get(int(k), 0) for k in kmers],
                            np.int64)
        return self.table[kmers].astype(np.int64)

    def count_sequence(self, seq) -> np.ndarray:
        """Occurrence count of each k-mer window of `seq`."""
        fw, _ = seq_to_kmer_ints(seq, self.word, with_rc=False)
        return self.get(fw)


def gc_content(seq: str) -> float:
    s = seq.upper()
    n = max(len(s), 1)
    return (s.count("G") + s.count("C")) / n


def melting_temperature(seq: str, na_molar: float = 0.3) -> float:
    """Wallace/GC-fraction Tm with salt correction — the quick screen the
    reference applies to candidate probes (library_tools/design.py uses a
    comparable formula-based Tm; full nearest-neighbor is overkill for
    ranked filtering)."""
    s = seq.upper()
    n = max(len(s), 1)
    gc = gc_content(s)
    return 81.5 + 16.6 * np.log10(na_molar) + 41.0 * gc - 600.0 / n


def max_homopolymer_run(seq: str) -> int:
    best = run = 1
    s = seq.upper()
    for a, b in zip(s, s[1:]):
        run = run + 1 if a == b else 1
        best = max(best, run)
    return best if s else 0


@dataclass
class ProbeCandidate:
    start: int
    seq: str
    gc: float
    tm: float
    max_offtarget: int
    mean_offtarget: float
    score: float
    max_repeat: int = 0
    masked_fraction: float = 0.0


@dataclass
class ProbeReport:
    """Designed probes for one region (reference pb_reports_class)."""

    region_name: str
    probes: List[ProbeCandidate] = field(default_factory=list)

    @property
    def starts(self) -> np.ndarray:
        return np.asarray([p.start for p in self.probes], int)


def design_probes(region_seq: str,
                  probe_len: int = 42,
                  n_probes: int = 50,
                  gc_range: Tuple[float, float] = (0.25, 0.75),
                  tm_range: Tuple[float, float] = (60.0, 90.0),
                  max_homopolymer: int = 6,
                  offtarget_table: Optional[KmerCountTable] = None,
                  max_offtarget_hits: int = 10,
                  repeat_table: Optional[KmerCountTable] = None,
                  max_repeat_hits: int = 0,
                  max_masked_fraction: Optional[float] = None,
                  min_spacing: int = 2,
                  region_name: str = "") -> ProbeReport:
    """Sliding-window probe design with greedy non-overlapping selection.

    Behavior target: pick_cand_probes / pb_reports_class
    (library_tools/design.py:270-948): every start position yields a
    candidate screened by GC / Tm / homopolymer / off-target-map hits;
    survivors are ranked (fewest off-targets, then most central GC) and
    picked greedily with `min_spacing` between probe ends.

    Repeat awareness (reference rep_map screening, design.py:270-500):
    ``repeat_table`` rejects probes carrying any repeat-library k-mer more
    than `max_repeat_hits` times, and ``max_masked_fraction`` bounds the
    fraction of soft-masked (lowercase) bases in the *input* sequence per
    probe window — pass the region sequence un-uppercased to use it.
    """
    raw = region_seq
    seq = region_seq.upper()
    n = len(seq)
    lower_mask = np.frombuffer(raw.encode(), np.uint8) >= ord("a")
    cands: List[ProbeCandidate] = []
    ot_counts = None
    if offtarget_table is not None and n >= offtarget_table.word:
        ot_counts = offtarget_table.count_sequence(seq)
    rep_counts = None
    if repeat_table is not None and n >= repeat_table.word:
        rep_counts = repeat_table.count_sequence(seq)
    for start in range(0, n - probe_len + 1):
        sub = seq[start:start + probe_len]
        if "N" in sub:
            continue
        gc = gc_content(sub)
        if not (gc_range[0] <= gc <= gc_range[1]):
            continue
        tm = melting_temperature(sub)
        if not (tm_range[0] <= tm <= tm_range[1]):
            continue
        if max_homopolymer_run(sub) > max_homopolymer:
            continue
        masked = float(lower_mask[start:start + probe_len].mean())
        if max_masked_fraction is not None \
                and masked > max_masked_fraction:
            continue
        max_rep = 0
        if rep_counts is not None:
            w = repeat_table.word
            window = rep_counts[start:start + probe_len - w + 1]
            max_rep = int(window.max()) if len(window) else 0
            if max_rep > max_repeat_hits:
                continue
        if ot_counts is not None:
            w = offtarget_table.word
            window = ot_counts[start:start + probe_len - w + 1]
            max_ot = int(window.max()) if len(window) else 0
            mean_ot = float(window.mean()) if len(window) else 0.0
            if max_ot > max_offtarget_hits:
                continue
        else:
            max_ot, mean_ot = 0, 0.0
        score = -mean_ot - 2.0 * abs(gc - 0.5)
        cands.append(ProbeCandidate(start, sub, gc, tm, max_ot, mean_ot,
                                    score, max_rep, masked))
    # greedy non-overlapping pick, best score first
    cands.sort(key=lambda c: -c.score)
    picked: List[ProbeCandidate] = []
    occupied = np.zeros(n, bool)
    for c in cands:
        if len(picked) >= n_probes:
            break
        lo = max(c.start - min_spacing, 0)
        hi = min(c.start + probe_len + min_spacing, n)
        if occupied[lo:hi].any():
            continue
        occupied[c.start:c.start + probe_len] = True
        picked.append(c)
    picked.sort(key=lambda c: c.start)
    return ProbeReport(region_name=region_name, probes=picked)


def assemble_probes(targets: Sequence[str],
                    readouts: Sequence[str],
                    fwd_primer: str = "", rev_primer: str = "",
                    n_readouts_per_probe: int = 3) -> List[str]:
    """Assemble final oligos: fwd primer + readouts + target + rev primer
    (reference Assemble_probes, library_tools/assemble.py:285+; readouts
    cycle across probes)."""
    out = []
    for i, t in enumerate(targets):
        rs = [readouts[(i + j) % len(readouts)]
              for j in range(n_readouts_per_probe)]
        out.append(fwd_primer + "".join(rs) + t
                   + reverse_complement(rev_primer))
    return out


def check_probes(probes: Sequence[str],
                 gc_range: Tuple[float, float] = (0.2, 0.8),
                 max_homopolymer: int = 7,
                 cross_word: int = 12) -> np.ndarray:
    """Quality screen: GC bounds, homopolymer runs, and cross-probe k-mer
    collisions (reference library_tools/quality_check.py).  Returns a
    keep-mask."""
    keep = np.ones(len(probes), bool)
    seen: Dict[int, int] = {}
    kmer_lists = []
    for i, p in enumerate(probes):
        gc = gc_content(p)
        if not (gc_range[0] <= gc <= gc_range[1]):
            keep[i] = False
        if max_homopolymer_run(p) > max_homopolymer:
            keep[i] = False
        fw, rc = seq_to_kmer_ints(p, min(cross_word, len(p)))
        kmer_lists.append(set(fw.tolist()) | set(rc.tolist()))
    for i, ks in enumerate(kmer_lists):
        for k in ks:
            if k in seen and seen[k] != i:
                keep[i] = False
                break
            seen[k] = i
    return keep
