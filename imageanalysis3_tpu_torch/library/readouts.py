"""Readout (secondary-probe) selection: generation, screening, adaptors.

The port's copy of ``imageanalysis3_tpu/library/readouts.py``, host NumPy
with no tensors, kept here so the port never imports the JAX package.

Behavior targets (reference library_tools/readouts.py):
  * Extend_Readout          :21-52   (random 5'/3' extension to target len)
  * Filter_Readout          :53-188  (GC window, max consecutive bases,
    internal k-mer uniqueness, C-content window + local C clamp, and a
    cross-similarity screen against existing readouts)
  * Search_Candidates       :225-304 (grow a candidate set from a source
    pool, re-screening against everything accepted so far)
  * filter_readouts_by_blast/Filter_Readouts_by_Genome :305-390
    (genome off-target screening)
  * Filter_Readouts_by_RNAfold :390-443 (secondary-structure screen)
  * Split_readouts_into_channels / Generate_adaptors :498-600

No-subprocess design: the reference shells out to NCBI BLAST and RNAfold.
Here the cross-similarity screen is an exact longest-shared-run scan
(against sequences and their reverse complements — the quantity BLAST's
HSP score proxies for ungapped short queries), genome screening queries
the native seqint k-mer table, and the structure screen is a Nussinov
maximum base-pairing fold (exact for these 20-40 nt sequences, where
RNAfold's MFE is dominated by pair count).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .design import (KmerCountTable, gc_content, read_fasta,
                     reverse_complement)

_ALPHABET = "ACGT"


def extend_readout(seq: str, target_len: int = 30, add_5p: bool = True,
                   rng: Optional[np.random.Generator] = None) -> str:
    """Extend a short readout with random bases (first added base A/T)
    (reference Extend_Readout, readouts.py:21-52)."""
    rng = rng or np.random.default_rng()
    if len(seq) >= target_len:
        raise ValueError("input seq length does not match target length")
    out = seq.upper()
    first = "AT"[rng.integers(2)]
    out = first + out if add_5p else out + first
    while len(out) < target_len:
        b = _ALPHABET[rng.integers(4)]
        out = b + out if add_5p else out + b
    return out


def max_consecutive_run(seq: str) -> int:
    s = seq.upper()
    best = run = 1 if s else 0
    for a, b in zip(s, s[1:]):
        run = run + 1 if a == b else 1
        best = max(best, run)
    return best


def has_repeated_kmer(seq: str, word: int) -> bool:
    """True when any internal `word`-mer occurs twice
    (reference _checking_repetitive)."""
    s = seq.upper()
    seen = set()
    for i in range(len(s) - word + 1):
        k = s[i:i + word]
        if k in seen:
            return True
        seen.add(k)
    return False


def max_shared_run(seq: str, refs: Sequence[str],
                   include_rc: bool = True) -> int:
    """Longest exact substring shared with any reference (or its reverse
    complement) — the native stand-in for the reference's short-word
    BLAST HSP screen (readouts.py:131-160): for ungapped short queries
    the HSP score is the matched run length."""
    s = seq.upper()
    best = 0
    for ref in refs:
        cands = [ref.upper()]
        if include_rc:
            cands.append(reverse_complement(ref.upper()))
        for r in cands:
            # classic O(n*m) longest-common-substring rolling row
            prev = np.zeros(len(r) + 1, np.int32)
            for ch in s:
                cur = np.zeros(len(r) + 1, np.int32)
                match = np.frombuffer(r.encode(), np.uint8) == ord(ch)
                cur[1:] = np.where(match, prev[:-1] + 1, 0)
                best = max(best, int(cur.max()))
                prev = cur
    return best


def filter_readout(seq: str,
                   gc_range: Tuple[float, float] = (0.4, 0.6),
                   max_consecutive: int = 4,
                   max_rep: int = 6,
                   c_range: Tuple[float, float] = (0.22, 0.28),
                   existing: Sequence[str] = (),
                   max_shared: int = 10) -> bool:
    """Full readout screen (reference Filter_Readout, readouts.py:53-188):
    GC in (gc_range), no `max_consecutive` homobase run, every internal
    `max_rep`-mer unique, C fraction in (c_range) with <= 3 C per 6-mer in
    the first 12 bases, and no run longer than `max_shared` shared with
    `existing` readouts (the BLAST screen's native equivalent)."""
    s = seq.upper()
    gc = gc_content(s)
    if not (gc_range[0] < gc < gc_range[1]):
        return False
    if max_consecutive and max_consecutive_run(s) >= max_consecutive:
        return False
    if max_rep and has_repeated_kmer(s, max_rep):
        return False
    if c_range:
        c_per = s.count("C") / max(len(s), 1)
        if not (c_range[0] < c_per < c_range[1]):
            return False
        for i in range(12 - 6):
            if s[i:i + 6].count("C") >= 4:
                return False
    if existing and max_shared_run(s, existing) > max_shared:
        return False
    return True


def search_candidates(source_seqs: Iterable[str],
                      total_cand: int = 200,
                      existing: Sequence[str] = (),
                      gc_range: Tuple[float, float] = (0.4, 0.6),
                      max_consecutive: int = 4,
                      max_rep: int = 6,
                      c_range: Tuple[float, float] = (0.22, 0.28),
                      max_shared: int = 10) -> List[str]:
    """Grow a candidate readout set from a source pool, screening each new
    sequence against everything accepted so far (reference
    Search_Candidates, readouts.py:225-304)."""
    accepted: List[str] = []
    pool = list(existing)
    for seq in source_seqs:
        if len(accepted) >= total_cand:
            break
        if filter_readout(seq, gc_range, max_consecutive, max_rep,
                          c_range, existing=pool, max_shared=max_shared):
            accepted.append(seq.upper())
            pool.append(seq.upper())
    return accepted


def screen_readouts_by_genome(seqs: Sequence[str],
                              genome_table: KmerCountTable,
                              max_hits: int = 0) -> np.ndarray:
    """Keep-mask: a readout passes when none of its genome-word k-mers
    occurs more than `max_hits` times in the genome table (reference
    Filter_Readouts_by_Genome, readouts.py:343-390, word_size 17)."""
    keep = np.ones(len(seqs), bool)
    for i, s in enumerate(seqs):
        if len(s) < genome_table.word:
            continue
        hits = genome_table.count_sequence(s)
        if len(hits) and hits.max() > max_hits:
            keep[i] = False
    return keep


def nussinov_max_pairs(seq: str, min_loop: int = 3) -> int:
    """Maximum number of Watson-Crick/GU base pairs in any secondary
    structure (Nussinov DP) — the structure-propensity score standing in
    for RNAfold's MFE on 20-40 nt readouts (reference
    Filter_Readouts_by_RNAfold, readouts.py:390-443)."""
    s = seq.upper().replace("T", "U")
    n = len(s)
    pairs = {("A", "U"), ("U", "A"), ("G", "C"), ("C", "G"),
             ("G", "U"), ("U", "G")}
    dp = np.zeros((n, n), np.int32)
    for span in range(min_loop + 1, n):
        for i in range(n - span):
            j = i + span
            best = dp[i + 1, j]
            if j > 0:
                best = max(best, dp[i, j - 1])
            if (s[i], s[j]) in pairs:
                best = max(best, dp[i + 1, j - 1] + 1)
            for k in range(i + 1, j):
                best = max(best, dp[i, k] + dp[k + 1, j])
            dp[i, j] = best
    return int(dp[0, n - 1]) if n else 0


def screen_readouts_by_structure(seqs: Sequence[str],
                                 max_pair_fraction: float = 0.35
                                 ) -> np.ndarray:
    """Keep-mask: readouts folding more than `max_pair_fraction` of their
    bases into pairs are rejected (hairpin-prone readouts hybridize
    poorly — the reference's RNAfold MFE threshold plays this role)."""
    keep = np.ones(len(seqs), bool)
    for i, s in enumerate(seqs):
        if not s:
            continue
        frac = 2.0 * nussinov_max_pairs(s) / len(s)
        if frac > max_pair_fraction:
            keep[i] = False
    return keep


def split_readouts_into_channels(seqs: Sequence[str],
                                 num_channels: int = 3,
                                 start_ind: int = 0) -> List[List[str]]:
    """Round-robin channel assignment (reference
    Split_readouts_into_channels, readouts.py:498-551)."""
    out: List[List[str]] = [[] for _ in range(num_channels)]
    for i, s in enumerate(seqs[start_ind:]):
        out[i % num_channels].append(s)
    return out


def generate_adaptors(readouts: Sequence[str],
                      adaptor_sites: Sequence[str],
                      rc_readout: bool = False,
                      rc_adaptor_site: bool = True) -> List[str]:
    """Adaptor oligos: readout complement + adaptor site pairing
    (reference Generate_adaptors, readouts.py:552-600): each adaptor
    carries the (rc of the) readout followed by two copies of the (rc of
    the) matched adaptor site."""
    out = []
    for r, a in zip(readouts, adaptor_sites):
        rr = reverse_complement(r) if rc_readout else r
        aa = reverse_complement(a) if rc_adaptor_site else a
        out.append(rr + aa + aa)
    return out
