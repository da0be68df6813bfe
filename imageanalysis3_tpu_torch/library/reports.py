"""Per-region probe reports, hierarchy-scored screening, primer
selection, and full library assembly QC.

The port's copy of ``imageanalysis3_tpu/library/reports.py``, host NumPy
with no tensors, kept here so the port never imports the JAX package.

Behavior targets (reference ImageAnalysis3 library_tools/):
  * pb_reports_class           design.py:270-948 (per-candidate report
    dicts with per-map hit counts, check_dic screening with
    single-map and map-difference thresholds, geometric-mean map
    scoring, best-score-first greedy pick with two-strand occupancy
    flags, pickle save/load)
  * primer selection           assemble.py:208-226 (load_primers) +
    quality_check.py:104-122 (_check_primer_usage): screen candidate
    primer pairs against the library for cross-hybridization
  * assembly quality check     quality_check.py:93-420
    (_check_primer_usage, _check_region_size, _check_region_to_readouts,
    _parsing_probe_sequence, _check_between_probes)

Design notes (house style — vectorized numpy, no BLAST):
hit counting queries each map ONCE per (region, orientation) via k-mer
count arrays and window sums, instead of the reference's per-probe
``OTmap.get`` loops; cross-hybridization screens use exact k-mer
collision counts where the reference shells out to BLAST.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .design import (KmerCountTable, gc_content, melting_temperature,
                     reverse_complement, read_fasta)
from .seqint import seq_to_kmer_ints

DEFAULT_MASKS = ("AAAA", "TTTT", "CCCC", "GGGG",   # quartet repeats
                 "GAATTC", "CTTAAG",               # EcoRI
                 "GGTACC", "CCATGG")               # KpnI


@dataclass
class MapSpec:
    """One off-target reference map (reference map_dic entries,
    design.py:272-279): `table` must be built WITHOUT reverse-complement
    counting (orientation is handled here).  `rev_com`: count the
    probe's reverse complement against the map; `two_stranded`: count
    both orientations."""
    table: KmerCountTable
    rev_com: bool = False
    two_stranded: bool = False


def _window_hits(counts: np.ndarray, pb_len: int, word: int,
                 n_pos: int) -> np.ndarray:
    """Per-start-position total k-mer hits of each pb_len window, from
    the per-kmer count array of the whole region (the vectorized form of
    OTmap.get(probe): sum of the probe's constituent k-mer counts)."""
    w = pb_len - word + 1
    if len(counts) == 0 or w <= 0:
        return np.zeros(n_pos, np.int64)
    c = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    out = np.zeros(n_pos, np.int64)
    m = min(n_pos, len(counts) - w + 1)
    if m > 0:
        out[:m] = c[w:w + m] - c[:m]
    return out


class ProbeDesigner:
    """Per-region candidate probe reports + screening + greedy pick
    (reference pb_reports_class, design.py:270-948).

    `sequences`: {region_name: sequence} or a fasta path.
    `maps`: {key: MapSpec} — e.g. genome / rep_genome / transcriptome.
      A 'self_sequences' map (hits within the region's own input) is
      computed automatically per region, as in the reference.
    `check_dic` keys (reference check_dic, design.py:286-294):
      'gc': (lo, hi) range or scalar minimum;
      'tm': (lo, hi) range or scalar minimum;
      'masks': forbidden substrings;
      '<map_key>': max allowed hits in that map;
      ('<tar>', '<ref>'): max allowed (tar hits - ref hits) difference.
    """

    def __init__(self, sequences: Union[str, Dict[str, str]],
                 maps: Optional[Dict[str, MapSpec]] = None,
                 pb_len: int = 42, word_size: int = 17,
                 buffer_len: int = 2,
                 input_rev_com: bool = False,
                 input_two_stranded: bool = False,
                 check_dic: Optional[dict] = None):
        if isinstance(sequences, str):
            sequences = read_fasta(sequences)
        self.names = list(sequences)
        self.seqs = [sequences[n].upper() for n in self.names]
        self.maps = dict(maps or {})
        self.pb_len = int(pb_len)
        self.word = int(word_size)
        self.buffer_len = int(buffer_len)
        self.input_rev_com = bool(input_rev_com)
        self.input_two_stranded = bool(input_two_stranded)
        self.check_dic = check_dic if check_dic is not None else {
            "gc": (0.25, 0.75),
            "tm": 47 + 0.61 * 50 + 5,
            "masks": list(DEFAULT_MASKS),
        }
        self.cand_probes: Dict[str, dict] = {}
        self.kept_probes: Dict[str, dict] = {}

    # -- report computation (reference compute_pb_report, :452-590)

    def _region_map_hits(self, seq: str, key: str, spec: MapSpec,
                         probe_rc: bool) -> np.ndarray:
        """Per-position hits of each candidate window (strand `probe_rc`)
        against one map, respecting the map's orientation flags."""
        n_pos = len(seq) - self.pb_len + 1
        fw, rc = seq_to_kmer_ints(seq, spec.table.word, with_rc=True)
        # the map stores forward-orientation k-mers of its source; a
        # probe hits it if the probe's k-mers (or their rc, per the
        # orientation flags) appear
        counts_fw = spec.table.get(fw)
        counts_rc = spec.table.get(rc)
        if probe_rc:
            # rc-strand probe: its k-mers are the rc of the window's
            counts_fw, counts_rc = counts_rc, counts_fw
        total = np.zeros(n_pos, np.int64)
        if not spec.rev_com or spec.two_stranded:
            total += _window_hits(counts_fw, self.pb_len,
                                  spec.table.word, n_pos)
        if spec.rev_com or spec.two_stranded:
            total += _window_hits(counts_rc, self.pb_len,
                                  spec.table.word, n_pos)
        return total

    def compute_reports(self) -> Dict[str, dict]:
        """Candidate report per probe sequence: name/region/index/strand,
        gc, tm, and per-map hit counts (keys 'map_<name>' +
        'map_self_sequences')."""
        self.cand_probes = {}
        for reg_id, (name, seq) in enumerate(zip(self.names, self.seqs)):
            n_pos = len(seq) - self.pb_len + 1
            if n_pos <= 0:
                continue
            # self map: the region's own k-mers, forward only
            self_table = KmerCountTable(self.word)
            self_table.consume(seq, count_rc=False)
            self_spec = MapSpec(self_table, rev_com=False,
                                two_stranded=True)
            strands = []
            if not self.input_rev_com or self.input_two_stranded:
                strands.append("+")
            if self.input_rev_com or self.input_two_stranded:
                strands.append("-")
            for strand in strands:
                probe_rc = strand == "-"
                hits = {f"map_{k}": self._region_map_hits(
                    seq, k, spec, probe_rc)
                    for k, spec in self.maps.items()}
                hits["map_self_sequences"] = self._region_map_hits(
                    seq, "self_sequences", self_spec, probe_rc)
                for i in range(n_pos):
                    sub = seq[i:i + self.pb_len]
                    if "N" in sub:
                        continue
                    pb = reverse_complement(sub) if probe_rc else sub
                    info = {"name": f"{name}_reg_{reg_id}_pb_{i}",
                            "reg_index": reg_id, "reg_name": name,
                            "pb_index": i, "strand": strand,
                            "gc": gc_content(pb),
                            "tm": melting_temperature(pb)}
                    for k, arr in hits.items():
                        info[k] = int(arr[i])
                    self.cand_probes[pb] = info
        return self.cand_probes

    # -- screening + pick (reference check_probes, :591-779)

    def _passes_scalar_checks(self, pb: str, info: dict) -> bool:
        cd = self.check_dic
        if "gc" in cd:
            th = cd["gc"]
            if isinstance(th, (tuple, list)):
                if not (min(th) <= info["gc"] <= max(th)):
                    return False
            elif info["gc"] < th:
                return False
        if "tm" in cd:
            th = cd["tm"]
            if isinstance(th, (tuple, list)):
                if not (min(th) <= info["tm"] <= max(th)):
                    return False
            elif info["tm"] < th:
                return False
        for mask in cd.get("masks", ()):
            if mask in pb:
                return False
        return True

    def _map_score(self, info: dict) -> Optional[float]:
        """Geometric mean of per-check (threshold / hits) ratios, with
        the reference's conventions (design.py:646-683): hits over
        threshold -> reject (None); zero hits w/ positive threshold ->
        ratio thres/0.5; zero threshold -> excluded from the mean."""
        ratios = []
        for key, th in self.check_dic.items():
            if key in ("gc", "tm", "masks"):
                continue
            if isinstance(key, (tuple, list)):
                val = info[f"map_{key[0]}"] - info[f"map_{key[1]}"]
            else:
                val = info[f"map_{key}"]
            if val > th:
                return None
            if val <= 0 and th > 0:
                ratios.append(th / 0.5)
            elif val <= 0 and th <= 0:
                continue
            else:
                ratios.append(th / val)
        if not ratios:
            return 1.0
        return float(np.prod(ratios) ** (1.0 / len(ratios)))

    def check_probes(self, pick_probe_by_hits: bool = True
                     ) -> Dict[str, dict]:
        """Screen candidates and greedily keep the best-scoring,
        non-overlapping set per region (two-strand occupancy flags with
        pb_len + buffer_len exclusion, best unique score first, then by
        position — reference check_probes :591-779)."""
        if not self.cand_probes:
            self.compute_reports()
        self.kept_probes = {}
        for reg_id, (name, seq) in enumerate(zip(self.names, self.seqs)):
            sel: Dict[str, dict] = {}
            scores: Dict[str, float] = {}
            edge = max(self.buffer_len, 0)
            last_start = len(seq) - self.pb_len + 1 - edge
            for pb, info in self.cand_probes.items():
                if info["reg_index"] != reg_id:
                    continue
                if info["pb_index"] < edge or info["pb_index"] > last_start:
                    continue
                if not self._passes_scalar_checks(pb, info):
                    continue
                s = self._map_score(info)
                if s is None:
                    continue
                sel[pb] = info
                scores[pb] = s
            # greedy keep: best score first (or by position when
            # pick_probe_by_hits=False), both-strand occupancy window
            flags = np.full((2, len(seq)), -1.0)
            kept: List[str] = []
            if pick_probe_by_hits:
                order = sorted(
                    sel, key=lambda p: (-scores[p], sel[p]["pb_index"]))
            else:
                order = sorted(sel, key=lambda p: sel[p]["pb_index"])
            for pb in order:
                info = sel[pb]
                start = info["pb_index"]
                end = start + self.pb_len + self.buffer_len
                if (flags[:, start:end] < 0).all():
                    kept.append(pb)
                    row = 1 if info["strand"] == "+" else 0
                    flags[row, start:end] = scores[pb]
            for pb in sorted(kept, key=lambda p: sel[p]["pb_index"]):
                self.kept_probes[pb] = {**sel[pb], "score": scores[pb]}
        return self.kept_probes

    def kept_by_region(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {n: [] for n in self.names}
        for pb, info in self.kept_probes.items():
            out[info["reg_name"]].append(pb)
        return out

    # -- persistence (reference save_to_file/load_from_file :779-833)

    def save(self, path: str) -> None:
        state = {k: getattr(self, k) for k in
                 ("names", "seqs", "pb_len", "word", "buffer_len",
                  "input_rev_com", "input_two_stranded", "check_dic",
                  "cand_probes", "kept_probes")}
        with open(path, "wb") as fh:
            pickle.dump(state, fh)

    @classmethod
    def load(cls, path: str) -> "ProbeDesigner":
        with open(path, "rb") as fh:
            state = pickle.load(fh)
        self = cls.__new__(cls)
        self.maps = {}
        for k, v in state.items():
            setattr(self, k, v)
        return self


# ---------------------------------------------------------------------------
# Primer selection (reference assemble.py:208-226 + quality_check.py:104)
# ---------------------------------------------------------------------------


def _kmer_set(seq: str, word: int) -> set:
    fw, rc = seq_to_kmer_ints(seq, word, with_rc=True)
    return set(fw.tolist()) | set(rc.tolist())


def select_primer_pair(fwd_candidates: Sequence[str],
                       rev_candidates: Sequence[str],
                       library_seqs: Sequence[str],
                       word: int = 12,
                       gc_range: Tuple[float, float] = (0.4, 0.6),
                       tm_range: Tuple[float, float] = (60.0, 75.0)
                       ) -> Tuple[str, str]:
    """Pick the (forward, reverse) primer pair with no k-mer
    cross-hybridization against the library and against each other,
    within GC/Tm bounds (reference primer screening behavior,
    assemble.py:208-226; BLAST screens replaced by exact `word`-mer
    collision tests).  Ties break toward GC closest to 0.5.
    Raises ValueError if no clean pair exists."""
    lib_kmers: set = set()
    for s in library_seqs:
        lib_kmers |= _kmer_set(s, word)

    def screened(cands):
        out = []
        for p in cands:
            gc = gc_content(p)
            tmv = melting_temperature(p)
            if not (gc_range[0] <= gc <= gc_range[1]):
                continue
            if not (tm_range[0] <= tmv <= tm_range[1]):
                continue
            ks = _kmer_set(p, word)
            if ks & lib_kmers:
                continue
            out.append((p, ks, abs(gc - 0.5)))
        return sorted(out, key=lambda t: t[2])

    fwd_ok = screened(fwd_candidates)
    rev_ok = screened(rev_candidates)
    for f, fks, _ in fwd_ok:
        for r, rks, _ in rev_ok:
            if not (fks & rks):
                return f, r
    raise ValueError("no primer pair passes cross-hybridization screens")


# ---------------------------------------------------------------------------
# Full assembly QC (reference quality_check.py:93-420)
# ---------------------------------------------------------------------------


def parse_probe_sequence(oligo: str, primer_len: int = 20,
                         readout_len: int = 20, target_len: int = 42,
                         n_readouts: int = 3) -> dict:
    """Split one assembled oligo back into its segments
    (reference _parsing_probe_sequence, quality_check.py:199-226):
    fwd primer + n readout sites + target + rc(rev primer)."""
    expect = primer_len + n_readouts * readout_len + target_len \
        + primer_len
    if len(oligo) != expect:
        raise ValueError(f"oligo length {len(oligo)} != expected {expect}")
    pos = primer_len
    readouts = [oligo[pos + j * readout_len: pos + (j + 1) * readout_len]
                for j in range(n_readouts)]
    pos += n_readouts * readout_len
    return {"fwd_primer": oligo[:primer_len],
            "readouts": readouts,
            "target": oligo[pos:pos + target_len],
            "rev_primer_rc": oligo[-primer_len:]}


def check_library(oligos: Sequence[str],
                  regions: Sequence[str],
                  fwd_primer: str, rev_primer: str,
                  readout_dict: Dict[str, Sequence[str]],
                  region_to_readouts: Dict[str, Sequence[str]],
                  primer_len: int = 20, readout_len: int = 20,
                  target_len: int = 42, n_readouts: int = 3,
                  min_region_size: int = 1,
                  cross_word: int = 17,
                  max_cross_hits: int = 50) -> dict:
    """Full assembled-library QC; returns a report dict whose 'ok' is
    True only if every check passes.

    Checks (each mirrors a reference quality_check.py routine):
      primer_usage   every oligo starts with fwd and ends with rc(rev)
                     (:104-122);
      region_size    per-region probe counts all >= min_region_size
                     (:123-142);
      readout_usage  the readout sites parsed out of each oligo are
                     exactly its region's assigned readouts and they
                     exist in readout_dict (:143-340);
      cross_hyb      no target `cross_word`-mer appears more than
                     max_cross_hits times across the library (:393-420).
    """
    report = {"ok": True}
    # primer usage
    rc_rev = reverse_complement(rev_primer)[:primer_len]
    primer_ok = all(o.startswith(fwd_primer[:primer_len])
                    and o.endswith(rc_rev) for o in oligos)
    report["primer_usage"] = primer_ok
    # region sizes
    sizes: Dict[str, int] = {}
    for r in regions:
        sizes[r] = sizes.get(r, 0) + 1
    report["region_sizes"] = sizes
    report["region_size_ok"] = all(v >= min_region_size
                                   for v in sizes.values())
    # readout usage
    known = {seq for seqs in readout_dict.values() for seq in seqs}
    readout_ok = True
    seen_by_region: Dict[str, set] = {}
    for o, r in zip(oligos, regions):
        parts = parse_probe_sequence(o, primer_len, readout_len,
                                     target_len, n_readouts)
        for site in parts["readouts"]:
            # a readout site is the rc of the dye-labeled readout or
            # the readout itself; accept either orientation
            if site not in known and reverse_complement(site) not in known:
                readout_ok = False
            canon = site if site in known else reverse_complement(site)
            seen_by_region.setdefault(r, set()).add(canon)
    for r, expected in region_to_readouts.items():
        if r in seen_by_region and \
                seen_by_region[r] != set(expected):
            readout_ok = False
    report["readout_usage"] = readout_ok
    # cross-hybridization between probes' targets
    table = KmerCountTable(cross_word)
    targets = []
    for o in oligos:
        t = parse_probe_sequence(o, primer_len, readout_len, target_len,
                                 n_readouts)["target"]
        targets.append(t)
        table.consume(t, count_rc=True)
    worst = 0
    for t in targets:
        counts = table.count_sequence(t)
        if len(counts):
            worst = max(worst, int(counts.max()))
    report["max_cross_hits"] = worst
    report["cross_hyb_ok"] = worst <= max_cross_hits
    report["ok"] = bool(primer_ok and report["region_size_ok"]
                        and readout_ok and report["cross_hyb_ok"])
    return report
