"""Genome/annotation readers: fasta regions, gff3 genes, transcript
splicing, isoform coverage flags.

The port's copy of ``imageanalysis3_tpu/library/sequences.py``, host NumPy
with no tensors, kept here so the port never imports the JAX package.

Behavior targets (reference library_tools):
  * gff3 parsing               references.py:81-315 (gff3_reader: header,
    gene -> mRNA -> exon hierarchy keyed by ID/Parent attributes)
  * region file + extraction   sequences.py:45-290 (read_region_file /
    parse_region / extract_sequence: 'chr:start-end' regions pulled from
    a genome fasta, reverse-complemented for '-' strand)
  * isoform flags              sequences.py:292-340
    (generate_flags_for_isoforms: per-base exon coverage across isoforms)
  * transcript extraction      sequences.py:341-799 (RNA_sequence_reader:
    splice exon sequences per transcript)

Plain-Python offline workload (not a device path); the heavy consumer is the
k-mer machinery in .design / native seqint.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .design import read_fasta, reverse_complement


@dataclass
class Transcript:
    """One transcript/isoform: ordered exons in genomic coordinates."""

    transcript_id: str
    gene_id: str
    seqid: str
    strand: str
    biotype: str = ""
    exons: List[Tuple[int, int]] = field(default_factory=list)  # 1-based inc.

    @property
    def span(self) -> Tuple[int, int]:
        return (min(s for s, _ in self.exons),
                max(e for _, e in self.exons))

    @property
    def length(self) -> int:
        return sum(e - s + 1 for s, e in self.exons)


@dataclass
class Gene:
    gene_id: str
    name: str
    seqid: str
    start: int
    end: int
    strand: str
    biotype: str = ""
    transcripts: Dict[str, Transcript] = field(default_factory=dict)


_ATTR_RE = re.compile(r"(\w+)=([^;]+)")


def _parse_attributes(text: str) -> Dict[str, str]:
    return {m.group(1): m.group(2) for m in _ATTR_RE.finditer(text)}


def read_gff3(path: str,
              feature_types: Sequence[str] = ("gene",),
              transcript_types: Sequence[str] = ("mRNA", "transcript"),
              ) -> Dict[str, Gene]:
    """Parse a gff3 annotation into gene -> transcript -> exon records.

    Behavior target: gff3_reader._batch_parse_gene_info
    (library_tools/references.py:81-315): walk the 9-column main text,
    opening a Gene at each `gene` row, attaching `mRNA`/`transcript` rows
    by Parent=, and exon rows to their parent transcript.  Header lines
    (## / #!) are skipped; coordinates stay 1-based inclusive (gff3
    convention).
    """
    genes: Dict[str, Gene] = {}
    tx_index: Dict[str, Transcript] = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            seqid, _src, ftype, start, end, _score, strand, _phase, attrs \
                = parts[:9]
            a = _parse_attributes(attrs)
            fid = a.get("ID", "")
            if ftype in feature_types:
                gid = fid.split(":")[-1] or a.get("gene_id", "")
                genes[gid] = Gene(
                    gene_id=gid, name=a.get("Name", gid), seqid=seqid,
                    start=int(start), end=int(end), strand=strand,
                    biotype=a.get("biotype", a.get("gene_biotype", "")))
            elif ftype in transcript_types:
                parent = a.get("Parent", "").split(":")[-1]
                tid = fid.split(":")[-1] or a.get("transcript_id", "")
                tx = Transcript(transcript_id=tid, gene_id=parent,
                                seqid=seqid, strand=strand,
                                biotype=a.get("biotype", ""))
                tx_index[tid] = tx
                if parent in genes:
                    genes[parent].transcripts[tid] = tx
            elif ftype == "exon":
                parent = a.get("Parent", "").split(":")[-1]
                if parent in tx_index:
                    tx_index[parent].exons.append((int(start), int(end)))
    for tx in tx_index.values():
        tx.exons.sort()
    return genes


# ---------------------------------------------------------------------------
# Region parsing + sequence extraction
# ---------------------------------------------------------------------------


_REGION_RE = re.compile(
    r"(?P<chr>[\w.]+):(?P<start>[\d,]+)-(?P<end>[\d,]+)")


def parse_region(text: str) -> Dict[str, object]:
    """'chr21:28,212,120-28,268,614' -> {'chr', 'start', 'end'}
    (reference parse_region, sequences.py:108-124)."""
    m = _REGION_RE.search(text.replace(" ", ""))
    if not m:
        raise ValueError(f"cannot parse region: {text!r}")
    return {"chr": m.group("chr"),
            "start": int(m.group("start").replace(",", "")),
            "end": int(m.group("end").replace(",", ""))}


def read_region_file(path: str) -> List[Dict[str, object]]:
    """Region list file: lines (or tab fields) holding 'chr:start-end'
    plus optional name/strand fields (reference read_region_file,
    sequences.py:45-107)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec: Dict[str, object] = {}
            for tok in re.split(r"[\t ]+", line):
                if _REGION_RE.search(tok):
                    rec.update(parse_region(tok))
                elif tok in ("+", "-"):
                    rec["strand"] = tok
                elif "name" not in rec and ":" not in tok:
                    rec["name"] = tok
            if "chr" in rec:
                rec.setdefault("strand", "+")
                out.append(rec)
    return out


def extract_region_sequence(genome: Dict[str, str], chrom: str,
                            start: int, end: int,
                            strand: str = "+") -> str:
    """1-based inclusive genomic slice, reverse-complemented for '-'
    (reference extract_sequence, sequences.py:125-290)."""
    key = chrom if chrom in genome else (
        chrom[3:] if chrom.startswith("chr") and chrom[3:] in genome
        else "chr" + chrom)
    seq = genome[key][start - 1:end]
    return reverse_complement(seq) if strand == "-" else seq


def extract_transcript_sequence(genome: Dict[str, str],
                                tx: Transcript) -> str:
    """Splice a transcript's exons from the genome (5'->3' in transcript
    orientation; reference RNA_sequence_reader, sequences.py:341-799)."""
    parts = [extract_region_sequence(genome, tx.seqid, s, e, "+")
             for s, e in tx.exons]
    seq = "".join(parts)
    return reverse_complement(seq) if tx.strand == "-" else seq


def isoform_coverage_flags(gene: Gene) -> Tuple[np.ndarray, int]:
    """Per-base count of isoforms covering each position of the gene span
    (reference generate_flags_for_isoforms, sequences.py:292-340).
    Returns (flags over [gene.start, gene.end] inclusive, n_isoforms);
    positions covered by every isoform are constitutive exon."""
    n = gene.end - gene.start + 1
    flags = np.zeros(n, np.int32)
    for tx in gene.transcripts.values():
        for s, e in tx.exons:
            lo = max(s, gene.start) - gene.start
            hi = min(e, gene.end) - gene.start + 1
            if hi > lo:
                flags[lo:hi] += 1
    return flags, len(gene.transcripts)
