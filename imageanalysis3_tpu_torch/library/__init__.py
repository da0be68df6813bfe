"""Probe-library design (offline workload; reference library_tools/).

The port's copy of ``imageanalysis3_tpu/library/``: host NumPy with no
tensors, and the native k-mer code (``native/seqint.cpp``) over ctypes.
"""

from .seqint import (seq2int, seq2int_rc, seq_to_kmer_ints,
                     count_kmers_dense, native_available)
from .design import (KmerCountTable, read_fasta, reverse_complement,
                     gc_content, melting_temperature, design_probes,
                     assemble_probes, check_probes, ProbeReport)
from .sequences import (Gene, Transcript, read_gff3, parse_region,
                        read_region_file, extract_region_sequence,
                        extract_transcript_sequence,
                        isoform_coverage_flags)
from .readouts import (extend_readout, filter_readout, search_candidates,
                       has_repeated_kmer, max_consecutive_run,
                       max_shared_run, screen_readouts_by_genome,
                       nussinov_max_pairs, screen_readouts_by_structure,
                       split_readouts_into_channels, generate_adaptors)
from .reports import (ProbeDesigner, MapSpec, select_primer_pair,
                      check_library, parse_probe_sequence)
from .encoding import (convert_bits_to_matrix, calculate_closest_overlap,
                       write_fasta)

__all__ = [
    "seq2int", "seq2int_rc", "seq_to_kmer_ints", "count_kmers_dense",
    "native_available",
    "KmerCountTable", "read_fasta", "reverse_complement", "gc_content",
    "melting_temperature", "design_probes", "assemble_probes",
    "check_probes", "ProbeReport",
    "Gene", "Transcript", "read_gff3", "parse_region",
    "read_region_file", "extract_region_sequence",
    "extract_transcript_sequence", "isoform_coverage_flags",
    "extend_readout", "filter_readout", "search_candidates",
    "has_repeated_kmer", "max_consecutive_run",
    "max_shared_run", "screen_readouts_by_genome", "nussinov_max_pairs",
    "screen_readouts_by_structure", "split_readouts_into_channels",
    "generate_adaptors",
    "ProbeDesigner", "MapSpec", "select_primer_pair", "check_library",
    "parse_probe_sequence",
    "convert_bits_to_matrix", "calculate_closest_overlap", "write_fasta",
]
