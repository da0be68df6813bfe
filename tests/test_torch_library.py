"""PyTorch port vs JAX package: ``library/`` (host NumPy and native seqint).

Every public function of the port's ``library`` against the JAX package's
on tests/test_library.py's cases, with the port's native k-mer code and
with its NumPy path; tests/test_library.py's own tests run on the port as
well.  The port builds ``library/native/seqint.cpp`` into its own hashed
build directory and refuses a library that is not exclusively its user's.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest

import test_library as JT
from imageanalysis3_tpu import library as JL
from imageanalysis3_tpu.library import reports as JR
from imageanalysis3_tpu_torch import _build
from imageanalysis3_tpu_torch import library as TL
from imageanalysis3_tpu_torch.library import reports as TR
from imageanalysis3_tpu_torch.library import seqint as tseq

PATHS = ("native", "numpy")
#: tests/test_library.py's tests, run on the port; the first checks that
#: the native build is live, so it runs on the native path only, and the
#: last is an io test
JAX_CASES = [(path, name) for name, fn in inspect.getmembers(
    JT, inspect.isfunction) if name.startswith("test_")
    and name != "test_load_position_file"
    for path in PATHS
    if not (path == "numpy" and name == "test_native_kernel_builds")]


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """The port's native k-mer code, or its NumPy path."""
    if request.param == "numpy":
        monkeypatch.setattr(tseq, "_build_lib", lambda: None)
    assert TL.native_available() == (request.param == "native")
    return request.param


def _rand_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("path_name,test", JAX_CASES,
                         ids=[f"{p}-{n}" for p, n in JAX_CASES])
def test_jax_library_cases_on_the_port(path_name, test, monkeypatch,
                                       tmp_path):
    if path_name == "numpy":
        monkeypatch.setattr(tseq, "_build_lib", lambda: None)
    monkeypatch.setattr(JT, "LB", TL)
    if test == "test_probe_designer_end_to_end":
        # the case imports the designer from the JAX module: give it ours
        monkeypatch.setattr(JR, "ProbeDesigner", TR.ProbeDesigner)
        monkeypatch.setattr(JR, "MapSpec", TR.MapSpec)
        monkeypatch.setattr(JR, "select_primer_pair", TR.select_primer_pair)
        monkeypatch.setattr(JR, "check_library", TR.check_library)
        monkeypatch.setattr(JR, "parse_probe_sequence",
                            TR.parse_probe_sequence)
    fn = getattr(JT, test)
    fn(**({"tmp_path": tmp_path}
          if "tmp_path" in inspect.signature(fn).parameters else {}))


def test_package_exports_every_jax_name():
    assert set(JL.__all__) <= set(TL.__all__)
    for name in JL.__all__:
        assert hasattr(TL, name), name


def test_packing_and_kmers_match_jax(path):
    rng = np.random.default_rng(0)
    seqs = ["A", "ACGT", "TTTTGGGGCCCCAAAA", "acgtACGT", "GATTACAGATTACAGAT",
            "ACGTNNACGT", _rand_seq(rng, 31)]
    for s in seqs:
        assert TL.seq2int(s) == JL.seq2int(s)
        assert TL.seq2int_rc(s) == JL.seq2int_rc(s)
        assert TL.seq2int(s.encode()) == JL.seq2int(s)
    seq = _rand_seq(rng, 3000, "ACGTacgtN")
    for word in (1, 5, 12, 17, 32):
        for with_rc in (True, False):
            fw_t, rc_t = TL.seq_to_kmer_ints(seq, word, with_rc)
            fw_j, rc_j = JL.seq_to_kmer_ints(seq, word, with_rc)
            assert fw_t.dtype == np.uint64
            np.testing.assert_array_equal(fw_t, fw_j)
            if with_rc:
                np.testing.assert_array_equal(rc_t, rc_j)
            else:
                assert rc_t is None and rc_j is None
    fw, rc = TL.seq_to_kmer_ints("ACG", 5)
    assert fw.size == 0 and rc.size == 0


def test_count_kmers_dense_matches_jax(path):
    rng = np.random.default_rng(1)
    kmers = rng.integers(0, 300, 5000).astype(np.uint64)
    kmers[:10] = 1000                              # out of the table
    t_t = np.zeros(256, np.uint16)
    t_j = np.zeros(256, np.uint16)
    t_t[7] = t_j[7] = 65530                        # saturates
    kmers[10:30] = 7
    TL.count_kmers_dense(kmers, t_t)
    JL.count_kmers_dense(kmers, t_j)
    np.testing.assert_array_equal(t_t, t_j)
    assert t_t[7] == 65535
    with pytest.raises(ValueError, match="uint16"):
        TL.count_kmers_dense(kmers, np.zeros(256, np.int32))


def test_count_tables_match_jax(path):
    rng = np.random.default_rng(2)
    genome = _rand_seq(rng, 4000)
    queries = [genome[100:130], _rand_seq(rng, 30), "ACGT" * 8]
    for word, sparse in ((4, False), (4, True), (12, None), (17, None)):
        tt = TL.KmerCountTable(word=word, sparse=sparse)
        tj = JL.KmerCountTable(word=word, sparse=sparse)
        for count_rc in (True, False):
            tt.consume(genome, count_rc=count_rc)
            tj.consume(genome, count_rc=count_rc)
        for q in queries:
            np.testing.assert_array_equal(tt.count_sequence(q),
                                          tj.count_sequence(q))
        kmers, _ = JL.seq_to_kmer_ints(genome[:200], word, False)
        np.testing.assert_array_equal(tt.get(kmers), tj.get(kmers))


def test_design_and_assembly_match_jax(path):
    rng = np.random.default_rng(0)
    region = _rand_seq(rng, 400)
    genome = _rand_seq(rng, 2000) + region[100:160] * 20
    repeat = _rand_seq(rng, 60)
    masked = region[:150] + repeat.lower() + region[150:]
    kw = dict(probe_len=40, n_probes=20, gc_range=(0.1, 0.9),
              tm_range=(0, 200))
    reports = {}
    for lib in (TL, JL):
        ot = lib.KmerCountTable(word=12)
        ot.consume(genome)
        rep = lib.KmerCountTable(word=12)
        rep.consume(repeat)
        reports[lib] = [
            lib.design_probes(region, offtarget_table=ot,
                              max_offtarget_hits=5, **kw),
            lib.design_probes(masked, repeat_table=rep, max_repeat_hits=0,
                              max_masked_fraction=0.2, **kw)]
    for a, b in zip(reports[TL], reports[JL]):
        assert _asdict(a) == _asdict(b)
        assert len(a.probes) >= 3
        np.testing.assert_array_equal(a.starts, b.starts)
    targets = ["ACGT" * 10, "GGCC" * 6 + "AATT" * 4]
    readouts = ["AAACCC", "GGGTTT", "CCCAAA"]
    for n in (1, 2, 3):
        assert TL.assemble_probes(targets, readouts, fwd_primer="TTTT",
                                  rev_primer="GGGG",
                                  n_readouts_per_probe=n) == \
            JL.assemble_probes(targets, readouts, fwd_primer="TTTT",
                               rev_primer="GGGG", n_readouts_per_probe=n)
    probes = ["ACGT" * 10, "AAAAAAAAAA" + "ACGT" * 8, "GC" * 20, "AT" * 20]
    np.testing.assert_array_equal(TL.check_probes(probes),
                                  JL.check_probes(probes))
    for s in (region[:40], "GCGC" * 10, ""):
        assert TL.gc_content(s) == JL.gc_content(s)
        if s:
            assert TL.melting_temperature(s) == JL.melting_temperature(s)
        assert TL.reverse_complement(s) == JL.reverse_complement(s)


def test_sequences_match_jax(tmp_path):
    gff, genome = JT._toy_annotation(tmp_path)
    gt, gj = TL.read_gff3(gff), JL.read_gff3(gff)
    assert {k: _asdict(v) for k, v in gt.items()} == \
        {k: _asdict(v) for k, v in gj.items()}
    for gname in gj:
        flags_t, n_t = TL.isoform_coverage_flags(gt[gname])
        flags_j, n_j = JL.isoform_coverage_flags(gj[gname])
        np.testing.assert_array_equal(flags_t, flags_j)
        assert n_t == n_j
        for tid in gj[gname].transcripts:
            assert TL.extract_transcript_sequence(
                genome, gt[gname].transcripts[tid]) == \
                JL.extract_transcript_sequence(genome,
                                               gj[gname].transcripts[tid])
    for reg in ("chr21:28,212,120-28,268,614", "chr1:100-200", "2:5-9"):
        assert TL.parse_region(reg) == JL.parse_region(reg)
    small = {"chr2": "ACGTACGTAA"}
    for args in (("chr2", 2, 5), ("2", 2, 5, "-"), ("chr2", 0, 10)):
        assert TL.extract_region_sequence(small, *args) == \
            JL.extract_region_sequence(small, *args)
    fa = tmp_path / "g.fasta"
    JL.write_fasta(str(fa), {"chr1": genome["chr1"][:300], "x": "ACGT"})
    assert TL.read_fasta(str(fa)) == JL.read_fasta(str(fa))
    reg = tmp_path / "regions.txt"
    reg.write_text("chr1:1-40\nchr1:101-160\n")
    assert TL.read_region_file(str(reg)) == JL.read_region_file(str(reg))


def test_readouts_match_jax(path):
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for seq in ("ACGTACGTACG", "TTTTTACG"):
        for add_5p in (True, False):
            assert TL.extend_readout(seq, 30, add_5p, rng=rng_t) == \
                JL.extend_readout(seq, 30, add_5p, rng=rng_j)
    rng = np.random.default_rng(3)
    pool = [_rand_seq(rng, 30) for _ in range(400)]
    good = "TCGATCAGTACGATCGTAGCTAGCATGTCA"
    cases = [good, "A" * 15 + "T" * 15, "TCGATCAGTAAAATCGTAGCTAGCATGTCA",
             "TCCACCTCCGTACGATGATCGTAGCATGTA"] + pool[:40]
    for s in cases:
        assert TL.filter_readout(s) == JL.filter_readout(s)
        assert TL.filter_readout(s, existing=[good], max_shared=10) == \
            JL.filter_readout(s, existing=[good], max_shared=10)
        assert TL.max_consecutive_run(s) == JL.max_consecutive_run(s)
        assert TL.has_repeated_kmer(s, 6) == JL.has_repeated_kmer(s, 6)
        assert TL.max_shared_run(s, pool[40:60]) == \
            JL.max_shared_run(s, pool[40:60])
        assert TL.nussinov_max_pairs(s) == JL.nussinov_max_pairs(s)
    assert TL.search_candidates(pool, total_cand=5, max_shared=12) == \
        JL.search_candidates(pool, total_cand=5, max_shared=12)
    genome_seq = _rand_seq(rng, 4000)
    reads = [genome_seq[100:130], pool[0], pool[1]]
    tt, tj = TL.KmerCountTable(word=12), JL.KmerCountTable(word=12)
    tt.consume(genome_seq)
    tj.consume(genome_seq)
    np.testing.assert_array_equal(
        TL.screen_readouts_by_genome(reads, tt, max_hits=0),
        JL.screen_readouts_by_genome(reads, tj, max_hits=0))
    stem = "GCGCGCGCGC"
    hairpin = stem + "TTTT" + JL.reverse_complement(stem)
    np.testing.assert_array_equal(
        TL.screen_readouts_by_structure([hairpin, "ACTGAT" * 5],
                                        max_pair_fraction=0.5),
        JL.screen_readouts_by_structure([hairpin, "ACTGAT" * 5],
                                        max_pair_fraction=0.5))
    reads = ["ACGTACGTAC", "TGCATGCATG", "GGATCCGGAT"]
    for n in (1, 2, 3):
        assert TL.split_readouts_into_channels(reads, num_channels=n) == \
            JL.split_readouts_into_channels(reads, num_channels=n)
    assert TL.generate_adaptors(reads[:2], ["TTTTT", "AAAAA"]) == \
        JL.generate_adaptors(reads[:2], ["TTTTT", "AAAAA"])


def _designer(lib, reports, gff, genome, tmp_path):
    genes = lib.read_gff3(gff)
    targets = {g: lib.extract_transcript_sequence(
        genome, next(iter(gene.transcripts.values())))
        for g, gene in genes.items()}
    genome_table = lib.KmerCountTable(17)
    genome_table.consume(genome["chr1"], count_rc=False)
    rep_table = lib.KmerCountTable(17)
    rep_table.consume("AT" * 40, count_rc=False)
    designer = reports.ProbeDesigner(
        targets,
        maps={"genome": reports.MapSpec(genome_table, two_stranded=True),
              "rep_genome": reports.MapSpec(rep_table, two_stranded=True)},
        pb_len=42, word_size=17, buffer_len=2,
        check_dic={"gc": (0.2, 0.8), "tm": 55.0,
                   "masks": list(reports.DEFAULT_MASKS),
                   ("genome", "self_sequences"): 10, "rep_genome": 0})
    cands = designer.compute_reports()
    kept = designer.check_probes()
    by_region = designer.kept_by_region()
    p = str(tmp_path / f"{lib.__name__}.pkl")
    designer.save(p)
    back = reports.ProbeDesigner.load(p)
    return cands, kept, by_region, back.kept_probes


def test_probe_designer_and_library_checks_match_jax(path, tmp_path):
    gff, genome = JT._designer_fixture(tmp_path)
    got = _designer(TL, TR, gff, genome, tmp_path)
    want = _designer(JL, JR, gff, genome, tmp_path)
    for a, b in zip(got, want):
        assert a == b
    assert len(got[0]) > 500 and len(got[2]["GA"]) >= 6
    kept, by_region = got[1], got[2]

    rng = np.random.default_rng(11)
    prim = [_rand_seq(rng, 20) for _ in range(60)]
    readouts = {"u": [_rand_seq(rng, 20) for _ in range(4)]}
    region_to_readouts = {"GA": readouts["u"][:3], "GB": readouts["u"][1:4]}
    lib_seqs = list(kept) + readouts["u"]
    kw = dict(word=12, gc_range=(0.25, 0.75), tm_range=(40.0, 100.0))
    fwd, rev = TR.select_primer_pair(prim[:30], prim[30:], lib_seqs, **kw)
    assert (fwd, rev) == JR.select_primer_pair(prim[:30], prim[30:],
                                               lib_seqs, **kw)
    oligos, regions = [], []
    for region, pbs in by_region.items():
        for pb in pbs:
            oligos.append(fwd + "".join(region_to_readouts[region]) + pb
                          + JL.reverse_complement(rev))
            regions.append(region)
    for olis in (oligos, ["X" * 20 + oligos[0][20:]] + oligos[1:]):
        args = (olis, regions, fwd, rev, readouts, region_to_readouts)
        ckw = dict(primer_len=20, readout_len=20, target_len=42,
                   n_readouts=3, min_region_size=6)
        assert TR.check_library(*args, **ckw) == \
            JR.check_library(*args, **ckw)
    for o in oligos[:5]:
        assert TR.parse_probe_sequence(o) == JR.parse_probe_sequence(o)


def test_encoding_matches_jax(tmp_path):
    for bits in ([[0, 2], [1, 3], [0, 3]], [], [[5], [0, 1, 2]]):
        np.testing.assert_array_equal(TL.convert_bits_to_matrix(bits),
                                      JL.convert_bits_to_matrix(bits))
    placed = [[0, 2], [1, 3], [4, 5]]
    for bits, loc in (([1, 9], 1), ([8, 9], 1), ([0], 0), ([4, 2], 2)):
        assert TL.calculate_closest_overlap(placed, bits, loc) == \
            JL.calculate_closest_overlap(placed, bits, loc)
    assert TL.calculate_closest_overlap([], [0], 0) == float("inf")
    with pytest.raises(ValueError):
        TL.calculate_closest_overlap(placed, [0], 7)
    for lib in (TL, JL):
        p = str(tmp_path / f"{lib.__name__}.fasta")
        lib.write_fasta(p, {"a": "ACGTACGT", "b": "GGCC"}, width=4)
        lib.write_fasta(p, [("c", "TTTT")], append=True)
    assert (tmp_path / f"{TL.__name__}.fasta").read_bytes() == \
        (tmp_path / f"{JL.__name__}.fasta").read_bytes()


def test_native_build_is_private_and_refuses_a_foreign_library(
        tmp_path, monkeypatch):
    """The port's seqint builds into its own hashed build directory (0700,
    not JAX's mtime-keyed cache); a library that others can write is
    refused, and then the NumPy path serves with the same values."""
    path = _build.native_library_path("seqint", tseq._SRC, tseq.GXX_FLAGS)
    assert TL.native_available() and path.exists()
    assert "torch_kernels" in str(path) or \
        "imageanalysis3_tpu_torch" in str(path)
    assert os.stat(path.parent).st_mode & 0o077 == 0
    assert os.stat(path).st_mode & 0o022 == 0

    monkeypatch.setattr(_build, "_build_root", lambda: tmp_path)
    monkeypatch.setattr(tseq, "_lib", None)
    monkeypatch.setattr(tseq, "_lib_tried", False)
    assert TL.native_available()                   # builds under tmp_path
    mine = _build.native_library_path("seqint", tseq._SRC, tseq.GXX_FLAGS)
    assert str(mine).startswith(str(tmp_path))
    os.chmod(mine, 0o777)
    with pytest.raises(PermissionError):
        _build.load_native_library("seqint", tseq._SRC, tseq.GXX_FLAGS)
    monkeypatch.setattr(tseq, "_lib", None)
    monkeypatch.setattr(tseq, "_lib_tried", False)
    assert not TL.native_available()
    fw, rc = TL.seq_to_kmer_ints("ACGTTGCAAC", 4)
    want = JL.seq_to_kmer_ints("ACGTTGCAAC", 4)
    np.testing.assert_array_equal(fw, want[0])
    np.testing.assert_array_equal(rc, want[1])
