"""End-to-end mapping tests: synthetic reads from a seeded phage-sized
genome through the full pipeline (SURVEY.md §4: synthetic-truth grading is the reference's test
harness)."""

import numpy as np
import pytest

from bbmap_tpu.align.pipeline import BBMapAligner, emit_sam
from bbmap_tpu.core import constants as K
from bbmap_tpu.core.batch import ReadBatch
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.core.genome import START_PADDING, build_genome
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu.io.fastx import SeqRecord

@pytest.fixture(scope="module")
def aligner(synth_fasta):
    g = build_genome(synth_fasta[0])
    idx = build_index(g, 13)
    analyze_index(idx, 0.0)
    return BBMapAligner(g, idx)


def _mkread(genome, start, length, strand=0, subs=(), rid="r"):
    arr = genome.chroms[0][START_PADDING + start:
                           START_PADDING + start + length].copy()
    for pos in subs:
        b = arr[pos]
        arr[pos] = {ord("A"): ord("C"), ord("C"): ord("G"),
                    ord("G"): ord("T"), ord("T"): ord("A")}[b]
    if strand == 1:
        arr = COMP_ASCII[arr][::-1]
    return SeqRecord(rid, bytes(arr), b"I" * length)


def test_exact_reads_map(aligner):
    g = aligner.genome
    recs = [_mkread(g, s, 100, rid=f"r{s}") for s in (0, 500, 1000, 3000)]
    batch = ReadBatch.from_records(recs)
    res = aligner.map_batch(batch)
    for r, start in zip(res, (0, 500, 1000, 3000)):
        assert r.mapped
        assert r.strand == 0
        assert r.start - START_PADDING == start
        assert r.perfect
        assert r.score == K.max_quality(100)
        assert r.match == b"m" * 100


def test_minus_strand(aligner):
    g = aligner.genome
    recs = [_mkread(g, 700, 100, strand=1)]
    res = aligner.map_batch(ReadBatch.from_records(recs))
    assert res[0].mapped and res[0].strand == 1
    assert res[0].start - START_PADDING == 700
    assert res[0].perfect


def test_substitutions(aligner):
    g = aligner.genome
    recs = [_mkread(g, 1200, 100, subs=(30, 60))]
    res = aligner.map_batch(ReadBatch.from_records(recs))
    r = res[0]
    assert r.mapped and not r.perfect
    assert r.start - START_PADDING == 1200
    assert r.match.count(b"S") == 2
    assert r.match.count(b"m") == 98


def test_deletion(aligner):
    g = aligner.genome
    # read skips 3 ref bases in the middle
    a = g.chroms[0][START_PADDING + 2000:START_PADDING + 2050]
    b = g.chroms[0][START_PADDING + 2053:START_PADDING + 2103]
    read = bytes(np.concatenate([a, b]))
    res = aligner.map_batch(ReadBatch.from_records(
        [SeqRecord("del", read, b"I" * 100)]))
    r = res[0]
    assert r.mapped
    assert r.start - START_PADDING == 2000
    assert b"DDD" in r.match
    assert r.stop - r.start == 102  # consumes 103 ref bases


def test_insertion(aligner):
    g = aligner.genome
    a = g.chroms[0][START_PADDING + 2500:START_PADDING + 2550]
    b = g.chroms[0][START_PADDING + 2550:START_PADDING + 2598]
    read = bytes(a) + b"AC" + bytes(b)
    res = aligner.map_batch(ReadBatch.from_records(
        [SeqRecord("ins", read, b"I" * 100)]))
    r = res[0]
    assert r.mapped
    assert r.start - START_PADDING == 2500
    assert r.match.count(b"I") == 2


def test_garbage_unmapped(aligner):
    rng = np.random.default_rng(3)
    read = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 100))
    res = aligner.map_batch(ReadBatch.from_records(
        [SeqRecord("junk", read, b"I" * 100)]))
    assert not res[0].mapped


def test_sam_emission(aligner):
    g = aligner.genome
    recs = [_mkread(g, 100, 100, rid="plus"),
            _mkread(g, 300, 100, strand=1, rid="minus")]
    batch = ReadBatch.from_records(recs)
    res = aligner.map_batch(batch)
    lines = emit_sam(g, batch, res)
    f1 = lines[0].split("\t")
    assert f1[0] == "plus" and f1[1] == "0"
    assert f1[3] == "101"
    assert f1[5] == "100="
    assert int(f1[4]) > 30
    assert "NM:i:0" in lines[0]
    f2 = lines[1].split("\t")
    assert f2[1] == "16" and f2[3] == "301"
    # minus-strand SEQ is the reverse complement = original genome fwd
    fwd = bytes(g.chroms[0][START_PADDING + 300:START_PADDING + 400])
    assert f2[9].encode() == fwd


def test_sam_paired(aligner):
    g = aligner.genome
    r1 = [_mkread(g, 1000, 100, rid="p/1")]
    r2 = [_mkread(g, 1200, 100, strand=1, rid="p/2")]
    b1 = ReadBatch.from_records(r1)
    b2 = ReadBatch.from_records(r2)
    res1 = aligner.map_batch(b1)
    res2 = aligner.map_batch(b2)
    lines = emit_sam(g, b1, res1, res2, b2)
    f1 = lines[0].split("\t")
    f2 = lines[1].split("\t")
    assert int(f1[1]) & 0x1 and int(f1[1]) & 0x2 and int(f1[1]) & 0x40
    assert int(f2[1]) & 0x80 and int(f2[1]) & 0x10
    assert f1[6] == "=" and f2[6] == "="
    assert f1[0] == "p" and f2[0] == "p"
    assert int(f1[8]) == 300 and int(f2[8]) == -300


def test_map_pairs_boost_and_flags(aligner):
    g = aligner.genome
    # r2's true site is ambiguous-ish alone but pairing should resolve flags
    r1 = [_mkread(g, 2000, 100, rid="q/1")]
    r2 = [_mkread(g, 2150, 100, strand=1, rid="q/2")]
    b1 = ReadBatch.from_records(r1)
    b2 = ReadBatch.from_records(r2)
    res1, res2 = aligner.map_pairs(b1, b2)
    assert res1[0].mapped and res2[0].mapped
    assert res1[0].paired and res2[0].paired
    assert res1[0].start - START_PADDING == 2000
    assert res2[0].start - START_PADDING == 2150
    # paired score boost raises mapScore above the single-end slow score
    from bbmap_tpu.core import constants as K
    assert res1[0].score > K.max_quality(100)


def test_mate_rescue(aligner):
    g = aligner.genome
    # r1 maps cleanly; r2 has so many errors its seeds all fail, but lies
    # at the expected innie position -> rescue should place it
    rng = np.random.default_rng(99)
    r1 = _mkread(g, 3200, 100, rid="resc/1")
    arr = g.chroms[0][START_PADDING + 3350:START_PADDING + 3450].copy()
    # heavy scattered errors kill every 13-mer seed
    for p in range(3, 100, 9):
        arr[p] = {ord("A"): ord("C"), ord("C"): ord("G"),
                  ord("G"): ord("T"), ord("T"): ord("A")}[arr[p]]
    arr = COMP_ASCII[arr][::-1]
    r2 = SeqRecord("resc/2", bytes(arr), b"I" * 100)
    b1 = ReadBatch.from_records([r1])
    b2 = ReadBatch.from_records([r2])
    res1, res2 = aligner.map_pairs(b1, b2)
    assert res1[0].mapped
    assert res2[0].mapped, "mate should be rescued"
    assert res2[0].start - START_PADDING == 3350
    assert res2[0].strand == 1


def test_long_deletion_gap_compressed(aligner):
    g = aligner.genome
    # read spans a 2000 bp deletion: first 60 bases at 500, last 60 at 2560
    a = g.chroms[0][START_PADDING + 500:START_PADDING + 560]
    b = g.chroms[0][START_PADDING + 2560:START_PADDING + 2620]
    read = bytes(np.concatenate([a, b]))
    res = aligner.map_batch(ReadBatch.from_records(
        [SeqRecord("longdel", read, b"I" * 120)]))
    r = res[0]
    assert r.mapped, "long-deletion read should map via gap compression"
    assert r.start - START_PADDING == 500
    assert r.stop - START_PADDING == 2619
    assert r.match.count(b"D") == 2000
    assert r.match.count(b"m") == 120


def test_100kbp_deletion_gap_compressed(tmp_path):
    """Reference envelope claim: 100 kbp+ deletions map exactly via
    gap compression (reference: makeGref GAPLEN blocks,
    MultiStateAligner11ts.java:1412; BASELINE.md sensitivity row)."""
    import numpy as np
    from bbmap_tpu.core.genome import build_genome
    from bbmap_tpu.index.build import build_index
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu.align.pipeline import BBMapAligner
    from bbmap_tpu.io.fastx import SeqRecord

    rng = np.random.default_rng(20)
    g = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 220_000))
    fa = tmp_path / "big.fa"
    fa.write_bytes(b">s1\n" + g + b"\n")
    genome = build_genome(str(fa))
    index = build_index(genome, k=13)
    al = BBMapAligner(genome, index, device_quickmap=False,
                      maxindel=150_000)
    DEL, s = 100_000, 30_000
    read = g[s:s + 60] + g[s + 60 + DEL:s + 120 + DEL]
    batch = ReadBatch.from_records([SeqRecord("r", read, b"I" * 120,
                                              0)])
    r = al.map_batch(batch)[0]
    assert r.mapped
    scaf, loc = genome.locate(r.chrom, r.start)
    assert loc == s
    assert r.match.count(ord("D")) == DEL


@pytest.mark.slow
def test_pacbio_error_model_reads_map(tmp_path):
    """randomreads pacbio=t produces indel-dominated long reads
    (reference: RandomReads3 PacBio profile); most map back correctly
    at 12% error even with the short-read stack."""
    import numpy as np
    from bbmap_tpu.tools import randomreads
    from bbmap_tpu.io import fastx
    from bbmap_tpu.core.genome import build_genome
    from bbmap_tpu.index.build import build_index
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu.align.pipeline import BBMapAligner

    rng = np.random.default_rng(30)
    g = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 50_000))
    ref = tmp_path / "ref.fa"
    ref.write_bytes(b">s1\n" + g + b"\n")
    fq = tmp_path / "pb.fq"
    assert randomreads.main([f"ref={ref}", f"out={fq}", "reads=10",
                             "pacbio=t", "pbmin=300", "pbmax=450",
                             "pberror=0.12", "seed=7"]) == 0
    genome = build_genome(str(ref))
    index = build_index(genome, k=12)
    al = BBMapAligner(genome, index, min_ratio=0.46,
                      device_quickmap=False)
    recs = list(fastx.read_seqs(str(fq)))
    assert len(recs) == 10
    correct = 0
    for r in recs:
        res = al.map_batch(ReadBatch.from_records([r]))[0]
        if not res.mapped:
            continue
        rel = int(r.id.split("_")[5])  # scaffold-relative truth
        scaf, loc = genome.locate(res.chrom, res.start)
        if abs(loc - rel) <= 50:
            correct += 1
    assert correct >= 6, correct
