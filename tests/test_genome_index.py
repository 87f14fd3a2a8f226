"""Genome packer and k-mer index tests (on a seeded synthetic genome)."""

import numpy as np
import pytest

from bbmap_tpu.core.genome import (END_PADDING, MID_PADDING, START_PADDING,
                                   build_genome)
from bbmap_tpu.index.build import (build_index, reverse_complement_key,
                                   rolling_keys)

@pytest.fixture(scope="module")
def phix(synth_fasta):
    return build_genome(synth_fasta[0])


def test_phix_packing(phix, synth_fasta):
    seq = synth_fasta[1]
    n = len(seq)
    assert phix.n_chroms == 1
    assert len(phix.scaffolds) == 1
    s = phix.scaffolds[0]
    assert s.length == n
    assert s.start == START_PADDING
    arr = phix.chroms[0]
    # leading pad
    assert bool((arr[:START_PADDING] == ord("N")).all())
    # trailing pad: END_PADDING+1 Ns (reference while-loop semantics)
    assert len(arr) == START_PADDING + n + END_PADDING + 1
    assert bool((arr[START_PADDING + n:] == ord("N")).all())
    # the packed body is the FASTA's sequence, line breaks removed
    assert bytes(arr[START_PADDING:START_PADDING + n]) == seq


def test_locate(phix, synth_fasta):
    scaf, off = phix.locate(1, START_PADDING + 100)
    assert synth_fasta[2] in scaf.name
    assert off == 100


def test_multi_scaffold(tmp_path):
    fa = tmp_path / "two.fa"
    fa.write_text(">s1\nACGTACGTAC\n>s2 with description\nGGGGCCCC\n")
    g = build_genome(str(fa))
    assert len(g.scaffolds) == 2
    s1, s2 = g.scaffolds
    assert s1.start == START_PADDING
    assert s2.start == START_PADDING + 10 + MID_PADDING
    assert s2.name == "s2 with description"
    scaf, off = g.locate(1, s2.start + 3)
    assert scaf.sid == 2 and off == 3


def test_rolling_keys():
    from bbmap_tpu.core.bases import to_codes
    seq = np.frombuffer(b"ACGTN", np.uint8)
    keys, valid = rolling_keys(to_codes(seq), 2)
    # AC=0b0001=1, CG=0b0110=6, GT=0b1011=11, TN invalid
    assert list(keys[valid]) == [1, 6, 11]
    assert list(valid) == [True, True, True, False]


def test_rc_key():
    # rc(ACG) = CGT : ACG=000110 -> CGT=011011
    assert int(reverse_complement_key(np.array([0b000110]), 3)[0]) \
        == 0b011011
    # involution
    keys = np.arange(4 ** 5)
    assert np.array_equal(
        reverse_complement_key(reverse_complement_key(keys, 5), 5), keys)


def test_index_lookup(phix):
    idx = build_index(phix, 13)
    # every stored site must reproduce its key
    g = idx.genome_codes
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 4 ** 13, size=200)
    for key in keys:
        for site in idx.get_sites(int(key)):
            kk = 0
            for j in range(13):
                kk = (kk << 2) | int(g[site + j])
            assert kk == key
    # total sites = defined 13-mers
    _, valid = rolling_keys(g, 13)
    assert len(idx.sites) == int(valid.sum())


def test_usemodulo_index(phix):
    """usemodulo keeps only keys with key%9==0 or rc(key)%9==0, ~2/9 of
    sites (reference: align2/IndexMaker4.java:335,522-523); mapping
    against a modulo index still works (reduced sensitivity)."""
    g = phix
    full = build_index(g, k=13)
    mod = build_index(g, k=13, usemodulo=True)
    assert len(mod.sites) < len(full.sites)
    # every surviving key satisfies the modulo condition
    lengths = np.diff(mod.starts)
    present = np.nonzero(lengths > 0)[0].astype(np.int64)
    rc = reverse_complement_key(present, 13)
    assert bool(((present % 9 == 0) | (rc % 9 == 0)).all())
    # keep rate is roughly 2/9
    rate = len(mod.sites) / max(1, len(full.sites))
    assert 0.1 < rate < 0.35
