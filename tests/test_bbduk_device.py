"""Device k-mer scan parity: kmerset_device must reproduce the host
scan_batch bit for bit (the device BBDuk scan).

Runs on the CPU backend (tests/conftest.py) with BBMAP_DEVICE_KMERS
forced on; the program is the same XLA on the GPU."""

import os

import numpy as np
import pytest

from bbmap_tpu.index import kmerset
from bbmap_tpu.index.kmerset_device import DeviceKmerSet


def _random_seqs(rng, n, lo, hi):
    bases = np.frombuffer(b"ACGT", np.uint8)
    return [bytes(rng.choice(bases, rng.integers(lo, hi)))
            for _ in range(n)]


def _reads_with_hits(rng, seqs, n_reads, L, embed_frac=0.5):
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = rng.choice(bases, size=(n_reads, L)).astype(np.uint8)
    for i in range(n_reads):
        if rng.random() < embed_frac:
            s = seqs[int(rng.integers(0, len(seqs)))]
            seg = np.frombuffer(s, np.uint8)
            ln = min(len(seg), L - 2)
            at = int(rng.integers(0, L - ln + 1))
            reads[i, at:at + ln] = seg[:ln]
    # sprinkle Ns
    nn = rng.random((n_reads, L)) < 0.01
    reads[nn] = ord("N")
    return reads


@pytest.mark.parametrize("k,mask_middle,rcomp,hdist", [
    (27, True, True, 0),
    (23, True, True, 1),
    (31, False, True, 0),
    (13, True, False, 0),
    (8, True, True, 0),
])
def test_device_scan_parity(k, mask_middle, rcomp, hdist):
    rng = np.random.default_rng(42 + k)
    seqs = _random_seqs(rng, 5, k + 5, 80)
    ks = kmerset.build_kmer_set(seqs, k=k, hdist=hdist,
                                mask_middle=mask_middle, rcomp=rcomp)
    reads = _reads_with_hits(rng, seqs, 64, 101)
    kmers, valid = kmerset.rolling_kmers_batch(reads, k)
    vals = ks.to_values(kmers, k)
    host_ids = ks.lookup_ids(vals)
    host_ids[~valid] = -1

    dks = DeviceKmerSet(ks)
    dev_ids = dks.scan_ids(reads)
    assert dev_ids.shape == host_ids.shape
    np.testing.assert_array_equal(dev_ids, host_ids)


def test_scan_batch_routes_device(monkeypatch):
    """scan_batch uses the device scanner when forced on and matches."""
    rng = np.random.default_rng(7)
    seqs = _random_seqs(rng, 4, 40, 90)
    ks = kmerset.build_kmer_set(seqs, k=23, hdist=0)
    reads = _reads_with_hits(rng, seqs, 64, 120)

    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "0")
    h_hits, h_ids = kmerset.scan_batch(ks, reads)
    if hasattr(ks, "_device_set"):
        del ks._device_set
    monkeypatch.setenv("BBMAP_DEVICE_KMERS", "1")
    d_hits, d_ids = kmerset.scan_batch(ks, reads)
    np.testing.assert_array_equal(d_ids, h_ids)
    np.testing.assert_array_equal(d_hits, h_hits)


def test_device_scan_empty_and_small():
    ks = kmerset.build_kmer_set([], k=27)
    reads = np.full((4, 50), ord("A"), np.uint8)
    os.environ["BBMAP_DEVICE_KMERS"] = "1"
    try:
        assert __import__(
            "bbmap_tpu.index.kmerset_device",
            fromlist=["device_scan_batch"]).device_scan_batch(
                ks, reads) is None
    finally:
        del os.environ["BBMAP_DEVICE_KMERS"]


def test_bbduk_outputs_identical_with_device_scan(tmp_path,
                                                  monkeypatch):
    """End-to-end: bbduk ktrim/filter outputs are identical with the
    device scan forced on vs off (the VERDICT r2 'identical outputs on
    the tests/test_bbduk.py corpus' criterion)."""
    from bbmap_tpu.tools import bbduk

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    adapter = bytes(rng.choice(bases, 34))
    ref = tmp_path / "adapters.fa"
    ref.write_text(f">ad1\n{adapter.decode()}\n")
    reads = []
    for i in range(300):
        body = bytes(rng.choice(bases, 150))
        if i % 3 == 0:
            at = int(rng.integers(60, 110))
            body = body[:at] + adapter + body[at + 34:]
            body = body[:150]
        reads.append(body)
    fq = tmp_path / "in.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")

    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("BBMAP_DEVICE_KMERS", mode)
        out = tmp_path / f"out{mode}.fq"
        stats = tmp_path / f"stats{mode}.txt"
        rc = bbduk.main([f"in={fq}", f"out={out}", f"ref={ref}",
                         "k=23", "ktrim=r", "mink=11", "hdist=1",
                         f"stats={stats}"])
        assert rc == 0
        outs[mode] = out.read_text()
    assert outs["0"] == outs["1"]
