"""Device overlap-scan parity: ops/overlap_device must reproduce the
host ladders bit for bit (the device BBMergeOverlapper). Runs on the
CPU backend; the same XLA runs on the GPU."""

import numpy as np
import pytest

from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.ops import overlap as ov
from bbmap_tpu.ops import overlap_device as od


def _pairs(rng, B, alen=150, blen=150, overlap_frac=0.7,
           err_rate=0.01):
    """Synthetic pairs: a fraction genuinely overlap at random inserts,
    the rest are unrelated."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(bases, size=(B, alen)).astype(np.uint8)
    b_rc = rng.choice(bases, size=(B, blen)).astype(np.uint8)
    inserts = rng.integers(60, alen + blen - 20, size=B)
    for i in range(B):
        if rng.random() > overlap_frac:
            continue
        ins = int(inserts[i])
        frag = rng.choice(bases, size=max(ins, alen, blen))
        a[i] = frag[:alen]
        b_rc[i] = frag[max(0, ins - blen):max(0, ins - blen) + blen]
        errs = rng.random((blen,)) < err_rate
        b_rc[i, errs] = bases[rng.integers(0, 4, size=int(errs.sum()))]
    qa = rng.integers(2, 41, size=(B, alen)).astype(np.int8)
    qb = rng.integers(2, 41, size=(B, blen)).astype(np.int8)
    return a, qa, b_rc, qb


@pytest.mark.parametrize("seed", [1, 2])
def test_ratio_mode_parity(seed):
    rng = np.random.default_rng(seed)
    a, qa, b, qb = _pairs(rng, 64)
    host = ov.mate_by_overlap_ratio_batch(a, b)
    dev = od.mate_by_overlap_ratio_device(a, b)
    for h, d, name in zip(host, dev, ("insert", "bad", "ambig")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_ratio_mode_parity_uneven_lengths():
    rng = np.random.default_rng(5)
    a, qa, b, qb = _pairs(rng, 48, alen=150, blen=100)
    host = ov.mate_by_overlap_ratio_batch(a, b)
    dev = od.mate_by_overlap_ratio_device(a, b)
    for h, d, name in zip(host, dev, ("insert", "bad", "ambig")):
        np.testing.assert_array_equal(d, h, err_msg=name)


@pytest.mark.parametrize("with_q", [True, False])
def test_mismatch_mode_parity(with_q):
    rng = np.random.default_rng(9)
    a, qa, b, qb = _pairs(rng, 64)
    args = (a, qa if with_q else None, b, qb if with_q else None)
    host = ov.mate_by_overlap_batch(*args)
    dev = od.mate_by_overlap_device(*args)
    for h, d, name in zip(host, dev, ("insert", "bad", "ambig")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_route_through_public_entry(monkeypatch):
    """The public entry routes big batches to the device kernel and the
    merge decisions are identical either way."""
    rng = np.random.default_rng(3)
    a, qa, b, qb = _pairs(rng, 600)
    monkeypatch.setenv("BBMAP_DEVICE_OVERLAP", "0")
    host = ov.mate_by_overlap_ratio_batch(a, b)
    monkeypatch.setenv("BBMAP_DEVICE_OVERLAP", "1")
    dev = ov.mate_by_overlap_ratio_batch(a, b)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(d, h)


def test_bbmerge_e2e_identical(tmp_path, monkeypatch):
    """bbmerge end-to-end: identical merged output with the device
    kernel forced on vs off."""
    from bbmap_tpu.tools import bbmerge

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    n = 600
    with open(tmp_path / "r1.fq", "w") as f1, \
            open(tmp_path / "r2.fq", "w") as f2:
        for i in range(n):
            ins = int(rng.integers(180, 260))
            frag = rng.choice(bases, size=ins)
            r1 = frag[:150]
            r2 = frag[ins - 150:][::-1].copy()
            r2 = COMP_ASCII[r2]
            q1 = "".join(chr(33 + int(q)) for q in
                         rng.integers(25, 40, 150))
            q2 = "".join(chr(33 + int(q)) for q in
                         rng.integers(25, 40, 150))
            f1.write(f"@p{i}/1\n{bytes(r1).decode()}\n+\n{q1}\n")
            f2.write(f"@p{i}/2\n{bytes(r2).decode()}\n+\n{q2}\n")

    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("BBMAP_DEVICE_OVERLAP", mode)
        out = tmp_path / f"m{mode}.fq"
        rc = bbmerge.main([f"in1={tmp_path/'r1.fq'}",
                           f"in2={tmp_path/'r2.fq'}",
                           f"out={out}"])
        assert rc == 0
        outs[mode] = out.read_text()
    assert outs["0"] == outs["1"]
    assert outs["1"].count("@p") > n * 0.8
