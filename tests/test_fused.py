"""Fused single-dispatch path (align/fused_device.py) must reproduce
the unfused quickmap + host-escalation path field for field, including
budget-overflow and wide-window fallbacks."""

import numpy as np
import pytest

from bbmap_tpu.align import fused_device
from bbmap_tpu.align.pipeline import BBMapAligner
from bbmap_tpu.core.batch import ReadBatch
from bbmap_tpu.core.bases import COMP_ASCII
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    g0 = rng.choice(BASES, size=80_000).astype(np.uint8)
    # implant a repeat family so site lists vary
    unit = rng.choice(BASES, size=600).astype(np.uint8)
    for at in (5_000, 22_000, 47_000, 63_000):
        g0[at:at + 600] = unit
    g = Genome(chroms=[g0], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(g0),
                 name="c1")]).finalize()
    index = build_index(g, 11)
    analyze_index(index, 0.01)
    return g, index


def make_reads(setup, n, L=100, seed=7, with_quality=False):
    g, index = setup
    gc = index.genome_codes
    A = np.frombuffer(b"ACGTN", np.uint8)
    rng = np.random.default_rng(seed)
    ok = np.lib.stride_tricks.sliding_window_view(gc < 4, L + 12).all(
        axis=1)
    starts = rng.choice(np.nonzero(ok)[0], size=n)
    reads = np.stack([A[np.minimum(gc[s:s + L + 12], 4)]
                      for s in starts])[:, :L + 12]
    out = reads[:, :L].copy()
    r = rng.random(n)
    for i in np.nonzero((r >= 0.5) & (r < 0.75))[0]:   # subs
        for _ in range(int(rng.integers(1, 4))):
            out[i, int(rng.integers(0, L))] = BASES[int(
                rng.integers(0, 4))]
    for i in np.nonzero((r >= 0.75) & (r < 0.88))[0]:  # deletions
        d = int(rng.integers(1, 9))
        p = int(rng.integers(10, L - 10))
        w = reads[i]
        out[i] = np.concatenate([w[:p], w[p + d:p + d + (L - p)]])
    for i in np.nonzero(r >= 0.88)[0]:                 # insertions
        d = int(rng.integers(1, 9))
        p = int(rng.integers(10, L - 10))
        ins = BASES[rng.integers(0, 4, size=d)]
        out[i] = np.concatenate([out[i, :p], ins, out[i, p:L - d]])
    flip = rng.random(n) < 0.5
    out[flip] = COMP_ASCII[out[flip]][:, ::-1]
    qual = None
    if with_quality:
        qual = rng.integers(10, 40, size=(n, L)).astype(np.int8)
        # some low-quality stretches to engage makeOffsets3
        qual[::5, :12] = 4
    return ReadBatch(bases=out, quality=qual,
                     lengths=np.full(n, L, np.int32),
                     ids=[str(i) for i in range(n)],
                     numeric_ids=np.arange(n, dtype=np.int64))


def assert_mb_equal(a, b):
    for f in ("mapped", "strand", "chrom", "start", "stop", "score",
              "perfect", "ambiguous", "n_sites"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for i in range(a.size):
        if a.mapped[i]:
            assert a.match(i) == b.match(i), i


def _pair(setup, **kw):
    g, index = setup
    fused = BBMapAligner(g, index, **kw)
    unfused = BBMapAligner(g, index, **kw)
    unfused._use_fused = lambda L=None: False
    return fused, unfused


def test_fused_parity(setup):
    fused, unfused = _pair(setup)
    batch = make_reads(setup, 192)
    mf = fused.map_batch_columnar(batch)
    mu = unfused.map_batch_columnar(batch)
    assert mf is not None and mu is not None
    assert mf.mapped.sum() > 150
    # traced (indel) reads must exist for this test to mean anything
    assert len(mf.match_override) > 5
    assert_mb_equal(mf, mu)


def test_fused_parity_quality(setup):
    fused, unfused = _pair(setup)
    batch = make_reads(setup, 96, with_quality=True, seed=13)
    mf = fused.map_batch_columnar(batch)
    mu = unfused.map_batch_columnar(batch)
    assert_mb_equal(mf, mu)


def test_fused_budget_overflow_fallback(setup, monkeypatch):
    """Tiny budgets force the overflow fallback; results must still
    match the unfused path exactly."""
    monkeypatch.setattr(fused_device, "esc_budget", lambda B: 8)
    monkeypatch.setattr(fused_device, "trace_budget", lambda B: 4)
    fused, unfused = _pair(setup)
    batch = make_reads(setup, 160, seed=3)
    mf = fused.map_batch_columnar(batch)
    mu = unfused.map_batch_columnar(batch)
    assert_mb_equal(mf, mu)


def _repeat_reads(setup, n, L=100, seed=19):
    """Reads drawn from inside the implanted repeat unit so every key
    has ~4 sites (admitted totals > the LO slot tier) — forces the
    two-tier hi gather."""
    g, index = setup
    gc = index.genome_codes
    A = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    copies = (5_000, 22_000, 47_000, 63_000)  # raw positions (pre-built
    #                                           chroms get no start pad)
    starts = np.array([copies[rng.integers(0, 4)]
                       + rng.integers(0, 600 - L) for _ in range(n)])
    reads = np.stack([A[np.minimum(gc[s:s + L], 3)] for s in starts])
    flip = rng.random(n) < 0.5
    reads[flip] = COMP_ASCII[reads[flip]][:, ::-1]
    return ReadBatch(bases=reads, quality=None,
                     lengths=np.full(n, L, np.int32),
                     ids=[str(i) for i in range(n)],
                     numeric_ids=np.arange(n, dtype=np.int64))


def test_fused_hi_budget_overflow_single(setup, monkeypatch):
    """Two-tier slot-gather overflow (ADVICE r4 medium: the HB budget
    was untestable inline): with hi_budget forced tiny, repeat-heavy
    rows are truncated in-device, flagged hi_over, and exactly refit on
    the host — parity with the unfused path must hold, including the
    match strings (ADVICE r4 high: stale deferred match_fill lambdas
    must not overwrite the refit rows). Tier admission
    (BBMAP_REF_ADMIT=0): the canonical-count budget packing of the
    ref-admit path caps local slot sums at LO, so the hi tier is live
    on the per-strand tier-admission config."""
    from bbmap_tpu.align import quickmap_device as qd
    monkeypatch.setenv("BBMAP_REF_ADMIT", "0")
    monkeypatch.setattr(qd, "hi_budget", lambda R2: 8)
    fused, unfused = _pair(setup)
    batch = _repeat_reads(setup, 96)
    f = fused._fused_dispatch(batch, 100)
    d = f.host()
    assert d["hi_over"].sum() > 20, "overflow path never engaged"
    mf = fused._columnar_from_fused(batch, 100, d)
    mu = unfused.map_batch_columnar(batch)
    assert mf.mapped.sum() > 80
    assert_mb_equal(mf, mu)


def test_fused_hi_budget_overflow_paired(setup, monkeypatch):
    """Paired two-tier overflow: truncated rows re-fit exactly by PAIR
    (the mate's boost saw the truncated table) — tiny-budget output must
    equal the default-budget output field for field."""
    from bbmap_tpu.align import quickmap_device as qd
    g, index = setup
    gc = index.genome_codes
    A = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(29)
    L, B, insert = 100, 64, 180
    copies = (5_000, 22_000, 47_000, 63_000)
    starts = np.array([copies[rng.integers(0, 4)]
                       + rng.integers(0, 600 - insert)
                       for _ in range(B)])
    r1 = np.stack([A[np.minimum(gc[s:s + L], 3)] for s in starts])
    r2f = np.stack([A[np.minimum(gc[s + insert - L:s + insert], 3)]
                    for s in starts])
    r2 = COMP_ASCII[r2f][:, ::-1].copy()

    def mk(rows):
        return ReadBatch(bases=rows.copy(), quality=None,
                         lengths=np.full(B, L, np.int32),
                         ids=[str(i) for i in range(B)],
                         numeric_ids=np.arange(B, dtype=np.int64))

    monkeypatch.setenv("BBMAP_REF_ADMIT", "0")
    al_def = BBMapAligner(*setup)
    out_def = al_def.map_pairs_columnar(mk(r1), mk(r2))
    monkeypatch.setattr(qd, "hi_budget", lambda R2: 8)
    al_tiny = BBMapAligner(*setup)
    f = al_tiny._fused_pair_dispatch(mk(r1), mk(r2), L)
    d = f.host()
    assert d["hi_over"].sum() > 20, "overflow path never engaged"
    out_tiny = al_tiny._columnar_pair_from_fused(mk(r1), mk(r2), L, d)
    assert out_def is not None and out_tiny is not None
    for a, b in zip(out_tiny, out_def):
        assert_mb_equal(a, b)
    assert out_def[0].mapped.sum() > 50


@pytest.mark.slow
def test_fused_map_stream(setup):
    fused, unfused = _pair(setup)
    batches = [make_reads(setup, 64, seed=s) for s in (21, 22, 23)]
    outs = list(fused.map_stream(iter(batches)))
    for b, mf in zip(batches, outs):
        mu = unfused.map_batch_columnar(b)
        assert_mb_equal(mf, mu)


def test_pack_roundtrip():
    rng = np.random.default_rng(0)
    A = np.frombuffer(b"ACGTN", np.uint8)
    bases = A[rng.integers(0, 5, size=(37, 101))]
    codes2, nmask = fused_device.pack_reads_host(bases)
    got = np.asarray(fused_device.unpack_reads_device(codes2, nmask, 101))
    want = fused_device._B2C[bases]
    assert np.array_equal(got, np.minimum(want, 4))
