"""Property tests: JAX wavefront DP must be bit-identical to the NumPy
oracle of the reference aligner (SURVEY.md §7 'Exact streak-dependent
scoring ... property tests vs a NumPy oracle of fillUnlimited')."""

import numpy as np
import pytest

from bbmap_tpu.core import constants as K
from bbmap_tpu.ops import msa_jax, msa_ref

BASES = np.frombuffer(b"ACGT", np.uint8)


def make_case(rng, rlen, clen, nsubs=0, nins=0, ndels=0, n_n=0, offset=None):
    """Plant a read inside a ref window with controlled mutations."""
    ref = rng.choice(BASES, size=clen).astype(np.uint8)
    if offset is None:
        offset = int(rng.integers(0, max(1, clen - rlen)))
    read = ref[offset:offset + rlen].copy()
    if len(read) < rlen:
        read = np.concatenate(
            [read, rng.choice(BASES, size=rlen - len(read)).astype(np.uint8)])
    for _ in range(nsubs):
        i = int(rng.integers(0, rlen))
        read[i] = BASES[(int(np.searchsorted(BASES, read[i])) + 1) % 4]
    for _ in range(nins):
        i = int(rng.integers(1, rlen - 1))
        read = np.concatenate(
            [read[:i], rng.choice(BASES, size=1).astype(np.uint8),
             read[i:-1]])
    for _ in range(ndels):
        i = int(rng.integers(1, rlen - 1))
        read = np.concatenate([read[:i], read[i + 1:],
                               rng.choice(BASES, size=1).astype(np.uint8)])
    for _ in range(n_n):
        read[int(rng.integers(0, rlen))] = ord("N")
    return read[:rlen], ref


CASES = [
    dict(rlen=20, clen=40),
    dict(rlen=20, clen=40, nsubs=2),
    dict(rlen=30, clen=50, nins=1),
    dict(rlen=30, clen=50, ndels=2),
    dict(rlen=30, clen=64, nsubs=3, nins=1, ndels=1),
    dict(rlen=25, clen=45, n_n=2),
    dict(rlen=40, clen=40),           # square
    dict(rlen=16, clen=90, nsubs=1),  # wide window
]


@pytest.mark.parametrize("case", CASES)
def test_score_matches_oracle(rng, case):
    read, ref = make_case(rng, **case)
    _, (rows, ocol, ostate, oscore) = msa_ref.fill_unlimited(read, ref)
    score, col, state = (
        np.asarray(x) for x in msa_jax.msa_score_single(
            read, ref, len(read), len(ref)))
    assert int(score) == oscore
    assert int(col) == ocol
    assert int(state) == ostate


@pytest.mark.parametrize("case", CASES[:5])
def test_full_waves_match_oracle(rng, case):
    read, ref = make_case(rng, **case)
    R, C = len(read), len(ref)
    opacked, (rows, ocol, ostate, oscore) = msa_ref.fill_unlimited(read, ref)
    waves, score, col, state = msa_jax.msa_full_single(read, ref, R, C)
    jpacked = msa_jax.waves_to_packed(np.asarray(waves), R, C)
    assert np.array_equal(jpacked[:, 1:, 1:], opacked[:, 1:, 1:])
    # traceback over the jax-produced matrices must equal oracle traceback
    m_o = msa_ref.traceback(read, ref, opacked, rows, ocol, ostate)
    m_j = msa_ref.traceback(read, ref, jpacked, R, int(col), int(state))
    assert m_o == m_j


def test_batch_matches_single(rng):
    R, C, B = 24, 48, 8
    reads = np.stack([make_case(rng, R, C, nsubs=i % 3)[0]
                      for i in range(B)])
    refs = np.stack([make_case(rng, R, C)[1] for _ in range(B)])
    s_b, c_b, st_b = (np.asarray(x) for x in
                      msa_jax.msa_score_batch(reads, refs, R, C))
    for i in range(B):
        s, c, st = msa_jax.msa_score_single(reads[i], refs[i], R, C)
        assert int(s) == s_b[i] and int(c) == c_b[i] and int(st) == st_b[i]


def test_perfect_read_score():
    rng = np.random.default_rng(7)
    read, ref = make_case(rng, 30, 60, offset=10)
    score, col, state = msa_jax.msa_score_single(read, ref, 30, 60)
    assert int(score) == K.max_quality(30)
    assert int(state) == K.MODE_MS


def test_constants():
    assert K.TIMEMASK == 0x7FF
    assert K.POINTS_MATCH == 70 and K.POINTS_MATCH2 == 100
    assert K.POINTS_INS_ARRAY[1] == -395
    assert K.POINTS_INS_ARRAY[2] == -39
    assert K.POINTS_INS_ARRAY[6] == -23
    assert K.POINTS_INS_ARRAY[21] == -8
    assert K.POINTS_SUB_ARRAY[1] == -127
    assert K.POINTS_SUB_ARRAY[2] == -51
    assert K.POINTS_SUB_ARRAY[6] == -25
    # identity->ratio spot value (reference default minratio 0.56 ~ 76% id)
    assert 0.55 < K.min_id_to_min_ratio(0.76) < 0.60


@pytest.mark.parametrize("case", CASES[:6])
def test_traceback_prevs_matches_oracle(rng, case):
    read, ref = make_case(rng, **case)
    R, C = len(read), len(ref)
    opacked, (rows, ocol, ostate, oscore) = msa_ref.fill_unlimited(read, ref)
    prevs, score, col, state = msa_jax.msa_trace_single(read, ref, R, C)
    assert int(score) == oscore and int(col) == ocol and int(state) == ostate
    m_o = msa_ref.traceback(read, ref, opacked, rows, ocol, ostate)
    m_p = msa_jax.traceback_prevs(read, ref, np.asarray(prevs),
                                  int(col), int(state))
    assert m_o == m_p


def test_variable_rows_matches_exact(rng):
    """Padded variable-row DP must equal exact-shape DP per read."""
    R_pad, C = 48, 80
    lens = [20, 33, 48, 41]
    reads = np.full((4, R_pad), ord("N"), np.uint8)
    refs = np.zeros((4, C), np.uint8)
    for i, L in enumerate(lens):
        rd, rf = make_case(rng, L, C, nsubs=i)
        reads[i, :L] = rd
        refs[i] = rf
    s, c, st = msa_jax.msa_score_batch_var(
        reads, refs, np.array(lens, np.int32), R_pad, C)
    for i, L in enumerate(lens):
        se, ce, ste = msa_jax.msa_score_single(reads[i, :L], refs[i], L, C)
        assert int(s[i]) == int(se)
        assert int(c[i]) == int(ce)
        assert int(st[i]) == int(ste)


def test_variable_rows_trace(rng):
    R_pad, C = 40, 64
    L = 29
    rd, rf = make_case(rng, L, C, nsubs=2, ndels=1)
    reads = np.full((2, R_pad), ord("N"), np.uint8)
    reads[0, :L] = rd
    reads[1, :L] = rd
    refs = np.stack([rf, rf])
    prevs, s, c, st = msa_jax.msa_trace_batch_var(
        reads, refs, np.array([L, L], np.int32), R_pad, C)
    m = msa_jax.traceback_prevs(rd, rf, np.asarray(prevs[0]),
                                int(c[0]), int(st[0]))
    pe, se, ce, ste = msa_jax.msa_trace_single(rd, rf, L, C)
    me = msa_jax.traceback_prevs(rd, rf, np.asarray(pe), int(ce), int(ste))
    assert m == me and int(s[0]) == int(se)
