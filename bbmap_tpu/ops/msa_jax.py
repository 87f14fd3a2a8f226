"""XLA wavefront implementation of the multi-state banded affine DP.

Same scoring semantics as the NumPy oracle (ops/msa_ref.py; reference:
align2/MultiStateAligner11ts.java:623-866) but reformulated as vector
work: the DP is swept along anti-diagonals, so every cell on a wave
depends only on the two previous waves and the whole wave is one vector op.
The per-cell packed int32 ``score << 11 | streak`` encoding is preserved
exactly, so scores are bit-identical to the reference.

Layout: wave ``d`` holds cells (r, c=d-r) for r in [0, R], kept as three
int32 vectors indexed by r. Dependencies:

  MS(r, c)  <- wave d-2, r-1   (diagonal)
  DEL(r, c) <- wave d-1, r     (left)
  INS(r, c) <- wave d-1, r-1   (up)

Boundary: row 0 is score 0 (free ref start); col 0 (r == d) carries the
cumulative insertion penalty (reference ctor :84-112).

Three drivers share the wave step:
- ``msa_score_*``  — score-only; the scan carries a per-state running
  last-row maximum, so nothing but (score, col, state) leaves the device
  (the fillLimited analog).
- ``msa_trace_*``  — additionally emits 2-bit prev-state codes per cell
  (6 bits/cell packed in uint8), the traceback2 walk's entire input, at
  1/24 the bytes of the packed planes.
- ``msa_full_*``   — emits raw packed waves (testing only).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import (
    GAPC, GAPLEN, MODE_DEL, MODE_INS, MODE_MS, SHORT_PROFILE,
    ScoringProfile,
)

_N = ord("N")
I32 = jnp.int32
_SHORT = SHORT_PROFILE


def _score(p, P: ScoringProfile = _SHORT):
    # clears low TIMEBITS, keeps sign
    return jnp.bitwise_and(p, jnp.int32(~P.TIMEMASK))


def _time(p, P: ScoringProfile = _SHORT):
    return jnp.bitwise_and(p, jnp.int32(P.TIMEMASK))


def _clamp_time(t, P: ScoringProfile = _SHORT):
    return jnp.where(t > P.MAX_TIME, P.MAX_TIME - P.MASK5, t)


def _sub_array(i, P: ScoringProfile = _SHORT):
    """POINTSoff_SUB_ARRAY[i] as selects (reference static block)."""
    return jnp.where(
        i > P.LIMIT_FOR_COST_3, P.POINTSoff_SUB3,
        jnp.where(i > 1, P.POINTSoff_SUB2, P.POINTSoff_SUB)).astype(I32)


def _ins_array(i, P: ScoringProfile = _SHORT):
    return jnp.where(
        i > P.LIMIT_FOR_COST_4, P.POINTSoff_INS4,
        jnp.where(i > P.LIMIT_FOR_COST_3, P.POINTSoff_INS3,
                  jnp.where(i > 1, P.POINTSoff_INS2,
                            P.POINTSoff_INS))).astype(I32)


def _del_ext(streak, P: ScoringProfile = _SHORT):
    """Deletion extension penalty by current run length
    (reference: :770-776)."""
    return jnp.where(
        streak == 0, P.POINTSoff_DEL,
        jnp.where(streak < P.LIMIT_FOR_COST_3, P.POINTSoff_DEL2,
                  jnp.where(streak < P.LIMIT_FOR_COST_4, P.POINTSoff_DEL3,
                            jnp.where(streak < P.LIMIT_FOR_COST_5,
                                      P.POINTSoff_DEL4,
                                      jnp.where((streak & P.MASK5) == 0,
                                                P.POINTSoff_DEL5, 0))))
    ).astype(I32)


def _ins0_column(R: int, P: ScoringProfile) -> np.ndarray:
    """Cumulative insertion penalty for column 0 (reference ctor :95-104)."""
    ins_off = np.zeros(R + 2, np.int64)
    for i in range(1, R + 2):
        if i > P.LIMIT_FOR_COST_4:
            ins_off[i] = P.POINTSoff_INS4
        elif i > P.LIMIT_FOR_COST_3:
            ins_off[i] = P.POINTSoff_INS3
        elif i > 1:
            ins_off[i] = P.POINTSoff_INS2
        else:
            ins_off[i] = P.POINTSoff_INS
    col = np.zeros(R + 1, np.int64)
    for i in range(R + 1):
        prev = 0 if i < 2 else col[i - 1]
        col[i] = prev + ins_off[i]
    return col.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _ins0_np(R: int, P: ScoringProfile = _SHORT):
    return _ins0_column(R, P)


def _wave_step(R: int, C: int, read1, read0, ref_rev_pad, rtrue,
               prev1, prev2, d, P: ScoringProfile = _SHORT):
    """One anti-diagonal. prev1/prev2 = waves d-1, d-2, each (3, R+1).
    R is the padded lane count; `rtrue` (scalar, may be traced) is the
    read's actual row count, so one compiled shape serves mixed read
    lengths. Returns (wave (3, R+1) int32, prevs (R+1,) uint8 packed
    2-bit prev-state codes per state)."""
    r_idx = jax.lax.broadcasted_iota(I32, (R + 1, 1), 0).reshape(R + 1)
    c_idx = d - r_idx  # column of each lane on this wave

    # reference window chars for this wave: ref1[r] = ref[c-1] = ref[d-r-1]
    # ref_rev_pad is ref reversed, padded with sentinel '!' by (R+1) on both
    # sides; ref1[r] -> ref_rev_pad[C - d + r + R + 1]
    start = C - d + R + 1
    ref_slice = jax.lax.dynamic_slice(ref_rev_pad, (start,), (R + 2,))
    ref1 = ref_slice[:R + 1].astype(I32)
    ref0 = ref_slice[1:].astype(I32)  # ref[d-r-2]

    call1 = read1
    call0 = read0

    match = jnp.logical_and(call1 == ref1, ref1 != _N)
    prev_match = jnp.logical_and(call0 == ref0, ref0 != _N)
    gap = ref1 == GAPC

    # dependencies as vector shifts
    ms_dd = jnp.roll(prev2[MODE_MS], 1)   # (r-1) of wave d-2
    del_dd = jnp.roll(prev2[MODE_DEL], 1)
    ins_dd = jnp.roll(prev2[MODE_INS], 1)
    ms_left = prev1[MODE_MS]              # (r) of wave d-1
    del_left = prev1[MODE_DEL]
    ms_up = jnp.roll(prev1[MODE_MS], 1)   # (r-1) of wave d-1
    ins_up = jnp.roll(prev1[MODE_INS], 1)

    maxGain = (rtrue - 1) * P.POINTSoff_MATCH2 + P.POINTSoff_MATCH
    subfloor = (-2 * maxGain).astype(I32) if hasattr(maxGain, 'astype') \
        else jnp.int32(-2 * maxGain)

    # ---- MS ----
    s_diag, s_del, s_ins = (_score(ms_dd, P), _score(del_dd, P),
                            _score(ins_dd, P))
    streak = _time(ms_dd, P)
    m_ms = s_diag + jnp.where(prev_match, P.POINTSoff_MATCH2,
                              P.POINTSoff_MATCH)
    m_d = s_del + P.POINTSoff_MATCH
    m_i = s_ins + P.POINTSoff_MATCH
    m_best = jnp.maximum(m_ms, jnp.maximum(m_d, m_i))
    m_from_ms = jnp.logical_and(m_ms >= m_d, m_ms >= m_i)
    m_time = jnp.where(m_from_ms & prev_match, streak + 1, 1)
    sub_pen = jnp.where(
        prev_match,
        jnp.where(streak <= 1, P.POINTSoff_SUBR, P.POINTSoff_SUB),
        _sub_array(streak + 1, P))
    x_ms = jnp.where(jnp.logical_and(ref1 != _N, call1 != _N),
                     s_diag + sub_pen, s_diag + P.POINTSoff_NOCALL)
    x_d = s_del + P.POINTSoff_SUB
    x_i = s_ins + P.POINTSoff_SUB
    x_best = jnp.maximum(x_ms, jnp.maximum(x_d, x_i))
    x_from_ms = jnp.logical_and(x_ms >= x_d, x_ms >= x_i)
    x_time = jnp.where(x_from_ms,
                       jnp.where(prev_match, 1, streak + 1), 1)
    ms_score = jnp.where(match, m_best, x_best)
    ms_time = _clamp_time(jnp.where(match, m_time, x_time), P)
    ms_val = jnp.where(gap, subfloor,
                       jnp.bitwise_or(ms_score, ms_time))
    # traceback prev code (reference: traceback2 :1122-1133 — time>1 stays
    # in state, else argmax of the diagonal predecessors, MS>=DEL>=INS)
    ms_prev_arg = jnp.where(
        jnp.logical_and(s_diag >= s_del, s_diag >= s_ins), MODE_MS,
        jnp.where(s_del >= s_ins, MODE_DEL, MODE_INS)).astype(jnp.uint8)
    ms_prev = jnp.where(ms_time > 1, jnp.uint8(MODE_MS), ms_prev_arg)

    # ---- DEL ----
    dstreak = _time(del_left, P)
    d_ms = _score(ms_left, P) + P.POINTSoff_DEL
    d_d = _score(del_left, P) + _del_ext(dstreak, P)
    refn_adj = jnp.where(ref1 == _N, P.POINTSoff_DEL_REF_N,
                         jnp.where(gap, P.POINTSoff_GAP, 0)).astype(I32)
    d_ms = d_ms + refn_adj
    d_d = d_d + refn_adj
    del_score = jnp.maximum(d_ms, d_d)
    del_time = _clamp_time(jnp.where(d_ms >= d_d, 1, dstreak + 1), P)
    del_barrier = jnp.logical_or(r_idx < P.BARRIER_D1,
                                 r_idx > rtrue - P.BARRIER_D1)
    del_val = jnp.where(del_barrier, subfloor,
                        jnp.bitwise_or(del_score, del_time))
    del_prev_arg = jnp.where(_score(ms_left, P) >= _score(del_left, P),
                             MODE_MS, MODE_DEL).astype(jnp.uint8)
    del_prev = jnp.where(del_time > 1, jnp.uint8(MODE_DEL), del_prev_arg)

    # ---- INS ----
    istreak = _time(ins_up, P)
    i_ms = _score(ms_up, P) + P.POINTSoff_INS
    i_i = _score(ins_up, P) + _ins_array(istreak + 1, P)
    ins_score = jnp.maximum(i_ms, i_i)
    ins_time = _clamp_time(jnp.where(i_ms >= i_i, 1, istreak + 1), P)
    # reference: BARRIER_I2b = columns - 1 (:633)
    ins_barrier = jnp.logical_or(
        gap,
        jnp.logical_or(
            jnp.logical_and(r_idx < P.BARRIER_I1, c_idx > 1),
            jnp.logical_and(r_idx > rtrue - P.BARRIER_I1,
                            c_idx < C - 1)))
    ins_val = jnp.where(ins_barrier, subfloor,
                        jnp.bitwise_or(ins_score, ins_time))
    ins_prev_arg = jnp.where(_score(ms_up, P) >= _score(ins_up, P),
                             MODE_MS, MODE_INS).astype(jnp.uint8)
    ins_prev = jnp.where(ins_time > 1, jnp.uint8(MODE_INS), ins_prev_arg)

    wave = jnp.stack([ms_val, del_val, ins_val])

    # boundary overrides: r==0 (row 0, c>=1) -> 0 ; r==d (col 0) -> INS0[r]
    ins0 = jnp.asarray(_ins0_np(R, P))
    is_row0 = r_idx == 0
    is_col0 = r_idx == d
    bound = jnp.where(is_row0, 0, jnp.where(is_col0, ins0, 0))
    use_bound = jnp.logical_or(is_row0, is_col0)
    wave = jnp.where(use_bound[None, :], bound[None, :], wave)
    invalid = jnp.logical_or(jnp.logical_or(c_idx < 0, c_idx > C),
                             r_idx > rtrue)
    wave = jnp.where(invalid[None, :], jnp.int32(P.BADoff), wave)

    prevs = (ms_prev | (del_prev << 2) | (ins_prev << 4)).astype(jnp.uint8)
    return wave, prevs


def _init_carry(R: int, P: ScoringProfile = _SHORT):
    w0 = np.full((3, R + 1), P.BADoff, np.int32)
    w0[:, 0] = 0  # cell (0, 0)
    wm1 = np.full((3, R + 1), P.BADoff, np.int32)
    return jnp.asarray(w0), jnp.asarray(wm1)


def _prep_read(read_ascii, R):
    read = read_ascii.astype(I32)
    q = jnp.full((1,), ord("?"), I32)
    read1 = jnp.concatenate([q, read])          # read1[r] = read[r-1]
    read0 = jnp.concatenate([q, q, read[:-1]])  # read0[r] = read[r-2]
    return read1, read0


def _prep_ref(ref_ascii, R):
    pad = jnp.full((R + 1,), ord("!"), I32)
    return jnp.concatenate([pad, ref_ascii.astype(I32)[::-1], pad])


def _update_best(best, wave, d, rtrue, C, P: ScoringProfile = _SHORT):
    """Track per-state running max over last-row cells (strict >, so the
    first/lowest column wins ties, matching the reference's scan order,
    :857-878). The last row is lane `rtrue` (may be traced)."""
    best_scores, best_cols = best
    val = _score(jnp.take(wave, rtrue, axis=1), P)  # (3,) last-row lane
    col = d - rtrue
    on_last = jnp.logical_and(col >= 1, col <= C)
    take = jnp.logical_and(on_last, val > best_scores)
    best_scores = jnp.where(take, val, best_scores)
    best_cols = jnp.where(take, col, best_cols)
    return best_scores, best_cols


def _finish_best(best, P: ScoringProfile = _SHORT):
    """Combine per-state bests in state-major order (ties -> lowest
    state), exactly the reference's final scan."""
    best_scores, best_cols = best
    # first index of max in order MS, DEL, INS
    state = jnp.argmax(best_scores)  # argmax returns first max
    return (best_scores[state] >> P.SCOREOFFSET, best_cols[state],
            state.astype(I32))


def _scan(read, ref, R: int, C: int, want_prevs: bool,
          want_waves: bool = False, rtrue=None,
          P: ScoringProfile = _SHORT):
    if rtrue is None:
        rtrue = R
    read1, read0 = _prep_read(read, R)
    ref_rev_pad = _prep_ref(ref, R)
    w0, wm1 = _init_carry(R, P)
    best0 = (jnp.full((3,), -(2 ** 31) + 1, I32), jnp.zeros((3,), I32))

    def step(carry, d):
        prev1, prev2, best = carry
        wave, prevs = _wave_step(R, C, read1, read0, ref_rev_pad, rtrue,
                                 prev1, prev2, d, P)
        best = _update_best(best, wave, d, rtrue, C, P)
        ys = ()
        if want_prevs:
            ys = prevs
        if want_waves:
            ys = wave
        return (wave, prev1, best), ys

    carry, ys = jax.lax.scan(step, (w0, wm1, best0),
                             jnp.arange(1, R + C + 1))
    score, col, state = _finish_best(carry[2], P)
    return ys, score, col, state


def msa_score_single(read, ref, R: int, C: int,
                     P: ScoringProfile = _SHORT):
    _, score, col, state = _scan(read, ref, R, C, False, P=P)
    return score, col, state


def msa_trace_single(read, ref, R: int, C: int,
                     P: ScoringProfile = _SHORT):
    """Returns (prevs (R+C, R+1) uint8, score, col, state)."""
    return _scan(read, ref, R, C, True, P=P)


def msa_full_single(read, ref, R: int, C: int,
                    P: ScoringProfile = _SHORT):
    """Testing: returns raw packed waves (R+C, 3, R+1)."""
    return _scan(read, ref, R, C, False, want_waves=True, P=P)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def msa_score_batch(reads, refs, R: int, C: int,
                    P: ScoringProfile = _SHORT):
    return jax.vmap(lambda rd, rf: msa_score_single(rd, rf, R, C, P))(
        reads, refs)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def msa_trace_batch(reads, refs, R: int, C: int,
                    P: ScoringProfile = _SHORT):
    return jax.vmap(lambda rd, rf: msa_trace_single(rd, rf, R, C, P))(
        reads, refs)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def msa_full_batch(reads, refs, R: int, C: int,
                   P: ScoringProfile = _SHORT):
    return jax.vmap(lambda rd, rf: msa_full_single(rd, rf, R, C, P))(
        reads, refs)


def traceback_prevs(read: np.ndarray, ref: np.ndarray, prevs: np.ndarray,
                    col: int, state: int) -> bytes:
    """Host walk over device-produced prev-state codes — identical output
    to the oracle traceback (reference: traceback2 :1102-1232).
    prevs[d-1, r] holds the packed codes of cell (r, c=d-r)."""
    R, C = len(read), len(ref)
    row = R
    out = bytearray()
    gaps = 0
    while row > 0 and col > 0:
        code = int(prevs[row + col - 1, row])
        prev = (code >> (2 * state)) & 3
        if state == MODE_MS:
            c, r = int(read[row - 1]), int(ref[col - 1])
            if c == r:
                out.append(ord("m"))
            elif not _defined(c) or not _defined(r):
                out.append(ord("N"))
            else:
                out.append(ord("S"))
            row -= 1
            col -= 1
        elif state == MODE_DEL:
            if ref[col - 1] == GAPC:
                out.append(ord("-"))
                gaps += 1
            else:
                out.append(ord("D"))
            col -= 1
        else:
            if col >= C:
                out.append(ord("Y"))
            else:
                out.append(ord("I"))
            row -= 1
        state = prev
    while row > 0:
        out.append(ord("X"))
        row -= 1
    out.reverse()
    if gaps == 0:
        return bytes(out)
    out3 = bytearray()
    for ch in out:
        if ch != GAPC:
            out3.append(ch)
        else:
            out3.extend(b"D" * GAPLEN)
    return bytes(out3)


def _defined(c: int) -> bool:
    return c in (ord("A"), ord("C"), ord("G"), ord("T"), ord("U"))


def waves_to_packed(waves: np.ndarray, R: int, C: int,
                    P: ScoringProfile = _SHORT) -> np.ndarray:
    """Host-side: wave layout (R+C, 3, R+1) -> matrix layout
    (3, R+1, C+1) for the oracle traceback walk (testing)."""
    out = np.full((3, R + 1, C + 1), P.BADoff, np.int64)
    ins0 = _ins0_np(R, P)
    out[:, 0, :] = 0
    for r in range(R + 1):
        out[:, r, 0] = ins0[r]
    for r in range(1, R + 1):
        cs = np.arange(1, C + 1)
        out[:, r, 1:] = waves[r + cs - 1, :, r].T
    return out


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def msa_score_batch_var(reads, refs, rows, R: int, C: int,
                        P: ScoringProfile = _SHORT):
    """Variable-row batched scoring: reads (B, R) padded with 'N' beyond
    each read's true length rows[b]. One compile serves all lengths <= R."""
    return jax.vmap(
        lambda rd, rf, rt: _scan(rd, rf, R, C, False, rtrue=rt, P=P)[1:]
    )(reads, refs, rows)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def msa_trace_batch_var(reads, refs, rows, R: int, C: int,
                        P: ScoringProfile = _SHORT):
    return jax.vmap(
        lambda rd, rf, rt: _scan(rd, rf, R, C, True, rtrue=rt, P=P)
    )(reads, refs, rows)


# ---------------------------------------------------------------------------
# Fully-fused alignment: fill + in-device traceback walk. The prev-state
# codes never leave the device; only the (R+C)-byte symbol strings and
# scalars transfer. (reference: fillLimited + traceback2 as one unit)
# ---------------------------------------------------------------------------

_DEFINED_TABLE = np.zeros(256, np.bool_)
for _c in b"ACGTU":
    _DEFINED_TABLE[_c] = True


def _walk_device(prevs, read, ref, col0, st0, R: int, C: int):
    """Traceback walk on device. prevs: (R+C, R+1) uint8; returns
    (symbols (R+C,) uint8 reversed order, out_len, gaps).

    Active steps are a contiguous prefix of the walk (a step is active
    iff row > 0, and row is non-increasing), so the output position of
    step i is i itself — symbols are emitted as scan outputs instead of
    scattered into a carried buffer (a per-step dynamic-update-slice
    that dominated the walk's cost)."""
    defined = jnp.asarray(_DEFINED_TABLE)
    read_i = read.astype(I32)
    ref_i = ref.astype(I32)
    # pack per-position predicates into ONE gatherable word per side —
    # the walk is a serial scan of tiny-vector steps, so every
    # non-fusable gather inside the body costs a full step of latency
    read_prop = read_i | (jnp.where(defined[read_i], 1, 0) << 8)
    ref_prop = ref_i | (jnp.where(defined[ref_i], 1, 0) << 8) \
        | (jnp.where(ref_i == GAPC, 1, 0) << 9)

    def step(carry, _):
        row, col, st, gaps = carry
        main = jnp.logical_and(row > 0, col > 0)
        xpad = jnp.logical_and(row > 0, col <= 0)
        code = prevs[jnp.clip(row + col - 1, 0, R + C - 1),
                     jnp.clip(row, 0, R)].astype(I32)
        prev = (code >> (2 * st)) & 3
        ri = jnp.maximum(row - 1, 0)
        ci = jnp.clip(col - 1, 0, C - 1)
        rp = read_prop[ri]
        fp = ref_prop[ci]
        c_ = rp & 255
        r_ = fp & 255
        both_def = jnp.logical_and(rp & 256 > 0, fp & 256 > 0)
        sym_ms = jnp.where(
            c_ == r_, ord("m"),
            jnp.where(both_def, ord("S"), ord("N")))
        is_gap = fp & 512 > 0
        sym_del = jnp.where(is_gap, ord("-"), ord("D"))
        sym_ins = jnp.where(col >= C, ord("Y"), ord("I"))
        sym = jnp.where(st == MODE_MS, sym_ms,
                        jnp.where(st == MODE_DEL, sym_del, sym_ins))
        sym = jnp.where(xpad, ord("X"), sym)
        act = jnp.logical_or(main, xpad)
        sym = jnp.where(act, sym, 0).astype(jnp.uint8)
        gaps = gaps + jnp.where(
            jnp.logical_and(main, jnp.logical_and(st == MODE_DEL,
                                                  is_gap)), 1, 0)
        drow = jnp.where(jnp.logical_and(main, st != MODE_DEL), 1, 0) \
            + jnp.where(xpad, 1, 0)
        dcol = jnp.where(jnp.logical_and(main, st != MODE_INS), 1, 0) \
            + jnp.where(xpad, 1, 0)
        nst = jnp.where(main, prev, st)
        return (row - drow, col - dcol, nst.astype(I32), gaps), sym

    carry0 = (jnp.int32(R), col0.astype(I32), st0.astype(I32),
              jnp.int32(0))
    # unroll: the body is a handful of tiny-vector ops, so the per-step
    # launch/loop overhead dominates — unrolling amortizes it 8x
    (_row, _col, _st, gaps), syms = jax.lax.scan(
        step, carry0, None, length=R + C, unroll=8)
    outpos = jnp.sum((syms != 0).astype(I32))
    return syms, outpos, gaps


def _align_single(read, ref, R: int, C: int, rtrue=None,
                  P: ScoringProfile = _SHORT):
    prevs, score, col, state = _scan(read, ref, R, C, True, rtrue=rtrue,
                                     P=P)
    symbols, out_len, gaps = _walk_device(prevs, read, ref, col, state,
                                          R, C)
    return symbols, out_len, gaps, score, col, state


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def msa_align_batch(reads, refs, R: int, C: int,
                    P: ScoringProfile = _SHORT):
    """Fill + traceback in one device call. Returns (symbols (B, R+C)
    uint8 in reverse order, lengths (B,), gaps (B,), scores, cols,
    states)."""
    return jax.vmap(lambda rd, rf: _align_single(rd, rf, R, C, P=P))(
        reads, refs)


def finish_match(symbols_row: np.ndarray, out_len: int,
                 gaps: int) -> bytes:
    """Host: reverse the walked symbols and expand GAPC placeholders
    (reference: traceback2 :1205-1227)."""
    out = bytes(symbols_row[:out_len][::-1])
    if gaps == 0:
        return out
    res = bytearray()
    for ch in out:
        if ch == GAPC:
            res.extend(b"D" * GAPLEN)
        else:
            res.append(ch)
    return bytes(res)
