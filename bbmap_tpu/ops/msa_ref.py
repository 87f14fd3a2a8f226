"""NumPy oracle of the multi-state banded affine DP.

Bit-exact reimplementation of the reference aligner's fillUnlimited /
traceback2 semantics (reference: align2/MultiStateAligner11ts.java:612-866,
1102-1232). Used as the property-test ground truth for the XLA
wavefront (ops/msa_jax.py); NOT a production path.

DP model: three int32 planes (MS, DEL, INS), each cell packing
``score << 11 | streak``. Penalties depend on the current state run length
("streak"/"time"), giving the piecewise-affine gap and substitution model
that defines SAM equivalence.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.constants import (
    BADoff, BARRIER_D1, BARRIER_I1, GAPC, LIMIT_FOR_COST_3, LIMIT_FOR_COST_4,
    LIMIT_FOR_COST_5, MASK5, MAX_TIME, MODE_DEL, MODE_INS, MODE_MS,
    POINTSoff_DEL, POINTSoff_DEL2, POINTSoff_DEL3, POINTSoff_DEL4,
    POINTSoff_DEL5, POINTSoff_DEL_REF_N, POINTSoff_GAP, POINTSoff_INS,
    POINTSoff_INS_ARRAY, POINTSoff_MATCH, POINTSoff_MATCH2, POINTSoff_NOCALL,
    POINTSoff_SUB, POINTSoff_SUBR, POINTSoff_SUB_ARRAY, SCOREMASK,
    SCOREOFFSET, TIMEMASK,
)

_N = ord("N")


def score_part(packed: np.ndarray | int):
    """packed & SCOREMASK with Java int32 semantics: clears the low TIMEBITS,
    keeping the (possibly negative) score in the upper bits."""
    return packed & ~TIMEMASK


def time_part(packed):
    return packed & TIMEMASK


def fill_unlimited(read: np.ndarray, ref: np.ndarray,
                   P: "ScoringProfile" = None
                   ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Fill the 3-state DP over full matrices.

    read/ref: ASCII uint8 arrays (read = the query; ref = the reference
    window, possibly gap-compressed with GAPC symbols).
    ``P``: scoring profile (default SHORT = MSA11ts; pass PACBIO_PROFILE
    for MultiStateAligner9PacBio semantics).
    Returns (packed[3, rows+1, cols+1] int64-as-int32-semantics,
    (rows, maxCol, maxState, maxScore)).
    Reference: align2/MultiStateAligner11ts.java:623-866,
    align2/MultiStateAligner9PacBio.java:623-866.
    """
    from ..core.constants import SHORT_PROFILE
    if P is None:
        P = SHORT_PROFILE
    (POINTSoff_MATCH, POINTSoff_MATCH2, POINTSoff_SUB, POINTSoff_SUBR,
     POINTSoff_SUB2, POINTSoff_SUB3, POINTSoff_NOCALL, POINTSoff_INS,
     POINTSoff_DEL, POINTSoff_DEL2, POINTSoff_DEL3, POINTSoff_DEL4,
     POINTSoff_DEL5, POINTSoff_DEL_REF_N, POINTSoff_GAP, BADoff,
     MAX_TIME, MASK5, TIMEMASK, SCOREOFFSET, BARRIER_I1, BARRIER_D1,
     LIMIT_FOR_COST_3, LIMIT_FOR_COST_4, LIMIT_FOR_COST_5) = (
        P.POINTSoff_MATCH, P.POINTSoff_MATCH2, P.POINTSoff_SUB,
        P.POINTSoff_SUBR, P.POINTSoff_SUB2, P.POINTSoff_SUB3,
        P.POINTSoff_NOCALL, P.POINTSoff_INS, P.POINTSoff_DEL,
        P.POINTSoff_DEL2, P.POINTSoff_DEL3, P.POINTSoff_DEL4,
        P.POINTSoff_DEL5, P.POINTSoff_DEL_REF_N, P.POINTSoff_GAP,
        P.BADoff, P.MAX_TIME, P.MASK5, P.TIMEMASK, P.SCOREOFFSET,
        P.BARRIER_I1, P.BARRIER_D1, P.LIMIT_FOR_COST_3,
        P.LIMIT_FOR_COST_4, P.LIMIT_FOR_COST_5)

    def POINTSoff_INS_ARRAY(i):
        if i > LIMIT_FOR_COST_4:
            return P.POINTSoff_INS4
        if i > LIMIT_FOR_COST_3:
            return P.POINTSoff_INS3
        if i > 1:
            return P.POINTSoff_INS2
        return POINTSoff_INS if i == 1 else 0

    def POINTSoff_SUB_ARRAY(i):
        if i > LIMIT_FOR_COST_3:
            return POINTSoff_SUB3
        if i > 1:
            return POINTSoff_SUB2
        return POINTSoff_SUB if i == 1 else 0

    def score_part(p):
        return p & ~TIMEMASK

    def time_part(p):
        return p & TIMEMASK

    rows = len(read)
    cols = len(ref)
    read = read.astype(np.int64)
    ref = ref.astype(np.int64)

    max_gain = (rows - 1) * POINTSoff_MATCH2 + POINTSoff_MATCH
    subfloor = -2 * max_gain
    barrier_i2 = rows - BARRIER_I1
    barrier_i2b = cols - 1  # (reference: :633)
    barrier_d2 = rows - BARRIER_D1

    packed = np.zeros((3, rows + 1, cols + 1), np.int64)
    # init (reference: ctor :84-112): rows>=1 all BADoff; col 0 cumulative
    # insertion penalties; row 0 cols>=1 zero (free ref start)
    packed[:, 1:, :] = BADoff
    for mat in range(3):
        for i in range(rows + 1):
            prev = 0 if i < 2 else packed[mat, i - 1, 0]
            packed[mat, i, 0] = prev + POINTSoff_INS_ARRAY(i)

    for row in range(1, rows + 1):
        for col in range(1, cols + 1):
            call0 = read[row - 2] if row >= 2 else ord("?")
            call1 = read[row - 1]
            ref0 = ref[col - 2] if col >= 2 else ord("!")
            ref1 = ref[col - 1]
            match = (call1 == ref1) and ref1 != _N
            prev_match = (call0 == ref0) and ref0 != _N
            gap = ref1 == GAPC

            # --- MS ---
            if gap:
                packed[MODE_MS, row, col] = subfloor
            else:
                diag_p = packed[MODE_MS, row - 1, col - 1]
                s_diag = score_part(diag_p)
                s_del = score_part(packed[MODE_DEL, row - 1, col - 1])
                s_ins = score_part(packed[MODE_INS, row - 1, col - 1])
                streak = time_part(diag_p)
                if match:
                    score_ms = s_diag + (POINTSoff_MATCH2 if prev_match
                                         else POINTSoff_MATCH)
                    score_d = s_del + POINTSoff_MATCH
                    score_i = s_ins + POINTSoff_MATCH
                    if score_ms >= score_d and score_ms >= score_i:
                        score, time = score_ms, (streak + 1 if prev_match
                                                 else 1)
                    elif score_d >= score_i:
                        score, time = score_d, 1
                    else:
                        score, time = score_i, 1
                else:
                    if ref1 != _N and call1 != _N:
                        if prev_match:
                            sub = (POINTSoff_SUBR if streak <= 1
                                   else POINTSoff_SUB)
                        else:
                            sub = POINTSoff_SUB_ARRAY(streak + 1)
                        score_ms = s_diag + sub
                    else:
                        score_ms = s_diag + POINTSoff_NOCALL
                    score_d = s_del + POINTSoff_SUB
                    score_i = s_ins + POINTSoff_SUB
                    if score_ms >= score_d and score_ms >= score_i:
                        score, time = score_ms, (1 if prev_match
                                                 else streak + 1)
                    elif score_d >= score_i:
                        score, time = score_d, 1
                    else:
                        score, time = score_i, 1
                if time > MAX_TIME:
                    time = MAX_TIME - MASK5
                packed[MODE_MS, row, col] = score | time

            # --- DEL ---
            if row < BARRIER_D1 or row > barrier_d2:
                packed[MODE_DEL, row, col] = subfloor
            else:
                left_del = packed[MODE_DEL, row, col - 1]
                streak = time_part(left_del)
                s_diag = score_part(packed[MODE_MS, row, col - 1])
                s_del = score_part(left_del)
                score_ms = s_diag + POINTSoff_DEL
                if streak == 0:
                    ext = POINTSoff_DEL
                elif streak < LIMIT_FOR_COST_3:
                    ext = POINTSoff_DEL2
                elif streak < LIMIT_FOR_COST_4:
                    ext = POINTSoff_DEL3
                elif streak < LIMIT_FOR_COST_5:
                    ext = POINTSoff_DEL4
                else:
                    ext = POINTSoff_DEL5 if (streak & MASK5) == 0 else 0
                score_d = s_del + ext
                if ref1 == _N:
                    score_ms += POINTSoff_DEL_REF_N
                    score_d += POINTSoff_DEL_REF_N
                elif gap:
                    score_ms += POINTSoff_GAP
                    score_d += POINTSoff_GAP
                if score_ms >= score_d:
                    score, time = score_ms, 1
                else:
                    score, time = score_d, streak + 1
                if time > MAX_TIME:
                    time = MAX_TIME - MASK5
                packed[MODE_DEL, row, col] = score | time

            # --- INS ---
            if gap or (row < BARRIER_I1 and col > 1) or (
                    row > barrier_i2 and col < barrier_i2b):
                packed[MODE_INS, row, col] = subfloor
            else:
                up_ins = packed[MODE_INS, row - 1, col]
                streak = time_part(up_ins)
                s_diag = score_part(packed[MODE_MS, row - 1, col])
                s_ins = score_part(up_ins)
                score_ms = s_diag + POINTSoff_INS
                score_i = s_ins + POINTSoff_INS_ARRAY(streak + 1)
                if score_ms >= score_i:
                    score, time = score_ms, 1
                else:
                    score, time = score_i, streak + 1
                if time > MAX_TIME:
                    time = MAX_TIME - MASK5
                packed[MODE_INS, row, col] = score | time

    # final max over last row (reference: :857-878)
    max_score = None
    max_col = -1
    max_state = -1
    for state in range(3):
        for col in range(1, cols + 1):
            x = score_part(packed[state, rows, col])
            if max_score is None or x > max_score:
                max_score, max_col, max_state = x, col, state
    return packed, (rows, max_col, max_state, int(max_score) >> SCOREOFFSET)


def traceback(read: np.ndarray, ref: np.ndarray, packed: np.ndarray,
              row: int, col: int, state: int,
              P: "ScoringProfile" = None) -> bytes:
    """Generate the long-form match string by walking the packed planes
    (reference: align2/MultiStateAligner11ts.java traceback2 :1102-1232).
    Symbols: m=match S=sub N=nocall I=ins D=del X=clipped-tip -=gap."""
    from ..core.constants import SHORT_PROFILE
    if P is None:
        P = SHORT_PROFILE
    time_part = lambda p: p & P.TIMEMASK
    score_part = lambda p: p & ~P.TIMEMASK
    cols = len(ref)
    out = bytearray()
    gaps = 0
    while row > 0 and col > 0:
        time = time_part(packed[state, row, col])
        if state == MODE_MS:
            if time > 1:
                prev = state
            else:
                s_diag = score_part(packed[MODE_MS, row - 1, col - 1])
                s_del = score_part(packed[MODE_DEL, row - 1, col - 1])
                s_ins = score_part(packed[MODE_INS, row - 1, col - 1])
                if s_diag >= s_del and s_diag >= s_ins:
                    prev = MODE_MS
                elif s_del >= s_ins:
                    prev = MODE_DEL
                else:
                    prev = MODE_INS
            c, r = read[row - 1], ref[col - 1]
            if c == r:
                out.append(ord("m"))
            elif not _defined(c) or not _defined(r):
                out.append(ord("N"))
            else:
                out.append(ord("S"))
            row -= 1
            col -= 1
        elif state == MODE_DEL:
            if time > 1:
                prev = state
            else:
                s_diag = score_part(packed[MODE_MS, row, col - 1])
                s_del = score_part(packed[MODE_DEL, row, col - 1])
                prev = MODE_MS if s_diag >= s_del else MODE_DEL
            r = ref[col - 1]
            if r == GAPC:
                out.append(ord("-"))
                gaps += 1
            else:
                out.append(ord("D"))
            col -= 1
        else:  # MODE_INS
            if time > 1:
                prev = state
            else:
                s_diag = score_part(packed[MODE_MS, row - 1, col])
                s_ins = score_part(packed[MODE_INS, row - 1, col])
                prev = MODE_MS if s_diag >= s_ins else MODE_INS
            if col == 0:
                out.append(ord("X"))
            elif col >= cols:
                out.append(ord("Y"))
            else:
                out.append(ord("I"))
            row -= 1
        state = prev
    if col != row:
        while row > 0:
            out.append(ord("X"))
            row -= 1
            col -= 1
    out.reverse()
    if gaps == 0:
        return bytes(out)
    # expand GAPC placeholders to GAPLEN 'D's
    # (reference: traceback2 :1212-1227)
    from ..core.constants import GAPLEN
    out3 = bytearray()
    for ch in out:
        if ch != GAPC:
            out3.append(ch)
        else:
            out3.extend(b"D" * GAPLEN)
    return bytes(out3)


def _defined(c: int) -> bool:
    return c in (ord("A"), ord("C"), ord("G"), ord("T"), ord("U"))


def align(read: np.ndarray, ref_window: np.ndarray,
          P: "ScoringProfile" = None) -> Tuple[int, int, bytes]:
    """Convenience: fill + traceback. Returns (score, ref_start_offset,
    match_string). ref_start_offset is 0-based offset of the alignment's
    first ref column within ref_window."""
    packed, (rows, max_col, max_state, max_score) = fill_unlimited(
        read, ref_window, P)
    match = traceback(read, ref_window, packed, rows, max_col, max_state,
                      P)
    # number of ref bases consumed = count of m/S/D/N symbols
    ref_len = sum(1 for ch in match if ch in b"mSDN")
    start = max_col - ref_len
    return max_score, start, match
