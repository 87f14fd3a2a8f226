"""Fused single-dispatch mapping: quickmap + DP escalation + traceback
as ONE jitted XLA program per batch.

The unfused escalation path makes 10-20 host<->device round trips per
batch (quickmap results down, escalation reads up, DP scores down, trace
reads up, trace arrays down ...). This module folds the whole decision
tree of ``BBMapAligner._escalate_columnar`` into the quickmap program
using fixed-size device compaction (top_k over flagged row indices), so
a batch costs one upload (2-bit packed reads) and one download:

1. candidate_stage + finalize_stage (align/quickmap_device.py)
2. escalate flags: best gapless < maxImperfectScore (reference:
   align2/AbstractMapThread.java:1252 — a site at or above that score
   cannot be beaten by any indel alignment)
3. compact escalated rows to a static budget E; DP-score the top-2
   gapless candidates of each (reference: align2/BBMapThread.scoreSlow
   :252-345 scores retained sites; the top-2 + gapless-rest competition
   matches the round-2 host path bit for bit)
4. device selection: eff = max(gapless, DP), winner/second/rest,
   n_sites — best/second ship to the host, which applies the clearzone
   ambiguity model in float64 exactly as before
5. winner gapless match symbols recomputed at the winner diagonal
   (covers the "stale match row" case without host work)
6. rows whose winner DP beat gapless compact to a static budget T and
   run fill + in-device traceback (reference: BBMapThread:309-345
   traceback on kept sites only); symbols ship 4-bit packed

Rows the program cannot settle exactly — escalation/trace budget
overflow and candidates wider than the narrow DP window — are flagged
and re-run on the host fallback path (align/pipeline.py
``_escalate_columnar``), preserving reference semantics. On real
workloads those are <<1% of reads.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..index.build import KmerIndex
from ..ops import msa_jax
from . import quickmap_device as qd
from .quickmap_device import (I32, U32, MAX_CANDIDATES, N_META, QmConfig,
                              _UNPACK_LUT, device_arrays, extract_ref_codes,
                              make_config, quality_offsets_stage)

SLOW_ALIGN_PADDING = 4
NARROW_SPREAD = 16          # must match escalate_device.NARROW_SPREAD
WIDE_SPREAD = 448           # must match escalate_device.WIDE_SPREAD
RETRY_EXTRA = 80 + SLOW_ALIGN_PADDING   # maxindel>0 re-pad (pipeline
# _apply_traces; fused runs only when maxindel > 0)
BIG = np.int32(2 ** 30)

# 2-bit host read packing --------------------------------------------------
_B2C = qd._B2C  # ASCII -> 2-bit code (0..3), 4 for undefined

# traceback symbol codec: 4-bit codes, 2 symbols per byte
_SYM_ASCII = np.frombuffer(b"\x00mSDINXY-", np.uint8)      # code -> ascii
_SYM_CODE = np.zeros(256, np.uint8)                        # ascii -> code
for _i, _ch in enumerate(_SYM_ASCII):
    _SYM_CODE[_ch] = _i
_SYM_UNPACK = np.zeros((256, 2), np.uint8)                 # byte -> 2 ascii
for _b in range(256):
    _SYM_UNPACK[_b, 0] = _SYM_ASCII[min(_b & 15, 8)]
    _SYM_UNPACK[_b, 1] = _SYM_ASCII[min((_b >> 4) & 15, 8)]


def pack_reads_host(bases: np.ndarray):
    """(B, L) ASCII -> (codes2 (B, W16) uint32 [16 bases/word],
    nmask (B, W32) uint32 or None when the batch has no N/undefined
    bases — the common case skips a third of the upload). ~4x smaller
    than raw ASCII."""
    B, L = bases.shape
    codes = _B2C[bases]
    W16 = (L + 15) // 16
    cpad = np.zeros((B, W16 * 16), np.uint8)
    np.minimum(codes, 3, out=cpad[:, :L])
    # byte-halving pack (verified bit-equal to the shift-sum form, and
    # cheaper)
    h4 = cpad[:, 0::2] | (cpad[:, 1::2] << 2)
    h8 = h4[:, 0::2] | (h4[:, 1::2] << 4)
    codes2 = np.ascontiguousarray(h8).view(np.uint32)
    nb = codes > 3
    if not nb.any():
        return codes2, None
    W32 = (L + 31) // 32
    npad = np.zeros((B, W32 * 32), np.uint32)
    npad[:, :L] = nb
    bshift = np.arange(32, dtype=np.uint32)
    nmask = (npad.reshape(B, W32, 32) << bshift[None, None, :]).sum(
        axis=2, dtype=np.uint32)
    return codes2, nmask


def unpack_reads_device(codes2, nmask, L: int):
    """Device inverse of pack_reads_host -> (B, L) codes 0..4.
    ``nmask=None``: the batch is N-free (static program variant)."""
    B, W16 = codes2.shape
    slots = jnp.arange(16, dtype=U32) * 2
    c = ((codes2[:, :, None] >> slots) & 3).astype(jnp.uint8)
    c = c.reshape(B, W16 * 16)[:, :L]
    if nmask is None:
        return c
    W32 = nmask.shape[1]
    bslots = jnp.arange(32, dtype=U32)
    nb = ((nmask[:, :, None] >> bslots) & 1).astype(bool)
    nb = nb.reshape(B, W32 * 32)[:, :L]
    return jnp.where(nb, jnp.uint8(4), c)


_CODE_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def _codes_to_read_ascii(codes):
    """(…, L) 2-bit codes 0..4 -> ASCII ACGTN (arithmetic, no gather)."""
    c = codes.astype(I32)
    a = 65 + 2 * c + 2 * (c >= 2).astype(I32) + 11 * (c == 3).astype(I32)
    return jnp.where(c > 3, 78, a).astype(jnp.uint8)


def _sym_to_code(sym):
    """Walk symbols (ascii m/S/D/I/N/X/Y/-/0) -> 4-bit codes."""
    s = sym.astype(I32)
    out = jnp.zeros_like(s)
    for code, ch in ((1, ord("m")), (2, ord("S")), (3, ord("D")),
                     (4, ord("I")), (5, ord("N")), (6, ord("X")),
                     (7, ord("Y")), (8, ord("-"))):
        out = jnp.where(s == ch, code, out)
    return out.astype(jnp.uint8)


class FusedConfig(NamedTuple):
    qm: QmConfig
    E: int            # escalation row budget
    T: int            # traceback row budget
    W: int            # wide-window rescore job budget
    RT: int           # wide/clip-retry traceback row budget
    Cn: int           # narrow DP window width
    Cw: int           # wide DP window width
    max_imp: int      # maxImperfectScore(L)
    min_score: int
    maxindel: int = 16000   # long-indel plausibility gate (li_plaus)


def esc_budget(B: int) -> int:
    # 25%: the bench error model escalates ~22-23% of reads (gapless
    # best under maxImperfectScore); a 3/16 budget pushed ~4% of rows
    # through the slow host refit every batch
    if B <= 2048:
        return B
    return max(1024, (B * 4 // 16 + 255) // 256 * 256)


def trace_budget(B: int) -> int:
    if B <= 2048:
        return B
    return max(512, (B // 8 + 255) // 256 * 256)


def make_fused_config(index: KmerIndex, L: int, B: int,
                      chain_dist: int = 400, min_ratio: float = 0.56,
                      max_list_length: Optional[int] = None,
                      profile=None, maxindel: int = 16000) -> FusedConfig:
    qm = make_config(index, L, chain_dist, min_ratio, max_list_length,
                     profile)
    if profile is None:
        from ..core.constants import SHORT_PROFILE
        profile = SHORT_PROFILE
    E = esc_budget(B)
    T = min(trace_budget(B), E)
    return FusedConfig(
        qm=qm, E=E, T=T, W=min(128, 2 * E), RT=min(64, T),
        Cn=L + 2 * SLOW_ALIGN_PADDING + NARROW_SPREAD,
        Cw=L + 2 * SLOW_ALIGN_PADDING + WIDE_SPREAD,
        max_imp=int(profile.max_imperfect_score(L)),
        min_score=qm.min_score, maxindel=maxindel)


def _compact_indices(flags, budget: int):
    """Indices of True flags, ascending, padded with BIG to `budget`."""
    n = flags.shape[0]
    pri = jnp.where(flags, jnp.arange(n, dtype=I32), BIG)
    if budget >= n:
        return jnp.sort(pri)
    neg, _ = jax.lax.top_k(-pri, budget)
    return -neg


# pairing constants (must mirror align/pipeline.py — reference:
# AbstractMapThread.java:2975-2991)
MAX_PAIR_DIST = 32000
OUTER_DIST_MULT = 14
OUTER_DIST_DIV = 32
NEG_BOOST = -(2 ** 30)
DEV_CAP = 1 << 22      # insert-deviation clamp (see pair_boost_device)


def pair_boost_device(gl, cand, Bp: int, L1: int, L2: int, apd,
                      chrom_offsets_d):
    """Device mirror of the host ``_pair_boost_fixed`` (reference:
    AbstractMapThread.pairSiteScoresFinal:1919-2100): every candidate of
    one mate is boosted by the best innie-compatible candidate of the
    other. ``gl``: (2*Bp, C) raw gapless scores, mate-1 rows then
    mate-2 rows; ``apd``: traced int32 scalar (the dynamic insert
    average — traced so its per-batch updates don't recompile).

    All arithmetic in int32: on valid (ok-masked) lanes every
    intermediate fits comfortably (|inner| <= MAX_PAIR_DIST, scores
    <= ~2^15, deviation*score <= ~2^30); invalid lanes may wrap but are
    masked before use. Bit-equal to the host int64 path on ok lanes."""
    s1 = gl[:Bp]
    s2 = gl[Bp:]
    # a site only CONTRIBUTES a boost when its own score is positive
    # (the reference's retained site lists never hold the deeply
    # negative padding slots of our fixed candidate table; without the
    # guard a -2851-score junk candidate 37 kbp away donates +18k
    # through the -(deviation*s)//denom sign flip). The RECIPIENT may
    # be negative — that is exactly how a bad mate is rescued into the
    # relaxed paired gate (reference: pairSiteScoresFinal boosts every
    # retained site, BBMapThread.java:846-871).
    v1 = s1 > -(2 ** 29)
    v2 = s2 > -(2 ** 29)
    c1 = s1 > 0            # may contribute to the mate's boost
    c2 = s2 > 0
    a_start = cand["start"][:Bp]
    a_stop = a_start + cand["spread"][:Bp] + (L1 - 1)
    b_start = cand["start"][Bp:]
    b_stop = b_start + cand["spread"][Bp:] + (L2 - 1)
    st1 = cand["strand"][:Bp]
    st2 = cand["strand"][Bp:]
    ch1 = jnp.searchsorted(chrom_offsets_d, a_start, side="right")
    ch2 = jnp.searchsorted(chrom_offsets_d, b_start, side="right")
    A = lambda x: x[:, :, None]
    Bx = lambda x: x[:, None, :]
    opp = A(st1) != Bx(st2)
    inner = jnp.where(A(st1) == 0, Bx(b_start) - A(a_stop),
                      A(a_start) - Bx(b_stop))
    outer = jnp.where(A(st1) == 0, Bx(b_stop) - A(a_start),
                      A(a_stop) - Bx(b_start))
    outer_limit = (max(L1, L2) * OUTER_DIST_MULT) // OUTER_DIST_DIV
    okg = (A(v1) & Bx(v2) & opp & (A(ch1) == Bx(ch2))
           & (outer >= outer_limit) & (inner <= MAX_PAIR_DIST))
    ok1 = okg & Bx(c2)     # mate-2 site donates to mate-1
    ok2 = okg & A(c1)      # mate-1 site donates to mate-2
    ok = okg               # deviation masking only needs geometry
    expected_frag = apd + (L1 + L2)
    # DEV_CAP keeps deviation*score inside int32 on ok lanes (inner is
    # only bounded by the chromosome length on the low side). For
    # positive mate scores the cap is provably value-preserving:
    # capped_term >= 12*s2 > mult*s2 >= m, so max(1, m-term) is already
    # pinned at 1 either way. (Host _pair_boost_fixed applies the same
    # cap so both paths stay bit-equal.)
    deviation = jnp.minimum(jnp.abs(apd - jnp.where(ok, inner, 0)),
                            DEV_CAP)
    mult1 = min(0.5, max(0.25, L1 / (4.0 * L2)))
    mult2 = min(0.5, max(0.25, L2 / (4.0 * L1)))
    denom = jnp.maximum(100, 10 * expected_frag + 100)
    # float multiply exactly as the host (float64 there; exact for the
    # power-of-two mults of the equal-length case), trunc toward zero
    m1 = (Bx(s2).astype(jnp.float32) * jnp.float32(mult1)).astype(I32)
    m2 = (A(s1).astype(jnp.float32) * jnp.float32(mult2)).astype(I32)
    p1 = A(s1) + 1 + jnp.maximum(1, m1 - (deviation * Bx(s2)) // denom)
    p2 = Bx(s2) + 1 + jnp.maximum(1, m2 - (deviation * A(s1)) // denom)
    neg = jnp.int32(NEG_BOOST)
    boost1 = jnp.where(ok1, p1, neg).max(axis=2)
    boost2 = jnp.where(ok2, p2, neg).max(axis=1)
    return jnp.concatenate([jnp.maximum(boost1, neg),
                            jnp.maximum(boost2, neg)], axis=0)


def fused_stage(fcfg: FusedConfig, rcodes, starts_d, sites_d, gpack_d,
                nmask_d, offsets_dyn=None, profile=None,
                scnt_d=None, _stop_after=None, pair=None, ccnt_d=None,
                weights_dyn=None, reject=None):
    """The full fused program body. rcodes: (B, L) 2-bit read codes
    (0..3, 4=N). Returns a dict of device arrays (see FusedRun.host).

    ``pair``: optional paired-mode context — rcodes is then the CONCAT
    of mate-1 and mate-2 rows (2*Bp, L) and the dict carries
    {"apd": traced int32 scalar, "chrom_offsets": device array,
    "min_gate": static int}. Pair boost (pair_boost_device) reorders
    winner selection everywhere downstream; escalation stays per-MATE
    (a mate at/above maxImperfectScore cannot be beaten by any indel
    alignment, so only sub-threshold mates ride the DP; reference:
    BBMapThread.processReadPair:943 + AbstractMapThread.java:1252)."""
    cfg = fcfg.qm
    L, G = cfg.L, cfg.G
    C = MAX_CANDIDATES
    E, T, Cn = fcfg.E, fcfg.T, fcfg.Cn
    P = cfg.profile
    if P is None:
        from ..core.constants import SHORT_PROFILE
        P = SHORT_PROFILE

    rcodes, cand = qd.candidate_stage(cfg, None, starts_d, sites_d,
                                      offsets_dyn=offsets_dyn,
                                      rcodes=rcodes, scnt_d=scnt_d,
                                      ccnt_d=ccnt_d, two_tier=True,
                                      weights_dyn=weights_dyn,
                                      reject=reject)
    hi_over = cand.pop("hi_over")
    B = rcodes.shape[0]
    if _stop_after == "cand":
        return (cand["votes"] + cand["mode"] + cand["strand"]
                + cand["start"] + cand["spread"])
    if pair is None:
        out_i32, _om, gl_scores = qd.finalize_stage(
            cfg, rcodes, cand, gpack_d, nmask_d, return_scores=True)
        boosted = gl_scores
    else:
        Bp = B // 2

        def boost_fn(scores):
            boost = pair_boost_device(scores, cand, Bp, L, L,
                                      pair["apd"],
                                      pair["chrom_offsets"])
            return jnp.maximum(scores, boost)

        out_i32, _om, gl_scores, boosted = qd.finalize_stage(
            cfg, rcodes, cand, gpack_d, nmask_d, return_scores=True,
            boost_fn=boost_fn)

    # long-indel plausibility (shipped as a meta flag so the host
    # gap-compressed pass only runs on rows that can possibly stitch a
    # wide chain — it was re-seeding EVERY unmapped row before): two
    # same-strand candidate chains whose modal diagonals differ by
    # (chain_dist, maxindel], or one chain already wider than MINGAP
    from ..core.constants import MINGAP
    dgc = cand["mode"]
    stc = cand["strand"]
    vc = cand["votes"] > 0
    sep = jnp.abs(dgc[:, :, None] - dgc[:, None, :])
    same = stc[:, :, None] == stc[:, None, :]
    okp = (vc[:, :, None] & vc[:, None, :] & same
           & (sep > cfg.chain_dist) & (sep <= fcfg.maxindel))
    li = okp.any(axis=(1, 2)) | (vc & (cand["spread"]
                                       >= MINGAP)).any(axis=1)

    # reduced meta: [best_raw, diag, strand, second(sel), n_good,
    # (eff,) li] — best_start/best_spread and the packed match block are
    # NOT shipped; the host recomputes gapless match rows from the
    # genome
    meta_cols = [out_i32[:, 0], out_i32[:, 1], out_i32[:, 2],
                 out_i32[:, 5], out_i32[:, 6]]
    if pair is not None:
        meta_cols.append(out_i32[:, N_META])       # eff
    # flags column: bit0 = long-indel plausible, bit1 = two-tier slot
    # budget overflow (whole-row exact host refit)
    meta_cols.append(li.astype(I32) | (hi_over.astype(I32) << 1))
    meta = jnp.stack(meta_cols, axis=1)
    if _stop_after == "boost":
        return meta

    # --- escalation compaction (reference: AbstractMapThread.java:1252)
    # Per-ROW also in pair mode: a mate whose raw gapless best is at or
    # above maxImperfectScore cannot be beaten by ANY indel alignment
    # (the single-path invariant), so only the sub-threshold mate needs
    # the DP — pair-OR escalation would double the DP load for nothing
    # and overflow the budget on real error rates.
    best0 = meta[:, 0]
    escalate = best0 < fcfg.max_imp
    esc_idx = _compact_indices(escalate, E)            # (E,) ascending
    esc_valid = esc_idx < BIG
    eidx = jnp.clip(esc_idx, 0, B - 1)

    # top-2 candidates by SELECTION score (raw gapless, or boosted on
    # the paired path), stable — matching the host argsort in
    # _escalate_columnar / _repick
    scs = gl_scores[eidx]                              # (E, C)
    bscs = boosted[eidx] if pair is not None else scs
    ord_all = jnp.argsort(-bscs, axis=1, stable=True)
    ordc = ord_all[:, :2]
    take2 = lambda a: jnp.take_along_axis(a[eidx], ordc, axis=1)
    g_sc = jnp.take_along_axis(scs, ordc, axis=1)
    # boost delta carried through the DP competition: eff(slot) =
    # max(gapless, dp) + (boosted - gapless)
    delta = jnp.take_along_axis(bscs, ordc, axis=1) - g_sc \
        if pair is not None else None
    diag = take2(cand["mode"])
    strand = take2(cand["strand"])
    start = take2(cand["start"])
    spread = take2(cand["spread"])
    valid_c = g_sc > -(2 ** 29)
    wstart = start - SLOW_ALIGN_PADDING
    wide_c = (spread > NARROW_SPREAD) & valid_c        # per-job wide flag

    # --- DP score jobs: (E, 2) candidates, narrow window
    rc_codes = jnp.where(rcodes <= 3, 3 - rcodes, rcodes)[:, ::-1]
    fwd_e = rcodes[eidx]
    rc_e = rc_codes[eidx]
    reads_j2 = jnp.where((strand == 0)[..., None], fwd_e[:, None, :],
                         rc_e[:, None, :])             # (E, 2, L) codes
    reads_ascii = _codes_to_read_ascii(
        reads_j2.reshape(E * 2, L))                    # (2E, L)
    wflat = wstart.reshape(E * 2).astype(I32)
    wcodes, wn = extract_ref_codes(gpack_d, nmask_d, wflat, Cn, G,
                                   has_n=cfg.has_n)
    refs_ascii = jnp.where(wn, jnp.uint8(78),
                           _codes_to_read_ascii(wcodes))
    sc_dp_flat = jax.vmap(
        lambda rd, rf: msa_jax.msa_score_single(rd, rf, L, Cn, P)[0]
    )(reads_ascii, refs_ascii)                         # (2E,)

    # --- wide-window rescore: jobs whose chain spread exceeds the
    # narrow window re-run at Cw (the unfused path's score_w class,
    # align/escalate_device.py SCORE_CHUNKS_W) under a small budget
    W = fcfg.W
    Cw = fcfg.Cw
    wide_flat = wide_c.reshape(E * 2)
    wloc = _compact_indices(wide_flat, W)              # job indices
    w_ok = wloc < BIG
    wl = jnp.clip(wloc, 0, E * 2 - 1)
    wwc, wwn = extract_ref_codes(gpack_d, nmask_d, wflat[wl], Cw, G,
                                 has_n=cfg.has_n)
    wrefs = jnp.where(wwn, jnp.uint8(78), _codes_to_read_ascii(wwc))
    wsc = jax.vmap(
        lambda rd, rf: msa_jax.msa_score_single(rd, rf, L, Cw, P)[0]
    )(reads_ascii[wl], wrefs)
    # padded budget entries scatter into a trash slot (index 2E), never
    # a real job (duplicate-index scatters are order-unspecified)
    wl_s = jnp.where(w_ok, wl, E * 2)
    sc_dp_flat = jnp.concatenate(
        [sc_dp_flat, jnp.zeros((1,), sc_dp_flat.dtype)]
    ).at[wl_s].set(wsc)[:E * 2]
    covered = jnp.zeros(E * 2 + 1, bool).at[wl_s].set(
        True)[:E * 2]
    wide_over = (wide_flat & ~covered).reshape(E, 2).any(axis=1)
    sc_dp = jnp.where(valid_c, sc_dp_flat.reshape(E, 2), -(2 ** 30))
    if _stop_after == "score":
        return sc_dp

    # --- selection (mirrors _escalate_columnar host math exactly)
    eff = jnp.maximum(g_sc, sc_dp)
    if delta is not None:
        eff = eff + delta                              # boost carry-over
    w0 = jnp.where(eff[:, 1] > eff[:, 0], 1, 0)        # ties -> slot 0
    ar = jnp.arange(E)
    best_e = eff[ar, w0]
    second_e = eff[ar, 1 - w0]
    rest = jnp.take_along_axis(bscs, ord_all[:, 2:], axis=1)
    rest_best = rest.max(axis=1) if rest.shape[1] else \
        jnp.full(E, -(2 ** 30), I32)
    second_full = jnp.maximum(second_e, rest_best)
    min_gate = fcfg.min_score if pair is None else pair["min_gate"]
    n_sites = ((eff >= min_gate).sum(axis=1)
               + (rest >= min_gate).sum(axis=1)).astype(I32)
    wdiag = diag[ar, w0]
    wstrand = strand[ar, w0]
    wws = wstart[ar, w0]
    g_w = g_sc[ar, w0]
    dp_w = sc_dp[ar, w0]
    mapped_e = best_e >= min_gate
    if _stop_after == "select":
        return best_e + second_full + n_sites + wdiag + wstrand + wws

    # (winner gapless match rows are recomputed on the host from the
    # genome)
    if _stop_after == "wmatch":
        return wdiag[:, None]

    # --- trace compaction + fill/traceback (narrow window)
    wide_w = wide_c[ar, w0]                            # winner job wide
    needs_trace = (mapped_e & (dp_w > g_w) & esc_valid)
    tloc = _compact_indices(needs_trace, T)            # rows into esc block
    t_valid = tloc < BIG
    tl = jnp.clip(tloc, 0, E - 1)
    treads = _codes_to_read_ascii(reads_j2[tl, w0[tl]])
    tws = wws[tl].astype(I32)
    twcodes, twn = extract_ref_codes(gpack_d, nmask_d, tws, Cn, G,
                                     has_n=cfg.has_n)
    trefs = jnp.where(twn, jnp.uint8(78), _codes_to_read_ascii(twcodes))
    sym, ln, gaps, sc2, col, _st = jax.vmap(
        lambda rd, rf: msa_jax._align_single(rd, rf, L, Cn, P=P)
    )(treads, trefs)                                   # sym (T, L+Cn)
    if _stop_after == "trace":
        return sym[:, :4] + sc2[:, None].astype(jnp.uint8)

    # --- wide/retry traceback (Cw window): winner jobs that are wide
    # re-trace at full width (the unfused trace_w class); narrow traces
    # clipped at the window edge re-trace with the re-pad shift
    # (pipeline._apply_traces retry semantics)
    RT = fcfg.RT
    twide = wide_w[tl]
    first = jnp.take_along_axis(
        sym, jnp.maximum(ln - 1, 0)[:, None].astype(I32), axis=1)[:, 0]
    last = sym[:, 0]
    clip_l = (first == ord("I")) | (first == ord("X"))
    clip_r = (last == ord("I")) | (last == ord("Y"))
    clipped = (clip_l | clip_r) & ~twide
    rneed = t_valid & (clipped | twide)
    rloc = _compact_indices(rneed, RT)                 # rows into trace blk
    r_ok = rloc < BIG
    rtl = jnp.clip(rloc, 0, T - 1)
    rws = jnp.where(twide[rtl], tws[rtl],
                    tws[rtl] - jnp.where(clip_l[rtl], RETRY_EXTRA, 0))
    rwc, rwn = extract_ref_codes(gpack_d, nmask_d, rws, Cw, G,
                                 has_n=cfg.has_n)
    rrefs = jnp.where(rwn, jnp.uint8(78), _codes_to_read_ascii(rwc))
    sym_w, ln_w, gaps_w, sc2_w, col_w, _stw = jax.vmap(
        lambda rd, rf: msa_jax._align_single(rd, rf, L, Cw, P=P)
    )(treads[rtl], rrefs)                              # (RT, L+Cw)
    if _stop_after == "retrace":
        return (sym_w[:, :4] + sc2_w[:, None].astype(jnp.uint8)
                + sym[:64, :4])
    # merge scalar results back (trash-slot scatter for padded entries)
    rtl_s = jnp.where(r_ok, rtl, T)

    def merge(base, upd):
        ext = jnp.concatenate([base, jnp.zeros((1,), base.dtype)])
        return ext.at[rtl_s].set(upd.astype(base.dtype))[:T]

    ln = merge(ln.astype(I32), ln_w)
    gaps = merge(gaps.astype(I32), gaps_w)
    sc2 = merge(sc2.astype(I32), sc2_w.astype(I32))
    col = merge(col.astype(I32), col_w)
    tws_final = merge(tws, rws)
    retried = jnp.zeros(T + 1, bool).at[rtl_s].set(True)[:T]
    # wide winners whose re-trace fell off the RT budget can't use the
    # narrow trace -> whole-row host fallback
    runsat = rneed & ~retried
    wide_trace_over = jnp.zeros(E + 1, bool).at[
        jnp.where(t_valid & runsat & twide, tl, E)].set(True)[:E]
    row_fallback = wide_over | wide_trace_over

    def pack_syms(s):
        n, w = s.shape
        w2 = (w + 1) // 2
        sc_ = _sym_to_code(s)
        spad_ = jnp.concatenate(
            [sc_, jnp.zeros((n, w2 * 2 - w), jnp.uint8)], axis=1)
        sp = spad_.reshape(n, w2, 2).astype(jnp.uint32)
        return (sp[:, :, 0] | (sp[:, :, 1] << 4)).astype(jnp.uint8)

    sym_packed = pack_syms(sym)                        # (T, ceil((L+Cn)/2))
    sym_w_packed = pack_syms(sym_w)                    # (RT, ceil((L+Cw)/2))

    raweff = jnp.maximum(g_w, dp_w).astype(I32)
    dp_beat = (dp_w > g_w).astype(I32)
    packed = ((jnp.clip(n_sites, 0, 2 ** 22) << 8)
              | (wstrand.astype(I32) << 2) | (dp_beat << 1)
              | row_fallback.astype(I32))
    esc_i32 = jnp.stack([
        esc_idx, best_e.astype(I32), second_full.astype(I32),
        wdiag, raweff, packed], axis=1)                # (E, 6)
    trace_i32 = jnp.stack([
        tloc, ln, gaps, sc2, col, tws_final,
        retried.astype(I32)], axis=1)                  # (T, 7)
    retry_i32 = jnp.stack([rloc], axis=1)              # (RT, 1)
    # ONE flat int32 output buffer: one host fetch per batch instead of
    # six
    return _pack_outputs(meta, esc_i32, trace_i32, sym_packed,
                         retry_i32, sym_w_packed)


def _u8_rows_to_i32(a):
    """(n, w) uint8 -> (n, ceil(w/4)) int32, 4 bytes per word in minor
    order (host inverse: .view(np.uint8) on the row-major array)."""
    n, w = a.shape
    wp = -(-w // 4) * 4
    if wp != w:
        a = jnp.concatenate(
            [a, jnp.zeros((n, wp - w), jnp.uint8)], axis=1)
    return jax.lax.bitcast_convert_type(
        a.reshape(n, wp // 4, 4), jnp.int32)


def _pack_outputs(meta, esc_i32, trace_i32, sym_packed, retry_i32,
                  sym_w_packed):
    parts = [meta.reshape(-1), esc_i32.reshape(-1),
             trace_i32.reshape(-1),
             _u8_rows_to_i32(sym_packed).reshape(-1),
             retry_i32.reshape(-1),
             _u8_rows_to_i32(sym_w_packed).reshape(-1)]
    return jnp.concatenate(parts)


ESC_COLS = ("idx", "best", "second", "wdiag", "raweff", "packed")
TRACE_COLS = ("tloc", "ln", "gaps", "sc2", "col", "tws", "retried")


class FusedRun:
    """In-flight fused dispatch; .host() blocks and unpacks. Match rows
    are NOT shipped — the host recomputes winner gapless match rows from
    the genome. The device ships ONE flat int32 blob (see _pack_outputs);
    .host() slices it apart."""

    def __init__(self, outs, L: int, Cn: int, Cw: int,
                 pair: bool = False,
                 fcfg: Optional[FusedConfig] = None, B: int = 0):
        self._outs = outs
        self._L = L
        self._Cn = Cn
        self._Cw = Cw
        self._pair = pair
        self._fcfg = fcfg
        self._B = B
        try:
            outs.copy_to_host_async()
        except Exception:
            pass

    def _unpack(self):
        blob = np.asarray(self._outs)
        fcfg = self._fcfg
        B, E, T, RT = self._B, fcfg.E, fcfg.T, fcfg.RT
        mw = 7 if self._pair else 6
        w2n = (self._L + self._Cn + 1) // 2
        w2w = (self._L + self._Cw + 1) // 2
        w4n = -(-w2n // 4)
        w4w = -(-w2w // 4)
        sizes = (B * mw, E * 6, T * 7, T * w4n, RT, RT * w4w)
        off = np.cumsum((0,) + sizes)
        cut = lambda j: blob[off[j]:off[j + 1]]
        meta = cut(0).reshape(B, mw)
        esc_i32 = cut(1).reshape(E, 6)
        trace_i32 = cut(2).reshape(T, 7)
        sym_packed = np.ascontiguousarray(
            cut(3).reshape(T, w4n)).view(np.uint8)[:, :w2n]
        retry_i32 = cut(4).reshape(RT, 1)
        sym_w_packed = np.ascontiguousarray(
            cut(5).reshape(RT, w4w)).view(np.uint8)[:, :w2w]
        return (meta, esc_i32, trace_i32, sym_packed, retry_i32,
                sym_w_packed)

    def host(self) -> Dict[str, np.ndarray]:
        (meta, esc_i32, trace_i32, sym_packed, retry_i32,
         sym_w_packed) = self._unpack()
        L = self._L
        d = {
            "best_score": meta[:, 0],
            "best_diag": meta[:, 1],
            "best_strand": meta[:, 2],
            "second_score": meta[:, 3],
            "n_good": meta[:, 4],
        }
        flags = meta[:, 6] if self._pair else meta[:, 5]
        if self._pair:
            d["eff"] = meta[:, 5]            # boosted winner score
        d["li_plaus"] = (flags & 1).astype(bool)
        d["hi_over"] = ((flags >> 1) & 1).astype(bool)
        esc = {k: esc_i32[:, i] for i, k in enumerate(ESC_COLS)}
        pk = esc.pop("packed")
        esc["n_sites"] = pk >> 8
        esc["wstrand"] = (pk >> 2) & 1
        esc["dp_beat"] = ((pk >> 1) & 1).astype(bool)
        esc["fb"] = (pk & 1).astype(bool)
        tr = {k: trace_i32[:, i] for i, k in enumerate(TRACE_COLS)}
        T = trace_i32.shape[0]
        sym = np.zeros((T, L + self._Cw), np.uint8)
        wn = L + self._Cn
        sym[:, :wn] = _SYM_UNPACK[sym_packed].reshape(
            T, -1)[:, :wn]
        rloc = retry_i32[:, 0]
        r_ok = rloc < 2 ** 30
        if r_ok.any():
            sym_w = _SYM_UNPACK[sym_w_packed].reshape(
                sym_w_packed.shape[0], -1)[:, :L + self._Cw]
            sym[rloc[r_ok]] = sym_w[r_ok]
        tr["sym"] = sym
        d["_esc"] = esc
        d["_trace"] = tr
        return d


def build_fused(index: KmerIndex, L: int, B: int, chain_dist: int = 400,
                min_ratio: float = 0.56,
                max_list_length: Optional[int] = None, profile=None):
    """Returns fused(bases_ascii (B, L), quality=None) -> FusedRun."""
    fcfg = make_fused_config(index, L, B, chain_dist, min_ratio,
                             max_list_length, profile)
    cfg = fcfg.qm
    starts_d, sites_d, gpack_d, nmask_d, _G = device_arrays(index)
    from .quickmap_device import ccnt_array, scnt_array
    scnt_d = scnt_array(index)
    ccnt_d = ccnt_array(index) if cfg.ref_admit else None
    from . import seed as seed_host
    den2, den3 = seed_host.key_density_ladder(L, index.k)

    def prog(codes2, nmask, starts_d, sites_d, gpack_d, nmask_d,
             scnt_d, ccnt_d):
        rcodes = unpack_reads_device(codes2, nmask, L)
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, scnt_d=scnt_d, ccnt_d=ccnt_d)

    def prog_q(codes2, nmask, qual, starts_d, sites_d, gpack_d, nmask_d,
               scnt_d, ccnt_d):
        rcodes = unpack_reads_device(codes2, nmask, L)
        offs, wts, rej = quality_offsets_stage(cfg, qual, den2, den3,
                                               return_weights=True)
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, offsets_dyn=offs, scnt_d=scnt_d,
                           ccnt_d=ccnt_d, weights_dyn=wts, reject=rej)

    def prog_q4(codes2, nmask, qpack, pal, pcpal, starts_d, sites_d,
                gpack_d, nmask_d, scnt_d, ccnt_d):
        from .quickmap_device import quality_offsets_stage_packed
        rcodes = unpack_reads_device(codes2, nmask, L)
        offs, wts, rej = quality_offsets_stage_packed(
            cfg, qpack, pal, pcpal, den2, den3, return_weights=True)
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, offsets_dyn=offs, scnt_d=scnt_d,
                           ccnt_d=ccnt_d, weights_dyn=wts, reject=rej)

    inv_a = np.float32(1.0) / np.float32(100 * index.k)   # IEEE, on host

    def prog_qh(codes2, nmask, offs16, sc16, rej8, starts_d, sites_d,
                gpack_d, nmask_d, scnt_d, ccnt_d):
        # host-computed quality offsets + Solver key scores
        # (csrc quality_offsets_scores, bit-identical to the device
        # stage) — skips the whole on-device quality stage and ships
        # 4 B/key instead of the quality rows
        rcodes = unpack_reads_device(codes2, nmask, L)
        offs = offs16.astype(jnp.int32)
        wts = sc16.astype(jnp.float32) * inv_a
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, offsets_dyn=offs, scnt_d=scnt_d,
                           ccnt_d=ccnt_d, weights_dyn=wts,
                           reject=rej8.astype(bool))

    jitted = jax.jit(prog)
    jitted_q = jax.jit(prog_q)
    jitted_q4 = jax.jit(prog_q4)
    jitted_qh = jax.jit(prog_qh)
    ladder_np = np.asarray(cfg.offsets_list, np.int32)

    def run(bases, quality=None) -> FusedRun:
        from ..io import native
        from .quickmap_device import pack_quality_host
        from .seed import PROB_CORRECT
        codes2, nm = pack_reads_host(np.ascontiguousarray(bases[:, :L]))
        if quality is None:
            outs = jitted(codes2, nm, starts_d, sites_d, gpack_d,
                          nmask_d, scnt_d, ccnt_d)
        else:
            host_os = native.quality_offsets_scores(
                quality, L, index.k, PROB_CORRECT, ladder_np, den3,
                100 * index.k)
            if host_os is not None:
                o16, s16, rej = host_os
                outs = jitted_qh(codes2, nm, o16, s16,
                                 rej.astype(np.uint8), starts_d,
                                 sites_d, gpack_d, nmask_d, scnt_d,
                                 ccnt_d)
            else:
                qpack, pal, pcp = pack_quality_host(quality, L)
                if qpack is not None:
                    outs = jitted_q4(codes2, nm, qpack, pal, pcp,
                                     starts_d, sites_d, gpack_d,
                                     nmask_d, scnt_d, ccnt_d)
                else:
                    outs = jitted_q(codes2, nm, quality[:, :L],
                                    starts_d, sites_d, gpack_d,
                                    nmask_d, scnt_d, ccnt_d)
        return FusedRun(outs, L, fcfg.Cn, fcfg.Cw, fcfg=fcfg, B=B)

    run.fcfg = fcfg
    return run


def paired_min_gate(profile, L: int, min_ratio: float) -> int:
    """The relaxed paired-site retention score (reference:
    AbstractMapThread.java:106 removeLowQualitySitesPaired; host mirror
    in pipeline._direct_select)."""
    ratio_paired = max(min_ratio * 0.80, 1 - (1 - min_ratio) * 1.4)
    return int(profile.max_quality(L) * ratio_paired)


def build_fused_pair(index: KmerIndex, L: int, Bp: int,
                     chrom_offsets: np.ndarray, chain_dist: int = 400,
                     min_ratio: float = 0.56,
                     max_list_length: Optional[int] = None,
                     profile=None):
    """Paired single-dispatch mapping: both mates' candidates, the pair
    boost, DP escalation of boosted winners, and traceback in ONE device
    program (reference: BBMapThread.processReadPair:943 —
    quickMap x2 -> pairSiteScoresFinal -> scoreSlow -> traceback).
    Mate rescue runs as a separate small program (ops/rescue_device)
    because its job set depends on host-side mapping decisions.

    Returns run(bases1, bases2, apd, quality1=None, quality2=None)
    -> FusedRun over the 2*Bp concatenated rows (mate-1 rows then
    mate-2 rows). ``apd`` is the dynamic average insert distance
    (traced scalar — updates never recompile)."""
    fcfg = make_fused_config(index, L, 2 * Bp, chain_dist, min_ratio,
                             max_list_length, profile)
    cfg = fcfg.qm
    if profile is None:
        from ..core.constants import SHORT_PROFILE
        profile = SHORT_PROFILE
    min_gate = paired_min_gate(profile, L, min_ratio)
    starts_d, sites_d, gpack_d, nmask_d, _G = device_arrays(index)
    from .quickmap_device import ccnt_array, scnt_array
    scnt_d = scnt_array(index)
    ccnt_d = ccnt_array(index) if cfg.ref_admit else None
    choff_d = jax.device_put(np.asarray(chrom_offsets, np.int32))
    from . import seed as seed_host
    den2, den3 = seed_host.key_density_ladder(L, index.k)

    def prog(c2a, nma, c2b, nmb, apd, starts_d, sites_d, gpack_d,
             nmask_d, scnt_d, ccnt_d, choff_d):
        r1 = unpack_reads_device(c2a, nma, L)
        r2 = unpack_reads_device(c2b, nmb, L)
        rcodes = jnp.concatenate([r1, r2], axis=0)
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, scnt_d=scnt_d, ccnt_d=ccnt_d,
                           pair={"apd": apd, "chrom_offsets": choff_d,
                                 "min_gate": min_gate})

    def prog_q(c2a, nma, q1, c2b, nmb, q2, apd, starts_d, sites_d,
               gpack_d, nmask_d, scnt_d, ccnt_d, choff_d):
        r1 = unpack_reads_device(c2a, nma, L)
        r2 = unpack_reads_device(c2b, nmb, L)
        rcodes = jnp.concatenate([r1, r2], axis=0)
        qual = jnp.concatenate([q1, q2], axis=0)
        offs, wts, rej = quality_offsets_stage(cfg, qual, den2, den3,
                                               return_weights=True)
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, offsets_dyn=offs, scnt_d=scnt_d,
                           ccnt_d=ccnt_d, weights_dyn=wts, reject=rej,
                           pair={"apd": apd, "chrom_offsets": choff_d,
                                 "min_gate": min_gate})

    def prog_q4(c2a, nma, c2b, nmb, qpack, pal, pcpal, apd, starts_d,
                sites_d, gpack_d, nmask_d, scnt_d, ccnt_d, choff_d):
        from .quickmap_device import quality_offsets_stage_packed
        r1 = unpack_reads_device(c2a, nma, L)
        r2 = unpack_reads_device(c2b, nmb, L)
        rcodes = jnp.concatenate([r1, r2], axis=0)
        offs, wts, rej = quality_offsets_stage_packed(
            cfg, qpack, pal, pcpal, den2, den3, return_weights=True)
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, offsets_dyn=offs, scnt_d=scnt_d,
                           ccnt_d=ccnt_d, weights_dyn=wts, reject=rej,
                           pair={"apd": apd, "chrom_offsets": choff_d,
                                 "min_gate": min_gate})

    inv_a = np.float32(1.0) / np.float32(100 * index.k)   # IEEE, on host

    def prog_qh(c2a, nma, c2b, nmb, offs16, sc16, rej8, apd, starts_d,
                sites_d, gpack_d, nmask_d, scnt_d, ccnt_d, choff_d):
        # host-computed quality offsets + key scores (csrc
        # quality_offsets_scores; concatenated over both mates)
        r1 = unpack_reads_device(c2a, nma, L)
        r2 = unpack_reads_device(c2b, nmb, L)
        rcodes = jnp.concatenate([r1, r2], axis=0)
        offs = offs16.astype(jnp.int32)
        wts = sc16.astype(jnp.float32) * inv_a
        return fused_stage(fcfg, rcodes, starts_d, sites_d, gpack_d,
                           nmask_d, offsets_dyn=offs, scnt_d=scnt_d,
                           ccnt_d=ccnt_d, weights_dyn=wts,
                           reject=rej8.astype(bool),
                           pair={"apd": apd, "chrom_offsets": choff_d,
                                 "min_gate": min_gate})

    jitted = jax.jit(prog)
    jitted_q = jax.jit(prog_q)
    jitted_q4 = jax.jit(prog_q4)
    jitted_qh = jax.jit(prog_qh)
    ladder_np = np.asarray(cfg.offsets_list, np.int32)

    def prepare(bases1, bases2, apd: int, quality1=None, quality2=None):
        """The jitted program variant this batch takes and its
        arguments: ``fn(*args)`` dispatches it, ``fn.lower(*args)``
        compiles it ahead of time."""
        from ..io import native
        from .quickmap_device import pack_quality_host
        from .seed import PROB_CORRECT
        c2a, nma = pack_reads_host(np.ascontiguousarray(bases1[:, :L]))
        c2b, nmb = pack_reads_host(np.ascontiguousarray(bases2[:, :L]))
        apd32 = np.int32(apd)
        dev = (starts_d, sites_d, gpack_d, nmask_d, scnt_d, ccnt_d,
               choff_d)
        if quality1 is None:
            return jitted, (c2a, nma, c2b, nmb, apd32) + dev
        qcat = np.vstack([quality1[:, :L], quality2[:, :L]])
        host_os = native.quality_offsets_scores(
            qcat, L, index.k, PROB_CORRECT, ladder_np, den3,
            100 * index.k)
        if host_os is not None:
            o16, s16, rej = host_os
            return jitted_qh, (c2a, nma, c2b, nmb, o16, s16,
                               rej.astype(np.uint8), apd32) + dev
        # one palette across both mates; the program consumes the
        # concatenated (2*Bp, W8) pack
        qpack, pal, pcp = pack_quality_host(qcat, L)
        if qpack is not None:
            return jitted_q4, (c2a, nma, c2b, nmb, qpack, pal, pcp,
                               apd32) + dev
        return jitted_q, (c2a, nma, quality1[:, :L], c2b, nmb,
                          quality2[:, :L], apd32) + dev

    def run(bases1, bases2, apd: int, quality1=None, quality2=None
            ) -> FusedRun:
        fn, args = prepare(bases1, bases2, apd, quality1, quality2)
        return FusedRun(fn(*args), L, fcfg.Cn, fcfg.Cw, pair=True,
                        fcfg=fcfg, B=2 * Bp)

    run.prepare = prepare
    run.fcfg = fcfg
    run.min_gate = min_gate
    return run
