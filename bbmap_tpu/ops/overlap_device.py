"""Device pair-overlap scan for BBMerge — the all-insert-sizes ×
mismatch reduction run as ONE jitted program per pair batch
(reference: jni/BBMergeOverlapper.c:389-489 mateByOverlapJNI*,
jgi/BBMergeOverlapper.java:52-102; VERDICT r2 missing #2).

The structure is a natural ``lax.scan``: the candidate ladder is
sequential over insert sizes with vectorized decision state across the
pair batch — each scan step dynamic-slices the aligned suffix/prefix
windows, reduces good/bad counts on the VPU, and advances the
best/second/ambig/done carry exactly as the host ladder
(ops/overlap.py, the reference implementation) does.

Numerics: ratio arithmetic is float32 on both paths (the reference
computes ratios in Java floats). The mismatch mode's quality gate
(``aprob*bprob > minprob``) is evaluated through a host-precomputed
128x128 boolean table so the device never re-derives float64 products —
bit-exact parity with the host path (tests/test_overlap_device.py).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .overlap import PROB_CORRECT

_N = ord("N")


def _enabled() -> bool:
    env = os.environ.get("BBMAP_DEVICE_OVERLAP")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "f", "no",
                                           "off", "")
    import jax
    return jax.default_backend() != "cpu"


# ---------------------------------------------------------------------------
# ratio mode (the reference default)
# ---------------------------------------------------------------------------

def _ratio_tables(alen: int, blen: int, min_overlap0: int,
                  min_overlap: int, min_insert0: int, min_insert: int):
    """Static per-insert geometry, mirroring the host loop exactly."""
    min_overlap = max(4, min_overlap0, min_overlap)
    min_overlap0 = int(np.clip(min_overlap0, 4, min_overlap))
    largest = alen + blen - min_overlap0
    smallest = min_insert0
    inserts = np.arange(largest, smallest - 1, -1, dtype=np.int32)
    istart = np.where(inserts <= blen, 0, inserts - blen)
    jstart = np.where(inserts >= blen, 0, blen - inserts)
    olen = np.minimum(np.minimum(alen - istart, blen - jstart), inserts)
    fb = (min_insert <= inserts) & (inserts <= alen + blen - min_overlap)
    return (inserts, istart.astype(np.int32), jstart.astype(np.int32),
            olen.astype(np.int32), fb, min_overlap, min_overlap0)


def _ratio_program(a, b, xs, maxol: int, alen: int, blen: int,
                   min_overlap: int, min_overlap0: int,
                   max_ratio: float, min_second_ratio: float,
                   margin: float, offset: float,
                   g_incr: float, b_incr: float):
    import jax
    import jax.numpy as jnp
    F32 = jnp.float32
    I32 = jnp.int32
    B = a.shape[0]
    min_length = min(alen, blen)
    margin2 = F32((margin + offset) / min_length)
    off32 = F32(offset)
    lane = jnp.arange(maxol, dtype=I32)
    # pad so dynamic_slice windows never clamp at the right edge (a
    # clamped start silently shifts the window — masked lanes keep the
    # pad bytes out of the counts)
    a = jnp.pad(a, ((0, 0), (0, maxol)))
    b = jnp.pad(b, ((0, 0), (0, maxol)))

    def counts(carry, x):
        insert, ist, jst, ol, fb = x
        ai = jax.lax.dynamic_slice_in_dim(a, ist, maxol, axis=1)
        bj = jax.lax.dynamic_slice_in_dim(b, jst, maxol, axis=1)
        m = lane < ol
        eq = (ai == bj) & m
        nn = (ai != _N) & m
        good = (eq & nn).sum(axis=1).astype(F32) * F32(g_incr)
        bad = ((~eq) & m).sum(axis=1).astype(F32) * F32(b_incr)
        valid = ol > 0
        ratio = jnp.where(
            valid, (bad + off32) / jnp.maximum(ol, 1).astype(F32),
            F32(np.inf))
        fbr = jnp.where(fb & valid, ratio, F32(np.inf))
        return jnp.minimum(carry, fbr), (good, bad, ratio, valid)

    x0 = jnp.full((B,), np.inf, F32)
    x, (goods, bads, ratios, valids) = jax.lax.scan(counts, x0, xs)
    x = jnp.minimum(x, F32(max_ratio + 0.0001))
    no_solution = x > F32(max_ratio)
    max_ratio_v = jnp.minimum(F32(max_ratio), x)

    def ladder(carry, xl):
        (best_insert, best_bad, best_ratio, second_ratio, ambig, done,
         early_neg) = carry
        insert, olen_f, good, bad, ratio, valid = xl
        badlimit = F32(1.2) * (jnp.minimum(best_ratio, max_ratio_v)
                               * F32(margin) * olen_f) + F32(1.0)
        active = (~done) & valid
        cond0 = active & (bad <= badlimit)
        e1 = cond0 & (bad == 0) & (good > min_overlap0) \
            & (good < min_overlap)
        ambig = jnp.where(e1, True, ambig)
        early_neg = early_neg | e1
        done = done | e1
        c2 = cond0 & (~e1) & (ratio < best_ratio * F32(margin))
        new_ambig = (ratio * F32(margin) >= best_ratio) \
            | (good < min_overlap)
        ambig = jnp.where(c2, new_ambig, ambig)
        improve = c2 & (ratio < best_ratio)
        second_ratio = jnp.where(improve, best_ratio, second_ratio)
        best_insert = jnp.where(improve, insert, best_insert)
        best_bad = jnp.where(improve, bad, best_bad)
        best_ratio = jnp.where(improve, ratio, best_ratio)
        tie2 = c2 & (~improve) & (ratio < second_ratio)
        second_ratio = jnp.where(tie2, ratio, second_ratio)
        f = c2 & ((ambig & (best_ratio < margin2))
                  | (second_ratio < F32(min_second_ratio)))
        early_neg = early_neg | f
        done = done | f
        return (best_insert, best_bad, best_ratio, second_ratio, ambig,
                done, early_neg), None

    carry0 = (jnp.full((B,), -1, I32),
              jnp.full((B,), float(min_length), F32),
              jnp.ones((B,), F32), jnp.ones((B,), F32),
              jnp.zeros((B,), bool), no_solution, no_solution)
    olen_f = xs[3].astype(F32)
    (best_insert, best_bad, best_ratio, second_ratio, ambig, done,
     early_neg), _ = jax.lax.scan(
        ladder, carry0, (xs[0], olen_f, goods, bads, ratios, valids))
    final_neg = early_neg | ((~ambig) & (best_ratio > max_ratio_v))
    insert_out = jnp.where(final_neg, -1, best_insert).astype(I32)
    return insert_out, best_bad.astype(I32), ambig


_RATIO_CACHE = {}


def mate_by_overlap_ratio_device(
        a_bases: np.ndarray, b_bases: np.ndarray,
        min_overlap0: int = 5, min_overlap: int = 8,
        min_insert0: int = 26, min_insert: int = 35,
        max_ratio: float = 0.09, min_second_ratio: float = 0.1,
        margin: float = 5.5, offset: float = 0.55,
        g_incr: float = 0.95, b_incr: float = 0.95
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device twin of overlap.mate_by_overlap_ratio_batch."""
    import jax
    import jax.numpy as jnp
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    (inserts, istart, jstart, olen, fb, mo, mo0) = _ratio_tables(
        alen, blen, min_overlap0, min_overlap, min_insert0, min_insert)
    maxol = int(olen.max()) if len(olen) else 0
    if maxol <= 0:
        return (np.full(B, -1, np.int32),
                np.full(B, min(alen, blen), np.int32),
                np.zeros(B, bool))
    key = (B, alen, blen, mo, mo0, min_insert0, min_insert,
           round(max_ratio, 6), round(min_second_ratio, 6),
           round(margin, 6), round(offset, 6), round(g_incr, 6),
           round(b_incr, 6))
    prog = _RATIO_CACHE.get(key)
    if prog is None:
        def f(a, b, xs):
            return _ratio_program(a, b, xs, maxol, alen, blen, mo, mo0,
                                  max_ratio, min_second_ratio, margin,
                                  offset, g_incr, b_incr)
        prog = jax.jit(f)
        _RATIO_CACHE[key] = prog
    xs = (jnp.asarray(inserts), jnp.asarray(istart),
          jnp.asarray(jstart), jnp.asarray(olen), jnp.asarray(fb))
    out = prog(np.ascontiguousarray(a_bases),
               np.ascontiguousarray(b_bases), xs)
    ins, bad, amb = (np.asarray(o) for o in out)
    return ins, bad, amb


# ---------------------------------------------------------------------------
# mismatch mode
# ---------------------------------------------------------------------------

_MM_CACHE = {}


def _counted_table(minq: int) -> np.ndarray:
    """(16384,) bool: PROB_CORRECT[qa]*PROB_CORRECT[qb] > minprob,
    evaluated host-side in float64 so the device matches the host gate
    bit for bit."""
    minprob = PROB_CORRECT[min(max(1, minq), 41)]
    p = PROB_CORRECT
    return ((p[:, None] * p[None, :]) > minprob).ravel()


def _mm_program(a, b, aq, bq, tbl, xs, maxol: int, alen: int,
                blen: int, min_overlap: int, margin: int,
                max_mismatches0: int, max_mismatches: int,
                have_q: bool, minq: int):
    import jax
    import jax.numpy as jnp

    from ..align.quickmap_device import take_flat
    I32 = jnp.int32
    B = a.shape[0]
    lane = jnp.arange(maxol, dtype=I32)
    const_counted = (0.98 * 0.98) > PROB_CORRECT[min(max(1, minq), 41)]
    a = jnp.pad(a, ((0, 0), (0, maxol)))
    b = jnp.pad(b, ((0, 0), (0, maxol)))
    if have_q:
        aq = jnp.pad(aq, ((0, 0), (0, maxol)))
        bq = jnp.pad(bq, ((0, 0), (0, maxol)))

    def step(carry, x):
        (best_overlap, best_good, best_bad, ambig, done,
         early_ret) = carry
        overlap, ist, jst, iters = x
        aj = jax.lax.dynamic_slice_in_dim(a, jst, maxol, axis=1)
        bi = jax.lax.dynamic_slice_in_dim(b, ist, maxol, axis=1)
        m = lane < iters
        if have_q:
            qa = jax.lax.dynamic_slice_in_dim(aq, jst, maxol, axis=1)
            qb = jax.lax.dynamic_slice_in_dim(bq, ist, maxol, axis=1)
            qi = jnp.clip(qa.astype(I32), 0, 127) * 128 \
                + jnp.clip(qb.astype(I32), 0, 127)
            counted = take_flat(tbl, qi) & m
        else:
            counted = m if const_counted else jnp.zeros_like(m)
        eq = aj == bi
        good = (counted & eq).sum(axis=1).astype(I32)
        bad = (counted & (~eq)).sum(axis=1).astype(I32)
        valid = iters > 0

        active = (~done) & valid
        cand = active & (bad * 2 < good)
        c1 = cand & (good > min_overlap) & (bad <= best_bad)
        winner = c1 & ((bad < best_bad)
                       | ((bad == best_bad) & (good > best_good)))
        ambig = ambig | (winner & (best_bad - bad < margin))
        tie = c1 & (~winner) & (bad == best_bad)
        ambig = ambig | tie
        best_overlap = jnp.where(winner, overlap, best_overlap)
        best_good = jnp.where(winner, good, best_good)
        best_bad = jnp.where(winner, bad, best_bad)
        f = c1 & ambig & (best_bad < margin)
        early_ret = early_ret | f
        done = done | f
        g = cand & (~(good > min_overlap)) & (bad < margin)
        ambig = ambig | g
        early_ret = early_ret | g
        done = done | g
        return (best_overlap, best_good, best_bad, ambig, done,
                early_ret), None

    carry0 = (jnp.full((B,), -1, I32), jnp.full((B,), -1, I32),
              jnp.full((B,), max_mismatches0, I32),
              jnp.zeros((B,), bool), jnp.zeros((B,), bool),
              jnp.zeros((B,), bool))
    (best_overlap, best_good, best_bad, ambig, done, early_ret), _ = \
        jax.lax.scan(step, carry0, xs)
    no_sln = (~ambig) & (best_bad > max_mismatches - margin)
    best_overlap = jnp.where(no_sln | early_ret, -1, best_overlap)
    insert = jnp.where(best_overlap < 0, -1,
                       alen + blen - best_overlap).astype(I32)
    return insert, best_bad, ambig


def mate_by_overlap_device(
        a_bases: np.ndarray, a_qual: Optional[np.ndarray],
        b_bases: np.ndarray, b_qual: Optional[np.ndarray],
        min_overlap0: int = 8, min_overlap: int = 11,
        min_insert0: int = 35, margin: int = 2,
        max_mismatches0: int = 3, max_mismatches: int = 3,
        minq: int = 10) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device twin of overlap.mate_by_overlap_batch."""
    import jax
    import jax.numpy as jnp
    B, alen = a_bases.shape
    blen = b_bases.shape[1]
    min_overlap0 = min(max(1, min_overlap0), min_overlap)
    margin = max(margin, 0)
    max_overlap = alen + blen - max(min_overlap, min_insert0)
    ovr = np.arange(max(min_overlap0, 0), max_overlap, dtype=np.int32)
    istart = np.where(ovr <= alen, 0, ovr - alen).astype(np.int32)
    jstart = np.where(ovr <= alen, alen - ovr, 0).astype(np.int32)
    iters = np.minimum(np.minimum(ovr - istart, blen - istart),
                       alen - jstart).astype(np.int32)
    keep = iters > 0
    ovr, istart, jstart, iters = (x[keep] for x in
                                  (ovr, istart, jstart, iters))
    maxol = int(iters.max()) if len(iters) else 0
    if maxol <= 0:
        return (np.full(B, -1, np.int32),
                np.full(B, max_mismatches0, np.int32),
                np.zeros(B, bool))
    have_q = a_qual is not None and b_qual is not None
    key = (B, alen, blen, min_overlap0, min_overlap, min_insert0,
           margin, max_mismatches0, max_mismatches, minq, have_q)
    prog = _MM_CACHE.get(key)
    if prog is None:
        def f(a, b, aq, bq, tbl, xs):
            return _mm_program(a, b, aq, bq, tbl, xs, maxol, alen, blen,
                               min_overlap, margin, max_mismatches0,
                               max_mismatches, have_q, minq)
        prog = jax.jit(f)
        _MM_CACHE[key] = prog
    tbl = _counted_table(minq)
    z = np.zeros((1, 1), np.int8)
    xs = (jnp.asarray(ovr), jnp.asarray(istart), jnp.asarray(jstart),
          jnp.asarray(iters))
    out = prog(np.ascontiguousarray(a_bases),
               np.ascontiguousarray(b_bases),
               np.ascontiguousarray(a_qual) if have_q else z,
               np.ascontiguousarray(b_qual) if have_q else z,
               tbl, xs)
    ins, bad, amb = (np.asarray(o) for o in out)
    return ins, bad, amb
