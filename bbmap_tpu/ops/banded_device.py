"""Device batched banded edit distance — Dedupe's verification
hot loop as one jitted program per candidate-pair batch (reference:
jni/BandedAlignerJNI.c:588-716 alignForward/RC/Reverse/RC,
align2/BandedAlignerConcrete.java; VERDICT r2 missing #4).

The band (2*maxEdits+1 diagonals) rides the lane axis and the pair
batch is vectorized; rows advance in a ``lax.scan``. The per-row
insertion sweep — the only serial dependence inside a row — closes into
``d + cummin(cur[e] - e)``, so a row is pure vector ops. Decision
parity with the numpy band sweep (ops/banded.py): both saturate at
``max_edits + 1`` (tests/test_banded_device.py).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def _enabled() -> bool:
    env = os.environ.get("BBMAP_DEVICE_BANDED")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "f", "no",
                                           "off", "")
    import jax
    return jax.default_backend() != "cpu"


_CACHE = {}


def _program(a, la, b, lb, Lmax: int, E: int,
             infix: bool = False):
    import jax
    import jax.numpy as jnp
    I32 = jnp.int32
    n = a.shape[0]
    w = 2 * E + 1
    BIGV = I32(E + 1)
    d_idx = jnp.arange(w, dtype=I32)

    # pad b so the per-row window slice never clamps (row index runs to
    # Lmax, which may exceed b's width when la >> lb)
    bp = jnp.pad(b, ((0, 0), (E + 1, Lmax + w + 2)),
                 constant_values=255)

    j0 = d_idx - E                      # row-0 column per diagonal
    ok0 = (j0 >= 0) & (j0[None, :] <= lb[:, None])
    if infix:
        # semi-global (contained-infix) mode: free start anywhere in b
        prev0 = jnp.where(ok0, I32(0), BIGV) * jnp.ones((1,), I32)
        prev0 = jnp.broadcast_to(prev0, (a.shape[0], w)).astype(I32)
    else:
        prev0 = jnp.where(ok0,
                          jnp.maximum(j0, 0)[None, :].astype(I32), BIGV)
        prev0 = jnp.minimum(prev0, BIGV)

    def row(prev, i):
        # columns js = i - E .. i + E ; window of b at js-1
        win = jax.lax.dynamic_slice_in_dim(bp, i, w,
                                           axis=1)       # b[js-1]
        ai = jax.lax.dynamic_slice_in_dim(a, i - 1, 1, axis=1)  # (n,1)
        js = i - E + d_idx                                # (w,)
        valid = (js[None, :] >= 1) & (js[None, :] <= lb[:, None])
        sub = prev + (ai != win).astype(I32)
        up = jnp.concatenate(
            [prev[:, 1:], jnp.full((n, 1), BIGV, I32)], axis=1) + 1
        cur = jnp.where(valid, jnp.minimum(sub, up), BIGV)
        # insertion sweep: cur[d] = min_e<=d (cur[e] + (d - e))
        cur = jnp.minimum(
            jax.lax.cummin(cur - d_idx[None, :], axis=1)
            + d_idx[None, :], cur)
        cur = jnp.minimum(cur, BIGV)
        active = (i <= la)[:, None]
        return jnp.where(active, cur, prev), None

    prev, _ = jax.lax.scan(row, prev0,
                           jnp.arange(1, Lmax + 1, dtype=I32))
    if infix:
        # free end: best cell of the last row's band
        jsf = la[:, None] - E + d_idx[None, :]
        okf = (jsf >= 0) & (jsf <= lb[:, None])
        return jnp.min(jnp.where(okf, prev, BIGV), axis=1)
    d_final = lb - la + E                                 # (n,)
    inb = (d_final >= 0) & (d_final < w)
    df = jnp.clip(d_final, 0, w - 1)
    out = jnp.take_along_axis(prev, df[:, None], axis=1)[:, 0]
    return jnp.where(inb & (jnp.abs(lb - la) <= E), out, BIGV)


def banded_edit_batch(a: np.ndarray, la: np.ndarray, b: np.ndarray,
                      lb: np.ndarray, max_edits: int,
                      infix: bool = False) -> np.ndarray:
    """Batched banded edit distance. a (n, La) / b (n, Lb) uint8 with
    per-row lengths la/lb; returns (n,) int32 saturated at
    max_edits + 1. ``infix=True`` scores a's best match to ANY infix of
    b (free start/end in b) — Dedupe's contained-with-edits
    verification (reference: Dedupe containment via
    BandedAligner.alignForward from a candidate offset)."""
    import jax
    n, La = a.shape
    Lmax = int(min(La, int(la.max()) if n else 0))
    key = (n, La, b.shape[1], Lmax, max_edits, infix)
    prog = _CACHE.get(key)
    if prog is None:
        def f(a, la, b, lb):
            return _program(a, la, b, lb, Lmax, max_edits, infix)
        prog = jax.jit(f)
        _CACHE[key] = prog
    out = prog(np.ascontiguousarray(a), la.astype(np.int32),
               np.ascontiguousarray(b), lb.astype(np.int32))
    return np.asarray(out)


def _pad_rows(seqs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(seqs), width), np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def contained_distances(query: np.ndarray,
                        windows: List[np.ndarray],
                        max_edits: int) -> np.ndarray:
    """Best infix edit distance of `query` within each window (free
    start/end inside the window) — Dedupe's contained-with-edits
    verification. Band width 2*max_edits covers the offset slack of a
    ±max_edits window."""
    n = len(windows)
    if n == 0:
        return np.zeros(0, np.int32)
    E = 2 * max_edits
    P = 1
    while P < n:
        P <<= 1
    La = len(query)
    Lb = max(len(w) for w in windows)
    W = -(-max(La, Lb) // 64) * 64
    a = np.broadcast_to(_pad_rows([query], W)[0], (P, W)).copy()
    la = np.full(P, La, np.int32)
    b = _pad_rows(windows + [np.zeros(0, np.uint8)] * (P - n), W)
    lb = np.array([len(w) for w in windows] + [0] * (P - n), np.int32)
    d = banded_edit_batch(a, la, b, lb, E, infix=True)[:n]
    return np.minimum(d, max_edits + 1)


def edit_distances_vs_one(query: np.ndarray,
                          others: List[np.ndarray],
                          max_edits: int) -> np.ndarray:
    """Distances of one query against many candidates (Dedupe's
    near-duplicate check), device-batched when enabled. Pads the
    candidate count to the next power of two so program shapes stay
    cacheable."""
    n = len(others)
    if n == 0:
        return np.zeros(0, np.int32)
    if not _enabled() or n < 4:
        from .banded import banded_edit_distance
        return np.array([banded_edit_distance(query, o, max_edits)
                         for o in others], np.int32)
    P = 1
    while P < n:
        P <<= 1
    La = len(query)
    Lb = max(len(o) for o in others)
    W = -(-max(La, Lb) // 64) * 64
    a = np.broadcast_to(
        _pad_rows([query], W)[0], (P, W)).copy()
    la = np.full(P, La, np.int32)
    b = _pad_rows(others + [np.zeros(0, np.uint8)] * (P - n), W)
    lb = np.array([len(o) for o in others] + [0] * (P - n), np.int32)
    return banded_edit_batch(a, la, b, lb, max_edits)[:n]
