"""Device quickmap: seeding -> chaining -> gapless scoring -> match
generation as ONE jitted XLA program with ONE packed result transfer.

Device replacement for the whole per-read search loop of the
reference (reference: align2/AbstractMapThread.quickMap:643 +
align2/BBIndex.find:403/slowWalk2:855): the CSR index (starts/sites) and
2-bit packed genome live in device memory; a batch of reads flows
through

1. key extraction at spaced offsets (2-bit packing, both strands)
2. bounded site-list gather from the CSR arrays. The per-key cap is
   index-adaptive: lists up to ``min(32, max_usable_length)`` are used;
   longer lists are SKIPPED entirely, the reference's over-long list
   exclusion (reference: BBIndex.find:421-440, analyzeIndex:101-191) —
   never silently truncated.
3. diagonal sort + chain segmentation (replaces the Quad heap merge)
4. per-chain vote counts, spread, and modal diagonal via segment ops
5. top-K candidate selection per read
6. gapless streak scoring of every candidate at its modal diagonal,
   against the 2-bit packed genome (one int32 word gather per 16 ref
   bases + register shifts — not a byte gather per base)
7. per-read best/second selection and the best site's m/S/N match
   symbols (reference: genMatchNoIndels:1956-1972), packed 2 bits/base

The host receives exactly TWO arrays per batch — one (B, meta+candidates)
int32 matrix and one (B, ceil(L/4)) uint8 packed match block — so a batch
costs two device->host transfers regardless of content. Only DP
escalation (indels) and SAM formatting remain host-side.

Votes are distinct-offset counts (matching the host seeding path; the
round-1 hit-count deviation is gone). Remaining documented deviation:
modal diagonal = the longest equal-diag run (ties -> lowest diagonal).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import constants as K
from ..core.bases import BASE_TO_NUMBER
from ..index.build import KmerIndex
from . import seed as seed_host
from .gapless import score_match_sub_vec

MAX_SITES_CAP = 32     # upper bound on the adaptive per-key site-list cap
SLOT_BUDGET = 64       # total site slots per (read, strand) — the dense
# equivalent of the reference's per-read hit-list working set; keys are
# packed into the budget by exclusive prefix sum, so short lists don't
# pay for the longest list's padding. The budget is sized to cover ~3x
# the average per-read site total rather than the worst case.
MAX_CANDIDATES = 8
I32 = jnp.int32
U32 = jnp.uint32
BIG = np.int32(2 ** 30)

# ASCII -> 2-bit code, undefined -> 4
_B2C = np.full(256, 4, np.uint8)
for _i, _ch in enumerate("ACGT"):
    _B2C[ord(_ch)] = _i
    _B2C[ord(_ch.lower())] = _i
_B2C[ord("U")] = 3
_B2C[ord("u")] = 3

# match-symbol 2-bit codes (packed transfer): 0=m 1=S 2=N 3=pad
_SYM_TABLE = np.frombuffer(b"mSNN", np.uint8)
# byte -> 4 symbols LUT for host unpacking
_UNPACK_LUT = np.zeros((256, 4), np.uint8)
for _b in range(256):
    for _s in range(4):
        _UNPACK_LUT[_b, _s] = _SYM_TABLE[(_b >> (2 * _s)) & 3]

N_META = 7  # best_score, best_diag, best_strand, best_start, best_spread,
#             second_score, n_good
N_CFIELD = 5  # scores, diag, strand, start, spread


def pack_genome_2bit(codes: np.ndarray):
    """uint8 code array (0..3, 4=N) -> (gpack uint32 16 bases/word,
    nmask uint32 32 bases/word). Both padded so window gathers never
    index out of range."""
    G = len(codes)
    nw = (G + 15) // 16 + 2
    c = np.minimum(codes, 3).astype(np.uint32)
    cpad = np.zeros(nw * 16, np.uint32)
    cpad[:G] = c
    shifts = (2 * np.arange(16, dtype=np.uint32))
    gpack = (cpad.reshape(nw, 16) << shifts[None, :]).sum(
        axis=1, dtype=np.uint32)
    nwn = (G + 31) // 32 + 2
    nbit = (codes > 3).astype(np.uint32)
    npad = np.zeros(nwn * 32, np.uint32)
    npad[:G] = nbit
    bshift = np.arange(32, dtype=np.uint32)
    nmask = (npad.reshape(nwn, 32) << bshift[None, :]).sum(
        axis=1, dtype=np.uint32)
    return gpack, nmask


def take_flat(table, idx):
    """``table[idx]`` (1-D table) with the index collapsed to 2-D
    (keeping the big leading dim as rows) and its minor dim padded up to
    a multiple of 64 (pad entries index 0: one cached line), then sliced
    and reshaped back. Large batches are fully flattened instead.
    Bit-identical to ``table[idx]``. The layout was chosen for another
    backend's gather compile times; its cost on the GPU is not yet
    measured (ROADMAP)."""
    sh = idx.shape
    if idx.ndim <= 1:
        return table[idx]
    m = 1
    for d in sh[1:]:
        m *= int(d)
    M = -(-m // 64) * 64
    total = int(sh[0]) * m
    if M != m and total >= (1 << 16) and total % 256 == 0:
        # minor-dim padding would inflate the index count; fully
        # flatten instead: every index slot is a real index
        i1 = idx.reshape(total // 256, 256)
        return table[i1].reshape(sh)
    i2 = idx.reshape(sh[0], m)
    if M != m or len(sh) > 2:
        if M != m:
            i2 = jnp.pad(i2, ((0, 0), (0, M - m)))
        out = table[i2]
        if M != m:
            out = out[:, :m]
        return out.reshape(sh)
    return table[i2].reshape(sh)


def take_along_flat(a, idx):
    """``jnp.take_along_axis(a, idx, axis=-1)`` with the same index
    layout as :func:`take_flat` (collapsed to 2-D rows, minor dims
    padded to a multiple of 64). Leading dims of ``a`` and ``idx`` must
    match. Bit-identical results."""
    sh_a, sh_i = a.shape, idx.shape
    m, mi = int(sh_a[-1]), int(sh_i[-1])
    ra = 1
    for d in sh_a[:-1]:
        ra *= int(d)
    a2 = a.reshape(ra, m)
    i2 = idx.reshape(ra, mi)
    M = -(-m // 64) * 64
    MI = -(-mi // 64) * 64
    if M != m:
        a2 = jnp.pad(a2, ((0, 0), (0, M - m)))
    if MI != mi:
        i2 = jnp.pad(i2, ((0, 0), (0, MI - mi)))
    out = jnp.take_along_axis(a2, i2, axis=1)
    if MI != mi:
        out = out[:, :mi]
    return out.reshape(sh_i)


def _gather_words(table, w0, NW: int):
    """Gather NW consecutive words starting at word index ``w0`` (any
    leading shape; may be negative or past the end) from a 1-D uint32
    word table, via 8-wide ROW gathers: fetching ceil((NW+14)/8) rows
    of 8 needs ~NW/8 the indices of the naive per-word gather. The
    dynamic 0..7 intra-row offset is resolved by an 8-way static-slice
    select.

    Exactness contract: in-range words (0 <= w0+j < len) are returned
    exactly; out-of-range words return ZERO instead of the old per-word
    clip's edge word — callers mask those positions via the oob/N mask,
    so window extraction results are unchanged wherever they are used.
    """
    NR = (NW + 14) // 8                  # rows covering NW words at any
    #                                      0..7 intra-row offset
    F_ROWS = NR + 2                      # zero front-pad so every
    #                                      possibly-in-range w0 maps to a
    #                                      non-clipped row (see callers:
    #                                      base >= -(L + ~90) always)
    nrows = (table.shape[0] + 7) // 8
    t8 = jnp.pad(table, (F_ROWS * 8,
                         nrows * 8 - table.shape[0])).reshape(
        nrows + F_ROWS, 8)               # tiny (genome/16 words)
    r0 = (w0 + F_ROWS * 8) >> 3          # >= 0 whenever any word in range
    ridx = jnp.clip(r0[..., None] + jnp.arange(NR, dtype=I32),
                    0, nrows + F_ROWS - 1)
    # 2-D row gather with a flat, unpadded index layout (every index
    # slot real — the gather runtime is per-index)
    sh = ridx.shape
    total = 1
    for d in sh:
        total *= int(d)
    lane = 256
    while lane > 1 and total % lane:
        lane //= 2
    rows = t8[ridx.reshape(total // lane, lane)].reshape(sh + (8,))
    wide = rows.reshape(rows.shape[:-2] + (NR * 8,))
    s = (w0 & 7)[..., None]
    out = wide[..., 0:NW]
    for k in range(1, 8):
        out = jnp.where(s == k, wide[..., k:k + NW], out)
    return out


def extract_ref_codes(gpack, nmask, base, L: int, G: int,
                      has_n: bool = True):
    """Gather L consecutive genome codes starting at flat position
    ``base`` (any leading shape; may be out of range). Returns
    (codes uint8 (..., L) in 0..3, is_n bool (..., L) — N or out of
    bounds). One uint32 gather per 16 bases + register shifts instead of
    a byte gather per base. ``has_n=False`` (genome contains no
    N/undefined bases — true for phiX/E. coli-class references, known at
    index build) skips the whole nmask gather chain: the windows are
    ~40% of the candidate stage's random-access traffic."""
    base = base.astype(I32)
    NW = (L + 15) // 16 + 1
    w0 = base >> 4                       # arithmetic shift = floor div
    o = (base & 15).astype(U32)
    w = _gather_words(gpack, w0, NW)     # (..., NW) uint32
    sh = (2 * o)[..., None]
    lo = w[..., :-1] >> sh
    hi = jnp.where(sh == 0, jnp.uint32(0),
                   w[..., 1:] << ((jnp.uint32(32) - sh) & jnp.uint32(31)))
    aligned = lo | hi                    # (..., NW-1) = 16*(NW-1) bases
    slots = jnp.arange(16, dtype=U32) * 2
    codes = ((aligned[..., :, None] >> slots) & 3).astype(jnp.uint8)
    codes = codes.reshape(codes.shape[:-2] + ((NW - 1) * 16,))[..., :L]

    pos = base[..., None] + jnp.arange(L, dtype=I32)
    oob = (pos < 0) | (pos >= G)
    if not has_n:
        return codes, oob

    NWn = (L + 31) // 32 + 1
    nw0 = base >> 5
    no = (base & 31).astype(U32)
    nwords = _gather_words(nmask, nw0, NWn)
    nsh = no[..., None]
    nlo = nwords[..., :-1] >> nsh
    nhi = jnp.where(nsh == 0, jnp.uint32(0),
                    nwords[..., 1:] << ((jnp.uint32(32) - nsh)
                                        & jnp.uint32(31)))
    naligned = nlo | nhi
    bslots = jnp.arange(32, dtype=U32)
    nbits = ((naligned[..., :, None] >> bslots) & 1).astype(bool)
    nbits = nbits.reshape(nbits.shape[:-2] + ((NWn - 1) * 32,))[..., :L]
    return codes, nbits | oob


def ascii_to_codes(bases):
    """(..., L) ASCII -> 2-bit codes 0..3 (A0 C1 G2 T3), 4 for anything
    else. Pure arithmetic, no table gather."""
    c = bases.astype(I32)
    x = (c >> 1) & 3          # A->0 C->1 G->3 T->2
    x = x ^ (x >> 1)          # swap 2<->3: A0 C1 G2 T3
    ok = (c == 65) | (c == 67) | (c == 71) | (c == 84) \
        | (c == 97) | (c == 99) | (c == 103) | (c == 116) \
        | (c == 85) | (c == 117)                    # ACGT/acgt/Uu
    return jnp.where(ok, x, 4).astype(jnp.uint8)


def _keys_all_positions(codes, k, L):
    """(B, L) 2-bit codes -> (B, L-k+1) int32 keys via shifted slices
    (no gathers), -1 where the window contains an undefined base."""
    m = L - k + 1
    ci = codes.astype(I32)
    keys = jnp.zeros(codes.shape[:1] + (m,), I32)
    bad = jnp.zeros(codes.shape[:1] + (m,), bool)
    for j in range(k):
        c = ci[:, j:m + j]
        bad |= c > 3
        keys = (keys << 2) | jnp.where(c > 3, 0, c)
    return jnp.where(bad, -1, keys)


def _keys_from_codes(codes, offsets_list, k, L):
    """(B, L) 2-bit codes -> (B, nk) keys at the static seed offsets.
    Small nk: per-offset static slices (no gather). Long-read nk
    (hundreds): one lane-aligned take (an nk-unrolled stack traces
    750+ ops at the PacBio envelope)."""
    keys_all = _keys_all_positions(codes, k, L)
    if len(offsets_list) <= 64:
        return jnp.stack([keys_all[:, o] for o in offsets_list],
                         axis=1)
    off = jnp.asarray(np.asarray(offsets_list, np.int32))
    B = codes.shape[0]
    return take_along_flat(keys_all,
                           jnp.broadcast_to(off, (B, len(offsets_list))))


def _rc_keys(keys, k):
    x = (~keys).astype(jnp.uint32)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0000FFFF) << 16) | (x >> 16)
    x = x >> (32 - 2 * k)
    return x.astype(I32)


class QuickmapRun:
    """Handle for an in-flight quickmap dispatch: keeps the two device
    result arrays so callers can overlap host work with device compute;
    ``host()`` blocks, transfers both, and unpacks into the result dict."""

    def __init__(self, out_i32, out_match, L: int):
        self._out_i32 = out_i32
        self._out_match = out_match
        self._L = L
        # start both device->host copies in flight immediately so they
        # overlap each other (and the rest of the dispatch queue)
        try:
            out_i32.copy_to_host_async()
            out_match.copy_to_host_async()
        except Exception:
            pass

    def host(self) -> Dict[str, np.ndarray]:
        m = np.asarray(self._out_i32)
        pk = np.asarray(self._out_match)
        B = m.shape[0]
        C = MAX_CANDIDATES
        d = {
            "best_score": m[:, 0],
            "best_diag": m[:, 1],
            "best_strand": m[:, 2],
            "best_start": m[:, 3],
            "best_spread": m[:, 4],
            "second_score": m[:, 5],
            "n_good": m[:, 6],
        }
        cand = m[:, N_META:].reshape(B, N_CFIELD, C)
        d["cand_scores"] = cand[:, 0]
        d["cand_diag"] = cand[:, 1]
        d["cand_strand"] = cand[:, 2]
        d["cand_start"] = cand[:, 3]
        d["cand_spread"] = cand[:, 4]
        # packed 2-bit match symbols -> (B, L) ASCII m/S/N
        d["best_match"] = _UNPACK_LUT[pk].reshape(B, -1)[:, :self._L]
        return d


def device_arrays(index: KmerIndex):
    """Device-resident (starts, sites, gpack, nmask, G) for an index,
    uploaded once and shared by the quickmap and the DP escalation
    programs (the packed genome is the biggest single device tenant)."""
    ent = getattr(index, "_device_arrays", None)
    if ent is None:
        gpack_np, nmask_np = pack_genome_2bit(index.genome_codes)
        ent = (jax.device_put(index.starts.astype(np.int32)),
               jax.device_put(index.sites.astype(np.int32)),
               jax.device_put(gpack_np), jax.device_put(nmask_np),
               len(index.genome_codes))
        index._device_arrays = ent
    return ent


def scnt_array(index: KmerIndex):
    """Packed per-key (start << 8 | min(count, 255)) uint32 table — the
    candidate stage's CSR lookup in ONE random gather instead of two
    (the count byte saturates at 255, safely above every admission
    threshold, see the sharded-path invariant assert). Only valid while start offsets
    fit 24 bits; returns None for bigger indexes (callers fall back to
    the two-gather path)."""
    if len(index.sites) >= (1 << 24):
        return None
    ent = getattr(index, "_scnt_array", None)
    if ent is None:
        starts = index.starts.astype(np.int64)
        cnt8 = np.minimum(np.diff(starts), 255).astype(np.uint32)
        packed = ((starts[:-1].astype(np.uint32) << np.uint32(8))
                  | cnt8)
        ent = jax.device_put(packed)
        index._scnt_array = ent
    return ent


class QmConfig(NamedTuple):
    """Static quickmap configuration shared by the single-device and the
    mesh-sharded builds (parallel/sharded.py)."""
    k: int
    L: int
    S: int                 # per-key site-list cap (GLOBAL list length)
    chain_dist: int
    min_score: int
    offsets_list: tuple    # static seed offsets
    G: int                 # flat genome length
    profile: object = None  # ScoringProfile (None = SHORT)
    has_n: bool = True     # genome contains N bases (False skips the
    #                        nmask gathers in every window extraction)
    # reference-faithful retention (BBIndex.find staged re-admission +
    # Solver-weighted greedy trim; align/search_oracle.py is the host
    # truth). Enabled when the index carries canonical counts.
    ref_admit: bool = False
    max_usable_length: int = 1 << 30
    # site-slot budget per (read, strand): SLOT_BUDGET (64) for the
    # short stack; long reads (L > 600) carry ~L/8 seed keys at ~1.3
    # sites each, so the budget scales to keep sensitivity (reference
    # PacBio stack: maxDesiredKeys=63 -> keyDen2 clamps to
    # minKeyDensity=2.8 -> ~1400 keys/6 kbp read)
    slot_budget: int = 64
    limit_avg: int = 20
    limit_avg2: int = 20
    limit_shortest: int = 20
    points_per_site: int = -50


def make_config(index: KmerIndex, L: int, chain_dist: int = 400,
                min_ratio: float = 0.56,
                max_list_length: Optional[int] = None,
                profile=None) -> QmConfig:
    k = index.k
    offsets_np = seed_host.make_offsets(L, k)
    if offsets_np is None:
        raise ValueError(f"read length {L} < k {k}")
    actual_max = int(np.diff(index.starts).max()) if len(index.sites) \
        else 1
    if max_list_length is None:
        max_list_length = min(index.max_usable_length, MAX_SITES_CAP,
                              max(actual_max, 1))
    slot_budget = SLOT_BUDGET if L <= 600 else 512
    S = int(max(2, min(max_list_length, MAX_SITES_CAP, slot_budget)))
    max_sw = profile.max_quality(L) if profile is not None \
        else K.max_quality(L)
    has_n = getattr(index, "_has_n", None)
    if has_n is None:
        has_n = bool(np.any(index.genome_codes > 3))
        index._has_n = has_n
    ref_admit = (index.counts_canonical is not None
                 and os.environ.get("BBMAP_REF_ADMIT", "1")
                 not in ("0", "false", "off"))
    return QmConfig(k=k, L=L, S=S, chain_dist=chain_dist,
                    min_score=int(max_sw * min_ratio),
                    offsets_list=tuple(int(o) for o in offsets_np),
                    G=len(index.genome_codes), profile=profile,
                    has_n=has_n, ref_admit=ref_admit,
                    max_usable_length=int(index.max_usable_length),
                    limit_avg=int(index.limit_avg),
                    limit_avg2=int(index.limit_avg2),
                    limit_shortest=int(index.limit_shortest),
                    points_per_site=int(index.points_per_site),
                    slot_budget=slot_budget)


def ccnt_array(index: KmerIndex):
    """Device-resident canonical COUNTS table (int32 [4^k]) — the
    reference's AbstractIndex.COUNTS (key + rc summed, analyzeIndex
    :147-151); shard-stable by construction (every shard holds the same
    global table)."""
    if index.counts_canonical is None:
        return None
    ent = getattr(index, "_ccnt_array", None)
    if ent is None:
        ent = jax.device_put(index.counts_canonical.astype(np.int32))
        index._ccnt_array = ent
    return ent


EARLY_TERMINATION_SCORE = -100000   # Solver.java:232 (frozen, see
#                                     align/search_oracle.py)


def hi_budget(R2: int) -> int:
    """Two-tier slot-gather upper-half row budget: ~R2/8 rows (rounded
    up to a 256 multiple, min 256) may exceed the LO slot tier before
    in-device truncation + host refit engages (candidate_stage two_tier
    contract). Module-level so tests can monkeypatch it down to force
    the overflow path (ADVICE r4 medium)."""
    return min(R2, max(256, -(-R2 // 8) // 256 * 256))


def _ref_retention(cfg: QmConfig, kp, off_p, ccnt, weights=None):
    """Reference-faithful key retention, vectorized per read on the
    PLUS-strand layout (the minus strand mirrors the retained set —
    find() trims keysP before deriving keysM, BBIndex.java:457-524):

    1. staged re-admission on CANONICAL counts with strict ``< maxLen``
       and the exact (maxLen*3)/2 .. maxLen*5 ladder (find:421-440)
    2. Solver-weighted greedy hit-list trimming
       (trimExcessHitListsByGreedy:266 + Solver.findWorstGreedy:47
       + valueOfElement:74), including the ascending-scan
       EARLY_TERMINATION quirk and the float32 valuep*weight truncation

    Bit-parity with align/search_oracle.retain_keys is asserted by
    tests/test_search_oracle.py. kp: (B, nk) plus keys (-1 invalid);
    off_p: (B, nk) int32 offsets (ascending); ccnt: (B, nk) canonical
    counts for kp. weights: None (all 1.0 — the no-quality case) or
    (B, nk) float32 PER SLOT (aligned with kp); internally compacted to
    the post-readmission (shrunk) array order, because the reference
    indexes keyWeights by LIST position, not key slot — after a removal
    the surviving lists inherit the weights of their new positions
    (Solver.findWorstGreedy's loop variable, BBIndex.java:305; a
    preserved quirk). Returns alive (B, nk) bool."""
    B, nk = kp.shape
    valid = kp >= 0
    maxLen = cfg.max_usable_length
    slot = jnp.arange(nk, dtype=I32)[None, :]
    pos = ccnt > 0

    # int32-safe tier caps (maxLen is 1<<30 when no exclusion applies;
    # counts are clipped below 2^31-1 so the capped compare is exact)
    tiers = tuple(min(t, 2 ** 31 - 1)
                  for t in (maxLen, (maxLen * 3) // 2, maxLen * 2,
                            maxLen * 3, maxLen * 5))
    hit = [valid & pos & (ccnt < t) for t in tiers]
    n = [jnp.sum(h.astype(I32), axis=1) for h in hit]
    trig = (3 * nk) // 4
    gate = n[0] > 0
    sel = jnp.zeros_like(n[0])
    num = n[0]
    for t, need in ((1, 4), (2, 3), (3, 3), (4, 2)):
        esc = gate & (num < need) & (num < trig)
        sel = jnp.where(esc, t, sel)
        num = jnp.where(esc, n[t], num)
    adm = hit[0]
    for t in range(1, 5):
        adm = jnp.where((sel == t)[:, None], hit[t], adm)

    if weights is not None:
        # compact per-slot weights to the shrunk-array (admitted-rank)
        # order once: position r holds the weight of the r-th ADMITTED
        # slot. Exact elementwise selection (a one-hot matmul could
        # round the f32 weights to bf16 or TF32).
        if nk <= 64:
            adm_rank = jnp.cumsum(adm.astype(I32), axis=1) - 1
            weights = jnp.stack(
                [jnp.sum(jnp.where(adm & (adm_rank == r), weights,
                                   0.0), axis=1) for r in range(nk)],
                axis=1)
        else:
            # long-read nk: admitted-first stable permutation gather
            # (exact — a pure reorder, no arithmetic; the nk-unrolled
            # stack above would trace 750+ ops at the PacBio nk)
            order = jnp.argsort((~adm).astype(I32), axis=1,
                                stable=True)
            weights = jnp.take_along_axis(weights, order, axis=1)

    lengths0 = jnp.where(adm, ccnt, 0)
    initial = jnp.sum((lengths0 > 0).astype(I32), axis=1)      # (B,)
    total0 = jnp.sum(lengths0, axis=1)
    shortest = jnp.min(jnp.where(lengths0 > 0, lengths0, BIG), axis=1)
    limit3 = max(20, cfg.limit_shortest)
    kill = (initial >= 1) & (shortest > limit3)   # SLOW=false rule
    alive = adm & ~kill[:, None]
    # per-read limits (arrays are the SHRUNK views: length = initial)
    limit = max(20, cfg.limit_avg) * initial
    limit2 = max(20, cfg.limit_avg2)
    max_lists = jnp.maximum(
        (jnp.float32(0.85) * initial.astype(jnp.float32)).astype(I32),
        6)
    # first/last ADMITTED slot = shrunk array ends (END bonus + the
    # offsets[length-1] sentinel are FIXED during the loop)
    first_adm = jnp.argmax(adm, axis=1).astype(I32)
    last_adm = (nk - 1) - jnp.argmax(adm[:, ::-1], axis=1).astype(I32)
    off_last = jnp.take_along_axis(off_p, last_adm[:, None],
                                   axis=1)[:, 0]
    pps = cfg.points_per_site
    # canonical counts can be genome-scale; clamp so pps*len stays in
    # int32 (engages only on pathological indexes — the oracle uses
    # int64; documented edge)
    vm_cap = (2 ** 30) // max(1, -pps)
    chunk = cfg.k
    hits = jnp.where(kill, 0, initial)
    total = jnp.where(kill, 0, total0)
    active = ~kill & (initial >= 1)

    def _greedy_body(carry):
        alive, total, hits, active = carry
        l = jnp.where(alive, ccnt, 0)
        numl = jnp.maximum(hits, 1)[:, None]
        prevoff = jax.lax.cummax(jnp.where(alive, off_p, -1), axis=1)
        offL = jnp.concatenate(
            [jnp.full((B, 1), -1, I32), prevoff[:, :-1]], axis=1)
        nxt = jnp.flip(jax.lax.cummin(
            jnp.flip(jnp.where(alive, off_p, BIG), 1), axis=1), 1)
        offR_next = jnp.concatenate(
            [nxt[:, 1:], jnp.full((B, 1), BIG, I32)], axis=1)
        is_first = alive & (offL == -1)
        is_last = alive & (offR_next == BIG)
        offR = jnp.where(is_last, off_last[:, None] + 1, offR_next)
        lsafe = jnp.maximum(l, 1)
        vp = (30000 + 60000 // numl + 300000 // lsafe)
        vp = vp + jnp.where((slot == first_adm[:, None])
                            | (slot == last_adm[:, None]), 40000, 0)
        oldL = off_p - offL
        oldR = offR - off_p
        newS = offR - offL
        space = ((oldL * oldL + oldR * oldR) - newS * newS) * (-30)
        uc = jnp.where(
            is_first, offR - off_p,
            jnp.where(is_last, off_p - offL,
                      jnp.maximum(offR - (offL + chunk), 0)))
        tail = jnp.where(is_first | is_last, 11500 * uc, 6000 * uc)
        vp_final = jnp.where(numl == 1, vp + 11500 * chunk,
                             vp + space + tail)
        if weights is None:
            # weight 1.0f: float32(valuep) is exact below 2^24
            vpw = vp_final.astype(I32)
        else:
            # weight by LIST position (alive-rank) — reference quirk:
            # w[b, s] = weights[b, rank[b, s]]
            rank = jnp.cumsum(alive.astype(I32), axis=1) - 1
            rclip = jnp.clip(rank, 0, nk - 1)
            if nk <= 64:
                # one-match masked sum ((B, nk, nk) is tiny)
                ar = jnp.arange(nk, dtype=I32)
                w = jnp.sum(
                    jnp.where(rclip[:, :, None] == ar[None, None, :],
                              weights[:, None, :], jnp.float32(0.0)),
                    axis=2)
            else:
                # long-read nk: the masked-sum tensor is GBs — plain
                # take_along gather (bit-identical values)
                w = take_along_flat(weights, rclip)
            vpw = (vp_final.astype(jnp.float32) * w).astype(I32)
        value = vpw + pps * jnp.minimum(l, vm_cap)
        vals = jnp.where(alive, value, BIG)
        runmin = jax.lax.cummin(vals, axis=1)
        runmin_before = jnp.concatenate(
            [jnp.full((B, 1), BIG, I32), runmin[:, :-1]], axis=1)
        is_new = alive & (vals < runmin_before)
        first_alive = jnp.argmax(alive, axis=1).astype(I32)
        trigm = is_new & (runmin_before < EARLY_TERMINATION_SCORE) \
            & (slot != first_alive[:, None])
        trig_any = trigm.any(axis=1)
        first_trig = jnp.argmax(trigm, axis=1).astype(I32)
        gmin = jnp.argmin(vals, axis=1).astype(I32)
        worst = jnp.where(trig_any, first_trig, gmin)
        g1 = lambda a: jnp.take_along_axis(a, worst[:, None],
                                           axis=1)[:, 0]
        worst_value = g1(vals)
        worst_len = g1(l)
        cond = active & (hits >= 1) & (
            (total > limit)
            | (total // jnp.maximum(initial, 1) > limit2)
            | (hits > max_lists))
        stop_now = (worst_value > 0) | (worst_len < 20)
        do_remove = cond & ~stop_now
        total = jnp.where(cond, total - worst_len, total)
        alive = alive & ~(do_remove[:, None] & (slot == worst[:, None]))
        hits = jnp.where(do_remove, hits - 1, hits)
        return (alive, total, hits, do_remove)

    # dynamic trip count: the reference loop almost always stops after
    # 0-3 removals; a while_loop runs exactly that many iterations
    # instead of a full nk-1 static unroll (compile size AND runtime)
    def _greedy_cond(carry):
        return carry[3].any()

    alive, _t, _h, _a = jax.lax.while_loop(
        _greedy_cond, _greedy_body, (alive, total, hits, active))
    return alive


def quality_offsets_stage(cfg: QmConfig, qual, density: float,
                          max_density: float,
                          return_weights: bool = False):
    """Device port of the quality-probability key selection (VERDICT r1
    #9 — the host and device seeding paths must share semantics):
    QualityTools.makeKeyProbs (reference:
    align2/QualityTools.java:188-218) + KeyRing.makeOffsets3 (reference:
    align2/KeyRing.java:396-506, all float32 like the Java). qual:
    (B, L) int8 phred. Returns (B, nk) int32 offsets, -1 for unused
    slots; reads with no usable keys fall back to the static ladder
    (host fallback in seed.make_offsets_quality).

    With ``return_weights=True`` also returns the keyProbs-derived
    Solver greedy-trim weights and the probAllErrors read rejection
    (VERDICT r4 missing #1; reference: AbstractMapThread.java:704-727
    keyScoresAll = baseKeyScore + round(range*(1-keyProbs)) with
    a = BASE_KEY_HIT_SCORE = 100*k, baseKeyScore = a/8, range = a -
    baseKeyScore; keyWeights = keyScores * (1f/a), BBIndex.java:268-270;
    reads with prod(keyProbs[offsets]) > 0.5 are rejected outright,
    AbstractMapThread.java:723). Returns (offsets (B, nk) int32,
    weights (B, nk) float32 per SLOT, reject (B,) bool)."""
    q = jnp.clip(qual.astype(I32), 0, 127)
    pc = take_flat(jnp.asarray(seed_host.PROB_CORRECT), q)   # (B, L)
    return _quality_offsets_core(cfg, q, pc, density, max_density,
                                 return_weights)


def pack_quality_host(quality: np.ndarray, L: int):
    """(B, >=L) int8 phred -> (qpack (B, ceil(L/8)) uint32 [8 nibbles
    per word], palette (16,) int32, pcpal (16,) float32) when the batch
    has <= 16 distinct quality values (every production Illumina
    instrument bins to 4-8 levels), else (None, None, None) — the
    caller falls back to the raw-int8 program. Halves the quality
    upload AND replaces the device's per-position 128-entry
    PROB_CORRECT gather with a 16-way select chain."""
    q = np.clip(quality[:, :L], 0, 127).astype(np.uint8)
    pal = np.unique(q)
    if len(pal) > 16:
        return None, None, None
    B = q.shape[0]
    pal16 = np.zeros(16, np.uint8)
    pal16[:len(pal)] = pal
    lut = np.zeros(128, np.uint8)
    lut[pal] = np.arange(len(pal), dtype=np.uint8)
    qi = lut[q]
    W8 = (L + 7) // 8
    pad = np.zeros((B, W8 * 8), np.uint8)
    pad[:, :L] = qi
    n8 = pad[:, 0::2] | (pad[:, 1::2] << 4)
    qpack = np.ascontiguousarray(n8).view(np.uint32)
    pcpal = seed_host.PROB_CORRECT[pal16]
    return qpack, pal16.astype(np.int32), pcpal.astype(np.float32)


def unpack_quality_device(qpack, palette, pcpal, L: int):
    """Device inverse of pack_quality_host -> (q (B, L) int32,
    pc (B, L) float32). The palette/pcpal tables are traced inputs
    (16,), so palette changes never recompile; values resolve via
    16-way select chains — exact (single match per position)."""
    B = qpack.shape[0]
    nibs = jnp.stack([(qpack >> jnp.uint32(4 * s)) & jnp.uint32(15)
                      for s in range(8)], axis=2)       # (B, W8, 8)
    qi = nibs.reshape(B, -1)[:, :L].astype(I32)
    q = jnp.zeros(qi.shape, I32)
    pc = jnp.zeros(qi.shape, jnp.float32)
    for i in range(16):
        hit = qi == i
        q = jnp.where(hit, palette[i].astype(I32), q)
        pc = jnp.where(hit, pcpal[i], pc)
    return q, pc


def quality_offsets_stage_packed(cfg: QmConfig, qpack, palette, pcpal,
                                 density: float, max_density: float,
                                 return_weights: bool = False):
    """quality_offsets_stage over palette-packed quality (see
    pack_quality_host). Bit-identical results to the raw path."""
    q, pc = unpack_quality_device(qpack, palette, pcpal, cfg.L)
    return _quality_offsets_core(cfg, q, pc, density, max_density,
                                 return_weights)


def _quality_offsets_core(cfg: QmConfig, q, pc, density: float,
                          max_density: float,
                          return_weights: bool = False):
    k, L = cfg.k, cfg.L
    m = L - k + 1
    nk = len(cfg.offsets_list)
    F32 = jnp.float32
    prob = pc[:, 0:m]
    for j in range(1, k):
        prob = prob * pc[:, j:m + j]
    probs = (F32(1.0) - prob)
    z = q == 0
    haszero = z[:, 0:m]
    for j in range(1, k):
        haszero = haszero | z[:, j:m + j]
    probs = jnp.where(haszero, F32(1.0), probs)

    l1 = F32(0.94)
    l2 = F32(0.9999)
    idx = jnp.arange(m, dtype=I32)[None, :]
    ok1 = probs < l1
    ok2 = probs < l2
    any1 = ok1.any(axis=1)
    left = jnp.argmax(ok1, axis=1).astype(I32)
    right = (m - 1) - jnp.argmax(ok1[:, ::-1], axis=1).astype(I32)
    inwin = (idx >= left[:, None]) & (idx <= right[:, None])
    potential = jnp.sum((inwin & ok2).astype(I32), axis=1)
    valid_read = any1 & (potential > 0) & (right >= left)
    usable = right - left + k
    slots_u = usable - k + 1
    # XLA lowers f32 division as reciprocal-multiply, which differs from
    # true IEEE division by an ulp on some operands — enough to flip the
    # discrete desired/interval values vs the host seeding path
    # (observed: interval 97/16 picking offset 51 where the host picks
    # 50). Both divisions here have tiny integer operand ranges, so they
    # resolve through HOST-computed tables (closure constants, ~10 KB)
    # with exact host semantics: d2 in float64 like
    # seed.desired_keys_from_density, interval in true f32 division like
    # seed.make_offsets3.
    d2_tab = jnp.asarray(np.ceil(
        np.arange(L + 1, dtype=np.float64) * float(max_density)
        / float(k)).astype(np.int32))
    d2 = take_flat(d2_tab, jnp.clip(usable, 0, L))
    d2 = jnp.minimum(slots_u, jnp.maximum(2, d2))
    desired = jnp.where(usable < L, jnp.minimum(nk, d2), nk)
    desired = jnp.maximum(jnp.minimum(desired, potential), 1)
    div_tab = (np.arange(m, dtype=np.float32)[:, None]
               / np.maximum(np.arange(nk, dtype=np.float32)[None, :],
                            np.float32(1.0))).astype(np.float32)
    span = jnp.clip(right - left, 0, m - 1)
    dm1 = jnp.clip(desired - 1, 0, nk - 1)
    interval = take_flat(jnp.asarray(div_tab.ravel()),
                         span * nk + dm1)
    interval_int = interval.astype(I32) + 1

    offs = []
    f = left.astype(F32)
    prev = jnp.full(q.shape[:1], -1, I32)
    j = left
    for i in range(nk):
        active = (i < desired) & valid_read
        # probs[b, j[b]] via masked sum — exactly one match per row, so
        # the f32 sum is exact
        pj = jnp.sum(jnp.where(idx == jnp.clip(j, 0, m - 1)[:, None],
                               probs, F32(0.0)), axis=1)
        condA = pj < l2
        # backward: largest kk in (prev+2, j-1] passing l2 (:459-462)
        mb = ok2 & (idx > (prev + 2)[:, None]) & (idx <= (j - 1)[:, None])
        xb = jnp.max(jnp.where(mb, idx, -1), axis=1).astype(I32)
        # forward: smallest kk in [j+1, min(j+intervalInt, right))
        lim = jnp.minimum(j + interval_int, right)
        mc = ok2 & (idx >= (j + 1)[:, None]) & (idx < lim[:, None])
        xc = jnp.min(jnp.where(mc, idx, m + 9), axis=1).astype(I32)
        xc = jnp.where(xc >= m + 9, -1, xc)
        x = jnp.where(condA, j, jnp.where(xb >= 0, xb, xc))
        x = jnp.where(active & (prev < j), x, -1)
        offs.append(x)
        hit = x > -1
        prev = jnp.where(active,
                         jnp.where(hit, x, jnp.maximum(prev, j - 2)),
                         prev)
        f = jnp.where(active, f + interval, f)
        j = jnp.where(
            active,
            jnp.minimum(m - 1, jnp.maximum(
                j + 1, jnp.floor(f + F32(0.5)).astype(I32))),
            j)
    offsets = jnp.stack(offs, axis=1)                    # (B, nk)
    ladder = jnp.asarray(np.asarray(cfg.offsets_list, np.int32))
    out_off = jnp.where(valid_read[:, None], offsets,
                        jnp.broadcast_to(ladder[None, :], offsets.shape))
    if not return_weights:
        return out_off
    # keyProbs at the chosen offsets -> Solver greedy weights
    # (reference: AbstractMapThread.java:704-727 — keyScoresAll[i] =
    # baseKeyScore + (int)Math.round(range*(1-keyProbs[i])) with
    # a = 100*k, baseKeyScore = a/8, range = a - baseKeyScore; then
    # keyWeights = keyScores * (1f/a), BBIndex.trimExcessHitListsByGreedy
    # :268-270 — all float32 like the Java)
    active = out_off > -1
    # probs at the chosen offsets via a one-match masked sum (exact)
    clip_off = jnp.clip(out_off, 0, m - 1)
    psel = jnp.sum(
        jnp.where(clip_off[:, :, None] == idx[:, None, :],
                  probs[:, None, :], F32(0.0)), axis=2)
    psel = jnp.where(active, psel, F32(1.0))
    a = 100 * k
    base_ks = a // 8
    rng_i = a - base_ks
    # the barrier keeps the product rounded to f32 before the +0.5: a
    # GPU compiler may otherwise contract the two into one FMA, which
    # rounds once and can move floor() by one
    prod = jax.lax.optimization_barrier(F32(rng_i) * (F32(1.0) - psel))
    score = base_ks + jnp.floor(prod + F32(0.5)).astype(I32)
    inv = np.float32(1.0) / np.float32(a)
    wts = score.astype(F32) * inv
    # probAllErrors rejection (AbstractMapThread.java:720-723): the
    # product runs over the USED offsets only (misses are compacted out
    # of the reference's offsets array). Fallback-ladder reads are kept
    # (documented deviation: the reference drops reads whose offset
    # selection fails entirely; we map them with the static ladder).
    # SEQUENTIAL f32 product in slot order (the Java multiplies in a
    # loop, AbstractMapThread.java:721; jnp.prod may reduce tree-wise,
    # which differs in ulps — and the host-C twin multiplies
    # sequentially too)
    pmask = jnp.where(active, psel, F32(1.0))
    pae = pmask[:, 0]
    for i in range(1, nk):
        pae = pae * pmask[:, i]
    reject = valid_read & (pae > F32(0.5))
    return out_off, wts, reject


def candidate_stage(cfg: QmConfig, bases, starts_d, sites_d,
                    gcnt_d=None, offsets_dyn=None, rcodes=None,
                    scnt_d=None, _stop=None, ccnt_d=None,
                    two_tier: bool = False, weights_dyn=None,
                    reject=None):
    """Steps 1-5 (seed -> chain -> vote -> top-K candidates) against ONE
    CSR index shard. Returns (rcodes (B, L), cand dict of (B, K) arrays:
    votes, mode, strand, start, spread).

    ``gcnt_d``: optional per-key GLOBAL site-list length table (uint8,
    saturated at 255 — every admission threshold is < 255). On the
    sharded path each shard sees only its local list, so over-long-list
    exclusion, staged re-admission, and the greedy slot budget
    (reference: BBIndex.find:421-440) must consult the GLOBAL length to
    reproduce the single-device decisions bit for bit — single-device
    passes None and uses the local (= global) count directly."""
    k, L, S = cfg.k, cfg.L, cfg.S
    chain_dist = cfg.chain_dist
    offsets_list = cfg.offsets_list
    nk = len(offsets_list)
    offsets_d = jnp.asarray(np.asarray(offsets_list, np.int32))
    offadj_minus = jnp.asarray(
        (L - (np.asarray(offsets_list) + k)).astype(np.int32))
    INVALID = jnp.int32(2 ** 30)

    if True:
        if rcodes is None:
            rcodes = ascii_to_codes(bases)                  # (B, L) 0..4
        B = rcodes.shape[0]
        if offsets_dyn is None:
            kp = _keys_from_codes(rcodes, offsets_list, k,
                                  L)                        # (B, nk)
            off_p = jnp.broadcast_to(offsets_d, (B, nk))
            off_m = jnp.broadcast_to(offadj_minus, (B, nk))
        else:
            # per-read quality-selected offsets (-1 = unused slot)
            keys_all = _keys_all_positions(rcodes, k, L)    # (B, m)
            m = L - k + 1
            od = offsets_dyn.astype(I32)
            kp = take_along_flat(keys_all, jnp.clip(od, 0, m - 1))
            kp = jnp.where(od < 0, -1, kp)
            if reject is not None:
                # probAllErrors > 0.5 read rejection (reference:
                # AbstractMapThread.java:720-723 returns -1 — unmapped)
                kp = jnp.where(reject[:, None], -1, kp)
            off_p = jnp.maximum(od, 0)
            off_m = L - (off_p + k)
        km = jnp.where(kp < 0, -1, _rc_keys(jnp.where(kp < 0, 0, kp), k))
        keys = jnp.stack([kp, km], axis=1)                  # (B, 2, nk)
        offadj = jnp.stack([off_p, off_m], axis=1)
        valid = keys >= 0
        safe = jnp.where(valid, keys, 0)
        if _stop == "keys":
            return rcodes, {"a": safe}
        if scnt_d is not None:
            sc = take_flat(scnt_d, safe)
            s0 = (sc >> 8).astype(I32)
            cnt_local = (sc & 255).astype(I32)
        else:
            s0 = take_flat(starts_d, safe)
            cnt_local = take_flat(starts_d, safe + 1) - s0
        # admission consults the GLOBAL list length (== local on the
        # single-device path); gathers use the LOCAL length
        gcnt = cnt_local if gcnt_d is None \
            else take_flat(gcnt_d, safe).astype(I32)
        # over-long lists are skipped entirely (reference exclusion
        # semantics, BBIndex.find:421-440), not truncated.
        # staged re-admission (reference: BBIndex.find:421-440):
        # when a (read, strand) hits too few keys at the base cap,
        # progressively longer lists (1.5x/2x/3x/5x) are re-admitted
        if _stop == "gather0":
            return rcodes, {"a": cnt_local, "b": s0}
        if cfg.ref_admit and ccnt_d is not None:
            # reference-faithful retention: staged re-admission on
            # CANONICAL counts + Solver-weighted greedy trim, decided
            # once per read on the plus-strand layout and mirrored to
            # the minus strand (oracle: align/search_oracle.py)
            ccnt_p = take_flat(ccnt_d, jnp.where(kp < 0, 0, kp))
            ccnt_p = jnp.where(kp < 0, 0, ccnt_p)       # (B, nk)
            alive = _ref_retention(cfg, kp, off_p.astype(I32), ccnt_p,
                                   weights=weights_dyn)
            admit = jnp.broadcast_to(alive[:, None, :],
                                     (B, 2, nk))
            # budget packing ranks by the canonical (global) length —
            # shard-stable by construction
            gadm = jnp.where(admit, ccnt_p[:, None, :], 0)
        else:
            nz = valid & (gcnt > 0)
            tiers = (S, (3 * S) // 2, 2 * S, 3 * S, 5 * S)
            nh = [jnp.sum((nz & (gcnt <= t)).astype(I32), axis=-1)
                  for t in tiers]                   # each (B, 2)
            trig = (3 * nk) // 4
            sel = jnp.zeros_like(nh[0])
            esc = (nh[0] > 0) & (nh[0] < 4) & (nh[0] < trig)
            sel = jnp.where(esc, 1, sel)
            cur = jnp.where(esc, nh[1], nh[0])
            for t, need in ((2, 3), (3, 3), (4, 2)):
                esc = esc & (cur < need) & (cur < trig)
                sel = jnp.where(esc, t, sel)
                cur = jnp.where(esc, nh[t], cur)
            tier_arr = jnp.asarray(np.asarray(tiers, np.int32))
            Tsel = tier_arr[sel][..., None]          # (B, 2, 1)
            admit = gcnt <= Tsel
            gadm = jnp.where(valid & admit, gcnt, 0)
        # greedy hit-list trimming, APPROXIMATING the reference's
        # weighted greedy trim by list length only (reference: BBIndex
        # trimExcessHitListsByGreedy:266 removes the worst list by
        # Solver.findWorstGreedy key-score weights under
        # limit/limit2/maxHitLists conditions — not bit-parity with that
        # heuristic; ADVICE r2): when the admitted lists overflow the
        # slot budget, lists are admitted shortest-first while the
        # cumulative (GLOBAL) length stays within budget, so every shard
        # reproduces the single-device decision deterministically. A
        # list is always dropped WHOLE (exclusion semantics), never
        # truncated. Ties break toward the earlier key offset.
        # shortest-first greedy realized as a pairwise rank-sum instead
        # of argsort+take_along+inverse-argsort: key j precedes key k
        # iff (len_j, j) < (len_k, k) lexicographically, so k fits iff
        # the summed length of its predecessors (inclusive) is within
        # budget. nk is tiny, so the (B, 2, nk, nk) broadcast is cheap
        # (bit-identical to the sort chain).
        SB = cfg.slot_budget
        g1 = jnp.where(gadm > 0, gadm, BIG)
        if nk <= 64:
            # pairwise rank-sum (9x faster than the sort chain at the
            # short stack's tiny nk)
            ar_nk = jnp.arange(nk, dtype=I32)
            before = (g1[:, :, :, None] < g1[:, :, None, :]) | \
                ((g1[:, :, :, None] == g1[:, :, None, :])
                 & (ar_nk[:, None] <= ar_nk[None, :]))
            csum = jnp.sum(jnp.where(before, gadm[:, :, :, None], 0),
                           axis=2)
            fits = csum <= SB
        else:
            # long-read nk (hundreds of keys): the (B, 2, nk, nk)
            # rank-sum tensor is GBs — shortest-first via a stable
            # argsort + inclusive cumsum + inverse permutation,
            # same (len, index)-lexicographic order
            order = jnp.argsort(g1, axis=-1, stable=True)
            g_sorted = jnp.take_along_axis(gadm, order, axis=-1)
            csum_sorted = jnp.cumsum(g_sorted, axis=-1)
            fits_sorted = csum_sorted <= SB
            inv = jnp.argsort(order, axis=-1, stable=True)
            fits = jnp.take_along_axis(fits_sorted, inv, axis=-1)
        cnt = jnp.where(valid & admit & fits & (gadm > 0),
                        cnt_local, 0)
        if _stop == "admit":
            return rcodes, {"a": cnt}
        # budget-slot gather: pack each (read, strand)'s site lists into
        # SLOT_BUDGET contiguous slots via prefix sums — the compute cost
        # scales with the budget, not nk * (longest allowed list). The
        # slot->key assignment is an unrolled interval test per key
        # (3D elementwise ops) rather than a (B, 2, nk, WB) searchsorted
        # tensor + take_along chains, which XLA lowers ~2x slower.
        WB = cfg.slot_budget
        cum = jnp.cumsum(cnt, axis=-1)                      # (B, 2, nk)
        wslot = jnp.arange(WB, dtype=I32)
        if nk <= 64:
            # slot->key assignment as an unrolled interval test per key
            # (XLA lowers this ~2x faster than searchsorted chains at
            # the short stack's tiny nk)
            base = jnp.zeros((B, 2, WB), I32)   # s0_t - cum0_t of key
            offadj_slot = jnp.zeros((B, 2, WB), I32)
            toff_slot = jnp.zeros((B, 2, WB), I32)
            cum_prev = jnp.zeros((B, 2), I32)
            for t in range(nk):
                cum_t = cum[:, :, t]
                m = (cum_prev[..., None] <= wslot) \
                    & (wslot < cum_t[..., None])
                base = jnp.where(m, (s0[:, :, t] - cum_prev)[..., None],
                                 base)
                offadj_slot = jnp.where(m, offadj[:, :, t][..., None],
                                        offadj_slot)
                toff_slot = jnp.where(m, t, toff_slot)
                cum_prev = cum_t
        else:
            # vectorized slot->key assignment (an nk-unrolled loop at
            # the PacBio nk~750 traces 4500+ ops and compiles for
            # minutes): owning key t = #{cum <= w}, then gather the
            # key's base/offadj per slot
            t_of = jnp.sum((cum[:, :, None, :]
                            <= wslot[None, None, :, None]).astype(I32),
                           axis=-1)                       # (B, 2, WB)
            t_clip = jnp.clip(t_of, 0, nk - 1)
            cum_prev_k = jnp.concatenate(
                [jnp.zeros((B, 2, 1), I32), cum[:, :, :-1]], axis=-1)
            base = take_along_flat(s0 - cum_prev_k, t_clip)
            offadj_slot = take_along_flat(offadj, t_clip)
            toff_slot = t_clip
        valid_slot = wslot < cum[..., -1:]
        gather_idx = jnp.clip(base + wslot, 0, sites_d.shape[0] - 1)
        hi_over = None
        if not two_tier:
            site = take_flat(sites_d, gather_idx)           # (B, 2, WB)
        else:
            # two-tier slot gather: the admitted-site total is heavily
            # skewed (bench-class genome: median 6, p99 23 of 64 slots),
            # so the upper half of the slot axis is gathered only for
            # the few (read, strand) rows that actually need it —
            # compacted to a static budget HB (gather cost ~B*2*LO +
            # HB*LO instead of B*2*WB). Rows whose upper tier falls off the budget lose
            # those slots in-device and are flagged (``hi_over``) for
            # the caller's exact host-refit fallback — same contract as
            # the escalation/trace budget overflows (fused_device).
            LO = WB // 2
            R2 = B * 2
            site_lo = take_flat(sites_d, gather_idx[:, :, :LO])
            need_hi = (cum[:, :, -1] > LO).reshape(R2)
            HB = hi_budget(R2)
            pri = jnp.where(need_hi, jnp.arange(R2, dtype=I32), INVALID)
            if HB >= R2:
                rows = jnp.sort(pri)
            else:
                rows = -jax.lax.top_k(-pri, HB)[0]
            ok = rows < INVALID
            rcl = jnp.clip(rows, 0, R2 - 1)
            hi_idx = gather_idx.reshape(R2, WB)[:, LO:]
            site_hi_rows = take_flat(sites_d, hi_idx[rcl])   # (HB, LO)
            rows_s = jnp.where(ok, rcl, R2)       # trash-slot scatter
            site_hi = jnp.zeros((R2 + 1, LO), sites_d.dtype).at[
                rows_s].set(site_hi_rows)[:R2]
            covered = jnp.zeros(R2 + 1, bool).at[rows_s].set(
                True)[:R2]
            ok_hi = (covered | ~need_hi).reshape(B, 2, 1)
            valid_slot = valid_slot & jnp.concatenate(
                [jnp.ones((B, 2, LO), bool),
                 jnp.broadcast_to(ok_hi, (B, 2, LO))], axis=-1)
            hi_over = (need_hi & ~covered).reshape(B, 2).any(axis=1)
            site = jnp.concatenate(
                [site_lo, site_hi.reshape(B, 2, LO)], axis=-1)
        diag = jnp.where(valid_slot, site - offadj_slot, INVALID)
        if _stop == "slots":
            return rcodes, {"a": diag}
        # sort diagonals within each (read, strand), carrying each
        # slot's key index so votes can count DISTINCT offsets
        # (reference: BBIndex voting counts keys, not raw hits —
        # round-1 deviation now removed)
        flat, toff = jax.lax.sort(
            (diag.reshape(B * 2, WB), toff_slot.reshape(B * 2, WB)),
            dimension=1, num_keys=1)
        valid_f = flat < INVALID
        if _stop == "sort":
            return rcodes, {"a": flat, "b": toff}

        # chain segmentation — scatter-free: all per-chain statistics are
        # carried by each chain's FIRST element via prefix scans + gathers
        # (segment_sum/min/max lower to scatters; cumsum/cummax do not)
        W = WB
        nseg = W
        R2 = B * 2
        dd = jnp.diff(flat, axis=1)
        new_chain = jnp.concatenate(
            [jnp.ones((R2, 1), bool), dd > chain_dist], axis=1)
        new_chain &= valid_f
        idx = jax.lax.broadcasted_iota(I32, (R2, W), 1)
        # boundary = start of the NEXT chain (or first invalid slot)
        boundary = new_chain | ~valid_f
        # next boundary strictly after e: reverse cummin of boundary idx
        bidx = jnp.where(boundary, idx, W)
        nxt = jnp.flip(jax.lax.cummin(jnp.flip(bidx, 1), axis=1), 1)
        next_start = jnp.concatenate(
            [nxt[:, 1:], jnp.full((R2, 1), W, I32)], axis=1)
        last_idx = jnp.clip(next_start - 1, 0, W - 1)
        seg_start0 = jax.lax.cummax(jnp.where(new_chain, idx, 0), axis=1)

        # distinct-offset votes (reference: BBIndex key voting): bitmask
        # segmented prefix-OR by doubling (gather-free), then the chain
        # total is broadcast back to the chain-first slot via a packed
        # reverse cummax. One 32-bit mask word per group of 32 key
        # offsets (nk is static), so long-read key counts > 32 stay
        # exact instead of aliasing mod 32.
        n_groups = (nk + 31) // 32
        mbits = [jnp.where(valid_f & ((toff >> 5) == gi),
                           1 << (toff & 31), 0)
                 for gi in range(n_groups)]
        incls = list(mbits)
        s = 1
        while s < W:
            prev_ok = idx - s >= seg_start0
            for gi in range(n_groups):
                shifted = jnp.concatenate(
                    [jnp.zeros((R2, s), I32), incls[gi][:, :-s]], axis=1)
                incls[gi] = incls[gi] | jnp.where(prev_ok, shifted, 0)
            s <<= 1
        in_seg = idx - 1 >= seg_start0
        is_new = valid_f
        for gi in range(n_groups):
            seen_excl = jnp.concatenate(
                [jnp.zeros((R2, 1), I32), incls[gi][:, :-1]], axis=1)
            seen_excl = jnp.where(in_seg, seen_excl, 0)
            is_new &= (seen_excl & mbits[gi]) == 0
        c = jnp.cumsum(is_new.astype(I32), axis=1)
        cbase = jax.lax.cummax(
            jnp.where(new_chain, c - is_new.astype(I32), -1), axis=1)
        dc = c - jnp.maximum(cbase, 0)          # distinct count so far
        seg_ord0 = jnp.cumsum(new_chain.astype(I32), axis=1)
        packed_dc = ((W + 1 - seg_ord0) << 16) | jnp.where(valid_f, dc, 0)
        rmax = jnp.flip(jax.lax.cummax(jnp.flip(packed_dc, 1), axis=1), 1)
        chain_distinct = rmax & 0xFFFF
        size = jnp.where(new_chain, chain_distinct, 0)
        if _stop == "votes":
            return rcodes, {"a": size}

        # modal diagonal: longest equal-diag run in the chain; ties ->
        # lowest diag. Encode (run_size, earliness) per run-first element
        # and take the chain max via an ordinal-offset cummax.
        dd_eq = jnp.concatenate(
            [jnp.ones((R2, 1), bool), dd != 0], axis=1)
        new_run = (dd_eq | new_chain) & valid_f
        ridx = jnp.where(new_run | ~valid_f, idx, W)
        rnxt = jnp.flip(jax.lax.cummin(jnp.flip(ridx, 1), axis=1), 1)
        rnext = jnp.concatenate(
            [rnxt[:, 1:], jnp.full((R2, 1), W, I32)], axis=1)
        run_size = jnp.where(new_run, rnext - idx, 0)
        seg_start = jax.lax.cummax(
            jnp.where(new_chain, idx, -1), axis=1)
        in_chain_off = jnp.clip(idx - seg_start, 0, 255)
        meta = (jnp.clip(run_size, 0, 255) << 8) | (255 - in_chain_off)
        seg_ord = jnp.cumsum(new_chain.astype(I32), axis=1)  # 1..W
        glob = (seg_ord << 16) | jnp.where(new_run, meta, 0)
        gmax = jax.lax.cummax(glob, axis=1)

        # candidate table per read: (B, 2*W); non-first elements have 0
        # votes and never reach the top-k. Full-width per-row gathers
        # (take_along_axis) are deferred until after top_k — a
        # (B, 2W)-wide take costs ~10x the whole top_k, a (B, K)-wide
        # take is noise.
        votes = size.reshape(B, 2 * nseg)
        if _stop == "runs":
            return rcodes, {"a": votes, "b": gmax}
        topv, topi = jax.lax.top_k(votes, MAX_CANDIDATES)  # (B, K)
        if _stop == "topk":
            return rcodes, {"a": topv, "b": topi}
        # global-slot helpers: second half of the slot axis is strand 1
        half = (topi >= nseg).astype(I32)
        cd_strand = half
        strand_off = half * nseg
        flat2 = flat.reshape(B, 2 * nseg)
        last2 = last_idx.reshape(B, 2 * nseg)
        segs2 = seg_start.reshape(B, 2 * nseg)
        gmax2 = gmax.reshape(B, 2 * nseg)
        # the remaining takes share three indexes: round 1 indexes by
        # topi, round 2 by the derived cd_last, round 3 by the modal-run
        # slot. A native gather: on the H100 it beat the one-hot matmul
        # that stood here for the TPU by ~5.6x at this shape (PERF.md)
        cd_start, last_raw, segs_raw = (
            take_along_flat(a, topi) for a in (flat2, last2, segs2))
        if _stop == "take1":
            return rcodes, {"a": cd_start}
        cd_last = jnp.clip(last_raw + strand_off,
                           0, 2 * nseg - 1)          # global last idx
        cd_stop, win = (take_along_flat(a, cd_last)
                        for a in (flat2, gmax2))
        win_off = 255 - (win & 0xFF)
        cd_mode_idx = jnp.clip(segs_raw + win_off, 0, nseg - 1)
        cd_mode = take_along_flat(
            flat2, jnp.clip(cd_mode_idx + strand_off, 0, 2 * nseg - 1))
        cd_votes = topv
        cd_valid = cd_votes > 0
        cd_spread = jnp.where(cd_valid,
                              (cd_stop - cd_start).astype(I32), 0)
        cand = {"votes": cd_votes, "mode": cd_mode,
                "strand": cd_strand, "start": cd_start,
                "spread": cd_spread}
        if hi_over is not None:
            cand["hi_over"] = hi_over
        return rcodes, cand


def finalize_stage(cfg: QmConfig, rcodes, cand, gpack_d, nmask_d,
                   return_scores: bool = False, boost_fn=None):
    """Steps 6-7: gapless scoring of the candidate table at each modal
    diagonal + best/second selection + packed match symbols. ``cand`` is
    the dict produced by candidate_stage (possibly merged across index
    shards). Returns (out_i32 (B, N_META + 5K), out_match packed).

    ``boost_fn(scores) -> sel``: optional selection-score override (the
    paired path passes the pair-boost; reference:
    AbstractMapThread.pairSiteScoresFinal:1919). Winner/second selection
    and the match block follow ``sel``; best_score stays the raw gapless
    score of the selected slot and meta gains an [eff] column."""
    L, G, min_score = cfg.L, cfg.G, cfg.min_score
    INVALID = jnp.int32(2 ** 30)
    L4 = (L + 3) // 4
    B = rcodes.shape[0]
    cd_votes = cand["votes"]
    cd_mode = cand["mode"]
    cd_strand = cand["strand"]
    cd_start = cand["start"]
    cd_spread = cand["spread"]
    cd_valid = cd_votes > 0

    if True:
        # gapless scoring at modal diagonal, against the packed genome
        ref_codes, ref_n = extract_ref_codes(
            gpack_d, nmask_d, cd_mode, L, G,
            has_n=cfg.has_n)                         # (B, C, L)
        rc = jnp.where(rcodes <= 3, 3 - rcodes, rcodes)[:, ::-1]
        cand_codes = jnp.where((cd_strand == 0)[..., None],
                               rcodes[:, None, :], rc[:, None, :])
        read_n = cand_codes > 3
        eq = (cand_codes == ref_codes) & ~ref_n
        is_match = eq & ~read_n
        is_sub = ~eq & ~read_n & ~ref_n
        scores = score_match_sub_vec(is_match, is_sub,
                                     cfg.profile)       # (B, C)
        scores = jnp.where(cd_valid, scores, -(2 ** 30))

        # optional selection-score override (paired path: pair boost) —
        # ordering/winner selection follow ``sel``, the reported
        # best_score stays the RAW gapless score of the selected slot
        # (mirrors the host _repick semantics, pipeline._repick)
        sel = scores if boost_fn is None else boost_fn(scores)
        # per-read best/second (deterministic: score desc, then slot order,
        # slots already sorted by votes desc then segment order)
        order = jnp.argsort(-sel, axis=1, stable=True)
        o0 = order[:, 0:1]
        o1 = order[:, 1:2]
        g1 = lambda a, o: jnp.take_along_axis(a, o, axis=1)[:, 0]
        best_score = g1(scores, o0)
        second_score = g1(sel, o1)
        n_good = jnp.sum(scores >= min_score, axis=1).astype(I32)

        # match symbols of the best site: 2-bit codes 0=m 1=S 2=N
        sym2 = jnp.where(read_n | ref_n, 2,
                         jnp.where(eq, 0, 1)).astype(jnp.uint8)  # (B,C,L)
        best_sym = jnp.take_along_axis(
            sym2, o0[..., None], axis=1)[:, 0]                   # (B, L)
        pad = jnp.full((B, L4 * 4 - L), 3, jnp.uint8)
        padded = jnp.concatenate([best_sym, pad], axis=1)
        quads = padded.reshape(B, L4, 4).astype(jnp.uint32)
        packshift = jnp.arange(4, dtype=U32) * 2
        out_match = (quads << packshift[None, None, :]).sum(
            axis=2, dtype=jnp.uint32).astype(jnp.uint8)

        meta_cols = jnp.stack([
            best_score.astype(I32), g1(cd_mode, o0), g1(cd_strand, o0),
            g1(cd_start, o0), g1(cd_spread, o0).astype(I32),
            second_score.astype(I32), n_good], axis=1)        # (B, 7)
        cand_block = jnp.stack([
            scores.astype(I32), cd_mode, cd_strand, cd_start,
            cd_spread.astype(I32)], axis=1).reshape(
                B, N_CFIELD * cd_votes.shape[1])
        if boost_fn is not None:
            # paired path appends [eff (boosted winner score)] so the
            # host can apply clearzone on boosted values
            meta_cols = jnp.concatenate(
                [meta_cols, g1(sel, o0).astype(I32)[:, None]], axis=1)
        out_i32 = jnp.concatenate([meta_cols, cand_block], axis=1)
        if return_scores:
            if boost_fn is not None:
                return out_i32, out_match, scores.astype(I32), \
                    sel.astype(I32)
            return out_i32, out_match, scores.astype(I32)
        return out_i32, out_match


def build_quickmap(index: KmerIndex, L: int, chain_dist: int = 400,
                   min_ratio: float = 0.56,
                   max_list_length: Optional[int] = None,
                   profile=None):
    """Returns quickmap(bases_ascii (B, L) uint8) -> QuickmapRun.
    Device-resident constants (CSR index + packed genome) are closed
    over. The per-key site-list cap adapts to the index's frequency
    analysis (reference: analyzeIndex MAX_USABLE_LENGTH) and to the
    actual longest list, bounded by MAX_SITES_CAP."""
    cfg = make_config(index, L, chain_dist, min_ratio, max_list_length,
                      profile)
    starts_d, sites_d, gpack_d, nmask_d, _G = device_arrays(index)
    scnt_d = scnt_array(index)
    ccnt_d = ccnt_array(index) if cfg.ref_admit else None
    den2, den3 = seed_host.key_density_ladder(L, index.k)

    def quickmap(bases, starts_d, sites_d, gpack_d, nmask_d, scnt_d,
                 ccnt_d):
        rcodes, cand = candidate_stage(cfg, bases, starts_d, sites_d,
                                       scnt_d=scnt_d, ccnt_d=ccnt_d)
        return finalize_stage(cfg, rcodes, cand, gpack_d, nmask_d)

    def quickmap_q(bases, qual, starts_d, sites_d, gpack_d, nmask_d,
                   scnt_d, ccnt_d):
        # quality-probability key offsets + keyProbs greedy weights +
        # probAllErrors rejection, same semantics as the host seeding
        # path (VERDICT r1 #9, r4 missing #1; reference:
        # KeyRing.makeOffsets3 + AbstractMapThread.java:704-727)
        offs, wts, rej = quality_offsets_stage(cfg, qual, den2, den3,
                                               return_weights=True)
        rcodes, cand = candidate_stage(cfg, bases, starts_d, sites_d,
                                       offsets_dyn=offs, scnt_d=scnt_d,
                                       ccnt_d=ccnt_d, weights_dyn=wts,
                                       reject=rej)
        return finalize_stage(cfg, rcodes, cand, gpack_d, nmask_d)

    jitted = jax.jit(quickmap)
    jitted_q = jax.jit(quickmap_q)

    def run(bases, quality=None) -> QuickmapRun:
        if quality is None:
            out_i32, out_match = jitted(bases, starts_d, sites_d,
                                        gpack_d, nmask_d, scnt_d,
                                        ccnt_d)
        else:
            out_i32, out_match = jitted_q(bases, quality, starts_d,
                                          sites_d, gpack_d, nmask_d,
                                          scnt_d, ccnt_d)
        return QuickmapRun(out_i32, out_match, L)

    return run


_COMP_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A")]:
    _COMP_TABLE[ord(_a)] = ord(_b)
