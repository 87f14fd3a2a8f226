"""Device k-mer set scan for BBDuk/BBDuk2/Seal — the rolling
lookup hot loop of the reference run as ONE jitted XLA program per read
batch (reference: jgi/BBDukF.java ProcessThread per-base rolling lookup;
SURVEY §3.3 hot loop).

Design: the sorted-value set (index/kmerset.py) is already the layout a
device wants — membership is a vectorized branchless binary search. int64
values are carried as (hi, lo) uint32 pairs (no jax_enable_x64), and a
radix bucket table over the value's top bits narrows each search to a
handful of probe rounds:

1. rolling (hi, lo) 2-bit k-mers of every read position via k shifted
   slices (no gathers)
2. canonicalization (max(kmer, rc)), middle-base mask, length-mask bit —
   bit-for-bit the host ``KmerSet.to_values`` / reference
   ``jgi/BBDukF.toValue``
3. bucket = top bits -> [start, end) slice of the sorted array
   (host-precomputed prefix table)
4. T rounds of branchless lower-bound (T = ceil(log2(max bucket len)),
   typically 3-6) — each round is one lane-aligned gather pair
5. final equality probe -> per-position scaffold ids ((B, m) int32, -1
   for miss), identical to the host ``scan_batch``

The host numpy path remains the reference implementation; parity is
asserted in tests/test_bbduk_device.py on adapter corpora and random
batches.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .kmerset import KmerSet, length_mask, middle_mask

I32 = None  # populated lazily with jnp dtypes (keep module import cheap)


def _jnp():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _rev2_32(x):
    """Reverse the 16 2-bit groups of each uint32 lane."""
    _, jnp = _jnp()
    x = ((x & jnp.uint32(0x33333333)) << 2) | \
        ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | \
        ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | \
        ((x >> 8) & jnp.uint32(0x00FF00FF))
    x = ((x & jnp.uint32(0x0000FFFF)) << 16) | (x >> 16)
    return x


def _shr_pair(hi, lo, s: int):
    """Logical right shift of a (hi, lo) uint32 pair by static s."""
    _, jnp = _jnp()
    if s == 0:
        return hi, lo
    if s < 32:
        lo2 = (lo >> s) | (hi << (32 - s))
        hi2 = hi >> s
        return hi2, lo2
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (s - 32)


def _rc_pair(hi, lo, k: int):
    """Reverse complement of a 2k-bit k-mer held in (hi, lo)."""
    _, jnp = _jnp()
    nhi = ~hi
    nlo = ~lo
    rhi = _rev2_32(nlo)
    rlo = _rev2_32(nhi)
    return _shr_pair(rhi, rlo, 64 - 2 * k)


def _lt_pair(h1, l1, h2, l2):
    return (h1 < h2) | ((h1 == h2) & (l1 < l2))


class DeviceKmerSet:
    """Device-resident mirror of a host KmerSet for one k-mer length."""

    N_BUCKET_BITS = 16

    def __init__(self, ks: KmerSet):
        import jax
        self.k = ks.k
        self.rcomp = ks.rcomp
        self.mask_middle = ks.mask_middle
        self.n = len(ks.values)
        v = ks.values.astype(np.uint64)
        self.hi_np = (v >> np.uint64(32)).astype(np.uint32)
        self.lo_np = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        self.hi = jax.device_put(self.hi_np)
        self.lo = jax.device_put(self.lo_np)
        self.ids = jax.device_put(ks.ids.astype(np.int32))
        self.sparse_ok = (len(ks.ids) == 0
                          or int(ks.ids.max()) < 32767)
        # radix bucket table over the top bits: values fit in
        # 2k+1 bits (length-mask bit 2k is the highest set bit for
        # uniform-k sets; mixed mink lengths only lower it)
        bits = 2 * ks.k + 1
        NB = min(self.N_BUCKET_BITS, bits)
        self.shift = max(0, bits - NB)
        bkt = (v >> np.uint64(self.shift)).astype(np.int64)
        nb = 1 << NB
        starts = np.searchsorted(bkt, np.arange(nb + 1), side="left")
        self.starts = jax.device_put(starts.astype(np.int32))
        maxlen = int(np.max(np.diff(starts))) if self.n else 0
        self.t_rounds = max(1, int(np.ceil(np.log2(maxlen + 1)))) \
            if maxlen else 1
        self._scan_cache = {}
        # blocked-Bloom prefilter: ONE uint32-word gather per k-mer
        # answers "possibly in set?" (two bits of the same word); the
        # ~13-gather binary search then runs only on a compacted
        # minority of positions, so most k-mers cost one gather index
        # instead of ~13.
        W = 1 << max(14, int(np.ceil(np.log2(max(self.n, 1) * 8))))
        self.bloom_words = W
        h = self._bloom_hash_np(self.hi_np, self.lo_np)
        word = (h & np.uint32(W - 1)).astype(np.int64)
        b1 = (h >> np.uint32(17)) & np.uint32(31)
        b2 = (h >> np.uint32(22)) & np.uint32(31)
        bits = np.zeros(W, np.uint32)
        np.bitwise_or.at(bits, word, np.uint32(1) << b1)
        np.bitwise_or.at(bits, word, np.uint32(1) << b2)
        self.bloom = jax.device_put(bits)

    @staticmethod
    def _bloom_hash_np(hi, lo):
        """splitmix32-style mix of the (hi, lo) value — numpy build-time
        twin of the jnp scan-time hash (must stay bit-identical)."""
        h = (lo.astype(np.uint32) * np.uint32(0x9E3779B9)) \
            ^ (hi.astype(np.uint32) * np.uint32(0x85EBCA6B))
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
        h ^= h >> np.uint32(13)
        return h

    # -- device program ---------------------------------------------------

    def _values_pair(self, codes, m: int):
        """(B, L) 2-bit codes -> ((B, m) hi, lo canonical values,
        valid mask). Mirrors KmerSet.to_values + rolling_kmers_batch."""
        jax, jnp = _jnp()
        k = self.k
        U32 = jnp.uint32
        B = codes.shape[0]
        hi = jnp.zeros((B, m), U32)
        lo = jnp.zeros((B, m), U32)
        bad = jnp.zeros((B, m), bool)
        ci = codes.astype(jnp.int32)
        for j in range(k):
            c = ci[:, j:m + j]
            bad = bad | (c > 3)
            cc = jnp.where(c > 3, 0, c).astype(U32)
            hi = (hi << 2) | (lo >> 30)
            lo = (lo << 2) | cc
        if self.rcomp:
            rhi, rlo = _rc_pair(hi, lo, k)
            use_rc = _lt_pair(hi, lo, rhi, rlo)
            hi = jnp.where(use_rc, rhi, hi)
            lo = jnp.where(use_rc, rlo, lo)
        mm = middle_mask(k, self.mask_middle)
        if mm != -1:
            # middle-base bits are below bit 32 for every k <= 31
            lo = lo & U32(np.uint32(mm & 0xFFFFFFFF))
            hi = hi & U32(np.uint32((mm >> 32) & 0xFFFFFFFF))
        lm = length_mask(k)
        if lm < (1 << 32):
            lo = lo | U32(lm)
        else:
            hi = hi | U32(lm >> 32)
        return hi, lo, ~bad

    def _scan_program(self, codes, s_hi, s_lo, s_ids, s_starts):
        """(B, L) codes -> (B, m) int32 ids (-1 miss). The set arrays
        arrive as jit ARGUMENTS, never closed over as constants, so one
        compiled program serves every set of the same shape."""
        jax, jnp = _jnp()
        from ..align.quickmap_device import take_flat
        I = jnp.int32
        U32 = jnp.uint32
        B, L = codes.shape
        m = L - self.k + 1
        qhi, qlo, valid = self._values_pair(codes, m)
        # miss sentinel for invalid windows: all-ones never matches a
        # real value (bit 63 is never set: values < 2^63)
        qhi = jnp.where(valid, qhi, U32(0xFFFFFFFF))
        qlo = jnp.where(valid, qlo, U32(0xFFFFFFFF))

        # bucket -> [base, end)
        s = self.shift
        if s >= 32:
            bkt = (qhi >> (s - 32)).astype(I)
        elif s > 0:
            bkt = (((qhi << (32 - s)) | (qlo >> s))
                   & U32((1 << (2 * self.k + 1 - s)) - 1)).astype(I)
        else:
            bkt = qlo.astype(I)
        bkt = jnp.clip(bkt, 0, s_starts.shape[0] - 2)
        base = take_flat(s_starts, bkt)
        end = take_flat(s_starts, bkt + 1)
        sz = end - base

        # branchless lower_bound within the bucket
        for _ in range(self.t_rounds):
            half = sz >> 1
            mid = base + half
            midc = jnp.clip(mid, 0, max(self.n - 1, 0))
            vh = take_flat(s_hi, midc)
            vl = take_flat(s_lo, midc)
            go_right = _lt_pair(vh, vl, qhi, qlo) & (sz > 0)
            base = jnp.where(go_right, mid + 1, base)
            sz = jnp.where(go_right, sz - half - 1, half)

        pos = jnp.clip(base, 0, max(self.n - 1, 0))
        fh = take_flat(s_hi, pos)
        fl = take_flat(s_lo, pos)
        hit = (fh == qhi) & (fl == qlo) & (base < self.n)
        ids = jnp.where(hit, take_flat(s_ids, pos), -1).astype(I)
        return ids

    def _bloom_hash_dev(self, hi, lo):
        _, jnp = _jnp()
        U32 = jnp.uint32
        h = (lo * U32(0x9E3779B9)) ^ (hi * U32(0x85EBCA6B))
        h = h ^ (h >> 16)
        h = h * U32(0xC2B2AE35)
        return h ^ (h >> 13)

    def _search_pair(self, qhi, qlo, s_hi, s_lo, s_ids, s_starts):
        """Branchless bucketed binary search of (any shape) canonical
        value pairs -> ids (-1 miss). Factored from _scan_program."""
        jax, jnp = _jnp()
        from ..align.quickmap_device import take_flat
        I = jnp.int32
        U32 = jnp.uint32
        s = self.shift
        if s >= 32:
            bkt = (qhi >> (s - 32)).astype(I)
        elif s > 0:
            bkt = (((qhi << (32 - s)) | (qlo >> s))
                   & U32((1 << (2 * self.k + 1 - s)) - 1)).astype(I)
        else:
            bkt = qlo.astype(I)
        bkt = jnp.clip(bkt, 0, s_starts.shape[0] - 2)
        base = take_flat(s_starts, bkt)
        end = take_flat(s_starts, bkt + 1)
        sz = end - base
        for _ in range(self.t_rounds):
            half = sz >> 1
            mid = base + half
            midc = jnp.clip(mid, 0, max(self.n - 1, 0))
            vh = take_flat(s_hi, midc)
            vl = take_flat(s_lo, midc)
            go_right = _lt_pair(vh, vl, qhi, qlo) & (sz > 0)
            base = jnp.where(go_right, mid + 1, base)
            sz = jnp.where(go_right, sz - half - 1, half)
        pos = jnp.clip(base, 0, max(self.n - 1, 0))
        fh = take_flat(s_hi, pos)
        fl = take_flat(s_lo, pos)
        hit = (fh == qhi) & (fl == qlo) & (base < self.n)
        return jnp.where(hit, take_flat(s_ids, pos), -1).astype(I)

    def _scan_program_bloom(self, codes, s_hi, s_lo, s_ids, s_starts,
                            s_bloom, BR: int, KC: int):
        """Bloom-prefiltered scan: one word-gather per k-mer, then the
        exact search only on <=BR rows x <=KC positions (compacted).
        Returns (ids (B, m), overflow bool scalar) — overflow means a
        budget was exceeded and the caller must re-run the full
        program."""
        jax, jnp = _jnp()
        from ..align.quickmap_device import take_flat
        I = jnp.int32
        U32 = jnp.uint32
        B, L = codes.shape
        m = L - self.k + 1
        qhi, qlo, valid = self._values_pair(codes, m)
        qhi = jnp.where(valid, qhi, U32(0xFFFFFFFF))
        qlo = jnp.where(valid, qlo, U32(0xFFFFFFFF))
        h = self._bloom_hash_dev(qhi, qlo)
        word = (h & U32(self.bloom_words - 1)).astype(I)
        w = take_flat(s_bloom, word)
        bit1 = (U32(1) << ((h >> 17) & 31))
        bit2 = (U32(1) << ((h >> 22) & 31))
        maybe = valid & ((w & bit1) > 0) & ((w & bit2) > 0)   # (B, m)

        nrow = maybe.any(axis=1)
        n_rows = jnp.sum(nrow.astype(I))
        rowpri = jnp.where(nrow, jnp.arange(B, dtype=I), jnp.int32(B))
        rsel = jax.lax.top_k(-rowpri, BR)[0] * -1            # ascending
        r_ok = rsel < B
        rs = jnp.clip(rsel, 0, B - 1)
        # per-row position compaction (sort ascending position)
        mayr = maybe[rs]                                     # (BR, m)
        pcnt = jnp.sum(mayr.astype(I), axis=1)
        M64 = -(-m // 64) * 64
        ppri = jnp.where(mayr, jnp.arange(m, dtype=I)[None, :],
                         jnp.int32(m))
        ppri = jnp.pad(ppri, ((0, 0), (0, M64 - m)),
                       constant_values=m)
        psort = jax.lax.sort(ppri, dimension=1)[:, :KC]      # (BR, KC)
        p_ok = psort < m
        psafe = jnp.clip(psort, 0, m - 1)
        # flat gather (a one-hot matmul at K=48 would materialize a
        # GB-scale one-hot; the flat gather is ~2 indices per selected
        # position)
        gflat = rs[:, None] * m + psafe                      # (BR, KC)
        sel_hi = take_flat(qhi.reshape(B * m), gflat)
        sel_lo = take_flat(qlo.reshape(B * m), gflat)
        miss = ~(r_ok[:, None] & p_ok)
        sel_hi = jnp.where(miss, U32(0xFFFFFFFF), sel_hi)
        sel_lo = jnp.where(miss, U32(0xFFFFFFFF), sel_lo)
        ids_c = self._search_pair(sel_hi, sel_lo, s_hi, s_lo, s_ids,
                                  s_starts)                  # (BR, KC)
        ids_c = jnp.where(miss, -1, ids_c)
        # SPARSE result: (rows, positions, ids) — a dense (B, m) int32
        # block is tens of MB per chunk; the sparse triple is ~10x
        # smaller and the host densifies it. pos fits 15 bits, id fits 16 -> one int32.
        packed = jnp.where(miss, -1,
                           (psafe << 16) | (ids_c & 0xFFFF))
        overflow = (n_rows > BR) | (pcnt > KC).any()
        return rsel, packed, overflow

    def scan_ids(self, bases: np.ndarray) -> np.ndarray:
        """Host entry: (B, L) ASCII -> (B, m) int32 ids, -1 for miss.
        Tries the bloom-prefiltered program first; budget overflow
        (dense-hit batches, e.g. Seal quantification) falls back to the
        full branchless search — identical results either way."""
        jax, jnp = _jnp()
        from ..align.quickmap_device import ascii_to_codes
        B, L = bases.shape
        if not self.sparse_ok:      # >32k ref ids: packed int16 ids
            return self._scan_full(bases)
        BR = min(B, max(256, -(-(B * 3 // 8) // 256) * 256))
        KC = 48
        key = ("bloom", B, L)
        prog = self._scan_cache.get(key)
        if prog is None:
            from ..align.fused_device import unpack_reads_device

            def fb(c2, nm, s_hi, s_lo, s_ids, s_starts, s_bloom):
                return self._scan_program_bloom(
                    unpack_reads_device(c2, nm, L), s_hi, s_lo, s_ids,
                    s_starts, s_bloom, BR, KC)
            prog = jax.jit(fb)
            self._scan_cache[key] = prog
        # 2-bit packed upload (4x smaller than raw ASCII, nmask skipped
        # for N-free batches)
        from ..align.fused_device import pack_reads_host
        c2, nm = pack_reads_host(np.ascontiguousarray(bases))
        rsel, packed, overflow = prog(
            c2, nm, self.hi, self.lo, self.ids,
            self.starts, self.bloom)
        if not bool(overflow):
            rsel = np.asarray(rsel)
            packed = np.asarray(packed)
            m = L - self.k + 1
            out = np.full((B, m), -1, np.int32)
            rok = rsel < B
            pk = packed[rok]
            rows = np.repeat(rsel[rok], pk.shape[1])
            flat = pk.reshape(-1)
            sel = flat >= 0
            pos = (flat[sel] >> 16).astype(np.int64)
            # sign-extend the 16-bit id (-1 = searched but absent)
            ids_v = (((flat[sel] & 0xFFFF) ^ 0x8000) - 0x8000).astype(
                np.int32)
            out[rows[sel], pos] = ids_v
            return out
        return self._scan_full(bases)

    def _scan_full(self, bases: np.ndarray) -> np.ndarray:
        jax, jnp = _jnp()
        from ..align.quickmap_device import ascii_to_codes
        B, L = bases.shape
        key = (B, L)
        full = self._scan_cache.get(key)
        if full is None:
            def f(b, s_hi, s_lo, s_ids, s_starts):
                return self._scan_program(ascii_to_codes(b), s_hi,
                                          s_lo, s_ids, s_starts)
            full = jax.jit(f)
            self._scan_cache[key] = full
        return np.asarray(full(np.ascontiguousarray(bases), self.hi,
                               self.lo, self.ids, self.starts))


def _enabled() -> bool:
    env = os.environ.get("BBMAP_DEVICE_KMERS")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "f", "no",
                                           "off", "")
    import jax
    return jax.default_backend() != "cpu"


def device_scan_batch(ks: KmerSet, bases: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Device twin of kmerset.scan_batch: (hits, ids) per full-length
    k-mer position. Falls back to None when disabled/too small (caller
    uses the host path)."""
    B, L = bases.shape
    m = L - ks.k + 1
    if m <= 0 or len(ks.values) == 0 or not _enabled():
        return None
    if B * m < 2048:       # dispatch latency beats tiny batches
        return None
    dks = getattr(ks, "_device_set", None)
    if dks is None:
        dks = DeviceKmerSet(ks)
        ks._device_set = dks
    ids = dks.scan_ids(bases)
    return (ids >= 0), ids


def device_scan_counts(ks: KmerSet, bases: np.ndarray,
                       nrefs: int) -> "np.ndarray | None":
    """Per-read per-scaffold hit-count matrix computed ON DEVICE:
    search every k-mer position for its value slot, gather the slot's
    multi-owner row from a precomputed (nslots+1, nrefs) owner matrix,
    and ship only the summed (B, nrefs) uint16 counts, far smaller than
    a dense per-position id block for a hit-dense Seal batch.

    Returns None when disabled, too small, or the owner matrix would
    be too large (caller uses the host path)."""
    B, L = bases.shape
    m = L - ks.k + 1
    if m <= 0 or len(ks.values) == 0 or not _enabled():
        return None
    if B * m < 2048 or nrefs > 4096:
        return None
    n = len(ks.values)
    if (n + 1) * nrefs > 256 * (1 << 20):
        return None
    dks = getattr(ks, "_device_set", None)
    if dks is None:
        dks = DeviceKmerSet(ks)
        ks._device_set = dks
    import jax

    owner_d = getattr(ks, "_owner_matrix_d", None)
    if owner_d is None:
        om = np.zeros((n + 1, nrefs), np.uint8)
        if ks.multi_offsets is not None:
            off = ks.multi_offsets
            reps = np.diff(off).astype(np.int64)
            cum = np.zeros(n + 1, np.int64)
            np.cumsum(reps, out=cum[1:])
            slot_of = np.repeat(np.arange(n), reps)
            om[slot_of, ks.multi_ids[:cum[-1]]] = 1
        else:
            om[np.arange(n), np.clip(ks.ids, 0, nrefs - 1)] = 1
        owner_d = jax.device_put(om)
        ks._owner_matrix_d = owner_d

    key = ("counts", B, L, nrefs)
    prog = dks._scan_cache.get(key)
    if prog is None:
        _, jnp = _jnp()
        from ..align.fused_device import unpack_reads_device

        def f(c2, nm, s_hi, s_lo, s_starts, own):
            codes = unpack_reads_device(c2, nm, L)
            qhi, qlo, valid = dks._values_pair(codes, m)
            U32 = jnp.uint32
            qhi = jnp.where(valid, qhi, U32(0xFFFFFFFF))
            qlo = jnp.where(valid, qlo, U32(0xFFFFFFFF))
            # slot search (same branchless bucketed binary search as
            # _search_pair, but returning the VALUE SLOT)
            from ..align.quickmap_device import take_flat
            I = jnp.int32
            s = dks.shift
            if s >= 32:
                bkt = (qhi >> (s - 32)).astype(I)
            elif s > 0:
                bkt = (((qhi << (32 - s)) | (qlo >> s))
                       & U32((1 << (2 * dks.k + 1 - s)) - 1)).astype(I)
            else:
                bkt = qlo.astype(I)
            bkt = jnp.clip(bkt, 0, s_starts.shape[0] - 2)
            base = take_flat(s_starts, bkt)
            end = take_flat(s_starts, bkt + 1)
            sz = end - base
            for _ in range(dks.t_rounds):
                half = sz >> 1
                mid = base + half
                midc = jnp.clip(mid, 0, max(dks.n - 1, 0))
                vh = take_flat(s_hi, midc)
                vl = take_flat(s_lo, midc)
                go_right = _lt_pair(vh, vl, qhi, qlo) & (sz > 0)
                base = jnp.where(go_right, mid + 1, base)
                sz = jnp.where(go_right, sz - half - 1, half)
            pos = jnp.clip(base, 0, max(dks.n - 1, 0))
            fh = take_flat(s_hi, pos)
            fl = take_flat(s_lo, pos)
            hit = (fh == qhi) & (fl == qlo) & (base < dks.n)
            slot = jnp.where(hit, pos, dks.n)         # miss -> zero row
            # owner-row gather + sum over positions, chunked so the
            # (B, m, nrefs) intermediate never materializes whole
            counts = jnp.zeros((B, nrefs), jnp.int32)
            CH = 8
            for g in range(0, m, CH):
                sl = slot[:, g:g + CH]
                counts = counts + own[sl].astype(jnp.int32).sum(axis=1)
            return jnp.clip(counts, 0, 65535).astype(jnp.uint16)

        prog = jax.jit(f)
        dks._scan_cache[key] = prog
    from ..align.fused_device import pack_reads_host
    c2, nm = pack_reads_host(np.ascontiguousarray(bases))
    return np.asarray(prog(c2, nm, dks.hi, dks.lo, dks.starts,
                           owner_d)).astype(np.int64)
