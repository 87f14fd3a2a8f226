"""Probabilistic k-mer counter (counting Bloom filter / count-min sketch).

reference: bloom/KCountArray.java + KCountArray7MTA.java:27 — atomic
packed-cell counting Bloom filter with multiple hashes and optional
prefilter. Here: flat numpy cell arrays with vectorized multi-hash
scatter-add (np.add.at) — the same device-resident layout a device
scatter-add kernel uses (SURVEY.md §2.7: device-resident packed
counter arrays with vectorized multi-hash scatter-add).

Counts are capped at cell_max on read (count-min over the hash functions),
matching the reference's saturating packed cells.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_MASKS = [
    0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
    0x27D4EB2F165667C5, 0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53,
]


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    """64-bit mix (splitmix-style) for hashing kmers to cells."""
    x = (x.astype(np.uint64) * np.uint64(salt)) & np.uint64(2**64 - 1)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xFF51AFD7ED558CCD)) & np.uint64(2**64 - 1)
    x ^= x >> np.uint64(29)
    return x


class KCountArray:
    def __init__(self, cells: int, cell_bits: int = 16, hashes: int = 1):
        assert cell_bits in (2, 4, 8, 16, 32)
        self.cells = 1 << int(cells).bit_length() if cells & (cells - 1) \
            else cells
        self.mask = self.cells - 1
        self.cell_bits = cell_bits
        self.cell_max = (1 << cell_bits) - 1
        self.hashes = hashes
        dtype = (np.uint8 if cell_bits <= 8 else
                 np.uint16 if cell_bits == 16 else np.uint32)
        self.array = np.zeros((hashes, self.cells), dtype)
        self._acc_dtype = np.uint32

    def _idx(self, kmers: np.ndarray, h: int) -> np.ndarray:
        return (_mix(kmers, _MASKS[h % len(_MASKS)])
                & np.uint64(self.mask)).astype(np.int64)

    def increment(self, kmers: np.ndarray) -> None:
        """Vectorized multi-hash scatter-add with saturation."""
        for h in range(self.hashes):
            idx = self._idx(kmers, h)
            row = self.array[h]
            # saturating add: accumulate deltas in a wide dtype first
            deltas = np.bincount(idx, minlength=self.cells)
            nz = np.nonzero(deltas)[0]
            cur = row[nz].astype(np.int64)
            row[nz] = np.minimum(cur + deltas[nz],
                                 self.cell_max).astype(row.dtype)

    def read(self, kmers: np.ndarray) -> np.ndarray:
        """count-min over hash functions."""
        out = None
        for h in range(self.hashes):
            v = self.array[h][self._idx(kmers, h)].astype(np.int32)
            out = v if out is None else np.minimum(out, v)
        return out if out is not None else np.zeros(len(kmers), np.int32)

    def used_fraction(self) -> float:
        return float((self.array[0] != 0).mean())


class DeviceKCountArray:
    """Device-resident counting Bloom filter — the device port of the
    reference's atomic packed-cell counter (reference:
    bloom/KCountArray7MTA.java:27; SURVEY §2.7/§2.11 P8: 'HBM-resident
    packed counter arrays with vectorized multi-hash scatter-add').

    The per-hash rows live in HBM as uint32; ``increment`` is one jitted
    scatter-add per batch (duplicate indices accumulate — the lock-free
    analog of the reference's AtomicIntegerArray), ``read`` is a
    count-min gather clipped to cell_max. Same counts as the host
    KCountArray for any count below cell saturation; identical hash/
    index math (the splitmix mix runs in two uint32 halves on device)."""

    def __init__(self, cells: int, cell_bits: int = 16,
                 hashes: int = 1):
        import jax
        import jax.numpy as jnp
        assert cell_bits in (2, 4, 8, 16, 32)
        self.cells = 1 << int(cells).bit_length() \
            if cells & (cells - 1) else cells
        self.mask = self.cells - 1
        self.cell_bits = cell_bits
        self.cell_max = (1 << cell_bits) - 1
        self.hashes = hashes
        self.array = jax.device_put(
            np.zeros((hashes, self.cells), np.uint32))
        self._inc = jax.jit(self._inc_fn)
        self._read = jax.jit(self._read_fn)

    # -- device programs (kmers arrive as (N,) hi/lo uint32 pairs) ----

    @staticmethod
    def _mix_pair(hi, lo, salt: int):
        """64-bit splitmix mix in two uint32 halves (matches _mix)."""
        import jax.numpy as jnp
        U = jnp.uint32

        def mul64(ah, al, b: int):
            bh, bl = (b >> 32) & 0xFFFFFFFF, b & 0xFFFFFFFF

            # full 32x32 -> 64 product via 16-bit limbs with carries
            def mul32(x, y32: int):
                yl = y32 & 0xFFFF
                yh = (y32 >> 16) & 0xFFFF
                xl = x & U(0xFFFF)
                xh = x >> 16
                p0 = xl * U(yl)
                p1 = xh * U(yl)
                p2 = xl * U(yh)
                p3 = xh * U(yh)
                mid = p1 + p2
                mid_carry = (mid < p1).astype(U)
                lo_full = p0 + (mid << 16)
                carry2 = (lo_full < p0).astype(U)
                hi_full = p3 + (mid >> 16) + (mid_carry << 16) + carry2
                return hi_full, lo_full

            h1, l1 = mul32(al, bl)
            return (h1 + al * U(bh) + ah * U(bl)), l1

        def xorshr(h, l, s: int):
            if s >= 32:
                return h, l ^ (h >> (s - 32))
            return h ^ (h >> s), l ^ ((l >> s) | (h << (32 - s)))

        h, l = mul64(hi, lo, salt)
        h, l = xorshr(h, l, 33)
        h, l = mul64(h, l, 0xFF51AFD7ED558CCD)
        h, l = xorshr(h, l, 29)
        return h, l

    def _idx_pair(self, hi, lo, h: int):
        import jax.numpy as jnp
        mh, ml = self._mix_pair(hi, lo, _MASKS[h % len(_MASKS)])
        if self.mask <= 0xFFFFFFFF:
            return (ml & jnp.uint32(self.mask)).astype(jnp.int32)
        raise ValueError("device KCA supports cells <= 2^32")

    def _inc_fn(self, array, hi, lo):
        rows = []
        for h in range(self.hashes):
            idx = self._idx_pair(hi, lo, h)
            rows.append(array[h].at[idx].add(1))
        import jax.numpy as jnp
        return jnp.stack(rows)

    def _read_fn(self, array, hi, lo):
        import jax.numpy as jnp
        out = None
        for h in range(self.hashes):
            idx = self._idx_pair(hi, lo, h)
            v = array[h][idx]
            out = v if out is None else jnp.minimum(out, v)
        return jnp.minimum(out, jnp.uint32(self.cell_max)).astype(
            jnp.int32)

    # -- host API (kmers: int64 >= 0, same as the host class) ---------

    @staticmethod
    def _split(kmers: np.ndarray):
        v = kmers.astype(np.uint64)
        return ((v >> np.uint64(32)).astype(np.uint32),
                (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    def increment(self, kmers: np.ndarray) -> None:
        if not len(kmers):
            return
        hi, lo = self._split(kmers)
        self.array = self._inc(self.array, hi, lo)

    def read(self, kmers: np.ndarray) -> np.ndarray:
        if not len(kmers):
            return np.zeros(0, np.int32)
        hi, lo = self._split(kmers)
        return np.asarray(self._read(self.array, hi, lo))

    def used_fraction(self) -> float:
        return float(np.asarray((self.array[0] != 0).mean()))


def make_kca(cells: int, cell_bits: int = 16, hashes: int = 1):
    """KCountArray factory: device-backed on accelerator backends
    (BBMAP_DEVICE_KCA=0/1 overrides), host numpy otherwise."""
    import os
    env = os.environ.get("BBMAP_DEVICE_KCA")
    if env is not None:
        use = env.strip().lower() not in ("0", "false", "f", "no",
                                          "off", "")
    else:
        import jax
        use = jax.default_backend() != "cpu"
    if use:
        return DeviceKCountArray(cells, cell_bits=cell_bits,
                                 hashes=hashes)
    return KCountArray(cells, cell_bits=cell_bits, hashes=hashes)
