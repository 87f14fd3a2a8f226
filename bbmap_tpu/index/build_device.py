"""Device-parallel CSR k-mer index build (SURVEY §2.11 P3; reference:
align2/IndexMaker4.java:100-240 — per-block count threads, keyspace
partitioned by leading base, count -> prefix-sum -> fill).

Device formulation: no atomics, no per-thread partitions —
1. rolling 2-bit keys of the packed genome via k shifted slices
2. one device sort of (key, position) pairs  ->  ``sites``
3. ``starts`` by scattering each run boundary (unique indices — a
   fully parallel scatter) and back-filling absent keys with a reverse
   cumulative min — replacing the host bincount + cumsum over the 4^k
   table.

Bit-identical to the host build (index/build.py rolling_keys + stable
argsort): both order sites by (key, position).
"""

from __future__ import annotations

import numpy as np

from ..core.genome import Genome
from .build import MODULO, KmerIndex, reverse_complement_key


def _device_csr(gpack, nmask, G: int, k: int, usemodulo: bool):
    import jax
    import jax.numpy as jnp
    I32 = jnp.int32
    U32 = jnp.uint32
    NK = 4 ** k

    # unpack 2-bit codes + N flags
    nw = gpack.shape[0]
    slots = jnp.arange(16, dtype=U32) * 2
    codes = ((gpack[:, None] >> slots) & 3).astype(jnp.uint8)
    codes = codes.reshape(nw * 16)[:G]
    bslots = jnp.arange(32, dtype=U32)
    nb = ((nmask[:, None] >> bslots) & 1).astype(bool)
    nb = nb.reshape(nmask.shape[0] * 32)[:G]

    m = G - k + 1
    ci = codes.astype(I32)
    keys = jnp.zeros((m,), I32)
    bad = jnp.zeros((m,), bool)
    for j in range(k):
        c = ci[j:m + j]
        bad = bad | nb[j:m + j]
        keys = (keys << 2) | c
    del usemodulo      # guarded in build_index_device (host fallback)
    key_or_sentinel = jnp.where(bad, I32(NK), keys)
    pos = jnp.arange(m, dtype=I32)
    skeys, ssites = jax.lax.sort((key_or_sentinel, pos), dimension=0,
                                 num_keys=2)
    n_valid = jnp.sum((~bad).astype(I32))

    # starts: scatter run boundaries, then reverse-cummin fill.
    first = jnp.concatenate(
        [jnp.ones((1,), bool), skeys[1:] != skeys[:-1]])
    first = first & (skeys < NK)
    BIGV = jnp.iinfo(jnp.int32).max
    tgt = jnp.where(first, skeys, NK)          # sentinel -> slot NK
    starts = jnp.full((NK + 1,), BIGV, I32)
    starts = starts.at[tgt].set(
        jnp.where(first, pos, BIGV), mode="drop",
        unique_indices=False)
    # slot NK took garbage from sentinels; reset, then backfill
    starts = starts.at[NK].set(n_valid)
    starts = jnp.flip(jax.lax.cummin(jnp.flip(starts)))
    return starts, ssites, n_valid


def build_index_device(genome: Genome, k: int,
                       usemodulo: bool = False) -> KmerIndex:
    """Device twin of build.build_index (modulo mode stays host-side:
    it is a low-memory fallback, not a speed path)."""
    import jax

    if usemodulo:
        from .build import build_index
        return build_index(genome, k, usemodulo=True)
    from ..align.quickmap_device import pack_genome_2bit
    codes, offsets = genome.packed_codes()
    G = len(codes)
    gpack_np, nmask_np = pack_genome_2bit(codes)
    gpack = jax.device_put(gpack_np)
    nmask = jax.device_put(nmask_np)
    fn = jax.jit(_device_csr, static_argnums=(2, 3, 4))
    starts_d, sites_d, n_valid = fn(gpack, nmask, G, k, False)
    n = int(n_valid)
    starts = np.asarray(starts_d).astype(np.int64)
    sites = np.asarray(sites_d)[:n].astype(np.int32)
    idx = KmerIndex(k=k, starts=starts, sites=sites,
                    genome_codes=codes, chrom_offsets=offsets)
    # the freshly built arrays are already device-resident; seed the
    # device cache so the aligner skips the big re-upload
    idx._device_arrays = (starts_d.astype(np.int32)
                          if starts_d.dtype != np.int32 else starts_d,
                          sites_d[:n], gpack, nmask, G)
    return idx
