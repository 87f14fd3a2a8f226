"""Forced-sync stage profile of the fused PAIR program at the bench
shape (32k pairs = 64k reads). Times jitted programs truncated at each
candidate-stage _stop point / fused-stage _stop_after point; the
difference between consecutive points is the stage cost.

Run on the real chip:  python tools_dev/profile_stages.py [points...]
Each point compiles once (persistent cache) then times 3 reps.
Points: keys gather0 admit slots sort votes runs topk take1 full
        F:cand F:boost F:score F:select F:trace F:retrace F:full
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bbmap_tpu.utils.jaxcfg import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from bench import make_genome, make_pairs
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
from bbmap_tpu.align import quickmap_device as qd
from bbmap_tpu.align import fused_device as fd
from bbmap_tpu.align import seed as seed_host
from bbmap_tpu.core.constants import SHORT_PROFILE
from bbmap_tpu.io import native


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    n_pairs = int(os.environ.get("PROF_PAIRS", 32768))
    L = 150
    gbases = make_genome()
    g = Genome(chroms=[gbases], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(gbases),
                 name="ecoli_like")]).finalize()
    index = build_index(g, 13)
    analyze_index(index, 0.01)
    log("setup done")

    r1, r2, q1, q2, t1, t2 = make_pairs(gbases, n_pairs, L=L, seed=31)
    Bp = n_pairs
    fcfg = fd.make_fused_config(index, L, 2 * Bp)
    cfg = fcfg.qm
    min_gate = fd.paired_min_gate(SHORT_PROFILE, L, 0.56)
    starts_d, sites_d, gpack_d, nmask_d, _G = fd.device_arrays(index)
    scnt_d = qd.scnt_array(index)
    ccnt_d = qd.ccnt_array(index) if cfg.ref_admit else None
    choff_d = jax.device_put(np.asarray(index.chrom_offsets, np.int32))
    den2, den3 = seed_host.key_density_ladder(L, index.k)
    inv_a = np.float32(1.0) / np.float32(100 * index.k)
    ladder_np = np.asarray(cfg.offsets_list, np.int32)

    c2a, nma = fd.pack_reads_host(np.ascontiguousarray(r1[:, :L]))
    c2b, nmb = fd.pack_reads_host(np.ascontiguousarray(r2[:, :L]))
    qcat = np.vstack([q1[:, :L], q2[:, :L]])
    host_os = native.quality_offsets_scores(
        qcat, L, index.k, seed_host.PROB_CORRECT, ladder_np, den3,
        100 * index.k)
    if host_os is not None:
        o16, s16, rej = host_os
    else:
        # no native library: the device quality stage, run once outside
        # the timed programs, supplies the same three inputs
        qpack, pal, pcp = qd.pack_quality_host(qcat, L)
        o16, wts, rej = jax.jit(lambda a, b, c: qd.quality_offsets_stage_packed(
            cfg, a, b, c, den2, den3, return_weights=True))(qpack, pal, pcp)
        o16, rej = np.asarray(o16), np.asarray(rej)
        s16 = np.rint(np.asarray(wts) / inv_a).astype(np.int16)
    rej8 = rej.astype(np.uint8)
    apd32 = jnp.int32(250)
    pair_ctx = {"apd": apd32, "chrom_offsets": choff_d,
                "min_gate": min_gate}

    results = {}

    def timeit(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:1])
        compile_s = time.time() - t0
        reps = []
        for _ in range(3):
            t0 = time.time()
            out = fn(*args)
            for lv in jax.tree_util.tree_leaves(out):
                np.asarray(lv.ravel()[:1])
            reps.append(time.time() - t0)
        ms = 1000 * min(reps)
        results[name] = ms
        log(f"{name:14s} {ms:9.1f} ms   (compile {compile_s:.1f}s)")

    stops_cand = ["keys", "gather0", "admit", "slots", "sort", "votes",
                  "runs", "topk", "take1", "full"]
    stops_fused = ["F:cand", "F:boost", "F:score", "F:select",
                   "F:trace", "F:retrace", "F:full"]
    want = sys.argv[1:] or (stops_cand + stops_fused)

    for sp in [s for s in want if not s.startswith("F:")]:
        sp_v = None if sp == "full" else sp

        @jax.jit
        def prog(c2a_, nma_, c2b_, nmb_, o16_, s16_, rej8_,
                 st_, si_, sc_, cc_, _sp=sp_v):
            r1_ = fd.unpack_reads_device(c2a_, nma_, L)
            r2_ = fd.unpack_reads_device(c2b_, nmb_, L)
            rcodes = jnp.concatenate([r1_, r2_], axis=0)
            offs = o16_.astype(jnp.int32)
            wts = s16_.astype(jnp.float32) * inv_a
            rc, cand = qd.candidate_stage(
                cfg, None, st_, si_, offsets_dyn=offs,
                rcodes=rcodes, scnt_d=sc_, ccnt_d=cc_,
                two_tier=True, weights_dyn=wts,
                reject=rej8_.astype(bool), _stop=_sp)
            tot = jnp.int32(0)
            for v in cand.values():
                tot = tot + v.astype(jnp.int32).sum()
            return tot

        timeit(f"cand:{sp}", prog, c2a, nma, c2b, nmb, o16, s16, rej8,
               starts_d, sites_d, scnt_d, ccnt_d)

    for sp in [s[2:] for s in want if s.startswith("F:")]:
        sp_v = None if sp == "full" else sp

        @jax.jit
        def progf(c2a_, nma_, c2b_, nmb_, o16_, s16_, rej8_,
                  st_, si_, gp_, nm_, sc_, cc_, ch_, _sp=sp_v):
            r1_ = fd.unpack_reads_device(c2a_, nma_, L)
            r2_ = fd.unpack_reads_device(c2b_, nmb_, L)
            rcodes = jnp.concatenate([r1_, r2_], axis=0)
            offs = o16_.astype(jnp.int32)
            wts = s16_.astype(jnp.float32) * inv_a
            out = fd.fused_stage(
                fcfg, rcodes, st_, si_, gp_, nm_,
                offsets_dyn=offs, scnt_d=sc_, ccnt_d=cc_,
                weights_dyn=wts, reject=rej8_.astype(bool),
                pair={"apd": apd32, "chrom_offsets": ch_,
                      "min_gate": min_gate}, _stop_after=_sp)
            if isinstance(out, dict):
                out = list(out.values())
            # reduce EVERY element: a partial slice lets XLA drop the
            # work behind the rest of the output
            if isinstance(out, (tuple, list)):
                tot = jnp.int32(0)
                for v in out:
                    tot = tot + v.astype(jnp.int32).sum()
                return tot
            return out.astype(jnp.int32).sum()

        timeit(f"fused:{sp}", progf, c2a, nma, c2b, nmb, o16, s16,
               rej8, starts_d, sites_d, gpack_d, nmask_d, scnt_d,
               ccnt_d, choff_d)

    log("=== diffs (consecutive) ===")
    keys = list(results)
    for a, b in zip(keys, keys[1:]):
        log(f"{a} -> {b}: {results[b] - results[a]:+.1f} ms")


if __name__ == "__main__":
    main()
