#!/usr/bin/env python3
"""Smoke test: the paired short-read mapper on NVIDIA GPUs.

    python chip_smoke.py           one card: phases 1-6 below
    python chip_smoke.py --four    four cards: the mesh route and
                                   bbmap hosts=4, nothing else

Phases (each raises on failure, so any failure exits nonzero):

1. identity  the first JAX device must be a GPU; prints its kind, the
             device count, the JAX version, the compile-cache directory
             and nvidia-smi's name and power limit of each card
2. compile   builds the fused pair program (32,768 pairs x 150 bp, the
             4.6 Mbp bench genome); prints its memory_analysis, the
             compile seconds, whether a second build hit the persistent
             compile cache, and the compiled program's device time
3. dp        msa_jax score, fill and walk at the fused widths against
             the NumPy oracle (ops/msa_ref.py), and the PacBio profile on
             long jobs: 0 mismatches; times the fused program's DP shapes
4. gathers   the candidate stage's row take (take_along_flat, and plain
             take_along_axis) exact over the int32 range; timed at its
             shape
5. e2e       65,536 seeded pairs through tools.bbmap.main at
             batchsize=32768, graded against their origins; the first
             2,048 pairs mapped again by a CPU-only subprocess must give
             identical SAM records
6. tools     bbduk, bbmerge and seal CLIs with the device scans on and
             off: byte-equal outputs

The phase functions take their sizes, so tests run them small on the
CPU; only main() requires a GPU. Inputs are written under .smoke/
(git-ignored). The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
T0 = time.time()

L = 150
CN = L + 2 * 4 + 16          # fused narrow DP window (fused_device)
CW = L + 2 * 4 + 448         # fused wide DP window
ACGT = np.frombuffer(b"ACGT", np.uint8)


def log(msg: str) -> None:
    print(f"[smoke +{time.time() - T0:7.1f}s] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------- identity

def identity(require_gpu: bool = True) -> dict:
    import jax
    from bbmap_tpu.utils.devinfo import device_identity
    from bbmap_tpu.utils.jaxcfg import compilation_cache_dir
    dev = device_identity()
    if require_gpu and dev["platform"] != "gpu":
        raise SmokeFailure(f"no GPU found: JAX's first device is "
                           f"{dev['platform']} ({dev['kind']})")
    log(f"device_kind: {dev['kind']}")
    log(f"device count: {dev['count']}")
    log(f"jax {jax.__version__}")
    log(f"compile cache: {compilation_cache_dir()}")
    for ln in dev["cards"]:
        log(f"nvidia-smi: {ln}")
    return {k: dev[k] for k in ("platform", "kind", "count")}


# ----------------------------------------------------------------- inputs

def _fastq(path: str, reads: np.ndarray, qual: np.ndarray,
           names) -> None:
    with open(path, "wb") as fh:
        for name, r, q in zip(names, reads, qual):
            fh.write(b"@%s\n%s\n+\n%s\n" % (name, r.tobytes(),
                                            (q + 33).astype(np.uint8)
                                            .tobytes()))


def write_fasta(path: str, name: str, seq: np.ndarray) -> None:
    body = seq.tobytes()
    with open(path, "wb") as fh:
        fh.write(b">" + name.encode() + b"\n")
        for a in range(0, len(body), 80):
            fh.write(body[a:a + 80] + b"\n")


def prepare_inputs(work: str, n_pairs: int, n_head: int,
                   genome_len: int = 4_600_000, seed: int = 23) -> dict:
    """bench.make_genome's genome as FASTA and bench.make_pairs' pairs
    as FASTQ (all pairs, and the first ``n_head``), with their origins."""
    from bench import make_genome, make_pairs
    os.makedirs(work, exist_ok=True)
    g = make_genome(genome_len)
    ref = os.path.join(work, "ref.fa")
    write_fasta(ref, "ecoli_like", g)
    r1, r2, q1, q2, t1, t2 = make_pairs(g, n_pairs, L=L, seed=seed)
    names = [b"%d" % i for i in range(n_pairs)]
    paths = {"ref": ref, "t1": t1, "t2": t2, "n_pairs": n_pairs,
             "n_head": n_head}
    for tag, k in (("all", n_pairs), ("head", n_head)):
        for m, (r, q) in enumerate(((r1, q1), (r2, q2)), 1):
            p = os.path.join(work, f"{tag}_{m}.fq")
            _fastq(p, r[:k], q[:k], names[:k])
            paths[f"{tag}{m}"] = p
    return paths


# ---------------------------------------------------------------- compile

def build_cli_index(ref: str):
    """Genome + index exactly as ``bbmap ... nodisk`` builds them, so
    the programs compiled here are the ones the CLI runs."""
    from bbmap_tpu.core.genome import build_genome
    from bbmap_tpu.index.build import (analyze_index, build_index,
                                       set_fraction_to_exclude)
    genome = build_genome(ref)
    index = build_index(genome, 13)
    analyze_index(index, set_fraction_to_exclude(genome.total_bases()))
    return genome, index


def phase_compile(ref: str, n_pairs: int) -> dict:
    """AOT-compile the fused pair program at ``n_pairs``; compile it a
    second time with JAX's in-memory caches cleared and count the
    persistent-cache hits of that second build."""
    import jax
    from bbmap_tpu.align import fused_device as fdev
    from bbmap_tpu.align.pipeline import BBMapAligner
    from bench import make_pairs
    t = time.time()
    genome, index = build_cli_index(ref)
    log(f"compile: genome + index built in {time.time() - t:.1f}s "
        f"({genome.total_bases()} bases)")
    al = BBMapAligner(genome, index)
    run = fdev.build_fused_pair(index, L, n_pairs, al.chrom_offsets,
                                chain_dist=al.chain_dist,
                                min_ratio=al.min_ratio,
                                profile=al.profile)
    g = genome.chroms[0]
    r1, r2, q1, q2, _t1, _t2 = make_pairs(
        g[g != ord("N")], n_pairs, L=L, seed=5)
    fn, args = run.prepare(r1, r2, int(al.average_pair_dist), q1, q2)
    t = time.time()
    compiled = fn.lower(*args).compile()
    first_s = time.time() - t
    log(f"compile: fused pair program ({fn.__name__}) at {n_pairs} "
        f"pairs: {first_s:.1f}s")
    log(f"compile: memory_analysis: {compiled.memory_analysis()}")
    hits = []

    def listen(event, **_kw):
        if event == "/jax/compilation_cache/cache_hits":
            hits.append(event)

    jax.monitoring.register_event_listener(listen)
    jax.clear_caches()
    t = time.time()
    fn.lower(*args).compile()
    second_s = time.time() - t
    log(f"compile: second build {second_s:.1f}s, persistent cache "
        f"{'HIT' if hits else 'miss'} ({len(hits)} hits)")
    run_s = time_fn(compiled, *args)
    log(f"compile: fused program device time {1000 * run_s:.1f} ms per "
        f"{n_pairs}-pair batch (median of 3, after a warm-up)")
    d = fdev.FusedRun(compiled(*args), L, run.fcfg.Cn, run.fcfg.Cw,
                      pair=True, fcfg=run.fcfg, B=2 * n_pairs).host()
    frac = float((d["best_score"] > 0).mean())
    log(f"compile: compiled program ran; {frac:.4f} of rows have a "
        f"positive gapless best")
    check(d["best_score"].shape == (2 * n_pairs,) and frac > 0.9,
          "compile: fused program output implausible")
    return {"compile_s": first_s, "second_s": second_s,
            "cache_hit": bool(hits), "run_s": run_s}


# --------------------------------------------------------------------- dp

def make_dp_jobs(n: int, R: int, C: int, seed: int,
                 max_indel: int = 10, pacbio: bool = False):
    """(n, R) reads planted in (n, C) reference windows: substitutions,
    one 1..max_indel bp insertion or deletion, N bases in reads and
    references. ``pacbio``: ~12% indel-dominated errors instead."""
    rng = np.random.default_rng(seed)
    refs = rng.choice(ACGT, size=(n, C))
    reads = np.empty((n, R), np.uint8)
    for i in range(n):
        off = int(rng.integers(0, max(1, C - R - max_indel)))
        w = refs[i, off:].copy()
        if pacbio:
            out = []
            j = 0
            while len(out) < R and j < len(w):
                u = rng.random()
                if u < 0.03:
                    out.append(ACGT[rng.integers(0, 4)])
                    j += 1
                elif u < 0.08:
                    out.append(ACGT[rng.integers(0, 4)])    # insertion
                elif u < 0.12:
                    j += 1                                  # deletion
                else:
                    out.append(w[j])
                    j += 1
            row = np.array(out[:R], np.uint8)
            if len(row) < R:
                row = np.concatenate([row, rng.choice(ACGT, R - len(row))])
        else:
            kind = i % 4
            d = int(rng.integers(1, max_indel + 1))
            p = int(rng.integers(10, R - 10))
            if kind == 1:            # deletion
                row = np.concatenate([w[:p], w[p + d:p + d + R - p]])
            elif kind == 2:          # insertion
                row = np.concatenate([w[:p], rng.choice(ACGT, d),
                                      w[p:R - d]])
            else:
                row = w[:R].copy()
            row = row[:R]
            for _ in range(int(rng.integers(0, 4))):
                row[rng.integers(0, R)] = ACGT[rng.integers(0, 4)]
            if i % 5 == 0:
                row[rng.integers(0, R, size=2)] = ord("N")
            if i % 7 == 0:
                refs[i, rng.integers(0, C)] = ord("N")
        reads[i] = row
    return reads, refs


def oracle_job(args):
    """NumPy oracle (score, col, state, match) of one DP job."""
    from bbmap_tpu.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu.ops import msa_ref
    read, ref, pacbio, want_match = args
    P = PACBIO_PROFILE if pacbio else SHORT_PROFILE
    packed, (rows, col, state, score) = msa_ref.fill_unlimited(
        read, ref, P)
    match = msa_ref.traceback(read, ref, packed, rows, col, state, P) \
        if want_match else b""
    return int(score), int(col), int(state), match


def start_oracle(pool, jobs):
    """Submit every job set's oracle work; returns the futures."""
    return {tag: [pool.submit(oracle_job, (rd, rf, pb, wm))
                  for rd, rf in zip(reads, refs)]
            for tag, (reads, refs, pb, wm) in jobs.items()}


def dp_job_sets(n: int, n_pb: int, pb_rows: int, seed: int = 3) -> dict:
    """tag -> (reads, refs, pacbio, compare tracebacks)."""
    rn, fn = make_dp_jobs(n, L, CN, seed)
    rw, fw = make_dp_jobs(n, L, CW, seed + 1, max_indel=10)
    rp, fp = make_dp_jobs(n_pb, pb_rows, pb_rows + 100, seed + 2,
                          pacbio=True)
    return {"narrow": (rn, fn, False, True), "wide": (rw, fw, False, True),
            "pacbio": (rp, fp, True, True)}


def device_dp(reads, refs, pacbio: bool):
    """Device score pass and fill + walk (the fused program's calls)."""
    from bbmap_tpu.core.constants import PACBIO_PROFILE, SHORT_PROFILE
    from bbmap_tpu.ops import msa_jax
    P = PACBIO_PROFILE if pacbio else SHORT_PROFILE
    R, C = reads.shape[1], refs.shape[1]
    sc = [np.asarray(x) for x in
          msa_jax.msa_score_batch(reads, refs, R, C, P)]
    sym, ln, gaps, s2, c2, st2 = (np.asarray(x) for x in
                                  msa_jax.msa_align_batch(reads, refs,
                                                          R, C, P))
    matches = [msa_jax.finish_match(sym[i], int(ln[i]), int(gaps[i]))
               for i in range(len(reads))]
    return sc, (s2, c2, st2), matches


def compare_dp(tag, jobs, futures) -> int:
    reads, refs, pacbio, _ = jobs
    sc, fill, matches = device_dp(reads, refs, pacbio)
    bad = 0
    for i, fut in enumerate(futures):
        o_s, o_c, o_st, o_m = fut.result()
        got = [(int(sc[0][i]), int(sc[1][i]), int(sc[2][i])),
               (int(fill[0][i]), int(fill[1][i]), int(fill[2][i]))]
        if any(g != (o_s, o_c, o_st) for g in got) or matches[i] != o_m:
            bad += 1
            if bad <= 5:
                log(f"dp {tag} job {i}: device {got} {matches[i][:60]!r}"
                    f" oracle {(o_s, o_c, o_st)} {o_m[:60]!r}")
    log(f"dp {tag}: {len(futures)} jobs ({reads.shape[1]} x "
        f"{refs.shape[1]}), mismatches in score/col/state/symbols: {bad}")
    return bad


def time_fn(fn, *args, reps: int = 3) -> float:
    """Median wall seconds of ``fn(*args)`` to block_until_ready, after
    one warm-up call (compiles)."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def time_fused_dp(n_pairs: int, jobs) -> dict:
    """Device time of the fused program's DP calls at its budgets for
    ``n_pairs``: narrow score (2E jobs), narrow fill + walk (T), wide
    score (W) and wide re-trace (RT)."""
    import jax
    from bbmap_tpu.align import fused_device as fdev
    from bbmap_tpu.ops import msa_jax
    B = 2 * n_pairs
    E = fdev.esc_budget(B)
    T = min(fdev.trace_budget(B), E)
    shapes = {"score_narrow": (2 * E, CN, False),
              "fill_walk_narrow": (T, CN, True),
              "score_wide": (min(128, 2 * E), CW, False),
              "fill_walk_wide": (min(64, T), CW, True)}
    out = {}
    for name, (n, C, trace) in shapes.items():
        rd, rf = jobs["narrow" if C == CN else "wide"][:2]
        reps = -(-n // len(rd))
        rd = np.tile(rd, (reps, 1))[:n]
        rf = np.tile(rf, (reps, 1))[:n]
        if trace:
            f = jax.jit(jax.vmap(
                lambda a, b, C=C: msa_jax._align_single(a, b, L, C)[:2]))
        else:
            f = jax.jit(jax.vmap(
                lambda a, b, C=C: msa_jax.msa_score_single(a, b, L, C)))
        rd_d, rf_d = jax.device_put(rd), jax.device_put(rf)
        out[name] = time_fn(f, rd_d, rf_d)
        log(f"dp time {name}: {n} jobs ({L} x {C}): "
            f"{1000 * out[name]:.2f} ms")
    return out


def phase_dp(pool_futures, job_sets, n_pairs: int) -> dict:
    bad = sum(compare_dp(tag, job_sets[tag], pool_futures[tag])
              for tag in job_sets)
    check(bad == 0, f"dp: {bad} jobs differ from the oracle")
    return time_fused_dp(n_pairs, job_sets) if n_pairs else {}


# ---------------------------------------------------------------- gathers

def phase_gathers(B: int, n: int, K: int = 8, n_cols: int = 3,
                  seed: int = 9) -> dict:
    """Exactness of the candidate stage's row take over the full int32
    range, and its device time at (B, n) -> (B, K) with ``n_cols``
    columns (the stage's first take), beside a plain take_along_axis."""
    import jax
    import jax.numpy as jnp
    from bbmap_tpu.align import quickmap_device as qd
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-2 ** 31, 2 ** 31, size=(B, n),
                         dtype=np.int64).astype(np.int32)
            for _ in range(n_cols)]
    for c in cols:
        c.flat[:4] = (-2 ** 31, 2 ** 31 - 1, 0, -1)
    idx = rng.integers(0, n, size=(B, K)).astype(np.int32)
    want = [np.take_along_axis(c, idx, axis=1) for c in cols]
    impls = {
        "take_along_flat": jax.jit(
            lambda i, *c: [qd.take_along_flat(x, i) for x in c]),
        "take_along_axis": jax.jit(
            lambda i, *c: [jnp.take_along_axis(x, i, axis=1)
                           for x in c]),
    }
    dcols = [jax.device_put(c) for c in cols]
    didx = jax.device_put(idx)
    out = {}
    for name, f in impls.items():
        got = [np.asarray(x) for x in f(didx, *dcols)]
        exact = all(np.array_equal(g, w) for g, w in zip(got, want))
        check(exact, f"gathers: {name} is not exact")
        out[name] = time_fn(f, didx, *dcols, reps=5)
        log(f"gathers: {name} exact; ({B}, {n}) -> ({B}, {K}) x "
            f"{n_cols}: {1000 * out[name]:.3f} ms")
    return out


# -------------------------------------------------------------------- e2e

def start_cpu_map(inp: dict, out_sam: str, batch: int):
    """The first n_head pairs through the CLI in a subprocess held to
    the CPU: it never opens a card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", BBMAP_FORCE_CPU="1",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "bbmap_tpu", "bbmap", f"ref={inp['ref']}",
         f"in={inp['head1']}", f"in2={inp['head2']}", f"out={out_sam}",
         "nodisk", f"batchsize={batch}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def sam_records(path: str) -> list:
    return [ln for ln in _read(path).split(b"\n")
            if ln and not ln.startswith(b"@")]


def grade_sam(records, t1, t2, tol: int = 20) -> dict:
    """Mapped fraction, strict sensitivity (primary alignment start
    within ``tol`` of the origin), proper-pair rate."""
    n = len(t1)
    mapped = strict = proper = 0
    for rec in records:
        f = rec.split(b"\t", 4)
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 0x4:
            continue
        mapped += 1
        truth = (t1 if flag & 0x40 else t2)[int(f[0])]
        strict += abs(int(f[3]) - 1 - int(truth)) <= tol
        proper += bool(flag & 0x2 and flag & 0x40)
    return {"mapped_fraction": mapped / (2 * n),
            "sensitivity": strict / (2 * n), "pair_rate": proper / n}


def phase_e2e(inp: dict, cpu_proc, work: str, batch: int,
              min_frac: float = 0.99) -> dict:
    from bbmap_tpu.tools import bbmap
    from bbmap_tpu.utils.devinfo import card_lines
    sam = os.path.join(work, "gpu.sam")
    args = [f"ref={inp['ref']}", f"in={inp['all1']}",
            f"in2={inp['all2']}", f"out={sam}", "nodisk",
            f"batchsize={batch}"]
    t = time.time()
    check(bbmap.main(list(args)) == 0, "e2e: bbmap failed")
    cold = time.time() - t
    t = time.time()
    check(bbmap.main(list(args)) == 0, "e2e: bbmap (warm) failed")
    warm = time.time() - t
    recs = sam_records(sam)
    st = grade_sam(recs, inp["t1"], inp["t2"])
    n = inp["n_pairs"]
    cards = "; ".join(card_lines()) or "no nvidia-smi"
    log(f"e2e: {n} pairs, mapped {st['mapped_fraction']:.4f}, "
        f"sensitivity {st['sensitivity']:.4f}, "
        f"pair rate {st['pair_rate']:.4f}")
    log(f"e2e (information only, {cards}): first run {cold:.1f}s "
        f"(index build + compiles + mapping), second run {warm:.1f}s "
        f"= {2 * n / warm:.0f} reads/s incl. index build")
    check(st["mapped_fraction"] >= min_frac,
          f"e2e: mapped fraction {st['mapped_fraction']:.4f}")
    check(st["sensitivity"] >= min_frac,
          f"e2e: sensitivity {st['sensitivity']:.4f}")
    cpu_sam = os.path.join(work, "cpu.sam")
    _out, err = cpu_proc.communicate(timeout=1800)
    check(cpu_proc.returncode == 0,
          f"e2e: CPU subprocess failed: {err.decode()[-3000:]}")
    cpu = sam_records(cpu_sam)
    gpu = recs[:len(cpu)]
    diff = [(g, c) for g, c in zip(gpu, cpu) if g != c]
    for g, c in diff:
        log(f"e2e DIFF gpu: {g.decode()}")
        log(f"e2e DIFF cpu: {c.decode()}")
    check(len(cpu) == 2 * inp["n_head"], f"e2e: CPU run wrote "
          f"{len(cpu)} records")
    check(not diff, f"e2e: {len(diff)} of {len(cpu)} SAM records "
          f"differ between the GPU and the CPU")
    log(f"e2e: GPU and CPU SAM records identical "
        f"({len(cpu)} records, {inp['n_head']} pairs)")
    st.update(cold_s=cold, warm_s=warm)
    return st


# ------------------------------------------------------------------ tools

def _run_both(main, argv_for, env_key: str, outs) -> None:
    """Run a tool CLI with the device path on, then off; every output
    file must be byte-equal."""
    got = {}
    for mode in ("1", "0"):
        os.environ[env_key] = mode
        try:
            t = time.time()
            check(main(argv_for(mode)) == 0, f"tools: rc != 0 ({mode})")
            log(f"tools: {main.__module__} {env_key}={mode}: "
                f"{time.time() - t:.1f}s")
        finally:
            os.environ.pop(env_key, None)
        got[mode] = [_read(p(mode)) for p in outs]
    for i, (a, b) in enumerate(zip(got["1"], got["0"])):
        check(a == b, f"tools: {main.__module__} output {i} differs "
              f"device vs host")
    check(all(len(x) for x in got["1"]), "tools: empty output")


def phase_tools(work: str, n_reads: int, seed: int = 31) -> None:
    from bbmap_tpu.core.bases import COMP_ASCII
    from bbmap_tpu.tools import bbduk, bbmerge, seal
    rng = np.random.default_rng(seed)
    qual = np.full((n_reads, L), 35, np.int8)
    names = [b"r%d" % i for i in range(n_reads)]
    # bbduk: adapter-trimming, k=23 hdist=1 (without mink=: the short
    # tip k-mers are a per-read host loop that takes minutes at this
    # size, device scan or not)
    adapters = rng.choice(ACGT, size=(4, 34))
    ad_fa = os.path.join(work, "adapters.fa")
    with open(ad_fa, "wb") as fh:
        for i, a in enumerate(adapters):
            fh.write(b">ad%d\n%s\n" % (i, a.tobytes()))
    reads = rng.choice(ACGT, size=(n_reads, L))
    for i in range(0, n_reads, 3):
        at = int(rng.integers(60, 110))
        a = adapters[i % 4]
        reads[i, at:] = a[:L - at] if L - at <= 34 else \
            np.concatenate([a, reads[i, at + 34:]])
    fq = os.path.join(work, "duk.fq")
    _fastq(fq, reads, qual, names)
    _run_both(bbduk.main, lambda m: [
        f"in={fq}", f"out={work}/duk{m}.fq", f"ref={ad_fa}", "k=23",
        "ktrim=r", "hdist=1"], "BBMAP_DEVICE_KMERS",
        [lambda m: f"{work}/duk{m}.fq"])
    # bbmerge: overlapping pairs, inserts 180..260
    n_p = n_reads // 2
    ins = rng.integers(180, 261, n_p)
    frag = rng.choice(ACGT, size=(n_p, 260))
    m1 = frag[:, :L]
    idx2 = (ins - L)[:, None] + np.arange(L)[None, :]
    m2 = COMP_ASCII[np.take_along_axis(frag, idx2, axis=1)][:, ::-1]
    q = rng.integers(25, 40, size=(n_p, L)).astype(np.int8)
    pn = [b"p%d" % i for i in range(n_p)]
    _fastq(f"{work}/mg1.fq", m1, q, pn)
    _fastq(f"{work}/mg2.fq", np.ascontiguousarray(m2), q[:, ::-1], pn)
    _run_both(bbmerge.main, lambda m: [
        f"in1={work}/mg1.fq", f"in2={work}/mg2.fq",
        f"out={work}/merged{m}.fq"], "BBMAP_DEVICE_OVERLAP",
        [lambda m: f"{work}/merged{m}.fq"])
    # seal: attribution over 50 references
    nrefs, rl = 50, 5000
    refmat = rng.choice(ACGT, size=(nrefs, rl))
    sref = os.path.join(work, "seal_refs.fa")
    with open(sref, "wb") as fh:
        for i, r in enumerate(refmat):
            fh.write(b">scaf%d\n%s\n" % (i, r.tobytes()))
    src = rng.integers(0, nrefs, n_reads)
    off = rng.integers(0, rl - L, n_reads)
    sreads = refmat[src[:, None], off[:, None] + np.arange(L)[None, :]]
    sfq = os.path.join(work, "seal.fq")
    _fastq(sfq, sreads, qual, names)
    _run_both(seal.main, lambda m: [
        f"in={sfq}", f"ref={sref}", f"outm={work}/sealm{m}.fq",
        f"stats={work}/sealstats{m}.txt", "k=31", "ambig=first"],
        "BBMAP_DEVICE_KMERS",
        [lambda m: f"{work}/sealm{m}.fq",
         lambda m: f"{work}/sealstats{m}.txt"])
    log(f"tools: bbduk, bbmerge, seal byte-equal device vs host "
        f"({n_reads} reads each)")


# ----------------------------------------------------------------- --four

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_hosts(inp: dict, work: str, n_hosts: int, batch: int,
                child_env=None) -> None:
    """``bbmap hosts=N``, one process per card (each opens only card
    ``hostid % cards``), against one process in this one. Single-end
    reads: paired runs update the average insert size per process, so
    a striped paired run's MAPQs legitimately differ from one process's."""
    from bbmap_tpu.tools import bbmap
    port = _free_port()
    merged = os.path.join(work, "hosts.sam")
    base = [f"ref={inp['ref']}", f"in={inp['all1']}", "nodisk",
            f"batchsize={batch}"]
    env = dict(os.environ, **(child_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bbmap_tpu", "bbmap", f"out={merged}",
         f"hosts={n_hosts}", f"hostid={h}",
         f"coordinator=localhost:{port}"] + base, cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for h in range(n_hosts)]
    errs = []
    for p in procs:
        _out, err = p.communicate(timeout=1800)
        errs.append(err.decode()[-2000:])
    check(all(p.returncode == 0 for p in procs),
          f"hosts: a process failed: {errs}")
    single = os.path.join(work, "single.sam")
    check(bbmap.main([f"out={single}"] + base) == 0, "hosts: single run")
    a, b = _read(merged), _read(single)
    n_rec = len(sam_records(single))
    check(a == b, f"hosts: merged SAM of {n_hosts} processes differs "
          f"from one process ({n_rec} records)")
    log(f"hosts: bbmap hosts={n_hosts} merged SAM byte-equal to one "
        f"process ({n_rec} records)")


def phase_mesh(n_devices: int) -> None:
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(n_devices, read_len=L)
    log(f"mesh: {n_devices}-device (data x index) route matches one "
        f"device at {L} bp")


# ------------------------------------------------------------------- main

def main_one(work: str) -> dict:
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context
    from bbmap_tpu.io import native
    dev = identity()
    native.get_lib()                 # build csrc once, before children
    inp = prepare_inputs(work, n_pairs=65536, n_head=2048)
    cpu_proc = start_cpu_map(inp, os.path.join(work, "cpu.sam"), 2048)
    jobs = dp_job_sets(n=512, n_pb=4, pb_rows=1000)
    with ProcessPoolExecutor(max_workers=max(2, (os.cpu_count() or 4)
                                             // 2),
                             mp_context=get_context("spawn")) as pool:
        futs = start_oracle(pool, jobs)
        try:
            phase_compile(inp["ref"], 32768)
            phase_dp(futs, jobs, 32768)
        finally:
            for fl in futs.values():
                for f in fl:
                    f.cancel()
    phase_gathers(65536, 128)
    try:
        phase_e2e(inp, cpu_proc, work, 32768)
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait()
    phase_tools(work, 200_000)
    return dev


def main_four(work: str) -> dict:
    from bbmap_tpu.parallel import multihost
    n = multihost.local_card_count()
    check(n >= 4, f"--four needs 4 cards, this machine has {n}")
    inp = prepare_inputs(work, n_pairs=16384, n_head=0)
    phase_hosts(inp, work, 4, 2048)       # before this process opens a card
    dev = identity()
    check(dev["count"] >= 4, f"JAX sees {dev['count']} devices")
    phase_mesh(4)
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh and hosts=4 paths")
    opts = ap.parse_args(argv)
    from bbmap_tpu.utils.jaxcfg import enable_compilation_cache
    enable_compilation_cache()
    try:
        dev = main_four(WORK) if opts.four else main_one(WORK)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
