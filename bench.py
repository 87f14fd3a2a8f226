"""Benchmark: reads/s mapping synthetic PAIRED 2x150 bp reads to an
E. coli-scale genome (the BASELINE.json north-star metric) on one GPU.

Prints ONE JSON line (the final line of stdout), naming the device it
ran on (platform, device_kind, device count, the cards' names and power
limits). Fails unless JAX's first device is a GPU: a CPU timing is not
a device measurement.

Baseline: the reference publishes no numeric throughput table
(BASELINE.md); the figure used here is 30,000 reads/s for single-node
Java BBMap on 2x150bp vs E. coli with 32 threads, a mid-range estimate
of the poster-era "similar in speed to bwa" claim (BASELINE.md rows
1-2). vs_baseline = value / 30000.

Workload: the timed loop maps PAIRS through
``map_pairs_columnar_stream`` — pair boost, DP escalation, device mate
rescue, proper-pair flags, and the dynamic insert model all run inside
the measurement. The genome carries implanted repeat families (7x 5 kbp,
20x 1.2 kbp, 30x 700 bp at 1% divergence); reads carry substitutions AND
1-10 bp indels; inserts ~N(250, 45). ``value`` is the MEDIAN of timed
rounds; ``sensitivity`` is the strict-correct fraction over BOTH mates
(mapped within +-20 bp of the sampled origin, gradesam-strict style,
reference: align2/GradeSamFile.java:17).

Structure:

- a warm thread runs the FULL ``map_pairs_columnar`` pipeline on a big
  batch (fused pair + rescue + escalate + trace + refit programs), so
  phase B's warmup meets no fresh compiles;
- results are banked after EVERY timed round (median-so-far), and a
  deadline watchdog (BENCH_DEADLINE) prints the banked result;
- phase A times a small batch size while the big programs compile;
- compiled programs persist in the compile cache
  (utils/jaxcfg.enable_compilation_cache).
"""

import json
import os
import statistics
import sys
import threading
import time

import numpy as np

BASELINE_READS_PER_SEC = 30_000.0
T_START = time.time()
DEVICE = None          # set by main(): devinfo.device_identity()

_best_lock = threading.Lock()
_best_result = None
_printed = threading.Event()


def _emit_and_exit():
    """Print the banked result exactly once and hard-exit 0."""
    with _best_lock:
        res = _best_result
        if _printed.is_set() or res is None:
            return
        _printed.set()
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    os._exit(0)


def _bank(res):
    """Keep the NEWEST result of the most-complete phase: larger batch
    beats smaller, then more timed rounds beat fewer, then newer beats
    older EVEN IF the median is lower (a lucky single-round median must
    not outrank the final 3-round median — honesty over max())."""
    global _best_result
    with _best_lock:
        if _best_result is None:
            _best_result = res
            return
        key = (res.get("batch_pairs", 0), res.get("rounds_timed", 0))
        cur = (_best_result.get("batch_pairs", 0),
               _best_result.get("rounds_timed", 0))
        if key >= cur:
            _best_result = res


def _watchdog(deadline_s: float):
    while True:
        left = (T_START + deadline_s) - time.time()
        if left <= 0:
            break
        time.sleep(min(left, 2.0))
    note("deadline reached — emitting banked result")
    _emit_and_exit()
    # nothing banked yet (a compile-service stall swallowed phase A):
    # emit the FIRST result that lands instead of running unbounded
    note("deadline passed with no banked result — will emit the first "
         "round that completes")
    while not _printed.is_set():
        time.sleep(1.0)
        _emit_and_exit()


def note(msg: str):
    print(f"[bench +{time.time()-T_START:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def make_genome(n=4_600_000, seed=7):
    """Random body + implanted repeat families (divergence 1%)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(bases, size=n).astype(np.uint8)

    def implant(length, copies, divergence=0.01):
        unit = rng.choice(bases, size=length).astype(np.uint8)
        for _ in range(copies):
            at = int(rng.integers(0, n - length))
            u = unit.copy()
            nmut = int(length * divergence)
            if nmut:
                pos = rng.choice(length, size=nmut, replace=False)
                u[pos] = bases[rng.integers(0, 4, size=nmut)]
            g[at:at + length] = u

    implant(5000, 7)     # rRNA-operon-like
    implant(1200, 20)    # IS-element-like
    implant(700, 30)     # short diverged repeats
    return g


def _mutate(reads, windows, rng, L):
    """~78% clean, 12% 1-3 subs, 5% one 1-10 bp deletion, 5% one
    1-10 bp insertion (per mate)."""
    n_reads = len(reads)
    bases = np.frombuffer(b"ACGT", np.uint8)
    r = rng.random(n_reads)
    sub_rows = np.nonzero((r >= 0.78) & (r < 0.90))[0]
    del_rows = np.nonzero((r >= 0.90) & (r < 0.95))[0]
    ins_rows = np.nonzero(r >= 0.95)[0]
    for i in sub_rows:
        for _ in range(int(rng.integers(1, 4))):
            p = int(rng.integers(0, L))
            reads[i, p] = bases[int(rng.integers(0, 4))]
    for i in del_rows:
        d = int(rng.integers(1, 11))
        p = int(rng.integers(10, L - 10))
        w = windows[i]
        reads[i] = np.concatenate([w[:p], w[p + d:p + d + (L - p)]])
    for i in ins_rows:
        d = int(rng.integers(1, 11))
        p = int(rng.integers(10, L - 10))
        ins = bases[rng.integers(0, 4, size=d)]
        reads[i] = np.concatenate([reads[i, :p], ins,
                                   reads[i, p:L - d]])
    return reads


def make_quality(rng, n_reads, L):
    """Illumina-like phred profile: high plateau with a sagging tail and
    sporadic low-quality positions, BINNED to the 8 RTA quality levels
    like every modern Illumina instrument (NovaSeq bins to 4) —
    exercises the quality-probability seeding offsets and the keyProbs
    greedy-trim weights (reference: AbstractMapThread.java:679) inside
    the timed loop, and keeps the batch palette-packable (<= 16 levels,
    quickmap_device.pack_quality_host)."""
    pos = np.arange(L)
    base = 37.0 - 8.0 * (pos / L) ** 2                     # 37 -> 29
    q = base[None, :] + rng.normal(0, 2.0, (n_reads, L))
    dips = rng.random((n_reads, L)) < 0.01                  # 1% bad spots
    q = np.where(dips, rng.uniform(2, 12, (n_reads, L)), q)
    q = np.clip(q, 2, 41)
    levels = np.array([2, 9, 12, 16, 22, 27, 32, 37], np.int8)
    edges = (levels[1:] + levels[:-1]) / 2.0
    return levels[np.digitize(q, edges)]


def make_pairs(genome, n_pairs, L=150, seed=11, with_quality=True):
    """FR innie pairs, insert ~N(250, 45) clipped to [2L+10, 420]; both
    mates carry the single-end error model. Returns (reads1, reads2,
    qual1, qual2, truth1, truth2) — truth = genome-forward alignment
    start of each mate; mate 2 is reverse-complemented in its read
    row."""
    from bbmap_tpu.core.bases import COMP_ASCII
    rng = np.random.default_rng(seed)
    W = L + 12
    insert = np.clip(rng.normal(250, 45, n_pairs).astype(np.int64),
                     2 * L + 10, 420)
    starts = rng.integers(0, len(genome) - 460, size=n_pairs)
    idx1 = starts[:, None] + np.arange(W)[None, :]
    r1 = genome[idx1]
    s2 = starts + insert - L
    idx2 = s2[:, None] + np.arange(W)[None, :]
    win2 = genome[idx2]
    r1 = _mutate(r1[:, :L].copy(), genome[idx1], rng, L)
    r2f = _mutate(win2[:, :L].copy(), win2, rng, L)
    r2 = COMP_ASCII[r2f][:, ::-1]
    if with_quality:
        q1 = make_quality(rng, n_pairs, L)
        q2 = make_quality(rng, n_pairs, L)
    else:
        q1 = q2 = None
    return (np.ascontiguousarray(r1), np.ascontiguousarray(r2),
            q1, q2, starts.astype(np.int64), s2.astype(np.int64))


def _phase(aligner, gbases, n_pairs: int, n_steady: int, L: int,
           label: str, rounds: int = 1, with_quality: bool = True):
    """Map 1 warmup + ``rounds`` x n_steady timed PAIR batches.
    value = median round reads/s (reads = 2 x pairs), best kept as
    value_best. The running result is BANKED AFTER EVERY ROUND
    so a deadline mid-phase still lands the newest
    median."""
    from bbmap_tpu.core.batch import ReadBatch
    n_batches = 1 + n_steady
    r1, r2, q1, q2, t1, t2 = make_pairs(
        gbases, n_pairs * n_batches, L=L, with_quality=with_quality)

    def mk(rows, quals, b):
        lo = b * n_pairs
        return ReadBatch(
            bases=rows[lo:lo + n_pairs],
            quality=None if quals is None else quals[lo:lo + n_pairs],
            lengths=np.full(n_pairs, L, np.int32),
            ids=[str(i) for i in range(lo, lo + n_pairs)],
            numeric_ids=np.arange(lo, lo + n_pairs, dtype=np.int64))

    note(f"{label}: warmup batch ({n_pairs} pairs) — compiles here")
    t_w = time.time()
    out0 = aligner.map_pairs_columnar(mk(r1, q1, 0), mk(r2, q2, 0))
    warmup_s = time.time() - t_w
    note(f"{label}: warmup done ({warmup_s:.1f}s), "
         f"timing {rounds}x{n_steady} pair batches")

    # grade the warmup batch once so every banked round carries
    # sensitivity numbers
    def grade(stats_list):
        n_mapped = n_correct = n_paired = n_rescued = 0
        nb = 0
        for b, (mb1, mb2) in stats_list:
            nb += 1
            lo = b * n_pairs
            for mb, truth in ((mb1, t1), (mb2, t2)):
                tr = truth[lo:lo + n_pairs]
                flat = aligner.chrom_offsets[
                    np.maximum(mb.chrom, 1) - 1] + mb.start
                n_mapped += int(mb.mapped.sum())
                ok = mb.mapped & (np.abs(flat - tr) <= 20)
                n_correct += int(ok.sum())
                n_rescued += int(mb.rescued.sum())
            n_paired += int(mb1.paired.sum())
        n_total = 2 * nb * n_pairs
        return {"mapped_fraction": round(n_mapped / n_total, 4),
                "sensitivity": round(n_correct / n_total, 4),
                "pair_rate": round(n_paired / (nb * n_pairs), 4),
                "rescued": n_rescued}

    graded = [(0, out0)]
    rates = []
    stages = {}
    quality_stats = None

    def bank_now():
        if not rates:
            return
        rps = statistics.median(rates)
        res = {
            "metric": "reads_per_sec_per_chip_2x150_ecoli",
            "value": round(rps, 1),
            "unit": "reads/s",
            "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 3),
            "value_best": round(max(rates), 1),
            "rounds_timed": len(rates),
            "stages": dict(stages),
            "paired_workload": True,
            "quality_in_loop": with_quality,
            "batch_pairs": n_pairs,
            "device": DEVICE,
            "setup_seconds": round(t_w - T_START, 1),
            "warmup_seconds": round(warmup_s, 1),
            "steady_ms_per_batch": round(
                1000.0 * 2 * n_pairs / rps, 1),
        }
        res.update(quality_stats or {})
        _bank(res)
        return res

    res = None
    for rnd in range(rounds):
        t0 = time.time()
        out = list(aligner.map_pairs_columnar_stream(
            (mk(r1, q1, b), mk(r2, q2, b))
            for b in range(1, n_batches)))
        dt_r = time.time() - t0
        rates.append(2 * n_steady * n_pairs / dt_r)
        if rnd == 0:
            graded.extend((b + 1, o) for b, o in enumerate(out))
            quality_stats = grade(graded)
            # per-stage decomposition (one serial batch, stage by
            # stage — no compiles: same shapes as the rounds)
            b1x, b2x = mk(r1, q1, 1), mk(r2, q2, 1)
            ts = time.time()
            f = aligner._fused_pair_dispatch(b1x, b2x, L)
            stages["dispatch_ms"] = round(1000 * (time.time() - ts), 1)
            ts = time.time()
            dd = f.host()
            stages["fused_device_and_fetch_ms"] = round(
                1000 * (time.time() - ts), 1)
            ts = time.time()
            mid = aligner._pair_phase1(b1x, b2x, L, dd)
            stages["host_assemble_ms"] = round(
                1000 * (time.time() - ts), 1)
            ts = time.time()
            aligner._pair_phase2(mid)
            stages["rescue_ms"] = round(1000 * (time.time() - ts), 1)
        note(f"{label}: round {rnd + 1}: {rates[-1]:.0f} reads/s")
        res = bank_now()
    if res is not None:
        note(f"{label}: {res['value']:.0f} reads/s median "
             f"(best {res['value_best']:.0f}; "
             f"sens {res.get('sensitivity')}, "
             f"mapped {res.get('mapped_fraction')}, "
             f"paired {res.get('pair_rate')}, "
             f"rescued {res.get('rescued')})")
    return res


def main():
    deadline = float(os.environ.get("BENCH_DEADLINE", "250"))
    threading.Thread(target=_watchdog, args=(deadline,),
                     daemon=True).start()

    from bbmap_tpu.utils.jaxcfg import enable_compilation_cache
    enable_compilation_cache()
    from bbmap_tpu.utils.devinfo import device_identity
    global DEVICE
    DEVICE = device_identity()
    note(f"device: {DEVICE}")
    if DEVICE["platform"] != "gpu":
        note("no GPU found: bench.py measures only on a GPU")
        return 1
    note("setup: building genome + index")
    from bbmap_tpu.align.pipeline import BBMapAligner
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu.core.genome import Genome, Scaffold
    from bbmap_tpu.index.build import analyze_index, build_index

    gbases = make_genome()
    g = Genome(chroms=[gbases], scaffolds=[
        Scaffold(chrom=1, sid=1, start=0, length=len(gbases),
                 name="ecoli_like")]).finalize()
    index = build_index(g, 13)
    analyze_index(index, 0.01)
    aligner = BBMapAligner(g, index)
    note("setup done")

    L = 150
    big = int(os.environ.get("BENCH_PAIRS", 32768))
    small = int(os.environ.get("BENCH_PAIRS_SMALL", 2048))
    n_steady = int(os.environ.get("BENCH_STEADY_BATCHES", 3))
    with_q = os.environ.get("BENCH_QUALITY", "1") != "0"

    # Warm the ENTIRE steady-state program set at the big shape
    # CONCURRENTLY with phase A: a full map_pairs_columnar run compiles
    # every pinned-shape program the stream will use.
    warm_done = threading.Event()

    def warm_big():
        try:
            r1, r2, q1, q2, _t1, _t2 = make_pairs(
                gbases, big, L=L, seed=99, with_quality=with_q)

            def mb(rows, quals):
                return ReadBatch(
                    bases=rows, quality=quals,
                    lengths=np.full(big, L, np.int32),
                    ids=[str(i) for i in range(big)],
                    numeric_ids=np.arange(big, dtype=np.int64))

            aligner.map_pairs_columnar(mb(r1, q1), mb(r2, q2))
            note("big-shape pipeline fully warm")
        except Exception as e:
            note(f"big-shape warm failed: {type(e).__name__}: {e}")
        finally:
            warm_done.set()

    threading.Thread(target=warm_big, daemon=True).start()

    if small and small < big:
        # 8 steady batches: the 3-deep pipeline needs >2 batches to
        # reach steady state
        _phase(aligner, gbases, small,
               int(os.environ.get("BENCH_STEADY_SMALL", "8")),
               L, "phase A", rounds=2, with_quality=with_q)

    warm_done.wait(timeout=max(5.0,
                               T_START + deadline - time.time() - 45))
    _phase(aligner, gbases, big, n_steady, L, "phase B",
           rounds=int(os.environ.get("BENCH_ROUNDS", "3")),
           with_quality=with_q)
    _emit_and_exit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
