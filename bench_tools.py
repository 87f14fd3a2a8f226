"""Tool-kernel throughput (BASELINE.json configs 3-4): BBDuk adapter
k-mer scanning, BBMerge overlap detection, Seal attribution and long-read
mapping, device path vs host numpy path.

Prints one JSON line per tool:
  {"metric": "bbduk_truseq_k23_hd1_reads_per_sec", "value": ..,
   "host_value": .., "device_speedup": ..}
  {"metric": "bbmerge_reads_per_sec", ...}

Run on the GPU: python bench_tools.py (TOOLBENCH_ONLY=name,... selects
tools). No GPU figure has been recorded yet (PERF.md).
"""
import json
import os
import sys
import time

import numpy as np


def note(m):
    print(f"[tools] {m}", file=sys.stderr, flush=True)


def _adapters():
    """TruSeq-class adapter set from the bundled resources
    (reference: resources/adapters.fa)."""
    import gzip
    path = "/root/reference/resources/adapters.fa"
    seqs = []
    name = None
    cur = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for ln in f:
            ln = ln.strip()
            if ln.startswith(">"):
                if cur and name and "TruSeq" in name:
                    seqs.append("".join(cur))
                name = ln[1:]
                cur = []
            else:
                cur.append(ln)
    if cur and name and "TruSeq" in name:
        seqs.append("".join(cur))
    if not seqs:       # fall back to any adapters
        with opener(path, "rt") as f:
            cur = []
            for ln in f:
                ln = ln.strip()
                if ln.startswith(">"):
                    if cur:
                        seqs.append("".join(cur))
                    cur = []
                else:
                    cur.append(ln)
            if cur:
                seqs.append("".join(cur))
    return seqs[:200]


def bench_bbduk(n_reads=1_000_000, L=150, k=23, hdist=1):
    from bbmap_tpu.index import kmerset
    note(f"bbduk: building k={k} hdist={hdist} set from bundled "
         f"adapters")
    seqs = _adapters()
    refs = [np.frombuffer(s.encode(), np.uint8) for s in seqs]
    ks = kmerset.build_kmer_set(
        [bytes(r) for r in refs], k=k, hdist=hdist)
    note(f"bbduk: {len(ks.values)} ref kmers (with hdist mutants)")

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = rng.choice(bases, size=(n_reads, L)).astype(np.uint8)
    # 20% of reads get an adapter insertion at a random tail position
    adlen = min(len(refs[0]), 33)
    hit_rows = rng.random(n_reads) < 0.2
    for i in np.nonzero(hit_rows)[0]:
        p = int(rng.integers(L // 2, L - 5))
        ad = refs[int(rng.integers(0, len(refs)))][:min(adlen, L - p)]
        reads[i, p:p + len(ad)] = ad

    CH = 131072
    npad = ((n_reads + CH - 1) // CH) * CH
    if npad != n_reads:
        reads = np.vstack([reads, reads[:npad - n_reads]])
    res = {}
    for mode, env in (("device", "1"), ("host", "0")):
        os.environ["BBMAP_DEVICE_KMERS"] = env
        # warm (compile)
        kmerset.scan_batch(ks, reads[:CH])
        t0 = time.time()
        nhit = 0
        for a in range(0, npad, CH):
            hits, _ids = kmerset.scan_batch(ks, reads[a:a + CH])
            nhit += int(hits.any(axis=1).sum())
        dt = time.time() - t0
        res[mode] = npad / dt
        note(f"bbduk {mode}: {res[mode]:.0f} reads/s "
             f"({nhit} adapter reads found)")
    os.environ.pop("BBMAP_DEVICE_KMERS", None)
    print(json.dumps({
        "metric": "bbduk_truseq_k23_hd1_reads_per_sec",
        "value": round(res["device"], 1), "unit": "reads/s",
        "host_value": round(res["host"], 1),
        "device_speedup": round(res["device"] / res["host"], 2),
        "reads": n_reads}), flush=True)


def bench_bbmerge(n_pairs=500_000, L=100, insert=160):
    from bbmap_tpu.core.bases import COMP_ASCII
    from bbmap_tpu.ops import overlap
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    frag = rng.choice(bases, size=(n_pairs, insert)).astype(np.uint8)
    a = frag[:, :L].copy()
    b_fwd = frag[:, insert - L:]
    # b in read-1 orientation (already rc'd back) per the API contract
    b = b_fwd.copy()
    CH = 65536
    npad = ((n_pairs + CH - 1) // CH) * CH
    if npad != n_pairs:
        a = np.vstack([a, a[:npad - n_pairs]])
        b = np.vstack([b, b[:npad - n_pairs]])
    res = {}
    for mode in ("device", "host"):
        os.environ["BBMAP_DEVICE_OVERLAP"] = \
            "1" if mode == "device" else "0"
        overlap.mate_by_overlap_batch(a[:CH], None, b[:CH], None)
        t0 = time.time()
        nm = 0
        for s in range(0, npad, CH):
            ins, bad, amb = overlap.mate_by_overlap_batch(
                a[s:s + CH], None, b[s:s + CH], None)
            nm += int((ins > 0).sum())
        dt = time.time() - t0
        res[mode] = 2 * npad / dt
        note(f"bbmerge {mode}: {res[mode]:.0f} reads/s "
             f"({nm} merged, expect ~{n_pairs})")
    os.environ.pop("BBMAP_DEVICE_OVERLAP", None)
    print(json.dumps({
        "metric": "bbmerge_reads_per_sec",
        "value": round(res["device"], 1), "unit": "reads/s",
        "host_value": round(res["host"], 1),
        "device_speedup": round(res["device"] / res["host"], 2),
        "pairs": n_pairs}), flush=True)


def bench_mappacbio(n_reads=1200, L=6000):
    """Long-read mode evidence (VERDICT r4 #5, BASELINE config 5):
    6 kbp PacBio-model reads vs a bacterial-scale genome through the
    REAL mappacbio CLI (k=12 index, minratio=0.46, MSA9PacBio profile,
    6020-row envelope — reference: align2/BBMapThreadPacBio.java:28,
    BBIndexPacBio.java:2462). Reports reads/s (second, warm run) and
    the gradesam strict-correct fraction."""
    import tempfile

    from bbmap_tpu.io import fastx
    from bbmap_tpu.tools import gradesam, mappacbio, randomreads

    tmp = tempfile.mkdtemp(prefix="pbbench")
    ref = os.path.join(tmp, "ref.fa")
    reads = os.path.join(tmp, "reads.fq")
    out = os.path.join(tmp, "mapped.sam")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import make_genome
    g = make_genome()
    with open(ref, "w") as fh:
        fh.write(">ecoli_like\n")
        for a in range(0, len(g), 80):
            fh.write(g[a:a + 80].tobytes().decode() + "\n")
    note(f"mappacbio: generating {n_reads} x {L} bp reads "
         f"(pacbio error model)")
    rc = randomreads.main([
        f"ref={ref}", f"out={reads}", f"reads={n_reads}", "pacbio=t",
        f"pbmin={L}", f"pbmax={L}", "pberror=0.12", "seed=19"])
    assert rc == 0
    args = [f"ref={ref}", f"in={reads}", f"out={out}", "nodisk"]
    note("mappacbio: warm run (compiles the 6 kbp programs)")
    t0 = time.time()
    assert mappacbio.main(list(args)) == 0
    warm_s = time.time() - t0
    note(f"mappacbio: warm run {warm_s:.1f}s; timing second run")
    t0 = time.time()
    assert mappacbio.main(list(args)) == 0
    dt = time.time() - t0
    s = gradesam.grade(out, 400)    # strict = within 400 bp for 6 kbp
    n = max(1, s["primary"] - s["unparsed"])
    res = {
        "metric": "mappacbio_6kbp_reads_per_sec",
        "value": round(n_reads / dt, 1), "unit": "reads/s",
        "bases_per_sec": round(n_reads * L / dt, 0),
        "strict_correct": round(s["strict"] / n, 4),
        "mapped_fraction": round(s["mapped"] / n, 4),
        "reads": n_reads, "read_len": L,
        "warmup_seconds": round(warm_s, 1)}
    note(f"mappacbio: {res['value']} reads/s "
         f"({res['bases_per_sec']:.0f} b/s), "
         f"strict {res['strict_correct']}, "
         f"mapped {res['mapped_fraction']}")
    print(json.dumps(res), flush=True)


def bench_seal(n_reads=500_000, L=150, nrefs=50):
    """Seal attribution throughput: device k-mer scan + vectorized
    multi-id condense vs the host scan path (VERDICT r4 #6)."""
    from bbmap_tpu.core.batch import ReadBatch
    from bbmap_tpu.tools.seal import Seal
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    refs = [bytes(rng.choice(bases, 5000)) for _ in range(nrefs)]
    names = [f"scaf{i}" for i in range(nrefs)]
    srcs = rng.integers(0, nrefs, n_reads)
    offs = rng.integers(0, 5000 - L, n_reads)
    reads = np.zeros((n_reads, L), np.uint8)
    refmat = np.array([np.frombuffer(r, np.uint8) for r in refs])
    reads = refmat[srcs[:, None],
                   offs[:, None] + np.arange(L)[None, :]]
    CH = 131072
    npad = ((n_reads + CH - 1) // CH) * CH
    if npad != n_reads:
        reads = np.vstack([reads, reads[:npad - n_reads]])
    res = {}
    for mode, env in (("device", "1"), ("host", "0")):
        os.environ["BBMAP_DEVICE_KMERS"] = env
        seal = Seal(refs, names, k=31, ambig="first")

        def mk(a):
            return ReadBatch(
                bases=reads[a:a + CH], quality=None,
                lengths=np.full(CH, L, np.int32),
                ids=[str(i) for i in range(CH)],
                numeric_ids=np.arange(a, a + CH, dtype=np.int64))

        seal.assign_batch(mk(0))                # warm/compile
        t0 = time.time()
        nm = 0
        for a in range(0, npad, CH):
            asg = seal.assign_batch(mk(a))
            nm += int((asg.primary >= 0).sum())
        dt = time.time() - t0
        res[mode] = npad / dt
        note(f"seal {mode}: {res[mode]:.0f} reads/s ({nm} matched)")
    os.environ.pop("BBMAP_DEVICE_KMERS", None)
    print(json.dumps({
        "metric": "seal_attribution_reads_per_sec",
        "value": round(res["device"], 1), "unit": "reads/s",
        "host_value": round(res["host"], 1),
        "device_speedup": round(res["device"] / res["host"], 2),
        "reads": n_reads, "nrefs": nrefs}), flush=True)


def main():
    from bbmap_tpu.utils.jaxcfg import enable_compilation_cache
    enable_compilation_cache()
    n = int(os.environ.get("TOOLBENCH_READS", 1_000_000))
    which = os.environ.get("TOOLBENCH_ONLY", "").split(",") \
        if os.environ.get("TOOLBENCH_ONLY") else None
    if which is None or "bbduk" in which:
        bench_bbduk(n_reads=n)
    if which is None or "bbmerge" in which:
        bench_bbmerge(n_pairs=max(1, n // 2))
    if which is None or "seal" in which:
        bench_seal(n_reads=max(1, n // 2))
    if which is None or "mappacbio" in which:
        bench_mappacbio(
            n_reads=int(os.environ.get("TOOLBENCH_PB_READS", 1200)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
