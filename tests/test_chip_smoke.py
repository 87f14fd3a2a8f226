"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself
requires a GPU; on the CPU main() must fail and print no result)."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    return work, cs.prepare_inputs(work, n_pairs=256, n_head=64,
                                   genome_len=120_000)


def test_main_fails_without_gpu(monkeypatch, capsys):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       os.path.join(REPO, ".jax_cache"))
    assert cs.main([]) == 1
    out, err = capsys.readouterr()
    assert "no GPU found" in err
    assert not any(ln.startswith("{") for ln in out.splitlines())


def test_identity_reports_device():
    dev = cs.identity(require_gpu=False)
    assert dev == {"platform": "cpu", "kind": dev["kind"],
                   "count": dev["count"]}
    assert dev["count"] >= 1
    with pytest.raises(cs.SmokeFailure, match="no GPU found"):
        cs.identity()


def test_dp_jobs_match_oracle():
    jobs = cs.dp_job_sets(n=6, n_pb=1, pb_rows=120)
    with ThreadPoolExecutor(4) as pool:
        futs = cs.start_oracle(pool, jobs)
        assert cs.phase_dp(futs, jobs, 0) == {}
    reads, refs = jobs["narrow"][:2]
    assert reads.shape == (6, cs.L) and refs.shape == (6, cs.CN)
    assert jobs["wide"][1].shape == (6, cs.CW)
    assert (reads == ord("N")).any() and (refs == ord("N")).any()


def test_dp_mismatch_is_reported():
    jobs = {"narrow": cs.dp_job_sets(n=2, n_pb=1, pb_rows=120)["narrow"]}

    class Wrong:
        def result(self):
            return (0, 0, 0, b"")

    with pytest.raises(cs.SmokeFailure, match="differ from the oracle"):
        cs.phase_dp({"narrow": [Wrong(), Wrong()]}, jobs, 0)


def test_gathers_exact():
    t = cs.phase_gathers(64, 128, n_cols=2)
    assert set(t) == {"take_along_flat", "take_along_axis"}


def test_grade_sam():
    t1 = np.array([100, 500])
    t2 = np.array([300, 900])
    recs = [b"0\t99\tc\t101\t60", b"0\t147\tc\t301\t60",
            b"1\t65\tc\t560\t60", b"1\t133\tc\t1\t0",
            b"1\t401\tc\t5\t0"]
    st = cs.grade_sam(recs, t1, t2)
    assert st == {"mapped_fraction": 0.75, "sensitivity": 0.5,
                  "pair_rate": 0.5}


def test_compile_phase(inputs):
    work, inp = inputs
    st = cs.phase_compile(inp["ref"], 64)
    assert st["compile_s"] > 0


def test_e2e_phase_gpu_run_matches_cpu_subprocess(inputs):
    work, inp = inputs
    proc = cs.start_cpu_map(inp, os.path.join(work, "cpu.sam"), 64)
    st = cs.phase_e2e(inp, proc, work, 128, min_frac=0.9)
    assert st["mapped_fraction"] >= 0.9


def test_tools_phase(tmp_path):
    cs.phase_tools(str(tmp_path), 600)


def test_mesh_phase():
    cs.phase_mesh(4)
