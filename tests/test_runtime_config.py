"""Process-level runtime choices: where compiled programs persist, which
card each hosts= process opens, and that the fused route needs no
Pallas."""

import os
import subprocess
import sys

import jax
import pytest

from bbmap_tpu.parallel import multihost
from bbmap_tpu.utils import jaxcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcfg.compilation_cache_dir() == os.path.join(REPO,
                                                          ".jax_cache")
    path = jaxcfg.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_cache_dir_env_wins_and_nothing_else_is_set(
        monkeypatch, tmp_path, restore_cache_dir):
    target = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    assert jaxcfg.enable_compilation_cache() == target
    # JAX reads the variable itself; the code sets no other directory
    assert jax.config.jax_compilation_cache_dir == "/untouched"
    assert not os.path.exists(target)


def test_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("pid,cards,want", [
    (0, 4, 0), (3, 4, 3), (5, 4, 1), (2, 1, 0), (7, 0, None)])
def test_card_for(pid, cards, want):
    assert multihost.card_for(pid, cards) == want


def test_pin_card_sets_visible_device(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(multihost, "local_card_count", lambda: 4)
    before = jax.config.values["jax_cuda_visible_devices"]
    try:
        assert multihost.pin_card(6) == 2
        assert jax.config.values["jax_cuda_visible_devices"] == "2"
    finally:
        jax.config.update("jax_cuda_visible_devices", before)


def test_pin_card_noop_on_cpu_or_without_cards(monkeypatch):
    before = jax.config.values["jax_cuda_visible_devices"]
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(multihost, "local_card_count", lambda: 4)
    assert multihost.pin_card(1) is None
    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.setattr(multihost, "local_card_count", lambda: 0)
    assert multihost.pin_card(1) is None
    assert jax.config.values["jax_cuda_visible_devices"] == before


def test_no_module_mentions_pallas():
    pkg = os.path.join(REPO, "bbmap_tpu")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert "pallas" not in fh.read().lower(), f


def test_fused_pair_route_never_imports_pallas():
    """Build and run the fused pair program in a fresh process: no
    Pallas module may be loaded."""
    script = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from bbmap_tpu.align.pipeline import BBMapAligner
from bbmap_tpu.core.batch import ReadBatch
from bbmap_tpu.core.genome import Genome, Scaffold
from bbmap_tpu.index.build import analyze_index, build_index
rng = np.random.default_rng(0)
g0 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 40_000)
g = Genome(chroms=[g0], scaffolds=[Scaffold(chrom=1, sid=1, start=0,
           length=len(g0), name="c")]).finalize()
idx = build_index(g, 11)
analyze_index(idx, 0.01)
al = BBMapAligner(g, idx)
L, n = 60, 16
s = rng.integers(0, len(g0) - 400, n)
r1 = np.stack([g0[a:a + L] for a in s])
from bbmap_tpu.core.bases import COMP_ASCII
r2 = np.stack([COMP_ASCII[g0[a + 200:a + 200 + L]][::-1] for a in s])
mk = lambda r: ReadBatch(bases=np.ascontiguousarray(r), quality=None,
                         lengths=np.full(n, L, np.int32),
                         ids=[str(i) for i in range(n)],
                         numeric_ids=np.arange(n, dtype=np.int64))
out = al.map_pairs_columnar(mk(r1), mk(r2))
assert out is not None and out[0].mapped.sum() == n
bad = [m for m in sys.modules if "pallas" in m]
assert not bad, bad
print("NO_PALLAS")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "NO_PALLAS" in p.stdout
