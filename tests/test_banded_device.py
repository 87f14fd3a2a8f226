"""Device banded edit-distance parity vs the numpy band sweep
(the device BandedAligner)."""

import numpy as np
import pytest

from bbmap_tpu.ops import banded_device as bd
from bbmap_tpu.ops.banded import banded_edit_distance


def _rand_pairs(rng, n, E):
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for i in range(n):
        la = int(rng.integers(10, 120))
        a = rng.choice(bases, size=la).astype(np.uint8)
        kind = i % 4
        if kind == 0:                       # unrelated
            b = rng.choice(bases,
                           size=int(rng.integers(10, 120))).astype(
                               np.uint8)
        else:                               # mutated copy
            b = a.copy()
            for _ in range(int(rng.integers(0, 2 * E + 2))):
                op = int(rng.integers(0, 3))
                p = int(rng.integers(0, max(1, len(b))))
                if op == 0 and len(b):
                    b[p] = bases[int(rng.integers(0, 4))]
                elif op == 1:
                    b = np.insert(b, p, bases[int(rng.integers(0, 4))])
                elif len(b) > 1:
                    b = np.delete(b, p)
        pairs.append((a, b))
    return pairs


@pytest.mark.parametrize("E", [1, 3, 8])
def test_banded_batch_parity(E):
    rng = np.random.default_rng(100 + E)
    pairs = _rand_pairs(rng, 64, E)
    W = -(-max(max(len(a), len(b)) for a, b in pairs) // 64) * 64
    a = bd._pad_rows([p[0] for p in pairs], W)
    b = bd._pad_rows([p[1] for p in pairs], W)
    la = np.array([len(p[0]) for p in pairs], np.int32)
    lb = np.array([len(p[1]) for p in pairs], np.int32)
    got = bd.banded_edit_batch(a, la, b, lb, E)
    want = np.array(
        [min(banded_edit_distance(p[0], p[1], E), E + 1)
         for p in pairs], np.int32)
    np.testing.assert_array_equal(np.minimum(got, E + 1), want)


def test_vs_true_edit_distance_small():
    """The device band sweep equals the numpy band sweep cell for cell,
    and never underestimates the true edit distance (the band may
    overestimate — it drops column-0 re-entry paths, exactly like the
    reference BandedAligner)."""
    def edlib(a, b):
        la, lb = len(a), len(b)
        D = np.zeros((la + 1, lb + 1), np.int32)
        D[:, 0] = np.arange(la + 1)
        D[0, :] = np.arange(lb + 1)
        for i in range(1, la + 1):
            for j in range(1, lb + 1):
                D[i, j] = min(D[i - 1, j - 1] + (a[i - 1] != b[j - 1]),
                              D[i - 1, j] + 1, D[i, j - 1] + 1)
        return int(D[la, lb])

    rng = np.random.default_rng(5)
    E = 6
    pairs = _rand_pairs(rng, 32, 2)
    W = 128
    a = bd._pad_rows([p[0] for p in pairs], W)
    b = bd._pad_rows([p[1] for p in pairs], W)
    la = np.array([len(p[0]) for p in pairs], np.int32)
    lb = np.array([len(p[1]) for p in pairs], np.int32)
    got = bd.banded_edit_batch(a, la, b, lb, E)
    for t, (x, y) in enumerate(pairs):
        true = edlib(x, y)
        band = min(banded_edit_distance(x, y, E), E + 1)
        assert got[t] == band, (t, got[t], band)
        assert got[t] >= min(true, E + 1), (t, got[t], true)


def test_edit_distances_vs_one(monkeypatch):
    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", np.uint8)
    q = rng.choice(bases, size=80).astype(np.uint8)
    others = []
    for _ in range(10):
        o = q.copy()
        for _ in range(int(rng.integers(0, 4))):
            o[int(rng.integers(0, 80))] = bases[int(rng.integers(0, 4))]
        others.append(o)
    monkeypatch.setenv("BBMAP_DEVICE_BANDED", "1")
    got = bd.edit_distances_vs_one(q, others, 3)
    want = [min(banded_edit_distance(q, o, 3), 4) for o in others]
    np.testing.assert_array_equal(np.minimum(got, 4), want)
