"""Exactness tests for the gather primitives in align/quickmap_device:
the candidate stage's row take (take_along_flat), the flattened
take_flat layout, and the row-gather word extraction. These tests sweep
the FULL int32 range (large genome coordinates and sentinels).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bbmap_tpu.align import quickmap_device as qd


def test_take_along_flat_full_int32_range():
    rng = np.random.default_rng(1)
    B, n, K = 512, 128, 8
    vals = [rng.integers(-2 ** 31, 2 ** 31 - 1, (B, n),
                         dtype=np.int64).astype(np.int32)
            for _ in range(3)]
    # sentinel values used by the candidate stage
    vals[0][0, :] = 2 ** 30
    vals[0][1, :] = -(2 ** 30)
    vals[1][2, :] = -1
    idx = rng.integers(0, n, (B, K)).astype(np.int32)

    outs = jax.jit(lambda a, b, c, i: [qd.take_along_flat(x, i)
                                       for x in (a, b, c)])(
        *[jnp.asarray(v) for v in vals], jnp.asarray(idx))
    for v, o in zip(vals, outs):
        np.testing.assert_array_equal(np.asarray(o),
                                      np.take_along_axis(v, idx, axis=1))


@pytest.mark.parametrize("shape", [(256, 2, 18), (256, 36), (512, 64),
                                   (64, 3, 7)])
def test_take_flat_layouts(shape):
    rng = np.random.default_rng(2)
    table = rng.integers(-2 ** 31, 2 ** 31 - 1, 100_000,
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, len(table), shape).astype(np.int32)
    out = jax.jit(lambda t, i: qd.take_flat(t, i))(
        jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(out), table[idx])


def test_gather_words_vs_direct():
    """_gather_words returns in-range words exactly; out-of-range word
    values are unspecified (callers mask them via oob)."""
    rng = np.random.default_rng(3)
    N = 1337
    table = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    NW = 11
    w0 = np.concatenate([np.arange(-40, 40), np.arange(N - 40, N + 10),
                         rng.integers(0, N - NW, 300)]).astype(np.int32)
    out = np.asarray(jax.jit(
        lambda t, w: qd._gather_words(t, w, NW))(jnp.asarray(table),
                                                 jnp.asarray(w0)))
    for r, w in enumerate(w0):
        for j in range(NW):
            src = w + j
            if 0 <= src < N:
                assert out[r, j] == table[src], (r, w, j)


def test_extract_ref_codes_matches_unpacked_genome():
    """End-to-end: codes+mask against a genome with N pads, every window
    position, including negative and past-the-end bases."""
    rng = np.random.default_rng(4)
    G = 4000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    codes[:500] = 4
    codes[-500:] = 4
    codes[1777] = 4            # interior N
    gpack, nmask = qd.pack_genome_2bit(codes)
    L = 150
    base = np.concatenate([np.arange(-200, 200),
                           np.arange(G - 200, G + 60),
                           rng.integers(-100, G, 200)]).astype(np.int32)
    c, isn = jax.jit(lambda b: qd.extract_ref_codes(
        jnp.asarray(gpack), jnp.asarray(nmask), b, L, G))(
            jnp.asarray(base))
    c, isn = np.asarray(c), np.asarray(isn)
    for r, b0 in enumerate(base):
        pos = b0 + np.arange(L)
        inr = (pos >= 0) & (pos < G)
        exp_n = ~inr | (inr & (codes[np.clip(pos, 0, G - 1)] > 3))
        np.testing.assert_array_equal(isn[r], exp_n, err_msg=str(b0))
        vis = ~exp_n
        np.testing.assert_array_equal(
            c[r][vis], codes[pos[vis]], err_msg=str(b0))
