"""Wire-format invariants: 4-bit sequence packing and the batched
cigar RLE must be transparent re-encodings."""

import numpy as np
import jax.numpy as jnp
import pytest

from bwamem_tpu.ops.ksw import (ksw_extend2_batched, ksw_global2_batched,
                                cigar_from_traceback,
                                cigars_from_tracebacks)
from bwamem_tpu.ops.engine import _pack4


def _mat():
    m = np.zeros(25, np.int32)
    for i in range(4):
        for j in range(4):
            m[i * 5 + j] = 1 if i == j else -4
    for k in range(5):
        m[k * 5 + 4] = -1
        m[4 * 5 + k] = -1
    return m


def _case(seed, B=8, LQ=32, LT=64):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 5, size=(B, LQ)).astype(np.int8)
    t = rng.integers(0, 5, size=(B, LT)).astype(np.int8)
    qlen = rng.integers(1, LQ + 1, size=B).astype(np.int32)
    tlen = rng.integers(1, LT + 1, size=B).astype(np.int32)
    w = rng.integers(1, 50, size=B).astype(np.int32)
    return q, t, qlen, tlen, w


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_packed_wire(seed):
    q, t, qlen, tlen, w = _case(seed)
    mat = _mat()
    eb = np.zeros(len(qlen), np.int32)
    h0 = np.full(len(qlen), 20, np.int32)
    a = ksw_extend2_batched(jnp.asarray(q), jnp.asarray(t),
                            jnp.asarray(qlen), jnp.asarray(tlen),
                            jnp.asarray(mat), 6, 1, 6, 1,
                            jnp.asarray(w), jnp.asarray(eb), 100,
                            jnp.asarray(h0), LQ=32, LT=64)
    b = ksw_extend2_batched(jnp.asarray(_pack4(q)),
                            jnp.asarray(_pack4(t)),
                            jnp.asarray(qlen), jnp.asarray(tlen),
                            jnp.asarray(mat), 6, 1, 6, 1,
                            jnp.asarray(w), jnp.asarray(eb), 100,
                            jnp.asarray(h0), LQ=32, LT=64, packed=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed", [0])
def test_global_packed_wire(seed):
    q, t, qlen, tlen, w = _case(seed)
    mat = _mat()
    a = ksw_global2_batched(jnp.asarray(q), jnp.asarray(t),
                            jnp.asarray(qlen), jnp.asarray(tlen),
                            jnp.asarray(mat), 6, 1, 6, 1,
                            jnp.asarray(w), LQ=32, LT=64)
    b = ksw_global2_batched(jnp.asarray(_pack4(q)),
                            jnp.asarray(_pack4(t)),
                            jnp.asarray(qlen), jnp.asarray(tlen),
                            jnp.asarray(mat), 6, 1, 6, 1,
                            jnp.asarray(w), LQ=32, LT=64, packed=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_batched_cigar_rle():
    rng = np.random.default_rng(3)
    B, M = 64, 40
    ops = rng.integers(0, 3, size=(B, M)).astype(np.uint8)
    n = rng.integers(0, M + 1, size=B)
    ri = rng.integers(-1, 4, size=B)
    rk = rng.integers(-1, 4, size=B)
    batch = cigars_from_tracebacks(ops, n, ri, rk, range(B))
    for i in range(B):
        assert batch[i] == cigar_from_traceback(
            ops[i], int(n[i]), int(ri[i]), int(rk[i]))
    # all-empty lanes (multi-sentinel runs)
    n[:] = 0
    ri[:] = -1
    rk[:] = -1
    assert all(c == [] for c in
               cigars_from_tracebacks(ops, n, ri, rk, range(B)))
