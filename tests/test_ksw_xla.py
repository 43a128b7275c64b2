"""The XLA Smith-Waterman row loops the device runs (banded extension,
global alignment with traceback, local SW waves) against the scalar
host oracles, over several random wave compositions each.  These are
the device kernels of every SW stage."""
import numpy as np
import pytest

import jax.numpy as jnp

from bwamem_tpu.config import MemOptions
from bwamem_tpu.oracle import ksw as oksw
from bwamem_tpu.ops.ksw import (ksw_extend2_batched, ksw_global2_batched,
                                cigar_from_traceback)
from tests.test_ksw_batched import _mutated_pair

OPT = MemOptions()
MAT = np.asarray(OPT.mat, dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extend2_xla_matches_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    LQ, LT, B = 64, 160, 48
    qb = np.full((B, LQ), 4, np.int8)
    tb = np.full((B, LT), 4, np.int8)
    qlen, tlen, wv, ebv, h0v = (np.zeros(B, np.int32) for _ in range(5))
    cases = []
    for i in range(B):
        ql = int(rng.integers(1, LQ + 1))
        tl = int(rng.integers(1, LT + 1))
        q, tgt = _mutated_pair(rng, ql, tl, related=(i % 4 != 3))
        w = int(rng.choice([3, 13, 50, 100]))
        eb, h0 = int(rng.choice([0, 5])), int(rng.integers(1, 90))
        qb[i, :ql], tb[i, :tl] = q, tgt
        qlen[i], tlen[i], wv[i], ebv[i], h0v[i] = ql, tl, w, eb, h0
        cases.append((q, tgt, w, eb, h0))
    out = ksw_extend2_batched(
        jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(qlen),
        jnp.asarray(tlen), jnp.asarray(MAT.astype(np.int32)),
        OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, jnp.asarray(wv),
        jnp.asarray(ebv), OPT.zdrop, jnp.asarray(h0v), LQ=LQ, LT=LT)
    out = [np.asarray(o) for o in out]
    for i, (q, tgt, w, eb, h0) in enumerate(cases):
        want = oksw.ksw_extend2(q, tgt, MAT, OPT.o_del, OPT.e_del,
                                OPT.o_ins, OPT.e_ins, w, eb, OPT.zdrop, h0)
        assert tuple(int(o[i]) for o in out) == tuple(want), i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global2_xla_matches_oracle(seed):
    rng = np.random.default_rng(200 + seed)
    LQ, LT, B = 64, 80, 48
    qb = np.full((B, LQ), 4, np.int8)
    tb = np.full((B, LT), 4, np.int8)
    qlen, tlen, wv = (np.zeros(B, np.int32) for _ in range(3))
    cases = []
    for i in range(B):
        ql = int(rng.integers(1, LQ + 1))
        tl = min(LT, max(1, ql + int(rng.integers(-8, 9))))
        q, tgt = _mutated_pair(rng, ql, tl, related=(i % 5 != 0))
        w = max(int(rng.choice([3, 10, 25])), abs(tl - ql) + 3)
        qb[i, :ql], tb[i, :tl] = q, tgt
        qlen[i], tlen[i], wv[i] = ql, tl, w
        cases.append((q, tgt, w))
    score, ops, n_ops, ri, rk = map(np.asarray, ksw_global2_batched(
        jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(qlen),
        jnp.asarray(tlen), jnp.asarray(MAT.astype(np.int32)),
        OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, jnp.asarray(wv),
        LQ=LQ, LT=LT))
    for i, (q, tgt, w) in enumerate(cases):
        want_sc, want_cig = oksw.ksw_global2(q, tgt, MAT, OPT.o_del,
                                             OPT.e_del, OPT.o_ins,
                                             OPT.e_ins, w)
        assert int(score[i]) == want_sc, i
        assert cigar_from_traceback(ops[i], int(n_ops[i]), int(ri[i]),
                                    int(rk[i])) == want_cig, i


@pytest.mark.parametrize("xbyte", [False, True], ids=["i16", "u8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_align2_wave_matches_oracle(seed, xbyte):
    """Local SW waves (ksw_align2: u8 / i16 passes, second best, start
    positions) against the striped oracle."""
    from bwamem_tpu.ops.ksw_align import align2_wave
    rng = np.random.default_rng(300 + seed)
    reqs = []
    for t in range(24):
        ql = int(rng.integers(10, 90))
        tl = int(rng.integers(20, 300))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        tgt = rng.integers(0, 4, tl).astype(np.uint8)
        if t % 2 == 0 and tl > ql:
            off = int(rng.integers(0, tl - ql))
            tgt[off:off + ql] = q
            nm = rng.integers(0, 5)
            tgt[rng.integers(0, tl, nm)] = rng.integers(0, 4, nm)
        xtra = (oksw.KSW_XSUBO | oksw.KSW_XSTART
                | (oksw.KSW_XBYTE if xbyte else 0)
                | (OPT.min_seed_len * OPT.a))
        reqs.append(("align2", q, tgt, xtra))
    outs = align2_wave(OPT, reqs, 32)
    for i, (_, q, tgt, xtra) in enumerate(reqs):
        want = oksw.ksw_align2(q, tgt, MAT, OPT.o_del, OPT.e_del,
                               OPT.o_ins, OPT.e_ins, xtra)
        got = outs[i]
        assert (got.score, got.te, got.qe, got.score2, got.te2,
                got.tb, got.qb) == (want.score, want.te, want.qe,
                                    want.score2, want.te2, want.tb,
                                    want.qb), i
