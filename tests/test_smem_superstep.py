"""The XLA SMEM twin (ops.smem: smem1_batched, smem_superstep,
smem_superstep_sa) against the host oracle, across the edge cases the
device must agree on: ambiguous bases, mid-read starts, min_intv > 1,
inactive lanes, short reads, int32 and int64 coordinates, every read
length bucket, the compact wire and the fused SA dispatch."""

import numpy as np
import pytest

import jax.numpy as jnp

from tests.smem_cases import small_genome, lane_batch, superstep_args


@pytest.fixture(scope="module")
def genome():
    return small_genome()


@pytest.fixture
def dev_index(genome, monkeypatch, request):
    """DeviceFmIndex of the small genome in the requested coordinate
    dtype ("i32" natural, "i64" forced — the >1 Gbp dtype)."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    if getattr(request, "param", "i32") == "i64":
        monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    return DeviceFmIndex.from_host(genome[1])


def _host_stream(fm, q, split_len, split_width):
    from bwamem_tpu.oracle.smem import SmemIterator
    itr = SmemIterator(fm, q)
    out = []
    while True:
        a = itr.next(split_len, split_width, 1)
        if a is None:
            return out
        out.extend(tuple(int(v) for v in p) for p in a)


@pytest.mark.parametrize("dev_index", ["i32", "i64"], indirect=True)
@pytest.mark.parametrize("amb,mid,widths", [
    (False, False, False),
    (True, False, False),
    (False, True, True),
    (True, True, True),
])
def test_smem1_xla_matches_host(genome, dev_index, amb, mid, widths):
    """One smem1 pass per lane: next start, SMEM list and overflow."""
    from bwamem_tpu.ops.smem import smem1_batched
    from bwamem_tpu.oracle.smem import smem1
    fwd, fm = genome
    d = dev_index
    rng = np.random.default_rng(hash((amb, mid, widths)) % 2 ** 31)
    B, L, M = 64, 128, 16
    q, qlen, act = lane_batch(fwd, B, L, rng, amb=amb)
    x = (rng.integers(0, qlen) if mid else np.zeros(B)).astype(np.int32)
    mi = (rng.integers(1, 12, B) if widths else np.ones(B)).astype(
        np.int64)
    ret, n_mem, m0, m1, ms, mqb, mqe, over = map(np.asarray, smem1_batched(
        d.blocks, d.primary, d.L2, jnp.asarray(q.astype(np.int32)),
        jnp.asarray(qlen), jnp.asarray(x), jnp.asarray(mi),
        jnp.asarray(act), L=L, M=M))
    assert m0.dtype == d.cdt
    for i in range(B - 1):
        if over[i]:
            continue
        qq = q[i, :qlen[i]]
        if qq[x[i]] > 3:
            assert n_mem[i] == 0
            continue
        w_ret, want = smem1(fm, qq, int(x[i]), int(mi[i]))
        assert int(ret[i]) == w_ret, i
        got = [(int(m0[i, j]), int(m1[i, j]), int(ms[i, j]),
                (int(mqb[i, j]) << 32) | int(mqe[i, j]))
               for j in range(n_mem[i])]
        assert got == [tuple(int(v) for v in p) for p in want], i
    assert n_mem[B - 1] == 0  # inactive lane


def test_smem1_xla_small_buffer_flags_overflow(genome):
    """M=2 interval buffers: a lane either flags overflow or is exact."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.ops.smem import smem1_batched
    from bwamem_tpu.oracle.smem import smem1
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(5)
    B, L, M = 64, 128, 2
    q, qlen, act = lane_batch(fwd, B, L, rng, amb=True, repeats=True)
    ret, n_mem, m0, m1, ms, mqb, mqe, over = map(np.asarray, smem1_batched(
        d.blocks, d.primary, d.L2, jnp.asarray(q.astype(np.int32)),
        jnp.asarray(qlen), jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.int64),
        jnp.asarray(act), L=L, M=M))
    assert over.any()
    for i in range(B - 1):
        if over[i] or n_mem[i] > M or q[i, 0] > 3:
            continue
        _, want = smem1(fm, q[i, :qlen[i]], 0, 1)
        assert int(n_mem[i]) == len(want), i


@pytest.mark.parametrize("dev_index", ["i32", "i64"], indirect=True)
@pytest.mark.parametrize("L", [64, 128, 256, 512])
def test_superstep_xla_matches_host_iterator(genome, dev_index, L):
    """Whole-iterator streams per lane (dense wire) == the host
    SmemIterator, in every read-length bucket; at L=512 the merge key
    is radix 1024 and qb/qe travel as int32."""
    from bwamem_tpu.ops.smem import smem_superstep
    fwd, fm = genome
    d = dev_index
    rng = np.random.default_rng(L)
    B, M, OC = 32, 16, 48 if L <= 256 else 64
    q, qlen, act = lane_batch(fwd, B, L, rng, amb=True,
                              min_len=max(21, L // 2))
    out = smem_superstep(*superstep_args(d, q, qlen, act), L=L, M=M,
                         OUT_CAP=OC, NEED_X1=True, IMPL="xla")
    o0, o1, os_, oqb, oqe, n, over = map(np.asarray, out)
    assert oqb.dtype == (np.uint8 if L <= 256 else np.int32)
    n_clean = 0
    for i in range(B - 1):
        if over[i]:
            continue
        qe = [int(v) or 256 if L == 256 else int(v) for v in oqe[i]]
        got = [(int(o0[i, j]), int(o1[i, j]), int(os_[i, j]),
                (int(oqb[i, j]) << 32) | qe[j]) for j in range(n[i])]
        assert got == _host_stream(fm, q[i, :qlen[i]], 29, 10), i
        n_clean += 1
    assert n_clean > B // 2


def test_superstep_gcap_compaction(genome):
    """GCAP compact wire == dense wire streams; lanes spilling past a
    tiny GCAP must flag overflow with zeroed counts."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.ops.smem import smem_superstep
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(41)
    B, L, M = 64, 64, 16
    q, qlen, act = lane_batch(fwd, B, L, rng)
    args = superstep_args(d, q, qlen, act)
    kw = dict(L=L, M=M, OUT_CAP=48, IMPL="xla")
    o0, o1, os_, oqb, oqe, n, over = smem_superstep(*args, NEED_X1=True,
                                                    **kw)
    n_np = np.where(np.asarray(over), 0, np.asarray(n, np.int64))
    mask = np.arange(48)[None, :] < n_np[:, None]
    want = [np.asarray(a)[mask] for a in (o0, o1, os_, oqb, oqe)]

    c0, c1, cs, cqb, cqe, cn, cover = smem_superstep(
        *args, NEED_X1=True, GCAP=B * 12, **kw)
    assert np.array_equal(np.asarray(cover), np.asarray(over))
    np.testing.assert_array_equal(np.asarray(cn), n_np)
    tot = int(n_np.sum())
    for name, w, c in zip("01sbe", want, (c0, c1, cs, cqb, cqe)):
        np.testing.assert_array_equal(
            np.asarray(c, np.int64)[:tot], w.astype(np.int64),
            err_msg=f"compact stream {name} diverged")

    # tiny GCAP: later lanes spill -> flagged over, counts zeroed, and
    # the surviving prefix still matches the dense streams
    g = max(8, tot // 3)
    s0, s1, ss, sqb, sqe, sn, sov = smem_superstep(
        *args, NEED_X1=True, GCAP=g, **kw)
    sov, sn = np.asarray(sov), np.asarray(sn, np.int64)
    assert sov.sum() > np.asarray(over).sum()
    assert (sn[sov] == 0).all()
    keep = int(sn.sum())
    assert keep <= g
    want0 = np.asarray(o0)[np.arange(48)[None, :]
                           < np.where(~sov, n_np, 0)[:, None]]
    np.testing.assert_array_equal(np.asarray(s0, np.int64)[:keep],
                                  want0.astype(np.int64))


def _queries(fwd, rng, n, lo, hi, repeats=False):
    out = []
    for i in range(n):
        ln = int(rng.integers(lo, hi))
        off = int(rng.integers(0, len(fwd) - ln))
        qq = fwd[off:off + ln].copy()
        if repeats and i % 5 == 0:
            qq = np.tile(fwd[off:off + 8], 16)[:ln].copy()
        elif rng.random() < 0.4:
            qq[int(rng.integers(0, ln))] = int(rng.integers(0, 4))
        out.append(qq)
    return out


def test_fused_sa_matches_split(genome, monkeypatch):
    """interval_arrays + seeds_from_arrays with the fused superstep+SA
    dispatch must produce exactly the split path's seeds."""
    import bwamem_tpu.ops.seeding as sd
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.config import MemOptions
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    opt = MemOptions()
    queries = _queries(fwd, np.random.default_rng(53), 60, 40, 101)

    def run(fuse):
        monkeypatch.setattr(sd, "FUSE_SA", fuse)
        s = sd.BatchedSeeder(d, max_len=128, sa_max_steps=1024,
                             fm_host=fm)
        iv = s.interval_arrays(opt, queries)
        return iv, s.seeds_from_arrays(fm, iv, opt)

    iv_a, seeds_a = run(False)
    iv_b, seeds_b = run(True)
    for x, y in zip(iv_a, iv_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for name, x, y in zip(["rid", "rbeg", "qb", "len"], seeds_a,
                          seeds_b):
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y),
            err_msg=f"fused-SA seeds field {name} diverged")
    assert len(seeds_b[0]) > 0


def test_fused_sa_salvage_with_overflow(genome, monkeypatch):
    """Buffer-overflow lanes splice in oracle streams; the fused-SA
    prefetch must survive for the CLEAN lanes (dev_mark salvage) and
    still produce exactly the split path's seeds."""
    import bwamem_tpu.ops.seeding as sd
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.config import MemOptions
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    opt = MemOptions()
    queries = _queries(fwd, np.random.default_rng(71), 48, 60, 101,
                       repeats=True)

    def run(fuse):
        monkeypatch.setattr(sd, "FUSE_SA", fuse)
        s = sd.BatchedSeeder(d, max_len=128, sa_max_steps=1024,
                             fm_host=fm)
        s.M = 4  # force interval-buffer overflow on the repetitive reads
        n_oracle = [0]
        orig = s._oracle_finish

        def of(*a, **k):
            n_oracle[0] += 1
            return orig(*a, **k)
        s._oracle_finish = of
        iv = s.interval_arrays(opt, queries)
        pre = s._sa_prefetch
        seeds = s.seeds_from_arrays(fm, iv, opt)
        return iv, seeds, n_oracle[0], pre

    iv_a, seeds_a, n_ora_a, _ = run(False)
    iv_b, seeds_b, n_ora_b, pre_b = run(True)
    assert n_ora_b > 0, "no overflow lanes: the salvage path never ran"
    assert pre_b is not None, "prefetch was dropped despite salvage"
    assert not pre_b[3].all(), "expected oracle-spliced intervals"
    for x, y in zip(iv_a, iv_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for name, x, y in zip(["rid", "rbeg", "qb", "len"], seeds_a,
                          seeds_b):
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y),
            err_msg=f"salvaged fused-SA seeds field {name} diverged")


@pytest.mark.parametrize("dev_index", ["i32", "i64"], indirect=True)
def test_sa_lookup_xla_overflow_lanes(genome, dev_index):
    """The inverse-Psi walk: exact values under a generous step cap,
    and a 3-step cap flags exactly the lanes whose walk is longer."""
    from bwamem_tpu.ops.fm import sa_lookup_batched
    fwd, fm = genome
    d = dev_index
    rng = np.random.default_rng(23)
    ks = rng.integers(0, int(fm.seq_len), 256).astype(np.int64)
    ks[0] = int(np.asarray(d.primary))
    ks[1] = 0
    kj = jnp.asarray(ks.astype(np.asarray(d.L2).dtype))
    v, o = map(np.asarray, sa_lookup_batched(
        d.blocks, d.primary, d.L2, d.seq_len, d.sa, d.sa_intv, kj,
        max_steps=1024))
    assert not o.any()
    np.testing.assert_array_equal(
        v.astype(np.int64), [fm.sa_lookup(int(k)) for k in ks])
    v3, o3 = map(np.asarray, sa_lookup_batched(
        d.blocks, d.primary, d.L2, d.seq_len, d.sa, d.sa_intv, kj,
        max_steps=3))
    assert o3.any() and not o3.all()
    np.testing.assert_array_equal(v3[~o3], v[~o3])
