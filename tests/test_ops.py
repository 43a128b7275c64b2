"""Device-kernel parity tests: every batched op must reproduce the host
oracle exactly (the reference's own HW-vs-SW verification contract,
USE_SW_VERIFY / bwt_temp.c pattern — SURVEY.md §4)."""
import numpy as np
import pytest

import jax.numpy as jnp

from bwamem_tpu.ops import fm as dfm_mod
from bwamem_tpu.ops.smem import smem1_batched
from bwamem_tpu.oracle.smem import smem1


@pytest.fixture(scope="module")
def dfm(ref_index):
    fm, _ = ref_index
    return dfm_mod.DeviceFmIndex.from_host(fm)


@pytest.fixture(scope="module")
def queries(data_dir):
    import os
    from bwamem_tpu.io.fastq import parse_fastx
    from bwamem_tpu.index.bntseq import NT4_TABLE
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))
    qs = [NT4_TABLE[np.frombuffer(r.seq.encode(), dtype=np.uint8)].copy()
          for r in reads[:32]]
    qs[3][10] = 4
    qs[3][50:53] = 4            # interior ambiguous bases
    qs[4] = qs[4][:25].copy()   # short read
    qs[5] = np.full(10, 4, np.uint8)  # all ambiguous
    return qs


def test_occ4_parity(ref_index, dfm):
    fm, _ = ref_index
    rng = np.random.default_rng(0)
    ks = np.concatenate(
        [[-1, 0, fm.seq_len - 1, fm.primary, fm.primary - 1],
         rng.integers(0, fm.seq_len, 200)]).astype(np.int64)
    got = np.asarray(dfm_mod.occ4(dfm.blocks, dfm.primary, jnp.asarray(ks)))
    want = np.stack([fm.occ4(int(k)) for k in ks])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_back", [False, True])
def test_extend_parity(ref_index, dfm, is_back):
    fm, _ = ref_index
    rng = np.random.default_rng(1)
    N = 200
    x0 = rng.integers(1, fm.seq_len, N)
    x1 = rng.integers(1, fm.seq_len, N)
    s = rng.integers(1, 50, N)
    o0, o1, os_ = dfm_mod.extend(dfm.blocks, dfm.primary, dfm.L2,
                                 jnp.asarray(x0), jnp.asarray(x1),
                                 jnp.asarray(s), is_back)
    o0, o1, os_ = map(np.asarray, (o0, o1, os_))
    for n in range(N):
        want = fm.extend((int(x0[n]), int(x1[n]), int(s[n]), 0),
                         int(is_back))
        for c in range(4):
            assert (o0[n, c], o1[n, c], os_[n, c]) == want[c][:3]


def test_sa_lookup_parity(ref_index, dfm):
    fm, _ = ref_index
    rng = np.random.default_rng(2)
    ks = rng.integers(0, fm.seq_len, 400).astype(np.int64)
    vals, over = dfm_mod.sa_lookup_batched(
        dfm.blocks, dfm.primary, dfm.L2, dfm.seq_len, dfm.sa, dfm.sa_intv,
        jnp.asarray(ks))
    vals, over = np.asarray(vals), np.asarray(over)
    want = np.array([fm.sa_lookup(int(k)) for k in ks])
    np.testing.assert_array_equal(vals[~over], want[~over])
    assert over.mean() < 0.1  # the walk cap must cover the vast majority


def _run_smem_batch(dfm, qs, xs, mi, L=128):
    B, M = len(qs), L + 1
    qpad = np.full((B, L), 4, np.int32)
    qlen = np.array([len(q) for q in qs], np.int32)
    for i, q in enumerate(qs):
        qpad[i, :len(q)] = q
    out = smem1_batched(dfm.blocks, dfm.primary, dfm.L2,
                        jnp.asarray(qpad), jnp.asarray(qlen),
                        jnp.asarray(xs.astype(np.int32)),
                        jnp.asarray(mi.astype(np.int64)),
                        jnp.ones(B, bool), L=L, M=M)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("which", ["x0", "x30", "x50_mi5", "xlast"])
def test_smem1_batched_parity(ref_index, dfm, queries, which):
    fm, _ = ref_index
    qs = queries
    qlen = np.array([len(q) for q in qs])
    xs = {"x0": np.zeros(len(qs), int),
          "x30": np.minimum(qlen - 1, 30),
          "x50_mi5": np.minimum(qlen - 1, 50),
          "xlast": qlen - 1}[which]
    mi = np.full(len(qs), 5 if which == "x50_mi5" else 1)
    ret, n_mem, m0, m1, ms, mqb, mqe, over = _run_smem_batch(
        dfm, qs, xs, mi)
    assert not over.any()
    for b, q in enumerate(qs):
        want_ret, want = smem1(fm, q, int(xs[b]), int(mi[b]))
        assert int(ret[b]) == want_ret
        got = [(int(m0[b, j]), int(m1[b, j]), int(ms[b, j]),
                (int(mqb[b, j]) << 32) | int(mqe[b, j]))
               for j in range(int(n_mem[b]))]
        assert got == want


def test_interval_streams_match_host_iterator(ref_index, dfm, queries):
    """The lock-step batched iterator must produce the identical
    interval stream the host SmemIterator produces per read."""
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops.seeding import BatchedSeeder
    from bwamem_tpu.oracle.smem import SmemIterator
    fm, _ = ref_index
    opt = MemOptions()
    seeder = BatchedSeeder(dfm, fm_host=fm)
    streams = seeder.interval_streams(opt, queries)
    for q, got in zip(queries, streams):
        itr = SmemIterator(fm, q)
        split_len = min(int(opt.min_seed_len * opt.split_factor + .499),
                        len(q))
        want = []
        while True:
            a = itr.next(split_len, opt.split_width, 1)
            if a is None:
                break
            want.extend(a)
        assert got == want


def test_sharded_smem_matches_single_device(ref_index, dfm, queries):
    """8-virtual-device reads-mesh sharding must not change results."""
    import jax
    from bwamem_tpu.parallel.mesh import make_mesh, sharded_smem1
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    qs = [q for q in queries if len(q) > 30][:16]
    L, M = 128, 129
    xs = np.zeros(len(qs), int)
    mi = np.ones(len(qs), int)
    ref = _run_smem_batch(dfm, qs, xs, mi)
    mesh = make_mesh(8)
    fn = sharded_smem1(mesh, dfm, L=L, M=M)
    B = len(qs)
    qpad = np.full((B, L), 4, np.int32)
    qlen = np.array([len(q) for q in qs], np.int32)
    for i, q in enumerate(qs):
        qpad[i, :len(q)] = q
    out = fn(jnp.asarray(qpad), jnp.asarray(qlen),
             jnp.asarray(xs.astype(np.int32)),
             jnp.asarray(mi.astype(np.int64)), jnp.ones(B, bool))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    import jax
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_gather_rows_is_the_plain_row_gather(dfm):
    """The occ-row gather is the plain table row gather, for any index
    shape (the one gather the device path uses)."""
    rng = np.random.default_rng(11)
    n_blocks = int(dfm.blocks.shape[0])
    blk = rng.integers(0, n_blocks, (2, 7, 5)).astype(np.int32)
    got = dfm_mod._gather_rows(dfm.blocks, jnp.asarray(blk))
    assert got.shape == (2, 7, 5, 16) and got.dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(dfm.blocks)[blk])


def test_occ4_forced_int64_matches_host(ref_index, monkeypatch):
    """occ4 with int64 coordinates (the >1 Gbp dtype, forced on the
    bundled genome) reads the 64-bit checkpoint words exactly."""
    monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    fm, _ = ref_index
    d64 = dfm_mod.DeviceFmIndex.from_host(fm)
    assert d64.cdt == jnp.int64 and d64.blocks.shape[1] == 16
    rng = np.random.default_rng(7)
    ks = np.concatenate(
        [[-1, 0, fm.seq_len - 1, fm.primary, fm.primary + 1],
         rng.integers(0, fm.seq_len, 61)]).astype(np.int64)
    got = np.asarray(dfm_mod.occ4(d64.blocks, d64.primary,
                                  jnp.asarray(ks)))
    want = np.stack([fm.occ4(int(k)) for k in ks])
    np.testing.assert_array_equal(got, want)


def test_smem_forced_int64_path(ref_index, queries, monkeypatch):
    """The wide-coordinate (int64) kernel path — what mammalian-scale
    genomes use — must match the narrow path and the host oracle."""
    monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    fm, _ = ref_index
    d64 = dfm_mod.DeviceFmIndex.from_host(fm)
    assert d64.cdt == jnp.int64
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops.seeding import BatchedSeeder
    opt = MemOptions()
    seeder = BatchedSeeder(d64, max_len=128, fm_host=fm)
    streams = seeder.interval_streams(opt, queries)
    from bwamem_tpu.oracle.smem import SmemIterator
    for q, got in zip(queries, streams):
        want = []
        if len(q) >= opt.min_seed_len:
            itr = SmemIterator(fm, q)
            sl = min(int(opt.min_seed_len * opt.split_factor + .499),
                     len(q))
            while True:
                a = itr.next(sl, opt.split_width, 1)
                if a is None:
                    break
                want.extend(a)
        assert [tuple(int(v) for v in p) for p in got] == \
            [tuple(int(v) for v in p) for p in want]
