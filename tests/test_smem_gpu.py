"""The GPU SMEM superstep kernel (ops.smem_gpu, Pallas through Triton)
against the XLA twin, run through the Pallas interpreter here; plus the
wrapper's shapes, padding and the choice between the two.  The compiled
kernel runs on the card in the `gpu`-marked test and in chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bwamem_tpu.ops import smem_gpu
from bwamem_tpu.ops import smem as smem_mod
from tests.smem_cases import (small_genome, lane_batch, superstep_args,
                              assert_streams_equal, host_streams)


@pytest.fixture(scope="module")
def genome():
    return small_genome()


def _index(fm, i64: bool, monkeypatch):
    from bwamem_tpu.ops.fm import DeviceFmIndex
    if i64:
        monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    return DeviceFmIndex.from_host(fm)


def _both(d, q, qlen, act, L, M, OC, packed, **kw):
    args = superstep_args(d, q, qlen, act, packed=packed, **kw)
    common = dict(L=L, M=M, OUT_CAP=OC, NEED_X1=True, QPACKED=packed)
    ref = smem_mod.smem_superstep(*args, IMPL="xla", **common)
    out = smem_mod.smem_superstep(*args, IMPL="interpret", **common)
    return ref, out


@pytest.mark.parametrize("L,M,i64,packed,amb,repeats", [
    (64, 16, False, False, False, False),
    (64, 16, False, True, True, False),
    (128, 16, False, True, True, True),
    (128, 16, True, True, True, False),
    (64, 8, False, False, True, True),
    (256, 16, False, True, True, False),
    (512, 16, False, False, True, False),
    (64, 16, True, False, False, True),
], ids=["L64", "L64-packed-amb", "L128-repeats", "L128-i64",
        "M8-overflow", "L256", "L512", "L64-i64-repeats"])
def test_kernel_interpret_matches_xla(genome, monkeypatch, L, M, i64,
                                     packed, amb, repeats):
    fwd, fm = genome
    d = _index(fm, i64, monkeypatch)
    rng = np.random.default_rng(L * 7 + M + i64)
    B = 4 * smem_gpu.BLOCK
    OC = 48 if L <= 256 else 64
    q, qlen, act = lane_batch(fwd, B, L, rng, amb=amb, repeats=repeats,
                              min_len=max(21, L // 2))
    ref, out = _both(d, q, qlen, act, L, M, OC, packed)
    n = assert_streams_equal(ref, out, OC)
    assert n > 0
    if M == 8:
        assert np.asarray(ref[6]).any(), "no lane overflowed"
    assert out[0].dtype == d.cdt


def test_kernel_interpret_bundled_reads(ref_index, data_dir):
    """Real 101 bp reads on the bundled genome, where pass-2 sub
    entries interleave with main entries in the merge (a masked-off
    store must never land on a live entry's column)."""
    import os
    from bwamem_tpu.io.fastq import ChunkReader
    from bwamem_tpu.core.pipeline import encode_read
    from bwamem_tpu.ops.fm import DeviceFmIndex
    fm, _ = ref_index
    d = DeviceFmIndex.from_host(fm)
    reads = ChunkReader(os.path.join(data_dir, "reads_se.fq")) \
        .read_chunk(1 << 30)[:8 * smem_gpu.BLOCK]
    B, L = len(reads), 128
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        encode_read(r)
        q[i, :len(r.seq_nt4)] = r.seq_nt4
        qlen[i] = len(r.seq_nt4)
    act = np.ones(B, bool)
    ref, out = _both(d, q, qlen, act, L, 16, 48, True, split_len=28)
    assert assert_streams_equal(ref, out, 48) > B


@pytest.mark.parametrize("split_len,split_width", [(0, 10), (20, 500)],
                         ids=["no-reseed", "wide-reseed"])
def test_kernel_interpret_reseed_params(genome, split_len, split_width):
    """Re-seeding off, and re-seeding on wide intervals (many pass-2
    lanes), agree with the twin."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(split_len + split_width)
    B, L = 4 * smem_gpu.BLOCK, 128
    q, qlen, act = lane_batch(fwd, B, L, rng, amb=True, repeats=True)
    ref, out = _both(d, q, qlen, act, L, 16, 48, True,
                     split_len=split_len, split_width=split_width)
    assert assert_streams_equal(ref, out, 48) > 0


def test_kernel_interpret_lane_blocks_in_order(genome):
    """Several programs: every lane's stream lands in its own row."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(3)
    B, L = 3 * smem_gpu.BLOCK, 64
    q, qlen, act = lane_batch(fwd, B, L, rng)
    act[: smem_gpu.BLOCK] = False   # a whole idle program
    ref, out = _both(d, q, qlen, act, L, 16, 48, False)
    assert assert_streams_equal(ref, out, 48) > 0
    assert (np.asarray(out[5])[: smem_gpu.BLOCK] == 0).all()


@pytest.mark.parametrize("n_lanes,L,M,ok", [
    (512, 128, 16, True),
    (64, 512, 16, True),
    (0, 128, 16, False),
    (smem_gpu.BLOCK + 1, 128, 16, False),
    (512, 100, 16, False),
    (512, 128, 12, False),
])
def test_kernel_shapes_ok(n_lanes, L, M, ok):
    assert smem_gpu.shapes_ok(n_lanes, L, M) is ok


@pytest.mark.parametrize("backend,n_lanes,sharded,want", [
    ("cpu", 512, False, "xla"),
    ("gpu", 512, False, "gpu"),
    ("gpu", smem_gpu.BLOCK + 1, False, "xla"),
    ("gpu", 512, True, "xla"),
])
def test_superstep_impl_selection(monkeypatch, backend, n_lanes, sharded,
                                  want):
    """The kernel is chosen on the GPU backend when its shapes fit and
    the tables are not mesh-sharded; the XLA twin otherwise."""
    from bwamem_tpu.ops import fm
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if sharded:
        with fm.table_axis("reads"):
            assert smem_mod.superstep_impl(n_lanes, 128, 16) == want
    else:
        assert smem_mod.superstep_impl(n_lanes, 128, 16) == want


def test_kernel_output_shapes_and_padding(genome):
    """Dense outputs come back cut to OUT_CAP from the kernel's
    power-of-two buffer (one spare column past OUT_CAP); counts int32,
    overflow bool."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    B, L = smem_gpu.BLOCK, 64
    q, qlen, act = lane_batch(fwd, B, L, np.random.default_rng(9))
    args = superstep_args(d, q, qlen, act)
    o0, o1, os_, oqb, oqe, n, over = smem_gpu.superstep(
        *args, L=L, M=16, OUT_CAP=48, interpret=True)
    assert smem_gpu._pow2_at_least(48 + 1) == 64
    for a in (o0, o1, os_):
        assert a.shape == (B, 48) and a.dtype == d.cdt
    for a in (oqb, oqe):
        assert a.shape == (B, 48) and a.dtype == jnp.int32
    assert n.shape == (B,) and n.dtype == jnp.int32
    assert over.shape == (B,) and over.dtype == jnp.bool_
    assert int(np.asarray(n)[-1]) == 0  # inactive lane
    with pytest.raises(AssertionError):
        smem_gpu.superstep(*superstep_args(d, q[:3], qlen[:3], act[:3]),
                           L=L, M=16, OUT_CAP=48, interpret=True)


def test_seeder_interpret_streams_match_host(genome):
    """BatchedSeeder with the kernel (compact wire, packed queries,
    oracle re-runs of overflow lanes) == the host SmemIterator."""
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.ops.seeding import BatchedSeeder
    fwd, fm = genome
    opt = MemOptions()
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(19)
    queries = []
    for i in range(40):
        ln = int(rng.integers(30, 128))
        off = int(rng.integers(0, len(fwd) - ln))
        qq = fwd[off:off + ln].copy()
        if i % 3 == 0:
            qq[int(rng.integers(0, ln))] = 4
        queries.append(qq)
    s = BatchedSeeder(d, max_len=128, fm_host=fm, smem_impl="interpret")
    got = [[tuple(int(v) for v in p) for p in st]
           for st in s.interval_streams(opt, queries, need_x1=True)]
    assert got == host_streams(fm, queries, opt)


def test_seeder_interpret_fused_seeds_match_xla(genome):
    """The fused superstep+SA dispatch with the kernel gives the twin's
    seeds exactly."""
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.ops.seeding import BatchedSeeder
    fwd, fm = genome
    opt = MemOptions()
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(29)
    queries = []
    for i in range(50):
        ln = int(rng.integers(40, 101))
        off = int(rng.integers(0, len(fwd) - ln))
        queries.append(fwd[off:off + ln].copy())

    def seeds(impl):
        s = BatchedSeeder(d, max_len=128, sa_max_steps=1024, fm_host=fm,
                          smem_impl=impl)
        iv = s.interval_arrays(opt, queries)
        return iv, s.seeds_from_arrays(fm, iv, opt)

    iv_x, s_x = seeds("xla")
    iv_k, s_k = seeds("interpret")
    for a, b in zip(iv_x + s_x, iv_k + s_k):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(s_k[0]) > 0


@pytest.mark.gpu
def test_kernel_compiled_matches_xla_on_gpu(gpu, genome):
    """The kernel as the GPU compiles it == the XLA twin."""
    from bwamem_tpu.ops.fm import DeviceFmIndex
    fwd, fm = genome
    d = DeviceFmIndex.from_host(fm)
    rng = np.random.default_rng(1)
    B, L = 512, 128
    q, qlen, act = lane_batch(fwd, B, L, rng, amb=True, repeats=True)
    args = superstep_args(d, q, qlen, act, packed=True)
    common = dict(L=L, M=16, OUT_CAP=48, NEED_X1=True, QPACKED=True)
    ref = smem_mod.smem_superstep(*args, IMPL="xla", **common)
    out = smem_mod.smem_superstep(*args, IMPL="gpu", **common)
    assert assert_streams_equal(ref, out, 48) > 0
