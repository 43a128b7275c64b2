"""Sharded index tables (capacity mode): the occ-block table and
the sampled SA row-sharded over the mesh, with every gather running as
all_gather(indices) -> local gather -> psum_scatter (ops/fm.py
table_axis).  This is the device mapping of the reference keeping its 3 GB
BWT in host DRAM and fetching 64-byte blocks per extension step over
CCI-P (software/HelloALINLB.cpp:59-63, hardware/afu_core.v:1428-1432) —
and the final scale-out stage of SURVEY.md §7 step 8.  Must be
byte-identical to the replicated-table path.
"""

import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bwamem_tpu.config import MemOptions
from bwamem_tpu.io.fastq import ChunkReader

if len(jax.devices()) < 8:
    pytest.skip("needs the 8-virtual-device CPU mesh", allow_module_level=True)


def test_sharded_occ4_matches_replicated(ref_index):
    """Kernel-level parity: occ4 against a row-sharded table equals
    occ4 against the replicated table for random positions."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from bwamem_tpu.ops import fm as fm_mod
    from bwamem_tpu.ops.fm import DeviceFmIndex, occ4
    from bwamem_tpu.parallel.mesh import make_mesh, pad_to_shards, READS_AXIS

    fm, _ = ref_index
    dfm = DeviceFmIndex.from_host(fm)
    mesh = make_mesh(8)
    rng = np.random.RandomState(7)
    k = rng.randint(-1, int(fm.seq_len), size=(512,)).astype(np.int64)

    ref = np.asarray(occ4(dfm.blocks, dfm.primary,
                          jnp.asarray(k, dfm.cdt)))

    blocks = pad_to_shards(np.asarray(dfm.blocks), 8, 0)

    def body(blocks_l, primary, kk):
        with fm_mod.table_axis(READS_AXIS):
            return occ4(blocks_l, primary, kk)

    fn = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(READS_AXIS, None), P(), P(READS_AXIS)),
        out_specs=P(READS_AXIS), check_vma=False))
    got = np.asarray(fn(blocks, dfm.primary, jnp.asarray(k, dfm.cdt)))
    np.testing.assert_array_equal(got, ref)


def test_sharded_tables_cli_golden(data_dir, monkeypatch):
    """`mem --mesh 8 --shard-tables` SAM output is byte-identical to the
    reference golden file."""
    import io
    import sys
    from bwamem_tpu import cli
    monkeypatch.delenv("BWAMEM_TPU_SHARD_TABLES", raising=False)
    out = io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        ret = cli.main_mem(["--engine", "jax", "--mesh", "8",
                            "--shard-tables",
                            os.path.join(data_dir, "genome.fa"),
                            os.path.join(data_dir, "reads_se.fq")])
    finally:
        sys.stdout = old
        os.environ.pop("BWAMEM_TPU_SHARD_TABLES", None)
    assert ret == 0
    ours = [l for l in out.getvalue().split("\n")
            if not l.startswith("@PG")]
    with open(os.path.join(data_dir, "golden_se.sam")) as f:
        golden = [l for l in f.read().split("\n")
                  if not l.startswith("@PG")]
    assert ours == golden


def test_sharded_tables_engine_matches_single(ref_index, data_dir,
                                              monkeypatch):
    """End-to-end: the mesh engine with BWAMEM_TPU_SHARD_TABLES=1
    produces identical alignment regions to the single-device engine."""
    from bwamem_tpu.ops.engine import JaxSeedingEngine
    from bwamem_tpu.parallel.mesh import make_mesh
    fm, bns = ref_index
    opt = MemOptions()
    reads = ChunkReader(os.path.join(data_dir, "reads_se.fq")) \
        .read_chunk(1 << 30)[:128]

    e1 = JaxSeedingEngine(fm)
    r1 = [copy.copy(r) for r in reads]
    regs1 = e1.align_batch(opt, fm, bns, bns.pac, r1)

    monkeypatch.setenv("BWAMEM_TPU_SHARD_TABLES", "1")
    e8 = JaxSeedingEngine(fm, mesh=make_mesh(8))
    assert e8.kernels is not None and e8.kernels.shard_tables
    # the tables really are distributed: each shard holds 1/8 of rows
    shards = e8.dfm.blocks.addressable_shards
    assert len(shards) == 8
    assert shards[0].data.shape[0] == e8.dfm.blocks.shape[0] // 8
    r8 = [copy.copy(r) for r in reads]
    regs8 = e8.align_batch(opt, fm, bns, bns.pac, r8)

    def fields(regs):
        return [[(p.rb, p.re, p.qb, p.qe, p.score, p.truesc, p.csub,
                  p.w, p.seedcov) for p in g] for g in regs]

    assert fields(regs1) == fields(regs8)
