"""Data-parallel mesh engine: the full mem pipeline sharded over the
8-virtual-device reads mesh must be byte-identical to single-device.

Every engine dispatch (SMEM superstep, SA lookup, extend/extend_lr/
global waves) runs shard_map'd with the index replicated and the lane
axis split (parallel/mesh.py ShardedKernels) — the device mapping of the
reference's N-workers-one-FPGA parallelism (SURVEY.md §2.4).
"""

import copy
import os

import pytest

import jax

from bwamem_tpu.config import MemOptions
from bwamem_tpu.io.fastq import ChunkReader

if len(jax.devices()) < 8:
    pytest.skip("needs the 8-virtual-device CPU mesh", allow_module_level=True)


def test_mesh_engine_regs_match_single(ref_index, data_dir):
    from bwamem_tpu.ops.engine import JaxSeedingEngine
    from bwamem_tpu.parallel.mesh import make_mesh
    fm, bns = ref_index
    opt = MemOptions()
    reads = ChunkReader(os.path.join(data_dir, "reads_se.fq")) \
        .read_chunk(1 << 30)[:128]

    e1 = JaxSeedingEngine(fm)
    r1 = [copy.copy(r) for r in reads]
    regs1 = e1.align_batch(opt, fm, bns, bns.pac, r1)

    e8 = JaxSeedingEngine(fm, mesh=make_mesh(8))
    assert e8.kernels is not None
    r8 = [copy.copy(r) for r in reads]
    regs8 = e8.align_batch(opt, fm, bns, bns.pac, r8)

    def fields(regs):
        return [[(p.rb, p.re, p.qb, p.qe, p.score, p.truesc, p.csub,
                  p.w, p.seedcov) for p in g] for g in regs]

    assert fields(regs1) == fields(regs8)
