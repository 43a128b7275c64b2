"""--shard i/n: chunk-strided multi-host data parallelism.

Shards must partition the input chunks disjointly and completely, and
each shard's records must be byte-identical to the same chunks run by
an unsharded process (shard-local determinism: the per-shard
n_processed numbering keys the hash tie-breaks)."""

import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    env.update(env_extra)
    out = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu.cli", "mem", "--engine",
         "jax"] + args,
        cwd=REPO, env=env, capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr.decode()[-500:]
    return [l for l in out.stdout.decode().splitlines()
            if not l.startswith("@")]


def test_shard_partition():
    env = {"BWAMEM_TPU_CHUNK_BP": "20000"}
    full = _run([os.path.join(DATA, "genome.fa"),
                 os.path.join(DATA, "reads_se.fq")], env)
    s0 = _run(["--shard", "0/2", os.path.join(DATA, "genome.fa"),
               os.path.join(DATA, "reads_se.fq")], env)
    s1 = _run(["--shard", "1/2", os.path.join(DATA, "genome.fa"),
               os.path.join(DATA, "reads_se.fq")], env)
    names = lambda ls: set(l.split("\t")[0] for l in ls)
    assert not (names(s0) & names(s1))
    assert names(s0) | names(s1) == names(full)
    assert len(s0) + len(s1) == len(full)


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for r in reads:
            if r.qual is None:
                f.write(">%s\n%s\n" % (r.name, r.seq))
            else:
                f.write("@%s\n%s\n+\n%s\n" % (r.name, r.seq, r.qual))


def test_shard_records_byte_identical(tmp_path):
    """The docstring's actual determinism claim: each shard's SAM
    records are BYTE-identical to an unsharded run over that shard's
    chunks alone (the per-shard n_processed numbering keys the
    hash_64 tie-breaks, software/bwamem.c:761,1604).  The unsharded
    twin re-chunks the shard's reads with the same greedy >=chunk_bp
    rule, which reproduces the original chunk boundaries because each
    donor chunk already ends exactly at the rule's stopping point."""
    chunk_bp = 20000
    env = {"BWAMEM_TPU_CHUNK_BP": str(chunk_bp)}
    from bwamem_tpu.io.fastq import ChunkReader
    reader = ChunkReader(os.path.join(DATA, "reads_se.fq"))
    chunks = []
    while True:
        reads = reader.read_chunk(chunk_bp)
        if not reads:
            break
        chunks.append(reads)
    assert len(chunks) >= 3, "workload too small to exercise sharding"
    for shard in (0, 1):
        fq = tmp_path / ("shard%d.fq" % shard)
        donor = [r for ci in range(shard, len(chunks), 2)
                 for r in chunks[ci]]
        _write_fastq(fq, donor)
        expect = _run([os.path.join(DATA, "genome.fa"), str(fq)], env)
        got = _run(["--shard", "%d/2" % shard,
                    os.path.join(DATA, "genome.fa"),
                    os.path.join(DATA, "reads_se.fq")], env)
        assert got == expect, \
            "shard %d records drifted from the unsharded twin" % shard
