"""Multi-host wiring: a real 2-process jax.distributed rendezvous on
the CPU backend, with the pestat orientation-histogram psum (the
pipeline's one true collective, software/bwamem_pair.c:46-107 over the
whole chunk) reducing ACROSS processes on the global reads mesh.

This is the mechanism behind `mem --distributed coord,N,i` (cli.py) and
BASELINE.json config 5 (multi-host pod slice); here each "host" is one
process with one CPU device.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import numpy as np
sys.path.insert(0, os.getcwd())
from bwamem_tpu.parallel import multihost
multihost.initialize(sys.argv[1], 2, int(sys.argv[2]))
import jax
import jax.numpy as jnp
assert jax.process_count() == 2, jax.process_count()
mesh = multihost.global_reads_mesh()
assert mesh.devices.size == 2, mesh.devices.size

from bwamem_tpu.parallel.mesh import pestat_histograms
fn = pestat_histograms(mesh)
pid = jax.process_index()
# each process contributes 4 local observations with orientation == its
# process id; the psum must see all 8 globally
from jax.sharding import NamedSharding, PartitionSpec as P
isize = jnp.full((4,), 100 + pid, jnp.int64)
orient = jnp.full((4,), pid, jnp.int32)
sh = NamedSharding(mesh, P("reads"))
g_is = jax.make_array_from_process_local_data(sh, np.asarray(isize), (8,))
g_or = jax.make_array_from_process_local_data(sh, np.asarray(orient), (8,))
counts, hist = fn(g_is, g_or)
c = np.asarray(jax.device_get(counts))
assert c.tolist()[:2] == [4, 4], c.tolist()
h = np.asarray(jax.device_get(hist))
assert h[0, 100] == 4 and h[1, 101] == 4
print("DIST_OK", pid)
"""


def test_two_process_full_pipeline_golden(tmp_path):
    """`mem --distributed` END TO END across 2 real processes on the
    CPU backend: each process rendezvouses, takes its default chunk
    stripe, and runs the full pipeline.  Each process's records must
    be byte-identical to a plain single-process `--shard i/2` run
    (the same mechanism without the rendezvous), and the two shards
    together must reproduce the golden SAM record set exactly."""
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = "127.0.0.1:%d" % port.getsockname()[1]
    port.close()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    env.pop("XLA_FLAGS", None)  # 1 local device per process
    env["BWAMEM_TPU_CHUNK_BP"] = "20000"

    def cli(extra):
        return [sys.executable, "-m", "bwamem_tpu.cli", "mem",
                "--engine", "jax"] + extra \
            + [os.path.join(data, "genome.fa"),
               os.path.join(data, "reads_se.fq")]

    procs = [subprocess.Popen(
        cli(["--distributed", "%s,2,%d" % (addr, i)]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=repo, env=env, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed mem workers timed out")

    body = []
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-2000:]
        recs = [l for l in out.splitlines() if not l.startswith("@")]
        # byte-identical to the plain --shard i/2 path
        solo = subprocess.run(
            cli(["--shard", "%d/2" % i]), cwd=repo, env=env,
            capture_output=True, text=True, timeout=300)
        assert solo.returncode == 0, solo.stderr[-2000:]
        srecs = [l for l in solo.stdout.splitlines()
                 if not l.startswith("@")]
        assert recs == srecs, \
            "process %d drifted from the --shard twin" % i
        body += recs

    # Together the shards cover the golden read set exactly.  Records
    # are NOT compared byte-wise against the unsharded golden: a
    # per-shard run renumbers reads, so hash_64 ties (mapq-0 reads
    # with XS == AS) legitimately resolve to the other equally-scored
    # position — exactly as the reference does when fed the subset.
    # Byte-level determinism is asserted above against the --shard
    # twin (and per-shard vs its own chunks in test_shard.py).
    with open(os.path.join(data, "golden_se.sam")) as f:
        golden = [l.rstrip("\n") for l in f
                  if not l.startswith("@")]
    name = lambda ls: sorted(l.split("\t")[0] for l in ls)
    assert name(body) == name(golden)


def test_two_process_rendezvous_and_pestat_psum(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = "127.0.0.1:%d" % port.getsockname()[1]
    port.close()

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # 1 local device per process

    procs = [subprocess.Popen(
        [sys.executable, str(script), addr, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out: rendezvous hung")
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        assert "DIST_OK" in out
