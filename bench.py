"""Benchmark: end-to-end `mem` alignment throughput (reads/s) on the
bundled test dataset, reported against the reference CPU baseline.

Baseline: stock bwa ran 512 reads in 0.427 real s with 4 CPU threads —
~1199 reads/s (software/bwares/stderr.log:8, SURVEY.md §6).

Prints one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

import json
import os
import sys
import time

# one maximal lane group per chunk for every stage
os.environ.setdefault("BWAMEM_TPU_LANES", "8192")
os.environ.setdefault("BWAMEM_TPU_WAVE", "2048")
os.environ.setdefault("BWAMEM_TPU_SA_SLICE", "32768")
os.environ.setdefault("BWAMEM_TPU_WAVE_EXT", "16384")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_READS_PER_S = 1199.0  # 512 reads / 0.427 s, 4 CPU threads


def main():
    import jax
    if jax.default_backend() != "gpu":
        sys.exit("[bench] no GPU found (backend %r): the bench measures "
                 "the card only" % jax.default_backend())
    # alternate dataset (e.g. the large-genome set from
    # tools/make_biggenome.py) via BWAMEM_TPU_BENCH_DATA
    data = os.environ.get("BWAMEM_TPU_BENCH_DATA") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "data")
    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.fastq import ChunkReader
    from bwamem_tpu.config import MemOptions
    import bwamem_tpu.core.pipeline as pl

    fm, bns = load_index(os.path.join(data, "genome.fa"))
    pac = bns.pac
    opt = MemOptions()
    # BWAMEM_TPU_BENCH_PE=1: the reference's canonical workload shape —
    # paired reads with `-M -a` (software/run.sh:1, README.md:13-17) —
    # exercising mate rescue, mem_pair and bm_finalize_pe
    pe = bool(os.environ.get("BWAMEM_TPU_BENCH_PE"))
    if pe:
        from bwamem_tpu.config import MEM_F_PE, MEM_F_ALL, MEM_F_NO_MULTI
        opt.flag |= MEM_F_PE | MEM_F_ALL | MEM_F_NO_MULTI
    sys.stderr.write("[bench] index loaded\n")
    sys.stderr.flush()

    # -t worker pool (parallel host finalize): BWAMEM_TPU_BENCH_POOL=N
    # (with chunk pipelining the host stages are the critical path, so
    # the earlier pickling-cost verdict may not hold — re-A/B freely)
    pool = None
    n_pool = int(os.environ.get("BWAMEM_TPU_BENCH_POOL", "0"))
    if n_pool > 1:
        from bwamem_tpu.core.mt import WorkerPool
        # spawn: workers reload the index and stay off the card
        pool = WorkerPool(fm, bns, pac, n_pool, method="spawn",
                          index_prefix=os.path.join(data, "genome.fa"))

    from bwamem_tpu.ops.engine import JaxSeedingEngine
    engine = JaxSeedingEngine(fm)

    if pe:
        reader = ChunkReader(os.path.join(data, "reads_1.fq"),
                             os.path.join(data, "reads_2.fq"))
        reads = reader.read_chunk(1 << 30)
    else:
        reader = ChunkReader(os.path.join(data, "reads_se.fq"))
        reads = reader.read_chunk(1 << 30)
    # replicate to a steadier workload: chunks driven through the
    # chunk-pipelined stream (chunk k+1 seeds on the device while chunk
    # k's waves/finalize run on the host)
    import copy
    import random
    rep = int(os.environ.get("BWAMEM_TPU_BENCH_REP", "0"))
    if rep <= 0:
        # size chunks to exactly fill one seeding lane group: a chunk
        # just past LANES pays a second near-empty smem dispatch
        lanes = int(os.environ.get("BWAMEM_TPU_LANES", "8192"))
        rep = max(1, lanes // max(len(reads), 1))
    # enough chunks that the pipeline edges (first-chunk seed lead-in,
    # last-chunk finalize drain) are a small part of the window
    n_chunks = int(os.environ.get("BWAMEM_TPU_BENCH_CHUNKS", "32"))
    # distinct read ORDER per chunk, so no two dispatch buffers are
    # identical; shuffling keeps the workload statistics.
    # BWAMEM_TPU_BENCH_LEGACY=1 runs identical chunks instead.
    legacy = os.environ.get("BWAMEM_TPU_BENCH_LEGACY")

    def make_chunks(seed_base: int):
        out = []
        for ci in range(n_chunks):
            c = [copy.copy(r) for r in reads * rep]
            if not legacy:
                if pe:  # shuffle PAIRS: mates must stay interleaved
                    pairs = [c[i:i + 2] for i in range(0, len(c), 2)]
                    random.Random(seed_base + ci).shuffle(pairs)
                    c = [r for p in pairs for r in p]
                else:
                    random.Random(seed_base + ci).shuffle(c)
            out.append(c)
        return out

    n_work = n_chunks * len(reads) * rep
    # self-describing workload record (resolved rep is workload scale:
    # cross-round numbers are only comparable at equal rep/chunk size)
    sys.stderr.write(
        "[bench] workload: rep=%d chunk=%d reads, n_chunks=%d, "
        "total=%d reads%s\n" % (rep, len(reads) * rep, n_chunks, n_work,
                                " (PE)" if pe else ""))

    sys.stderr.write("[bench] engine ready (device tables uploaded)\n")
    sys.stderr.flush()

    # warm-up (compiles)
    if engine is not None:
        engine.warm_shapes(opt)
    warm = [copy.copy(r) for r in reads[:64]]
    pl.process_seqs(opt, fm, bns, pac, 0, warm, None, "", engine,
                    verbose=0, pool=pool)
    sys.stderr.write("[bench] warmup done\n")
    sys.stderr.flush()

    # optional stage breakdown (stderr; JSON line unchanged)
    stages = {}
    if engine is not None and os.environ.get("BWAMEM_TPU_BENCH_STAGES"):
        def timed(name, fn):
            def wrap(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                stages[name] = stages.get(name, 0.0) \
                    + time.perf_counter() - t
                return out
            return wrap
        engine.chain_batch = timed("seed+sa", engine.chain_batch)
        engine.drive_waves = timed("sw_waves", engine.drive_waves)
        engine.kernel_time = 0.0
        engine.n_dispatches = 0
        engine.kernel_time_by_tag = {}

    prof = None
    if os.environ.get("BWAMEM_TPU_BENCH_PROFILE"):
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
    # median-of-N passes; per-pass numbers go to stderr
    n_pass = max(1, int(os.environ.get("BWAMEM_TPU_BENCH_PASSES", "3")))
    pass_rps = []
    for pi in range(n_pass):
        chunks = make_chunks(1000 + 100 * pi)
        t0 = time.perf_counter()
        pl.process_chunk_stream(opt, fm, bns, pac, iter(chunks), None,
                                "", engine, verbose=0, pool=pool)
        dt = time.perf_counter() - t0
        pass_rps.append(n_work / dt)
        sys.stderr.write("[bench] pass %d/%d: %.1f reads/s (%.2f s)\n"
                         % (pi + 1, n_pass, pass_rps[-1], dt))
        sys.stderr.flush()
    if prof is not None:
        prof.disable()
        import pstats
        pstats.Stats(prof, stream=sys.stderr).sort_stats(
            "tottime").print_stats(45)
    rps = sorted(pass_rps)[len(pass_rps) // 2]
    if pool is not None:
        pool.close()
    if stages:
        stages["total"] = sum(n_work / r for r in pass_rps)
        stages["kernel_time"] = engine.kernel_time
        stages["n_dispatches"] = engine.n_dispatches
        stages.update(engine.kernel_time_by_tag)
        sys.stderr.write("[bench] stages: %s\n" % json.dumps(
            {k: round(v, 3) if isinstance(v, float) else v
             for k, v in stages.items()}))

    print(json.dumps({
        "metric": "mem_align_throughput" + ("_pe" if pe else ""),
        "value": round(rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_S, 4),
    }))


if __name__ == "__main__":
    main()
