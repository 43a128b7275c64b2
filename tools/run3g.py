#!/usr/bin/env python3
"""The canonical human-scale regime end to end (round-3 verdict #1):
align reads against a >=3 Gbp reference (int64 coordinates) in ONE
process so the 3 GB table uploads once.

    # host reference SAM (CPU, any time):
    python tools/run3g.py host ref3g 2000 > host3g.sam
    # device: diff-aligns the same reads, byte-compares, then benches:
    python tools/run3g.py device ref3g 2000 --bench-chunks 8

Matches the reference's published workload shape: `mem` vs
human_g1k_v37-scale reference (software/run.sh:1, README.md:13-17),
3 GB BWT resident next to the accelerator (software/bwa.c:286-301).
"""
import argparse
import os
import sys
import time

# the bench.py lane-group defaults (one maximal group per chunk/stage)
os.environ.setdefault("BWAMEM_TPU_LANES", "8192")
os.environ.setdefault("BWAMEM_TPU_WAVE", "2048")
os.environ.setdefault("BWAMEM_TPU_SA_SLICE", "32768")
os.environ.setdefault("BWAMEM_TPU_WAVE_EXT", "16384")

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["host", "device"])
    ap.add_argument("data")
    ap.add_argument("n_diff", type=int, default=2000)
    ap.add_argument("--bench-chunks", type=int, default=0)
    ap.add_argument("--bench-rep", type=int, default=0)
    ap.add_argument("--pe", action="store_true")
    args = ap.parse_args()

    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.fastq import ChunkReader
    from bwamem_tpu.config import MemOptions
    import bwamem_tpu.core.pipeline as pl

    t0 = time.time()
    fm, bns = load_index(os.path.join(args.data, "genome.fa"),
                         load_sa8=True)
    pac = bns.pac
    print(f"[run3g] index loaded in {time.time()-t0:.1f} s "
          f"(seq_len={int(fm.seq_len)})", file=sys.stderr)

    engine = None
    if args.mode == "device":
        from bwamem_tpu.ops.engine import JaxSeedingEngine
        t1 = time.time()
        engine = JaxSeedingEngine(fm)
        sdr = engine.seeder
        print(f"[run3g] engine up in {time.time()-t1:.1f} s; "
              f"cdt={sdr.dfm.cdt} sa_intv={sdr.dfm.sa_intv}",
              file=sys.stderr)

    opt = MemOptions()
    if args.pe:
        from bwamem_tpu.config import MEM_F_PE
        opt.flag |= MEM_F_PE
        reader = ChunkReader(os.path.join(args.data, "reads_1.fq"),
                             os.path.join(args.data, "reads_2.fq"))
    else:
        reader = ChunkReader(os.path.join(args.data, "reads_se.fq"))
    reads = reader.read_chunk(1 << 34)
    diff_reads = reads[:args.n_diff]

    # ---- diff phase: align and emit records --------------------------
    import copy
    t2 = time.time()
    dr = [copy.copy(r) for r in diff_reads]
    pl.process_seqs(opt, fm, bns, pac, 0, dr, None, "", engine,
                    verbose=0)
    dt = time.time() - t2
    print(f"[run3g] diff phase: {len(dr)} reads in {dt:.1f} s "
          f"({len(dr)/dt:.0f} reads/s incl. first-dispatch compiles)",
          file=sys.stderr)
    for r in dr:
        sys.stdout.write(r.sam)
    sys.stdout.flush()

    # ---- bench phase (steady-state reads/s) --------------------------
    if args.bench_chunks:
        import random
        lanes = int(os.environ.get("BWAMEM_TPU_LANES", "8192"))
        rep = args.bench_rep or max(1, lanes // max(len(reads), 1))
        chunks = []
        for ci in range(args.bench_chunks):
            c = [copy.copy(r) for r in reads * rep]
            if args.pe:  # shuffle PAIRS: mates must stay interleaved
                pairs = [c[i:i + 2] for i in range(0, len(c), 2)]
                random.Random(1000 + ci).shuffle(pairs)
                c = [r for p in pairs for r in p]
            else:
                random.Random(1000 + ci).shuffle(c)
            chunks.append(c)
        n_work = sum(len(c) for c in chunks)
        # warm
        w = [copy.copy(r) for r in reads[:64]]
        pl.process_seqs(opt, fm, bns, pac, 0, w, None, "", engine,
                        verbose=0)
        t3 = time.time()
        pl.process_chunk_stream(opt, fm, bns, pac, iter(chunks), None,
                                "", engine, verbose=0)
        dt = time.time() - t3
        import json
        print(json.dumps({
            "metric": "mem_align_throughput_3g",
            "value": round(n_work / dt, 2), "unit": "reads/s",
            "vs_baseline": round(n_work / dt / 1199.0, 4)}))
        print(f"[run3g] bench: {n_work} reads in {dt:.1f} s",
              file=sys.stderr)
        if engine is not None:
            print(f"[run3g] kernel_time={engine.kernel_time:.1f} "
                  f"dispatches={engine.n_dispatches} "
                  f"by_tag={engine.kernel_time_by_tag}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
