#!/usr/bin/env python3
"""One-process device evaluation on any dataset dir: SE diff vs a host
SAM, SE bench, PE diff, PE bench — the device tables upload once
(at 256 Mbp+ the upload dominates a per-run process).

    python tools/run_eval.py /tmp/rep256 --n-diff 2000 \
        --se-host /tmp/rep256/host_se_r3g.sam \
        --pe-host /tmp/rep256/host_pe_r3g.sam \
        --bench-chunks 16

Prints PASS/FAIL per diff, one JSON line per bench, and the engine's
stage/fallback counters (the per-cap host-fallback rates the
repeat-realistic validation wants)."""
import argparse
import copy
import json
import os
import random
import sys
import time

os.environ.setdefault("BWAMEM_TPU_LANES", "8192")
os.environ.setdefault("BWAMEM_TPU_WAVE", "2048")
os.environ.setdefault("BWAMEM_TPU_SA_SLICE", "32768")
os.environ.setdefault("BWAMEM_TPU_WAVE_EXT", "16384")

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("data")
    ap.add_argument("--n-diff", type=int, default=2000)
    ap.add_argument("--se-host")
    ap.add_argument("--pe-host")
    ap.add_argument("--bench-chunks", type=int, default=0)
    ap.add_argument("--bench-passes", type=int, default=1)
    ap.add_argument("--skip-pe", action="store_true")
    ap.add_argument("--skip-se", action="store_true",
                    help="PE only (e.g. a rerun after a timeout)")
    args = ap.parse_args()

    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.fastq import ChunkReader
    from bwamem_tpu.config import MemOptions, MEM_F_PE
    import bwamem_tpu.core.pipeline as pl
    from bwamem_tpu.ops.engine import JaxSeedingEngine

    t0 = time.time()
    fm, bns = load_index(os.path.join(args.data, "genome.fa"))
    pac = bns.pac
    print(f"[eval] index loaded {time.time()-t0:.1f}s "
          f"seq_len={int(fm.seq_len)}", file=sys.stderr)
    t1 = time.time()
    engine = JaxSeedingEngine(fm)
    print(f"[eval] engine up {time.time()-t1:.1f}s", file=sys.stderr)

    def diff(reads, host_path, opt, tag):
        dr = [copy.copy(r) for r in reads]
        t = time.time()
        pl.process_seqs(opt, fm, bns, pac, 0, dr, None, "", engine,
                        verbose=0)
        got = "".join(r.sam for r in dr)
        want = open(host_path).read() if host_path else None
        ok = (want is None) or (got == want)
        print(f"[eval] {tag} diff: {len(dr)} reads {time.time()-t:.1f}s"
              f" -> {'BYTE-IDENTICAL' if ok else 'MISMATCH'}",
              file=sys.stderr)
        if not ok:
            with open(f"/tmp/eval_{tag}_got.sam", "w") as f:
                f.write(got)
            print(f"[eval] wrote /tmp/eval_{tag}_got.sam",
                  file=sys.stderr)
        return ok

    def bench(reads, opt, tag, pe):
        lanes = int(os.environ.get("BWAMEM_TPU_LANES", "8192"))
        rep = max(1, lanes // max(len(reads), 1))
        vals = []
        for p in range(args.bench_passes):
            chunks = []
            for ci in range(args.bench_chunks):
                c = [copy.copy(r) for r in reads * rep]
                if pe:
                    pairs = [c[i:i + 2] for i in range(0, len(c), 2)]
                    random.Random(1000 + ci + 71 * p).shuffle(pairs)
                    c = [r for q in pairs for r in q]
                else:
                    random.Random(1000 + ci + 71 * p).shuffle(c)
                chunks.append(c)
            n_work = sum(len(c) for c in chunks)
            w = [copy.copy(r) for r in reads[:64]]
            pl.process_seqs(opt, fm, bns, pac, 0, w, None, "", engine,
                            verbose=0)
            engine.kernel_time_by_tag = {}
            t = time.time()
            pl.process_chunk_stream(opt, fm, bns, pac, iter(chunks),
                                    None, "", engine, verbose=0)
            dt = time.time() - t
            vals.append(n_work / dt)
            print(f"[eval] {tag} pass {p+1}: {n_work/dt:.1f} reads/s "
                  f"({dt:.1f}s)", file=sys.stderr)
            print(f"[eval] {tag} stages: "
                  f"{json.dumps({k: (round(v, 3) if isinstance(v, float) else v) for k, v in engine.kernel_time_by_tag.items()})}",
                  file=sys.stderr)
        vals.sort()
        med = vals[len(vals) // 2]
        print(json.dumps({"metric": f"eval_{tag}", "value": round(med, 1),
                          "unit": "reads/s",
                          "vs_baseline": round(med / 1199.0, 4)}))

    # ---- SE ----
    if not args.skip_se:
        se = ChunkReader(os.path.join(args.data, "reads_se.fq")) \
            .read_chunk(1 << 34)
        opt = MemOptions()
        diff(se[:args.n_diff], args.se_host, opt, "se")
        if args.bench_chunks:
            bench(se, opt, "se", pe=False)

    # ---- PE ----
    if not args.skip_pe and \
            os.path.exists(os.path.join(args.data, "reads_1.fq")):
        per = ChunkReader(os.path.join(args.data, "reads_1.fq"),
                          os.path.join(args.data, "reads_2.fq")) \
            .read_chunk(1 << 34)
        opt2 = MemOptions()
        opt2.flag |= MEM_F_PE
        diff(per[:args.n_diff], args.pe_host, opt2, "pe")
        if args.bench_chunks:
            bench(per, opt2, "pe", pe=True)


if __name__ == "__main__":
    main()
