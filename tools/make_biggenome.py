#!/usr/bin/env python3
"""Large-genome dataset: a multi-Mbp i.i.d. random reference (two
contigs, a few N holes, one 15 kbp repeat) whose occ table is far past
the card's L2 cache — the regime production genomes (GRCh37 etc.) live
in.  Generates genome + bwa-format index + SE reads into a work
directory (not committed; regenerate on demand):

    python tools/make_biggenome.py bigref --mbp 4 --n-se 2000
    BWAMEM_TPU_BENCH_DATA=bigref python bench.py

--no-index writes the FASTA (and reads) only, for callers that index
with `bwamem_tpu.cli index` themselves.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))
from make_testdata import BASES, mutate, revcomp, sample_read, write_fastq  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('outdir')
    ap.add_argument('--mbp', type=float, default=4.0)
    ap.add_argument('--n-se', type=int, default=2000)
    ap.add_argument('--n-pe', type=int, default=0)
    ap.add_argument('--seed', type=int, default=20260817)
    ap.add_argument('--read-len', type=int, default=101)
    ap.add_argument('--no-index', action='store_true')
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    total = int(args.mbp * 1e6)
    lens = (total * 2 // 3, total - total * 2 // 3)
    contigs = []
    for n, L in enumerate(lens):
        seq = BASES[rng.integers(0, 4, size=L)].copy()
        for _ in range(4):  # N holes
            start = int(rng.integers(100, L - 600))
            seq[start:start + int(rng.integers(5, 40))] = ord('N')
        src = int(rng.integers(0, L - 40000))
        dst = int(rng.integers(0, L - 40000))
        seq[dst:dst + 15000] = seq[src:src + 15000]  # repeat region
        contigs.append((f"big{n+1}", seq))

    fa = os.path.join(args.outdir, "genome.fa")
    with open(fa, 'w') as f:
        for name, seq in contigs:
            f.write(f">{name} big contig\n")
            s = seq.tobytes().decode()
            for i in range(0, len(s), 70):
                f.write(s[i:i + 70] + "\n")
    print("genome written:", total, "bp")

    L = args.read_len
    se = []
    for i in range(args.n_se):
        name, pos, frag = sample_read(rng, contigs, L)
        read = mutate(rng, frag)
        if rng.random() < 0.5:
            read = revcomp(read)
        se.append((f"b{i}_{name}_{pos}", read))
    write_fastq(os.path.join(args.outdir, "reads_se.fq"), se)
    print("reads written:", len(se))

    if args.n_pe:  # FR pairs, insert ~300+-30 (make_testdata's model)
        r1, r2 = [], []
        while len(r1) < args.n_pe:
            name, seq = contigs[int(rng.integers(0, len(contigs)))]
            insert = max(L + 10, int(rng.normal(300, 30)))
            pos = int(rng.integers(0, len(seq) - insert))
            frag = seq[pos:pos + insert].tobytes().decode()
            if 'N' in frag:
                continue
            qname = f"pe{len(r1)}_{name}_{pos}"
            r1.append((qname + "/1", mutate(rng, frag[:L])))
            r2.append((qname + "/2", mutate(rng, revcomp(frag[-L:]))))
        write_fastq(os.path.join(args.outdir, "reads_1.fq"), r1)
        write_fastq(os.path.join(args.outdir, "reads_2.fq"), r2)
        print("pairs written:", len(r1))

    if args.no_index:
        return
    t0 = time.perf_counter()
    from bwamem_tpu.index.build import build_index
    build_index(fa)
    print("index built in %.1fs" % (time.perf_counter() - t0))


if __name__ == '__main__':
    main()
