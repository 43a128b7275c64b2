"""Command-line interface: the bwa command mux (reference:
software/top.c:63-118) rebuilt for the JAX device engine.

Implemented commands: index, mem, fastmap, aln, samse, sampe, bwasw
(+ bwtsw2/dbwtsw aliases), pemerge, fa2pac, pac2bwt, pac2bwtgen,
bwtupdate, bwt2sa — the reference's complete command set
(software/top.c:88-106); see docs/PARITY.md.
"""

import math
import os
import sys

PACKAGE_VERSION = "0.7.8-r455"  # output-compat version (top.c:10)


def _usage():
    sys.stderr.write(f"""
Program: bwa (alignment via Burrows-Wheeler transformation)
Version: {PACKAGE_VERSION}
Contact: tpu-bwa-mem

Usage:   bwa <command> [options]

Command: index         index sequences in the FASTA format
         mem           BWA-MEM algorithm
         fastmap       identify super-maximal exact matches
         pemerge       merge overlapping paired ends
         aln           gapped/ungapped alignment
         samse         generate alignment (single ended)
         sampe         generate alignment (paired ended)
         bwasw         BWA-SW for long queries

         fa2pac        convert FASTA to PAC format
         pac2bwt       generate BWT from PAC
         bwtupdate     update .bwt to the new format
         bwt2sa        generate SA from BWT and Occ

""")
    return 1


def set_rg(s: str):
    """bwa_set_rg (software/bwa.c:375-402): unescape and extract ID."""
    rg_line = (s.replace("\\t", "\t").replace("\\n", "\n")
               .replace("\\r", "\r").replace("\\\\", "\\"))
    if not rg_line.startswith("@RG"):
        sys.stderr.write("[E::bwa_set_rg] the read group line is not started"
                         " with @RG\n")
        return None, None
    idx = rg_line.find("\tID:")
    if idx < 0:
        sys.stderr.write("[E::bwa_set_rg] no ID at the read group line\n")
        return None, None
    p = idx + 4
    q = p
    while q < len(rg_line) and rg_line[q] not in "\t\n":
        q += 1
    return rg_line, rg_line[p:q]


def main_mem(argv):
    import getopt as _getopt
    from .config import (MemOptions, fill_scmat, MEM_F_PE, MEM_F_NOPAIRING,
                         MEM_F_ALL, MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                         MEM_F_NO_EXACT)
    from .index import load_index
    from .io.native import make_chunk_reader
    from .core.pipeline import process_seqs
    from .core import pair as pe
    from .core.sam import sam_header

    opt = MemOptions()
    copy_comment = False
    rg_line = rg_id = None
    pes0 = None
    verbose = 3
    engine_kind = "auto"
    mesh_spec = None
    shard_spec = None
    dist_spec = None
    profile_dir = None
    try:
        opts, args = _getopt.getopt(
            argv, "epaMCSPHk:c:v:s:r:t:b:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:",
            ["engine=", "profile=", "mesh=", "shard=",
             "distributed=", "shard-tables"])
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, val in opts:
        c = c.lstrip("-")
        if c == "k":
            opt.min_seed_len = int(val)
        elif c == "w":
            opt.w = int(val)
        elif c == "A":
            opt.a = int(val)
            opt._explicit.add("a")
        elif c == "B":
            opt.b = int(val)
            opt._explicit.add("b")
        elif c == "T":
            opt.T = int(val)
            opt._explicit.add("T")
        elif c == "U":
            opt.pen_unpaired = int(val)
            opt._explicit.add("pen_unpaired")
        elif c == "t":
            opt.n_threads = max(int(val), 1)
        elif c == "b":
            opt.batch_size = max(int(val), 1)
        elif c == "P":
            opt.flag |= MEM_F_NOPAIRING
        elif c == "a":
            opt.flag |= MEM_F_ALL
        elif c == "p":
            opt.flag |= MEM_F_PE
        elif c == "M":
            opt.flag |= MEM_F_NO_MULTI
        elif c == "S":
            opt.flag |= MEM_F_NO_RESCUE
        elif c == "e":
            opt.flag |= MEM_F_NO_EXACT
        elif c == "c":
            opt.max_occ = int(val)
        elif c == "d":
            opt.zdrop = int(val)
            opt._explicit.add("zdrop")
        elif c == "v":
            verbose = int(val)
        elif c == "r":
            opt.split_factor = float(val)
        elif c == "D":
            opt.chain_drop_ratio = float(val)
        elif c == "m":
            opt.max_matesw = int(val)
        elif c == "s":
            opt.split_width = int(val)
        elif c == "C":
            copy_comment = True
        elif c == "Q":
            opt.mapQ_coef_len = int(val)
            opt.mapQ_coef_fac = (math.log(opt.mapQ_coef_len)
                                 if opt.mapQ_coef_len > 0 else 0)
        elif c == "O":
            opt._explicit.update(("o_del", "o_ins"))
            parts = val.replace(",", " ").split()
            opt.o_del = opt.o_ins = int(parts[0])
            if len(parts) > 1:
                opt.o_ins = int(parts[1])
        elif c == "E":
            opt._explicit.update(("e_del", "e_ins"))
            parts = val.replace(",", " ").split()
            opt.e_del = opt.e_ins = int(parts[0])
            if len(parts) > 1:
                opt.e_ins = int(parts[1])
        elif c == "L":
            opt._explicit.update(("pen_clip5", "pen_clip3"))
            parts = val.replace(",", " ").split()
            opt.pen_clip5 = opt.pen_clip3 = int(parts[0])
            if len(parts) > 1:
                opt.pen_clip3 = int(parts[1])
        elif c == "R":
            rg_line, rg_id = set_rg(val)
            if rg_line is None:
                return 1
        elif c == "I":
            parts = val.replace(",", " ").split()
            p1 = pe.PeStat(failed=0)
            p1.avg = float(parts[0])
            p1.std = p1.avg * .1 if len(parts) < 2 else float(parts[1])
            p1.high = int(p1.avg + 4.0 * p1.std + .499)
            p1.low = max(1, int(p1.avg - 4.0 * p1.std + .499))
            if len(parts) > 2:
                p1.high = int(float(parts[2]) + .499)
            if len(parts) > 3:
                p1.low = int(float(parts[3]) + .499)
            pes0 = [pe.PeStat(failed=1), p1, pe.PeStat(failed=1),
                    pe.PeStat(failed=1)]
            if verbose >= 3:
                sys.stderr.write(
                    "[M::main_mem] mean insert size: %.3f, stddev: %.3f, "
                    "max: %d, min: %d\n" % (p1.avg, p1.std, p1.high, p1.low))
        elif c == "engine":
            engine_kind = val
        elif c == "mesh":
            mesh_spec = val
        elif c == "shard-tables":
            # capacity mode: row-shard the occ/SA tables over the
            # --mesh axis (gathers become collectives, ops/fm.py)
            os.environ["BWAMEM_TPU_SHARD_TABLES"] = "1"
        elif c == "shard":  # i/n: process chunks i, i+n, ... of the input
            parts = val.split("/")
            shard_spec = (int(parts[0]), int(parts[1]))
        elif c == "distributed":  # coord_addr,num_processes,process_id
            parts = val.split(",")
            dist_spec = (parts[0], int(parts[1]), int(parts[2]))
        elif c == "profile":
            profile_dir = val
        elif c == "H":
            pass
        else:
            return 1

    if len(args) < 2 or len(args) > 3:
        sys.stderr.write("Usage: bwa mem [options] <idxbase> <in1.fq>"
                         " [in2.fq]\n")
        return 1
    opt.rescale_for_a()
    opt.mat = fill_scmat(opt.a, opt.b)

    fm, bns = load_index(args[0])
    pac = bns.pac

    # fork the -t worker pool before the device client exists (children
    # share the index copy-on-write and never touch jax; core/mt.py)
    pool = None
    if opt.n_threads > 1:
        from .core.mt import WorkerPool
        pool = WorkerPool(fm, bns, pac, opt.n_threads,
                          index_prefix=args[0])

    if dist_spec is not None:
        # multi-host pod slice: jax.distributed rendezvous before any
        # backend init; --shard defaults to this process's stripe
        from .parallel import multihost
        multihost.initialize(dist_spec[0], dist_spec[1], dist_spec[2])
        if shard_spec is None:
            shard_spec = (dist_spec[2], dist_spec[1])
        sys.stderr.write("[M::main_mem] distributed: process %d of %d\n"
                         % (dist_spec[2], dist_spec[1]))

    engine = None
    if engine_kind not in ("auto", "jax", "host"):
        sys.stderr.write(f"[E::main_mem] unknown --engine '{engine_kind}' "
                         f"(expected auto|jax|host)\n")
        return 1
    if engine_kind == "auto":
        engine_kind = auto_engine()
    if engine_kind == "jax":
        from .ops.engine import JaxSeedingEngine
        mesh = None
        if mesh_spec:  # --mesh N|auto: data-parallel over cards
            import jax
            from .parallel.mesh import make_mesh
            n_dev = (len(jax.devices()) if mesh_spec == "auto"
                     else int(mesh_spec))
            if n_dev > 1:
                mesh = make_mesh(n_dev)
                sys.stderr.write("[M::main_mem] reads mesh over %d "
                                 "devices\n" % n_dev)
        engine = JaxSeedingEngine(fm, mesh=mesh)

    reader = make_chunk_reader(args[1],
                               args[2] if len(args) > 2 else None)
    if len(args) > 2 and not (opt.flag & MEM_F_PE):
        opt.flag |= MEM_F_PE

    out = sys.stdout
    out.write(sam_header(bns, rg_line,
                         "@PG\tID:bwa\tPN:bwa\tVN:%s\tCL:%s" % (
                             PACKAGE_VERSION, " ".join(["bwa", "mem"] + argv))))
    n_processed = 0
    import bwamem_tpu.core.pipeline as pl
    prof = None
    if profile_dir:  # jax.profiler trace (SURVEY.md §5 tracing analog)
        import jax.profiler
        prof = jax.profiler.trace(profile_dir)
        prof.__enter__()
    def chunk_iter():
        # --shard i/n: this process owns chunks i, i+n, i+2n, ... of
        # the input stream (multi-host data parallelism; output is
        # shard-local and deterministic — the per-shard n_processed
        # numbering keys the hash tie-breaks, SURVEY.md §3.5)
        import os as _o
        chunk_bp = int(_o.environ.get("BWAMEM_TPU_CHUNK_BP", "0")) \
            or opt.chunk_size * opt.n_threads
        chunk_no = -1
        while True:
            reads = reader.read_chunk(chunk_bp)
            if not reads:
                return
            chunk_no += 1
            if shard_spec is not None \
                    and chunk_no % shard_spec[1] != shard_spec[0]:
                continue
            if (opt.flag & MEM_F_PE) and len(reads) % 2 == 1:
                if verbose >= 2:
                    sys.stderr.write("[W::main_mem] odd number of reads in"
                                     " the PE mode; last read dropped\n")
                reads = reads[:-1]
                if not reads:
                    return
            if not copy_comment:
                for r in reads:
                    r.comment = None
            yield reads

    def on_start(reads):
        if verbose >= 3:
            sys.stderr.write("[M::main_mem] read %d sequences (%d bp)...\n"
                             % (len(reads), sum(r.l_seq for r in reads)))

    def emit(reads):
        for r in reads:
            out.write(r.sam)

    n_processed = pl.process_chunk_stream(
        opt, fm, bns, pac, chunk_iter(), pes0, rg_id or "", engine,
        verbose, pool=pool, n_processed=n_processed,
        on_start=on_start, emit=emit)
    if pool is not None:
        pool.close()
    if prof is not None:
        prof.__exit__(None, None, None)
    if engine is not None and verbose >= 3:
        # the reference manager's shutdown line
        # ("total kernel time", software/fastmap.c:427)
        sys.stderr.write("[M::main_mem] total device kernel time %fs over"
                         " %d dispatches\n" % (engine.kernel_time,
                                               engine.n_dispatches))
    return 0


def main_fa2pac(argv):
    """fa2pac command (software/bntseq.c:297-314): FASTA -> .pac/.ann/.amb,
    both-strand pack by default, forward-only with -f."""
    import getopt as _getopt
    from .index.bntseq import fasta2bntseq, dump_pac, dump_ann_amb
    opts, args = _getopt.getopt(argv, "f")
    for_only = any(c == "-f" for c, _ in opts)
    if not args:
        sys.stderr.write("Usage: bwa fa2pac [-f] <in.fasta> [<out.prefix>]\n")
        return 1
    prefix = args[1] if len(args) > 1 else args[0]
    bns, pac = fasta2bntseq(args[0], for_only=for_only)
    dump_ann_amb(bns, prefix)
    dump_pac(pac, bns.l_pac, prefix + ".pac")
    return 0


def main_pac2bwt(argv):
    """pac2bwt command (software/bwtindex.c:62-124): .pac -> raw .bwt
    (no occ interleaving; bwtupdate required before use).  The -d
    (libdivsufsort) flag is accepted; our SA-IS builder covers both."""
    import getopt as _getopt
    import numpy as np
    from .index.bntseq import load_pac, unpack_bases
    from .index.fmindex import FmIndex
    from .index.suffix_array import suffix_array
    opts, args = _getopt.getopt(argv, "d")
    if len(args) < 2:
        sys.stderr.write("Usage: bwa pac2bwt [-d] <in.pac> <out.bwt>\n")
        return 1
    pac, l_pac = load_pac(args[0])
    bases = unpack_bases(pac, l_pac)
    fm = FmIndex()
    fm.seq_len = int(l_pac)
    counts = np.bincount(bases, minlength=4)
    fm.L2 = np.zeros(5, dtype=np.int64)
    fm.L2[1:] = np.cumsum(counts)
    sa_full = suffix_array(bases)
    fm.primary = int(np.nonzero(sa_full == 0)[0][0])
    nz = np.concatenate((sa_full[:fm.primary], sa_full[fm.primary + 1:]))
    bwt_str = bases[nz - 1]
    # raw 2-bit pack, 16 bases/word MSB-first (bwtindex.c:99-101)
    n_words = (l_pac + 15) >> 4
    padded = np.zeros(n_words << 4, dtype=np.uint32)
    padded[:l_pac] = bwt_str
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    fm.bwt = (padded.reshape(-1, 16) << shifts[None, :]).sum(
        axis=1, dtype=np.uint32)
    fm.dump_bwt(args[1])
    return 0


def main_bwtupdate(argv):
    """bwtupdate command (software/bwtindex.c:128-164): interleave occ
    checkpoints into a raw .bwt, in place."""
    import numpy as np
    from .index.fmindex import FmIndex, interleave_occ
    if len(argv) < 1:
        sys.stderr.write("Usage: bwa bwtupdate <the.bwt>\n")
        return 1
    fm = FmIndex.restore(argv[0])
    n_words = (fm.seq_len + 15) >> 4
    words = fm.bwt[:n_words]
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    bwt_str = ((words[:, None] >> shifts[None, :]) & 3).astype(
        np.uint8).reshape(-1)[:fm.seq_len]
    fm.bwt = interleave_occ(bwt_str, fm.seq_len)
    fm.dump_bwt(argv[0])
    return 0


def main_bwt2sa(argv):
    """bwt2sa command (software/bwtindex.c:166-185): compute the sampled
    suffix array from an occ-interleaved .bwt by walking inverse Psi
    (bwt_cal_sa, software/bwt.c:80-102)."""
    import getopt as _getopt
    import numpy as np
    from .index.fmindex import FmIndex
    opts, args = _getopt.getopt(argv, "i:")
    sa_intv = 32
    for c, v in opts:
        if c == "-i":
            sa_intv = int(v)
    if len(args) < 2:
        sys.stderr.write("Usage: bwa bwt2sa [-i 32] <in.bwt> <out.sa>\n")
        return 1
    fm = FmIndex.restore(args[0])
    n_sa = (fm.seq_len + sa_intv) // sa_intv
    fm.sa_intv = sa_intv
    fm.sa = np.zeros(n_sa, dtype=np.int64)
    isa, sa_val = 0, fm.seq_len
    for _ in range(fm.seq_len):
        if isa % sa_intv == 0:
            fm.sa[isa // sa_intv] = sa_val
        sa_val -= 1
        isa = fm.inv_psi(isa)
    if isa % sa_intv == 0:
        fm.sa[isa // sa_intv] = sa_val
    fm.sa[0] = -1
    fm.dump_sa(args[1])
    return 0


def main_index(argv):
    import getopt as _getopt
    from .index import build_index
    prefix = None
    opts, args = _getopt.getopt(argv, "6a:p:")
    for c, val in opts:
        if c == "-p":
            prefix = val
    if not args:
        sys.stderr.write("Usage: bwa index [-p prefix] <in.fasta>\n")
        return 1
    build_index(args[0], prefix or args[0])
    return 0


def main_fastmap(argv):
    import getopt as _getopt
    from .index import load_index
    from .io.fastq import parse_fastx
    from .core.fastmap import run_fastmap
    min_iwidth, min_len, split_width, print_seq = 20, 17, 0, False
    opts, args = _getopt.getopt(argv, "w:l:ps:")
    for c, val in opts:
        if c == "-s":
            split_width = int(val)
        elif c == "-p":
            print_seq = True
        elif c == "-w":
            min_iwidth = int(val)
        elif c == "-l":
            min_len = int(val)
    if len(args) < 2:
        sys.stderr.write("Usage: bwa fastmap [-p] [-s splitWidth] [-l minLen]"
                         " [-w maxSaSize] <idxbase> <in.fq>\n")
        return 1
    fm, bns = load_index(args[0])
    reads = ((r.name, r.seq, r.qual) for r in parse_fastx(args[1]))
    run_fastmap(fm, bns, reads, sys.stdout, min_iwidth, min_len,
                split_width, print_seq)
    return 0


def main_pemerge(argv):
    from .core.pemerge import main_pemerge as _pm
    return _pm(argv)


def main_aln(argv):
    from .legacy.aln_cli import main_aln as _aln
    return _aln(argv)


def main_samse(argv):
    from .legacy.samse import main_samse as _se
    return _se(argv)


def main_sampe(argv):
    from .legacy.sampe import main_sampe as _pe
    return _pe(argv)


def main_bwasw(argv):
    from .legacy.bwasw import main_bwasw as _sw
    return _sw(argv)


def auto_engine() -> str:
    """`--engine auto`: the device engine when JAX's backend is an
    accelerator, the host oracle engine on the CPU backend (tests,
    hosts without a card).  Engine errors are never swallowed."""
    import jax
    return "host" if jax.default_backend() == "cpu" else "jax"


def main(argv=None):
    import time
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        return _usage()
    t_real = time.perf_counter()
    cmd, rest = argv[0], argv[1:]
    dispatch = {
        "index": main_index,
        "mem": main_mem,
        "fastmap": main_fastmap,
        "fa2pac": main_fa2pac,
        "pac2bwt": main_pac2bwt,
        "pac2bwtgen": main_pac2bwt,  # same artifact; our SA-IS covers both
        "bwtupdate": main_bwtupdate,
        "bwt2sa": main_bwt2sa,
        "pemerge": main_pemerge,
        "aln": main_aln,
        "samse": main_samse,
        "sampe": main_sampe,
        "bwasw": main_bwasw,
        "bwtsw2": main_bwasw,
        "dbwtsw": main_bwasw,
    }
    if cmd not in dispatch:
        sys.stderr.write(f"[main] unrecognized command '{cmd}'\n")
        return 1
    ret = dispatch[cmd](rest)
    sys.stdout.flush()
    if ret == 0:
        sys.stderr.write("[main] Version: %s\n" % PACKAGE_VERSION)
        sys.stderr.write("[main] CMD: bwa %s\n" % " ".join(argv))
        sys.stderr.write("[main] Real time: %.3f sec\n"
                         % (time.perf_counter() - t_real))
    return ret


if __name__ == "__main__":
    sys.exit(main())
