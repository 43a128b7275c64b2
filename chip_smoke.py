#!/usr/bin/env python3
"""Smoke test of `bwa mem` on an NVIDIA GPU, through the normal entry
point (`bwamem_tpu.cli mem --engine jax`), in one process.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # mem --mesh 4 against one card
    python chip_smoke.py --mbp 64        # a smaller generated genome

One card, two genomes:
  * the bundled 105 kbp genome (tests/data): SE, SE -a -M and PE, each
    byte-compared with the golden SAMs (the @PG line filtered);
  * a 256 Mbp i.i.d. genome generated from a fixed seed and indexed
    with `cli index` into .bigdata/ (reused when present): 2,000 SE
    reads and 1,000 pairs with -M -a, byte-compared with --engine host;
    then 20,000 SE reads and 10,000 pairs, on which `mem` runs end to end
    with each of the two superstep implementations in alternation.
On both genomes the GPU SMEM superstep kernel (ops.smem_gpu) is compared
with the XLA twin and the host oracle at the engine's lane width.

Prints per phase the byte identity, reads/s and the engine's host
fallback counters; the card's name and power limit on a line before
the last; and as its last line one JSON object naming the device.  Any
failed check exits non-zero.  Without a GPU it exits non-zero at once.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
BIG_SEED = 20261016
N_SE, N_PE = 2000, 1000          # parity reads (the reference's -M -a PE)
N_TIME_SE, N_TIME_PE = 20000, 10000   # kernel-vs-twin timing reads


def log(msg):
    print(msg, flush=True)


def fail(msg):
    sys.exit("[chip_smoke] FAILED: %s" % msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sam_body(text):
    return [ln for ln in text.split("\n") if not ln.startswith("@PG")]


def run_mem(args, engine="jax", smem_impl="auto"):
    """One `mem` run through cli.main; returns (SAM lines without @PG,
    wall seconds, the device engine it built or None)."""
    from bwamem_tpu import cli
    import bwamem_tpu.ops.engine as eng_mod
    base = eng_mod.JaxSeedingEngine
    made = []

    def factory(*a, **kw):
        e = base(*a, smem_impl=smem_impl, **kw)
        made.append(e)
        return e

    out, err = io.StringIO(), io.StringIO()
    eng_mod.JaxSeedingEngine = factory
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            rc = cli.main(["mem", "--engine", engine] + args)
            dt = time.perf_counter() - t0
    finally:
        eng_mod.JaxSeedingEngine = base
    if rc != 0:
        fail("mem %s exited %d: %s" % (args, rc, err.getvalue()[-2000:]))
    if "device engine unavailable" in err.getvalue():
        fail("mem %s fell back to the host engine" % args)
    if engine == "jax" and not made:
        fail("mem %s built no device engine" % args)
    return sam_body(out.getvalue()), dt, (made[-1] if made else None)


def counters(engine):
    """The engine's host-fallback counters (lanes, keys and reads the
    device handed back to the host oracle)."""
    if engine is None:
        return {}
    kt = engine.kernel_time_by_tag
    keys = ("host_routed_reads", "ovf_smem_lanes", "ovf_sa_keys",
            "ovf_keyexp_groups")
    return {k: int(kt.get(k, 0)) for k in keys}


def stage_seconds(engine):
    kt = engine.kernel_time_by_tag
    return {k: round(v, 4) for k, v in kt.items()
            if isinstance(v, float)}


def mem_phase(tag, args, n_reads, want, smem_impl="auto"):
    got, dt, eng = run_mem(args, smem_impl=smem_impl)
    if got != want:
        n_bad = sum(a != b for a, b in zip(got, want)) \
            + abs(len(got) - len(want))
        fail("%s: SAM differs from the reference in %d lines"
             % (tag, n_bad))
    log("[mem] %-28s byte-identical  %8.1f reads/s  (%.3f s)  "
        "fallbacks %s  device-wait s %s"
        % (tag, n_reads / dt, dt, counters(eng), stage_seconds(eng)))
    return dt, eng


def read_queries(path, n):
    from bwamem_tpu.io.fastq import ChunkReader
    from bwamem_tpu.core.pipeline import encode_read
    reads = ChunkReader(path).read_chunk(1 << 34)[:n]
    for r in reads:
        encode_read(r)
    return [r.seq_nt4 for r in reads]


def kernel_phase(tag, fm, queries, reps=5):
    """The superstep at the engine's lane width: the GPU kernel against
    the XLA twin (exact) and the host oracle (exact, clean lanes), and
    the time of each on the card."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops import seeding
    from bwamem_tpu.ops.fm import DeviceFmIndex
    from bwamem_tpu.ops.smem import smem_superstep
    opt = MemOptions()
    d = DeviceFmIndex.from_host(fm)
    B, L, M, OC = seeding.LANES, 128, 16, 48
    queries = queries[:B]
    sl = int(opt.min_seed_len * opt.split_factor + .499)
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    slens = np.zeros(B, np.int32)
    for i, qq in enumerate(queries):
        q[i, :len(qq)] = qq
        qlen[i], slens[i] = len(qq), min(sl, len(qq))
    act = np.zeros(B, bool)
    act[:len(queries)] = True
    qp = q[:, 0::2] | (q[:, 1::2] << np.int8(4))
    args = (d.blocks, d.primary, d.L2, jnp.asarray(qp), jnp.asarray(qlen),
            jnp.ones(B, d.L2.dtype), jnp.asarray(act), jnp.asarray(slens),
            jnp.full(B, opt.split_width, jnp.int32))
    res, times = {}, {}
    for impl in ("xla", "gpu"):
        fn = lambda: smem_superstep(*args, L=L, M=M, OUT_CAP=OC,
                                    NEED_X1=True, QPACKED=True, IMPL=impl)
        t0 = time.perf_counter()
        res[impl] = [np.asarray(a) for a in jax.block_until_ready(fn())]
        first = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        times[impl] = (first, sorted(ts)[len(ts) // 2], ts)
    x, k = res["xla"], res["gpu"]
    if not (x[6] == k[6]).all():
        fail("%s kernel: overflow flags differ from the XLA twin" % tag)
    n = np.where(x[6], 0, x[5].astype(np.int64))
    if not (n == np.where(k[6], 0, k[5].astype(np.int64))).all():
        fail("%s kernel: stream counts differ from the XLA twin" % tag)
    cols = np.arange(OC)[None, :] < n[:, None]
    for j, name in enumerate(("x0", "x1", "size", "qb", "qe")):
        if not (x[j][cols] == k[j][cols]).all():
            fail("%s kernel: %s differs from the XLA twin" % (tag, name))
    # host oracle: every clean lane's whole iterator stream
    sdr = seeding.BatchedSeeder(d, fm_host=fm)
    for i, qq in enumerate(queries):
        if k[6][i]:
            continue
        want = []
        sdr._oracle_finish(opt, qq, 0, 1, int(slens[i]), opt.split_width,
                           want)
        got = [(int(k[0][i, j]), int(k[1][i, j]), int(k[2][i, j]),
                (int(k[3][i, j]) << 32) | int(k[4][i, j]))
               for j in range(int(n[i]))]
        if got != [tuple(int(v) for v in p) for p in want]:
            fail("%s kernel: lane %d differs from the host oracle"
                 % (tag, i))
    log("[kernel] %s: %d lanes, %d intervals, %d overflow lanes; "
        "kernel == XLA twin == host oracle" % (
            tag, B, int(n.sum()), int(k[6].sum())))
    for impl, (first, med, ts) in times.items():
        log("[kernel] %s superstep %-3s first call %.3f s, median of %d "
            "%.3f ms  %s" % (tag, impl, first, reps, med * 1e3,
                             [round(t * 1e3, 3) for t in ts]))
    log("[kernel] %s superstep gpu kernel vs xla twin: %.2fx" % (
        tag, times["xla"][1] / times["gpu"][1]))


def big_dataset(mbp: int):
    """Generate (once) the i.i.d. genome, its index and two read sets:
    the parity reads in the genome's directory and the timing reads in
    its timing/ subdirectory."""
    d = os.path.join(REPO, ".bigdata", "g%dm_s%d" % (mbp, BIG_SEED))
    fa = os.path.join(d, "genome.fa")
    done = os.path.join(d, "done")
    if os.path.exists(done):
        log("[data] reusing %s" % d)
        return d
    os.makedirs(os.path.join(d, "timing"), exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_biggenome.py"),
                    d, "--mbp", str(mbp), "--n-se", "0",
                    "--seed", str(BIG_SEED), "--no-index"],
                   check=True, stdout=subprocess.DEVNULL)
    t1 = time.perf_counter()
    from bwamem_tpu import cli
    if cli.main(["index", fa]) != 0:
        fail("cli index failed")
    t2 = time.perf_counter()
    for out, n_se, n_pe, seed in ((d, N_SE, N_PE, BIG_SEED + 1),
                                  (os.path.join(d, "timing"), N_TIME_SE,
                                   N_TIME_PE, BIG_SEED + 2)):
        subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "sample_reads.py"),
                        fa, "--out", out, "--n-se", str(n_se),
                        "--n-pe", str(n_pe), "--seed", str(seed)],
                       check=True, stdout=subprocess.DEVNULL)
    open(done, "w").close()
    log("[data] %d Mbp genome %.1f s, cli index %.1f s (host), reads "
        "%.1f s" % (mbp, t1 - t0, t2 - t1, time.perf_counter() - t2))
    return d


def bundled_phase():
    from bwamem_tpu.index import load_index
    fa = os.path.join(DATA, "genome.fa")
    se = os.path.join(DATA, "reads_se.fq")
    r1, r2 = (os.path.join(DATA, "reads_%d.fq" % i) for i in (1, 2))
    gold = {k: sam_body(open(os.path.join(DATA, k)).read())
            for k in ("golden_se.sam", "golden_se_aM.sam",
                      "golden_pe.sam")}
    n_se = len(read_queries(se, 1 << 30))
    fm, _ = load_index(fa)
    kernel_phase("bundled", fm, read_queries(se, 1 << 30))
    mem_phase("bundled SE (compiles)", [fa, se], n_se,
              gold["golden_se.sam"])
    mem_phase("bundled SE -a -M", ["-a", "-M", fa, se], n_se,
              gold["golden_se_aM.sam"])
    mem_phase("bundled PE", [fa, r1, r2], 2 * n_se,
              gold["golden_pe.sam"])
    for impl in ("xla", "gpu", "xla", "gpu"):
        mem_phase("bundled SE, superstep %s" % impl, [fa, se], n_se,
                  gold["golden_se.sam"], smem_impl=impl)


def big_phase(mbp: int):
    from bwamem_tpu.index import load_index
    d = big_dataset(mbp)
    fa = os.path.join(d, "genome.fa")
    fm, _ = load_index(fa)
    log("[data] %d Mbp: occ table %d blocks (%.0f MB), coordinates %s"
        % (mbp, (int(fm.seq_len) + 127) >> 7,
           ((int(fm.seq_len) + 127) >> 7) * 64 / 1e6,
           "int32" if int(fm.seq_len) + 2 < (1 << 31) else "int64"))
    kernel_phase("%d Mbp" % mbp, fm,
                 read_queries(os.path.join(d, "reads_se.fq"), 1 << 30))
    del fm
    for rd, n_se, n_pe, timed in ((d, N_SE, N_PE, False),
                                  (os.path.join(d, "timing"), N_TIME_SE,
                                   N_TIME_PE, True)):
        se_args = [fa, os.path.join(rd, "reads_se.fq")]
        pe_args = ["-M", "-a", fa, os.path.join(rd, "reads_1.fq"),
                   os.path.join(rd, "reads_2.fq")]
        for tag, args, n in (("SE", se_args, n_se),
                             ("PE -M -a", pe_args, 2 * n_pe)):
            tag = "%d Mbp %s, %d reads" % (mbp, tag, n)
            t0 = time.perf_counter()
            want = run_mem(args, engine="host")[0]
            log("[mem] %s: host engine reference %.1f s"
                % (tag, time.perf_counter() - t0))
            if not timed:
                mem_phase(tag, args, n, want)
                continue
            # kernel vs XLA twin end to end: one cold run each, then
            # alternating warm pairs
            walls = {"gpu": [], "xla": []}
            for i, impl in enumerate(("gpu", "xla", "gpu", "xla", "xla",
                                      "gpu")):
                dt, _ = mem_phase("%s, superstep %s" % (tag, impl), args,
                                  n, want, smem_impl=impl)
                if i >= 2:
                    walls[impl].append(dt)
            g, x = sorted(walls["gpu"]), sorted(walls["xla"])
            log("[mem] %s: warm wall gpu kernel %s s, xla twin %s s; "
                "xla/gpu %.3f" % (tag, [round(t, 3) for t in walls["gpu"]],
                                  [round(t, 3) for t in walls["xla"]],
                                  (x[0] + x[1]) / (g[0] + g[1])))


def four_cards_phase(mbp: int):
    """`mem --mesh 4` on four cards, byte-compared with one card: the
    bundled genome (SE, PE; also against the golden SAMs), then the
    generated genome (SE, PE -M -a)."""
    fa = os.path.join(DATA, "genome.fa")
    se = os.path.join(DATA, "reads_se.fq")
    r1, r2 = (os.path.join(DATA, "reads_%d.fq" % i) for i in (1, 2))
    n = len(read_queries(se, 1 << 30))
    runs = [("bundled SE", [fa, se], n, "golden_se.sam"),
            ("bundled PE", [fa, r1, r2], 2 * n, "golden_pe.sam")]
    for tag, args, n_reads, gold in runs:
        one = mesh_pair(tag, args, n_reads)
        if one != sam_body(open(os.path.join(DATA, gold)).read()):
            fail("%s: one-card SAM differs from %s" % (tag, gold))
    d = big_dataset(mbp)
    fa = os.path.join(d, "genome.fa")
    r1, r2 = (os.path.join(d, "reads_%d.fq" % i) for i in (1, 2))
    mesh_pair("%d Mbp SE" % mbp, [fa, os.path.join(d, "reads_se.fq")],
              N_SE)
    mesh_pair("%d Mbp PE -M -a" % mbp, ["-M", "-a", fa, r1, r2], 2 * N_PE)


def mesh_pair(tag, args, n_reads):
    """One card, then --mesh 4, then each again (the first of each
    compiles); the SAMs must be identical.  Returns the one-card SAM."""
    one, t1, _ = run_mem(args)
    four, t4, eng = run_mem(["--mesh", "4"] + args)
    if eng.kernels is None:
        fail("--mesh 4 built no mesh")
    if four != one:
        fail("%s: --mesh 4 SAM differs from one card" % tag)
    _, w1, _ = run_mem(args)
    again, w4, _ = run_mem(["--mesh", "4"] + args)
    if again != one:
        fail("%s: --mesh 4 SAM differs from one card" % tag)
    log("[mesh] %-20s --mesh 4 byte-identical to one card; warm %.1f vs "
        "%.1f reads/s (4 cards vs 1), cold %.1f s vs %.1f s"
        % (tag, n_reads / w4, n_reads / w1, t4, t1))
    return one


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only mem --mesh 4 against one card")
    ap.add_argument("--mbp", type=int, default=256,
                    help="size of the generated genome (default 256)")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("[chip_smoke] no GPU: JAX's backend is %r"
                 % jax.default_backend())
    sys.path.insert(0, REPO)
    import bwamem_tpu  # noqa: F401  (fails outside a checkout)

    card = card_line()
    log("[card] %s" % card)
    log("[card] jax.devices(): %s" % jax.devices())
    t0 = time.perf_counter()
    if args.four_cards:
        if len(jax.devices()) != 4:
            fail("--four-cards needs 4 devices, found %d"
                 % len(jax.devices()))
        four_cards_phase(args.mbp)
    else:
        bundled_phase()
        big_phase(args.mbp)
    log("[done] all checks passed in %.1f s" % (time.perf_counter() - t0))
    dev = jax.devices()[0]
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
