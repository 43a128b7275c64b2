"""Multi-process worker pool: the analog of the reference's
kt_for worker threads (software/kthread.c:34-64, software/bwamem.c:1576,
1604-1639).

The reference parallelizes the per-read CPU stages (seeding fallback,
chain filtering, extension bookkeeping, SAM formatting) across -t
pthreads while the FPGA handles batched seeding.  Python threads can't
do that (GIL), so the pool forks worker *processes* before the device
client exists: the index (fm/bns/pac, hundreds of MB at scale) is
shared copy-on-write through fork, and only the per-read work units
travel through pickles.

Thread semantics match the reference exactly: workers split work
*within* one chunk (pestat still sees the whole chunk, so output is
byte-identical for every -t), and shard results are re-assembled in
read order.

IMPORTANT: the pool must be created before any jax/device call in the
parent — forked children inherit no live device client and never touch
jax (the host oracle path is pure numpy).
"""

import os
import sys
from typing import List, Optional, Sequence

# worker-side globals, populated by fork inheritance
_G = {}


class WorkerPool:
    """Fork-based pool over the host-side per-read pipeline stages."""

    def __init__(self, fm, bns, pac, n_workers: int,
                 method: str = None, index_prefix: str = None):
        import multiprocessing as mp
        if method is None:
            # prefer spawn once jax is imported AND the index can be
            # disk-reloaded: jax's runtime threads make os.fork a
            # documented deadlock risk (popen_fork RuntimeWarning);
            # fork stays the default only for the jax-free in-memory
            # case, where it is both safe and cheapest (COW index).
            default = "fork"
            if index_prefix is not None and "jax" in sys.modules:
                default = "spawn"
            method = os.environ.get("BWAMEM_TPU_POOL_METHOD", default)
        self.n = max(int(n_workers), 1)
        if method == "spawn":
            # With index_prefix, workers re-load the index from disk (OS
            # page cache shares the bytes) instead of receiving a
            # GB-scale pickle; workers pin JAX_PLATFORMS=cpu so any
            # accidental jax import never opens the card (one process
            # per card).
            ctx = mp.get_context("spawn")
            if index_prefix is not None:
                # ship cheap invariants so a worker that loads on-disk
                # artifacts diverging from the parent's in-memory index
                # (rebuilt in memory, stale dump) fails loudly instead
                # of silently producing different output
                inv = (int(fm.primary), int(fm.seq_len), int(bns.l_pac))
                self._pool = ctx.Pool(self.n, initializer=_init_spawn_load,
                                      initargs=(index_prefix, inv))
            else:
                self._pool = ctx.Pool(self.n, initializer=_init_spawn,
                                      initargs=(fm, bns, pac))
        else:
            _G["fm"], _G["bns"], _G["pac"] = fm, bns, pac
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(self.n)

    def close(self):
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None

    def _shards(self, n_items: int) -> List[range]:
        # contiguous shards, a few per worker for load balance
        per = max(1, (n_items + self.n * 4 - 1) // (self.n * 4))
        return [range(lo, min(lo + per, n_items))
                for lo in range(0, n_items, per)]

    # ---- stage runners -------------------------------------------------

    def align_regs(self, opt, reads) -> List[list]:
        """align1_core for every read (host oracle seeding + SW) — the
        engine-less SE/PE stage-1 (software/bwamem.c:1576)."""
        jobs = [(opt, list(rng), [reads[i] for i in rng])
                for rng in self._shards(len(reads))]
        out: List[list] = [None] * len(reads)
        for idxs, regs in self._pool.imap(_w_align, jobs):
            for i, rg in zip(idxs, regs):
                out[i] = rg
        return out

    def finalize_se(self, opt, reads, regs, ids: Sequence[int],
                    rg_id: str) -> None:
        """mark_primary + mem_reg2sam_se for every read on worker
        processes (host SW); writes read.sam in order
        (software/bwamem.c:1604-1618)."""
        jobs = [(opt, list(rng), [reads[i] for i in rng],
                 [regs[i] for i in rng], [ids[i] for i in rng], rg_id)
                for rng in self._shards(len(reads))]
        for idxs, sams in self._pool.imap(_w_fin_se, jobs):
            for i, s in zip(idxs, sams):
                reads[i].sam = s

    def finalize_pe(self, opt, pes, reads, regs, n_processed: int,
                    rg_id: str) -> None:
        """mem_sam_pe for every pair on worker processes
        (software/bwamem.c:1619-1639); pes comes from the whole chunk."""
        n_pairs = len(reads) >> 1
        jobs = []
        for rng in self._shards(n_pairs):
            pr = [(reads[i << 1], reads[i << 1 | 1]) for i in rng]
            rr = [(regs[i << 1], regs[i << 1 | 1]) for i in rng]
            jobs.append((opt, list(rng), pr, rr, pes,
                         n_processed, rg_id))
        for idxs, sams in self._pool.imap(_w_fin_pe, jobs):
            for i, (s1, s2) in zip(idxs, sams):
                reads[i << 1].sam = s1
                reads[i << 1 | 1].sam = s2


def _init_spawn(fm, bns, pac):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _G["fm"], _G["bns"], _G["pac"] = fm, bns, pac


def _init_spawn_load(index_prefix, invariants=None):
    """Spawn initializer that avoids pickling the index: each worker
    re-loads the artifacts from disk (bwa_idx_load analog); repeated
    loads share pages through the OS cache, so at GB index scale
    startup is I/O-bound once instead of pickle-bound per worker.
    load_sa8=False: the dense-SA sidecar is device-only (ops.fm) and
    these workers are host-only — skipping it saves ~1 GB/Gbp of RSS
    per worker."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from ..index import load_index
    fm, bns = load_index(index_prefix, load_sa8=False)
    if invariants is not None:
        got = (int(fm.primary), int(fm.seq_len), int(bns.l_pac))
        assert got == tuple(invariants), (
            f"worker-loaded index at {index_prefix!r} diverges from the "
            f"parent's in-memory index: {got} != {tuple(invariants)}")
    _G["fm"], _G["bns"], _G["pac"] = fm, bns, bns.pac


def _w_align(job):
    opt, idxs, reads = job
    from .pipeline import align1_core
    fm, bns, pac = _G["fm"], _G["bns"], _G["pac"]
    return idxs, [align1_core(opt, fm, bns, pac, r) for r in reads]


def _w_fin_se(job):
    opt, idxs, reads, regs, ids, rg_id = job
    bns, pac = _G["bns"], _G["pac"]
    # the shard's ids are contiguous (see _shards), so the whole shard
    # finalizes in one native call when the library is available
    try:
        from .nfinalize import finalize_se_native
        native_ok = finalize_se_native(opt, bns, reads, regs, ids[0],
                                       rg_id)
    except Exception:
        native_ok = False
    if not native_ok:
        from .pipeline import reg2sam_se
        from .region import mark_primary
        for r, rg, rid in zip(reads, regs, ids):
            mark_primary(opt, rg, rid)
            reg2sam_se(opt, bns, pac, r, rg, 0, None, rg_id)
    return idxs, [r.sam for r in reads]


def _w_fin_pe(job):
    opt, idxs, pairs, regpairs, pes, n_processed, rg_id = job
    bns, pac = _G["bns"], _G["pac"]
    flat_reads = [r for pr in pairs for r in pr]
    flat_regs = [g for rr in regpairs for g in rr]
    try:
        from .nfinalize import finalize_pe_native
        # pair ids are (n_processed>>1)+i with contiguous shard i's
        native_ok = finalize_pe_native(
            opt, bns, pes, flat_reads, flat_regs,
            (((n_processed >> 1) + idxs[0]) << 1), rg_id)
    except Exception:
        native_ok = False
    if not native_ok:
        from .swdrive import drive_host
        from . import pair as pe
        for i, pr, rr in zip(idxs, pairs, regpairs):
            g = pe.sam_pe_gen(opt, bns, pac, pes, (n_processed >> 1) + i,
                              pr, rr, rg_id)
            drive_host(g, opt)
    return idxs, [(pr[0].sam, pr[1].sam) for pr in pairs]
