"""Multi-chip scale-out: data-parallel read sharding over a device mesh.

The reference's parallelism is N CPU worker threads multiplexing one
FPGA through a manager-thread mailbox (software/fastmap.c:320-429,
kthread_batch.c).  The device replacement (SURVEY.md §2.4) is a
1-D `reads` mesh: the FM-index tables are replicated per card (the
analog of the one-time 3 GB SPL_BWT_ref upload, software/bwa.c:286-301),
read batches are sharded across cards, and the only cross-card
communication in the whole pipeline is the insert-size-statistics
reduction between worker1 and worker2 (mem_pestat over the whole chunk,
software/bwamem.c:1631-1634) — expressed as a psum over per-shard
orientation histograms.
"""

from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.fm import DeviceFmIndex
from ..ops import smem as smem_mod
from ..ops import fm as fm_mod

READS_AXIS = "reads"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (READS_AXIS,))


def sharded_smem1(mesh: Mesh, dfm: DeviceFmIndex, L: int, M: int):
    """smem1_batched sharded over the reads axis: index replicated,
    per-read arrays split across chips.  Returns a jitted callable with
    the same signature as smem1_batched minus the index args."""
    rep = P()
    shr = P(READS_AXIS)

    def step(blocks, primary, L2, q, qlen, x, min_intv, active):
        return smem_mod.smem1_batched(blocks, primary, L2, q, qlen, x,
                                      min_intv, active, L=L, M=M)

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(rep, rep, rep, shr, shr, shr, shr, shr),
        out_specs=(shr,) * 8,
        check_vma=False)

    @jax.jit
    def run(q, qlen, x, min_intv, active):
        return fn(dfm.blocks, dfm.primary, dfm.L2, q, qlen, x,
                  min_intv, active)

    return run


def sharded_sa_lookup(mesh: Mesh, dfm: DeviceFmIndex, max_steps: int = 128):
    """Batched bwt_sa sharded over the reads axis."""
    rep = P()
    shr = P(READS_AXIS)

    def step(blocks, primary, L2, seq_len, sa, k):
        return fm_mod.sa_lookup_batched(blocks, primary, L2, seq_len, sa,
                                        dfm.sa_intv, k,
                                        max_steps=max_steps)

    fn = shard_map(step, mesh=mesh,
                   in_specs=(rep, rep, rep, rep, rep, shr),
                   out_specs=(shr, shr), check_vma=False)

    @jax.jit
    def run(k):
        return fn(dfm.blocks, dfm.primary, dfm.L2, dfm.seq_len, dfm.sa, k)

    return run


def pestat_histograms(mesh: Mesh):
    """The one true collective of the pipeline: reduce per-shard
    insert-size observations (per FF/FR/RF/RR orientation) across chips
    before the pairing stage (mem_pestat, software/bwamem_pair.c:46-107
    runs over the *whole* chunk).

    Takes isize int64[B] and orientation int32[B] (−1 = no observation),
    both sharded over reads; returns, replicated, per-orientation counts
    and a bounded histogram of insert sizes for percentile estimation."""
    MAX_ISIZE = 65536  # observations beyond this are clamped into the tail

    def local(isize, orient):
        valid = orient >= 0
        o = jnp.where(valid, orient, 0)
        v = jnp.clip(jnp.where(valid, isize, 0), 0, MAX_ISIZE - 1)
        hist = jnp.zeros((4, MAX_ISIZE), jnp.int32)
        hist = hist.at[o, v].add(valid.astype(jnp.int32))
        counts = jnp.zeros((4,), jnp.int64).at[o].add(
            valid.astype(jnp.int64))
        hist = jax.lax.psum(hist, READS_AXIS)
        counts = jax.lax.psum(counts, READS_AXIS)
        return counts, hist

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(READS_AXIS), P(READS_AXIS)),
                   out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)


class ShardedKernels:
    """Data-parallel (reads-axis) shard_map wrappers for every device
    entry point the mem engine dispatches: the fused SMEM superstep, the
    batched SA lookup, and the three SW waves.  Index tables are
    replicated per chip (the SPL_BWT_ref analog); every per-lane array
    is split across the mesh.  Engine lane widths (LANES/WAVE_*) must be
    divisible by the mesh size — shapes are fixed per process, so this
    is checked once at construction.

    The engine built with `mesh=` runs the whole pipeline data-parallel
    with byte-identical output (reference parallelism mapping,
    SURVEY.md §2.4); on one chip the wrappers are never constructed.

    With `shard_tables=True` the occ-block table and the sampled SA are
    additionally ROW-SHARDED over the same mesh axis (for genomes whose
    tables exceed one card's memory — the analog of the reference keeping
    the 3 GB BWT in host DRAM and fetching blocks per-step over CCI-P,
    SURVEY.md §2.4); every table gather inside the seeding/SA kernels
    then runs as all_gather(indices) -> local gather -> psum_scatter
    (ops/fm.py table_axis), byte-identical to the replicated path."""

    def __init__(self, mesh: Mesh, shard_tables: bool = False):
        self.mesh = mesh
        self.n = mesh.devices.size
        self.shard_tables = shard_tables
        self._cache = {}

    def _wrap(self, key, fn, n_rep: int, n_dyn: int, n_out: int,
              static_kw, rep_specs=None):
        """shard_map fn with the first n_rep args replicated and the
        next n_dyn sharded on the reads axis; all outputs sharded.
        rep_specs overrides the specs of the first n_rep args (used by
        the table-sharded mode); table-touching kernels then trace
        under the fm.table_axis context."""
        ck = (key, tuple(sorted(static_kw.items())))
        got = self._cache.get(ck)
        if got is not None:
            return got
        rep, shr = P(), P(READS_AXIS)
        table_sharded = rep_specs is not None

        def body(*args):
            if table_sharded:
                with fm_mod.table_axis(READS_AXIS):
                    return fn(*args, **static_kw)
            return fn(*args, **static_kw)

        wrapped = jax.jit(shard_map(
            body, mesh=self.mesh,
            in_specs=(tuple(rep_specs) if rep_specs is not None
                      else (rep,) * n_rep) + (shr,) * n_dyn,
            out_specs=(shr,) * n_out, check_vma=False))
        self._cache[ck] = wrapped
        return wrapped

    def superstep(self, blocks, primary, L2, q, qlen, mi, active, slens,
                  swid, *, L, M, OUT_CAP, NEED_X1):
        from ..ops.smem import smem_superstep
        rs = (P(READS_AXIS, None), P(), P()) if self.shard_tables else None
        fn = self._wrap("superstep", smem_superstep.__wrapped__, 3, 6, 7,
                        dict(L=L, M=M, OUT_CAP=OUT_CAP, NEED_X1=NEED_X1),
                        rep_specs=rs)
        return fn(blocks, primary, L2, q, qlen, mi, active, slens, swid)

    def sa_lookup(self, blocks, primary, L2, seq_len, sa, sa_intv, k, *,
                  max_steps):
        from ..ops.fm import sa_lookup_batched

        def body(b, p, l2, s, kk, **kw):
            # seq_len/sa_intv are captured constants; the matching keys
            # in the static dict exist only for cache identity
            kw.pop("_seq_len")
            kw.pop("_intv")
            return sa_lookup_batched.__wrapped__(
                b, p, l2, seq_len, s, sa_intv, kk, **kw)

        rs = (P(READS_AXIS, None), P(), P(), P(READS_AXIS)) \
            if self.shard_tables else None
        fn = self._wrap("sa", body, 4, 1, 2,
                        dict(max_steps=max_steps,
                             _seq_len=int(seq_len), _intv=int(sa_intv)),
                        rep_specs=rs)
        return fn(blocks, primary, L2, sa, k)

    def extend_lr(self, *args, **static_kw):
        from ..ops.ksw import ksw_extend_lr_batched
        # signature: (lq, lt, llq, llt, rq, rt, rlq, rlt, mat,
        #             o_del..zdrop statics.., scs, sqb, srb, rm0, lqv,
        #             slv, LQ=, LT=, packed=)
        dyn_a = args[:8]
        mat = args[8]
        scal = args[9:17]   # o_del e_del o_ins e_ins w pc5 pc3 zdrop
        dyn_b = args[17:]
        st = dict(static_kw)
        st["_scal"] = tuple(int(x) for x in scal)

        def body(m, *arr, **kw):
            kw2 = dict(kw)
            sc = kw2.pop("_scal")
            return ksw_extend_lr_batched.__wrapped__(
                *arr[:8], m, *sc, *arr[8:], **kw2)

        fn = self._wrap("extlr", body, 1, len(dyn_a) + len(dyn_b),
                        8, st)
        return fn(mat, *dyn_a, *dyn_b)

    def extend2(self, qs, ts, qlen, tlen, mat, o_del, e_del, o_ins,
                e_ins, wv, ebv, zdrop, h0v, *, LQ, LT, packed):
        from ..ops.ksw import ksw_extend2_batched

        def body(m, q, t, ql, tl, w_, eb, h0, **kw):
            sc = kw.pop("_scal")
            return ksw_extend2_batched.__wrapped__(
                q, t, ql, tl, m, sc[0], sc[1], sc[2], sc[3], w_, eb,
                sc[4], h0, **kw)

        fn = self._wrap("ext2", body, 1, 7, 6,
                        dict(LQ=LQ, LT=LT, packed=packed,
                             _scal=(int(o_del), int(e_del), int(o_ins),
                                    int(e_ins), int(zdrop))))
        return fn(mat, qs, ts, qlen, tlen, wv, ebv, h0v)

    def global2(self, qs, ts, qlen, tlen, mat, o_del, e_del, o_ins,
                e_ins, wv, *, LQ, LT, packed):
        from ..ops.ksw import ksw_global2_batched

        def body(m, q, t, ql, tl, w_, **kw):
            sc = kw.pop("_scal")
            return ksw_global2_batched.__wrapped__(
                q, t, ql, tl, m, sc[0], sc[1], sc[2], sc[3], w_, **kw)

        fn = self._wrap("glo2", body, 1, 5, 5,
                        dict(LQ=LQ, LT=LT, packed=packed,
                             _scal=(int(o_del), int(e_del), int(o_ins),
                                    int(e_ins))))
        return fn(mat, qs, ts, qlen, tlen, wv)


def pad_to_shards(arr: np.ndarray, n_shards: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of the shard count."""
    n = arr.shape[0]
    rem = (-n) % n_shards
    if rem == 0:
        return arr
    pad = np.full((rem,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
