"""Lock-step batched SMEM iteration and seed production.

Device re-design of the reference's batched seeding pipeline
(smem_next2_batched software/bwamem.c:110-241, mem_insert_seed_batched
software/bwamem.c:357-451): all live reads advance their SMEM iterator
in lock-step, each outer iteration issuing at most two batched smem1
dispatches (main pass + the long-unique-SMEM re-seed pass) to the device
— exactly the dispatch structure the reference sends to the FPGA, with
the per-read `done[]` masking replaced by lane masks.

The ordered main/sub merge and the iterator bookkeeping are scalar host
work on the (tiny) returned interval lists, matching the reference,
which also keeps them on the CPU (software/bwamem.c:185-238).

Seed reference positions come from one batched SA-lookup dispatch over
every occurrence of every kept interval (software/bwamem.c:420,
bwt_sa software/bwt.c:104-114); lanes whose inverse-Psi walk exceeds the
static step cap fall back to the host oracle — the reference's own
HW-caps/CPU-fallback pattern (software/bwt.c:603-717).
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from .fm import DeviceFmIndex, sa_lookup_batched

Intv = Tuple[int, int, int, int]  # (x0, x1, s, info=qb<<32|qe)


# Fixed lane counts: every dispatch pads to exactly one shape so the
# device pays ONE compile per kernel no matter the workload (padded
# lanes mask out and finish instantly).
import os as _os
LANES = int(_os.environ.get("BWAMEM_TPU_LANES", "512"))
SA_SLICE = int(_os.environ.get("BWAMEM_TPU_SA_SLICE", "16384"))
# below this many live lanes a seeding dispatch costs more than the
# scalar oracle; the straggler tail of each lane group runs on the host
MIN_SEED_WAVE = int(_os.environ.get("BWAMEM_TPU_MIN_SEED_WAVE", "32"))
# compact-wire slots per lane for the superstep fetch (0 disables):
# per-lane streams average ~7 intervals vs the OUT_CAP=48 buffer, so
# cross-lane compaction (ops.smem._compact_streams) cuts the fetch ~4x;
# lanes spilling past LANES*GCAP_PER go to the host oracle like any cap
# overflow
GCAP_PER = int(_os.environ.get("BWAMEM_TPU_GCAP_PER_LANE", "12"))
# fused superstep+SA dispatch (ops.smem.smem_superstep_sa): occurrence
# keys expand on device and the psi-walk runs in the same dispatch —
# one fetch returns intervals AND SA values (0 disables)
FUSE_SA = _os.environ.get("BWAMEM_TPU_FUSE_SA", "1") != "0"
KEY_CAP = int(_os.environ.get("BWAMEM_TPU_KEY_CAP", str(8 * LANES)))


class BatchedSeeder:
    """Produces, per read, the ordered interval stream the host
    SmemIterator would produce — computed by batched device kernels."""

    def __init__(self, dfm: DeviceFmIndex, max_len: int = 128,
                 sa_max_steps: int = 128, fm_host=None, m_out: int = None,
                 timer=None, kernels=None, smem_impl: str = "auto"):
        # `kernels`: parallel.mesh.ShardedKernels — when set, the
        # superstep and SA dispatches run shard_map'd over the reads
        # mesh (data-parallel multi-chip; index replicated per chip)
        self.kernels = kernels
        # ops.smem.smem_superstep IMPL: "auto" picks by backend
        self.smem_impl = smem_impl
        self.dfm = dfm
        self.L = int(max_len)
        # interval-buffer width: the backward pass costs O(M) occ
        # lookups per iteration, so M is sized from measured interval
        # counts (p99 = 11, max 13 on 101 bp reads); lanes that outgrow
        # it are flagged overflow and fall back to the host oracle (the
        # FPGA's fixed push_mem BRAM + CPU fallback,
        # hardware/afu_core.v:5946-5969, software/bwt.c:603-717)
        self.M = int(_os.environ.get("BWAMEM_TPU_SMEM_M", "16"))
        # transfer-width cap: measured n_mem p99 = 11 on 101 bp reads;
        # lanes with more SMEMs than M_OUT re-run on the host oracle
        if m_out is None:
            m_out = int(_os.environ.get("BWAMEM_TPU_SMEM_MOUT", "12"))
        self.m_out = min(int(m_out), self.M)
        self.sa_max_steps = int(sa_max_steps)
        self.fm_host = fm_host  # host oracle for overflow fallback
        self.timer = timer      # engine's kernel-time accounting
        # per-bucket stream caps: long-fragment (512 bp) reads emit
        # ~2x the intervals/occurrences of the classic buckets, so the
        # 512 bucket widens its output stream and compact wire
        env_oc = int(_os.environ.get("BWAMEM_TPU_OUT_CAP", "48"))
        self.out_cap = env_oc if self.L <= 256 else max(env_oc, 64)
        self.gcap_per = GCAP_PER if self.L <= 256 else 2 * GCAP_PER

    def _sa_dispatch(self, pad: np.ndarray):
        """One batched bwt_sa dispatch (the lock-step XLA walk; mesh
        path via ShardedKernels)."""
        import jax.numpy as jnp
        d = self.dfm
        if self.kernels is not None:
            return self.kernels.sa_lookup(
                d.blocks, d.primary, d.L2, d.seq_len, d.sa, d.sa_intv,
                jnp.asarray(pad), max_steps=self.sa_max_steps)
        return sa_lookup_batched(
            d.blocks, d.primary, d.L2, d.seq_len, d.sa, d.sa_intv,
            jnp.asarray(pad), max_steps=self.sa_max_steps)

    def interval_streams(self, opt, queries: Sequence[np.ndarray],
                         need_x1: bool = True) -> List[List[Intv]]:
        """Run the full iterator for every read (sliced into fixed-width
        lane groups); returns, per read, the concatenated interval lists
        of every iterator call, in call order (the exact stream
        mem_chain consumes, software/bwamem.c:593-615).

        Default path: ONE fused superstep dispatch per lane group (the
        whole iterator on device, ops.smem.smem_superstep) instead of
        one per iterator round.  BWAMEM_TPU_SUPERSTEP=0 falls back to
        the round-per-dispatch path (_SliceRun).
        Dispatches are software-pipelined either way: while one group
        is in flight, the previous group's results unpack on the host —
        the overlap the reference gets from its manager thread running
        ahead of the FPGA (software/fastmap.c:320-429)."""
        if _os.environ.get("BWAMEM_TPU_SUPERSTEP", "1") != "0":
            return self._streams_superstep(opt, queries,
                                           need_x1=need_x1)
        states = [
            _SliceRun(self, opt, queries[lo:lo + LANES], lo)
            for lo in range(0, len(queries), LANES)]
        from collections import deque
        import jax
        pending = deque()
        for st in states:
            if st.advance():
                pending.append((st, st.dispatch()))
        while pending:
            st, dev = pending.popleft()
            get = lambda dev=dev: jax.device_get(dev)
            res = (self.timer._timed(get, _tag="smem")
                   if self.timer else get())
            st.process(res)
            if st.advance():
                pending.append((st, st.dispatch()))
        out: List[List[Intv]] = []
        for st in states:
            out.extend(st.out)
        return out

    def _streams_superstep(self, opt, queries,
                           need_x1: bool = True) -> List[List[Intv]]:
        """One smem_superstep dispatch per lane group; overflow lanes
        re-run entirely on the host oracle."""
        from .smem import smem_superstep
        from ..config import MEM_F_NO_EXACT
        import jax
        import jax.numpy as jnp
        start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        sl_init = int(opt.min_seed_len * opt.split_factor + .499)
        out_cap = self.out_cap
        pend = []
        for lo in range(0, len(queries), LANES):
            grp = queries[lo:lo + LANES]
            B = LANES
            qpad = np.full((B, self.L), 4, dtype=np.int8)
            qlen = np.zeros(B, dtype=np.int32)
            slens = np.zeros(B, dtype=np.int32)
            for i, qq in enumerate(grp):
                qlen[i] = len(qq)
                qpad[i, :len(qq)] = qq
                slens[i] = min(sl_init, len(qq))
            active = np.zeros(B, dtype=bool)
            active[:len(grp)] = True
            gcap = self.gcap_per * B if self.kernels is None else 0
            step_fn = (self.kernels.superstep if self.kernels is not None
                       else smem_superstep)
            kw = dict(GCAP=gcap) if gcap else {}
            if self.kernels is None:  # halve the query upload
                kw["QPACKED"] = True
                kw["IMPL"] = self.smem_impl
                qpad = qpad[:, 0::2] | (qpad[:, 1::2] << np.int8(4))
            dev = step_fn(
                self.dfm.blocks, self.dfm.primary, self.dfm.L2,
                jnp.asarray(qpad), jnp.asarray(qlen),
                jnp.full(B, start_width, dtype=self.dfm.L2.dtype),
                jnp.asarray(active), jnp.asarray(slens),
                jnp.full(B, opt.split_width, np.int32),
                L=self.L, M=self.M, OUT_CAP=out_cap, NEED_X1=need_x1,
                **kw)
            pend.append((lo, grp, gcap, dev))
        out: List[List[Intv]] = []
        for lo, grp, gcap, dev in pend:
            get = lambda dev=dev: jax.device_get(dev)
            (o0, o1, os_, oqb, oqe, n_out,
             over) = (self.timer._timed(get, _tag="smem")
                      if self.timer else get())
            n_l, over_l = n_out.tolist(), over.tolist()
            # qe rides the uint8 wire; at L=256 the one overflowing
            # value qe==256 wires as 0 (real intervals have qe >= 1)
            qe_wrap = self.L == 256
            if gcap:
                # compact wire: flat lane-major streams + per-lane counts
                off = 0
                o0l, osl = o0.tolist(), os_.tolist()
                o1l = (o1.tolist() if need_x1 else [0] * len(o0l))
                oqbl, oqel = oqb.tolist(), oqe.tolist()
                if qe_wrap:
                    oqel = [v if v else 256 for v in oqel]
                for i, qq in enumerate(grp):
                    if over_l[i]:
                        if self.timer:
                            self.timer._count("ovf_smem_lanes")
                        lst: List[Intv] = []
                        self._oracle_finish(opt, qq, 0, start_width,
                                            min(sl_init, len(qq)),
                                            opt.split_width, lst)
                        out.append(lst)
                        continue
                    n = n_l[i]
                    out.append([
                        (o0l[off + j], o1l[off + j], osl[off + j],
                         (oqbl[off + j] << 32) | oqel[off + j])
                        for j in range(n)])
                    off += n
                continue
            # dense wire (mesh path): (lanes, OUT_CAP) buffers
            # one C-level tolist per buffer instead of 4 int() calls
            # per interval (~0.3s of the bench was this unpacking)
            o0l, osl = o0.tolist(), os_.tolist()
            o1l = (o1.tolist() if need_x1
                   else [[0] * o0.shape[1]] * o0.shape[0])
            oqbl, oqel = oqb.tolist(), oqe.tolist()
            for i, qq in enumerate(grp):
                if over_l[i]:
                    if self.timer:
                        self.timer._count("ovf_smem_lanes")
                    lst: List[Intv] = []
                    self._oracle_finish(opt, qq, 0, start_width,
                                        min(sl_init, len(qq)),
                                        opt.split_width, lst)
                    out.append(lst)
                    continue
                r0, r1, rs = o0l[i], o1l[i], osl[i]
                rqb, rqe = oqbl[i], oqel[i]
                if qe_wrap:
                    rqe = [v if v else 256 for v in rqe]
                out.append([
                    (r0[j], r1[j], rs[j], (rqb[j] << 32) | rqe[j])
                    for j in range(n_l[i])])
        return out

    def _oracle_finish(self, opt, query, start: int, start_width: int,
                       split_len: int, split_width: int, out: list) -> None:
        """Run the iterator to exhaustion for one read on the host
        oracle (identical results to the device path)."""
        qlen = len(query)
        while start < qlen:
            while start < qlen and query[start] > 3:
                start += 1
            if start >= qlen:
                break
            start, matches = self._oracle_step(
                opt, query, start, start_width, split_len, split_width)
            out.extend(matches)

    def _oracle_step(self, opt, query, x: int, start_width: int,
                     split_len: int, split_width: int):
        """One full iterator step on the host oracle (pass1 + split +
        pass2 + merge) for lanes that overflowed the device buffers."""
        from ..oracle.smem import smem1
        assert self.fm_host is not None, "overflow without host oracle"
        oret, matches = smem1(self.fm_host, query, x, start_width)
        if not matches:
            return oret, matches
        best_len, best = 0, 0
        for j, p in enumerate(matches):
            ln = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
            if best_len < ln:
                best_len, best = ln, j
        pm = matches[best]
        if (split_len > 0 and best_len >= split_len
                and pm[2] <= split_width):
            _, sub = smem1(self.fm_host, query,
                           ((pm[3] >> 32) + (pm[3] & 0xFFFFFFFF)) >> 1,
                           pm[2] + 1)
            matches = _merge(matches, sub, best_len, x, len(query))
        return oret, matches

    def seed_positions(self, fm_host, intervals_per_read, opt
                       ) -> List[List[Tuple[int, int, int]]]:
        """For each read, the ordered (rbeg, qbeg, len) seed list after
        the min_seed_len/max_occ filters (software/bwamem.c:407-420),
        with all SA lookups batched into one device dispatch."""
        keys: List[int] = []
        layout = []  # (read, intv, slen, qb, n_occ, key_offset)
        for i, intervals in enumerate(intervals_per_read):
            for p in intervals:
                slen = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
                if slen < opt.min_seed_len or p[2] > opt.max_occ:
                    continue
                layout.append((i, p, slen, p[3] >> 32, p[2], len(keys)))
                keys.extend(range(p[0], p[0] + p[2]))
        out: List[List[Tuple[int, int, int]]] = \
            [[] for _ in intervals_per_read]
        if not keys:
            return out
        d = self.dfm
        kdt = np.int32 if d.sa.dtype == jnp.int32 else np.int64
        karr = np.asarray(keys, dtype=kdt)
        vals = np.empty(len(karr), dtype=np.int64)
        over = np.empty(len(karr), dtype=bool)
        import jax
        pend = []  # dispatch-all-then-collect (jax dispatch is async)
        for lo in range(0, len(karr), SA_SLICE):
            sl = karr[lo:lo + SA_SLICE]
            pad = np.zeros(SA_SLICE, dtype=kdt)
            pad[:len(sl)] = sl
            pend.append((lo, len(sl), self._sa_dispatch(pad)))
        for lo, n_sl, dev in pend:
            fn = lambda dev=dev: jax.device_get(dev)
            v, o = (self.timer._timed(fn, _tag="sa")
                    if self.timer else fn())
            vals[lo:lo + n_sl] = v[:n_sl]
            over[lo:lo + n_sl] = o[:n_sl]
        n_ovf = int(np.count_nonzero(over))
        if n_ovf and self.timer:
            self.timer._count("ovf_sa_keys", n_ovf)
        for idx in np.nonzero(over)[0]:  # host fallback
            vals[idx] = fm_host.sa_lookup(int(karr[idx]))
        vals_l = vals.tolist()
        for (i, p, slen, qb, n_occ, off) in layout:
            oi = out[i]
            for k in range(n_occ):
                oi.append((vals_l[off + k], qb, slen))
        return out

    def interval_arrays(self, opt, queries: Sequence[np.ndarray]):
        """interval_streams with flat-array output (the native chain
        path's input): per-interval (x0, size, qb, qe) int arrays +
        read_off, in the exact per-read stream order of the list form.
        Overflow lanes re-run on the host oracle and are spliced back
        in place."""
        from .smem import smem_superstep, smem_superstep_sa
        from ..config import MEM_F_NO_EXACT
        import jax
        import jax.numpy as jnp
        start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        sl_init = int(opt.min_seed_len * opt.split_factor + .499)
        out_cap = self.out_cap
        # fused SA needs the compact wire (smem_superstep_sa asserts
        # GCAP > 0): GCAP_PER=0 falls back to the split path
        fuse = FUSE_SA and self.kernels is None and GCAP_PER > 0
        d = self.dfm
        pend = []
        for lo in range(0, len(queries), LANES):
            grp = queries[lo:lo + LANES]
            B = LANES
            qpad = np.full((B, self.L), 4, dtype=np.int8)
            qlen = np.zeros(B, dtype=np.int32)
            slens = np.zeros(B, dtype=np.int32)
            for i, qq in enumerate(grp):
                qlen[i] = len(qq)
                qpad[i, :len(qq)] = qq
                slens[i] = min(sl_init, len(qq))
            active = np.zeros(B, dtype=bool)
            active[:len(grp)] = True
            gcap = self.gcap_per * B if self.kernels is None else 0
            step_fn = (self.kernels.superstep if self.kernels is not None
                       else smem_superstep)
            kw = dict(GCAP=gcap) if gcap else {}
            if self.kernels is None:  # halve the query upload
                kw["QPACKED"] = True
                kw["IMPL"] = self.smem_impl
                qpad = qpad[:, 0::2] | (qpad[:, 1::2] << np.int8(4))
            common = (
                jnp.asarray(qpad), jnp.asarray(qlen),
                jnp.full(B, start_width, dtype=self.dfm.L2.dtype),
                jnp.asarray(active), jnp.asarray(slens),
                jnp.full(B, opt.split_width, np.int32))
            if fuse:
                dev = smem_superstep_sa(
                    d.blocks, d.primary, d.L2, d.seq_len, d.sa,
                    *common,
                    jnp.int32(opt.min_seed_len), jnp.int32(opt.max_occ),
                    L=self.L, M=self.M, OUT_CAP=out_cap, QPACKED=True,
                    GCAP=gcap, KEY_CAP=KEY_CAP, SA_INTV=d.sa_intv,
                    SA_STEPS=self.sa_max_steps, IMPL=self.smem_impl)
            else:
                dev = step_fn(
                    self.dfm.blocks, self.dfm.primary, self.dfm.L2,
                    *common,
                    L=self.L, M=self.M, OUT_CAP=out_cap, NEED_X1=False,
                    **kw)
            pend.append((lo, grp, gcap, dev))
        xs, szs, qbs, qes, cnts, dms = [], [], [], [], [], []
        sa_vals, sa_over, sa_ok = [], [], True
        for lo, grp, gcap, dev in pend:
            get = lambda dev=dev: jax.device_get(dev)
            res = (self.timer._timed(get, _tag="smem")
                   if self.timer else get())
            if fuse:
                (o0, _o1, os_, oqb, oqe, n_out, over,
                 g_vals, g_over, g_nk, g_kovf) = res
            else:
                o0, _o1, os_, oqb, oqe, n_out, over = res
                g_vals = g_over = None
                g_kovf = False
            ng = len(grp)
            n_l = np.asarray(n_out)[:ng].astype(np.int64)
            over_l = np.asarray(over)[:ng]
            n_l = np.where(over_l, 0, n_l)
            if gcap:
                # compact wire: flat lane-major streams; this group's
                # slice is the first sum(n_l) slots (padding lanes have
                # n_out 0, so group rows ng..B contribute nothing)
                tot = int(np.asarray(n_out).astype(np.int64).sum())
                assert tot == int(n_l.sum())
                gx = np.asarray(o0)[:tot]
                gs = np.asarray(os_)[:tot]
                gqb = np.asarray(oqb)[:tot].astype(np.int64)
                gqe = np.asarray(oqe)[:tot].astype(np.int64)
                if self.L == 256:  # uint8 wire: qe==256 wires as 0
                    gqe[gqe == 0] = 256
            else:
                o0 = np.asarray(o0)[:ng]
                os_ = np.asarray(os_)[:ng]
                oqb = np.asarray(oqb)[:ng].astype(np.int64)
                oqe = np.asarray(oqe)[:ng].astype(np.int64)
                cap = o0.shape[1]
                mask = np.arange(cap)[None, :] < n_l[:, None]
                # row-major selection == per-read stream order
                gx, gs = o0[mask], os_[mask]
                gqb, gqe = oqb[mask], oqe[mask]
                if self.L == 256:  # uint8 wire: qe==256 wires as 0
                    gqe[gqe == 0] = 256
            if fuse:
                # the device key expansion fit KEY_CAP: its values are
                # usable.  Overflow lanes report n_out==0 on the wire,
                # so the expansion covers exactly the CLEAN lanes'
                # streams — which survive the oracle splice unchanged;
                # spliced intervals are marked for fresh resolution in
                # seeds_from_arrays instead of dropping the whole
                # group's prefetch (at large genomes a handful of
                # buffer-overflow lanes per group made the drop the
                # common case, costing a split SA dispatch per group)
                if bool(g_kovf):
                    sa_ok = False
                    if self.timer:
                        self.timer._count("ovf_keyexp_groups")
                else:
                    nk = int(g_nk)
                    sa_vals.append(np.asarray(g_vals)[:nk])
                    sa_over.append(np.asarray(g_over)[:nk])
            dev_mark = np.ones(len(gx), bool)
            if over_l.any():
                # splice host-oracle streams into the overflow rows
                # (their device segments are empty: n_out==0 on wire)
                px = np.split(gx, np.cumsum(n_l)[:-1])
                ps = np.split(gs, np.cumsum(n_l)[:-1])
                pqb = np.split(gqb, np.cumsum(n_l)[:-1])
                pqe = np.split(gqe, np.cumsum(n_l)[:-1])
                pdm = np.split(dev_mark, np.cumsum(n_l)[:-1])
                if self.timer:
                    self.timer._count("ovf_smem_lanes",
                                      int(over_l.sum()))
                for i in np.nonzero(over_l)[0]:
                    lst: List[Intv] = []
                    self._oracle_finish(opt, grp[i], 0, start_width,
                                        min(sl_init, len(grp[i])),
                                        opt.split_width, lst)
                    px[i] = np.asarray([p[0] for p in lst], np.int64)
                    ps[i] = np.asarray([p[2] for p in lst], np.int64)
                    pqb[i] = np.asarray([p[3] >> 32 for p in lst],
                                        np.int64)
                    pqe[i] = np.asarray([p[3] & 0xFFFFFFFF for p in lst],
                                        np.int64)
                    pdm[i] = np.zeros(len(lst), bool)
                    n_l[i] = len(lst)
                gx = np.concatenate(px) if px else gx
                gs = np.concatenate(ps) if ps else gs
                gqb = np.concatenate(pqb) if pqb else gqb
                gqe = np.concatenate(pqe) if pqe else gqe
                dev_mark = np.concatenate(pdm) if pdm else dev_mark
            xs.append(gx)
            szs.append(gs)
            qbs.append(gqb)
            qes.append(gqe)
            cnts.append(n_l)
            dms.append(dev_mark)
        x0 = np.concatenate(xs) if xs else np.zeros(0, np.int64)
        sz = np.concatenate(szs) if szs else np.zeros(0, np.int64)
        qb = np.concatenate(qbs) if qbs else np.zeros(0, np.int64)
        qe = np.concatenate(qes) if qes else np.zeros(0, np.int64)
        counts = (np.concatenate(cnts) if cnts
                  else np.zeros(0, np.int64))
        read_off = np.zeros(len(queries) + 1, dtype=np.int64)
        np.cumsum(counts, out=read_off[1:])
        iv = (x0.astype(np.int64), sz.astype(np.int64),
              qb.astype(np.int64), qe.astype(np.int64), read_off)
        if fuse and sa_ok:
            # pairing token pins the iv this prefetch was computed for
            # (object identity, not id(): the held reference cannot be
            # recycled) plus the filter params baked into the dispatch;
            # dev_mark flags which intervals the device expansion
            # covered (oracle-spliced intervals resolve freshly)
            self._sa_prefetch = (np.concatenate(sa_vals)
                                 if sa_vals else np.zeros(0, np.int64),
                                 np.concatenate(sa_over)
                                 if sa_over else np.zeros(0, bool),
                                 (read_off, float(opt.min_seed_len),
                                  float(opt.max_occ)),
                                 np.concatenate(dms)
                                 if dms else np.zeros(0, bool))
        else:
            self._sa_prefetch = None
        return iv

    def seeds_from_arrays(self, fm_host, iv, opt):
        """Vectorized seed_positions over interval_arrays output:
        returns (read_ids, rbeg, qbeg, len) flat arrays in the exact
        (read, interval, occurrence) order."""
        x0, sz, qb, qe, read_off = iv
        n_reads = len(read_off) - 1
        slen = qe - qb
        keep = (slen >= opt.min_seed_len) & (sz <= opt.max_occ)
        iv_read = np.repeat(np.arange(n_reads, dtype=np.int32),
                            np.diff(read_off))
        x0k, szk = x0[keep], sz[keep]
        qbk, slk = qb[keep], slen[keep]
        rdk = iv_read[keep]
        total = int(szk.sum())
        if total == 0:
            z32 = np.zeros(0, np.int32)
            return z32, np.zeros(0, np.int64), z32, z32
        pre = getattr(self, "_sa_prefetch", None)
        if pre is not None and (
                pre[2][0] is not iv[4]
                or pre[2][1] != float(opt.min_seed_len)
                or pre[2][2] != float(opt.max_occ)):
            pre = None  # prefetch was for a different iv/opt
        if pre is not None:
            # device-covered intervals (dev_mark) consume the fused
            # dispatch's values sequentially (same order: interval-
            # major, occurrence-minor); oracle-spliced intervals (a
            # handful of buffer-overflow lanes) resolve freshly
            dm = pre[3][keep]
            if int(szk[dm].sum()) != len(pre[0]):
                pre = None  # layout mismatch: fall through to split
        if pre is not None:
            vals = np.empty(total, dtype=np.int64)
            over = np.zeros(total, dtype=bool)
            if dm.all():
                vals[:] = pre[0].astype(np.int64)
                over[:] = pre[1]
            else:
                sel = np.repeat(dm, szk)  # per-occurrence, output order
                vals[sel] = pre[0].astype(np.int64)
                over[sel] = pre[1]
                fr = ~dm
                n_fresh = int(szk[fr].sum())
                if n_fresh:
                    base = np.repeat(x0k[fr], szk[fr])
                    excl = np.concatenate([[0], np.cumsum(szk[fr])[:-1]])
                    ramp = (np.arange(n_fresh, dtype=np.int64)
                            - np.repeat(excl, szk[fr]))
                    fkeys = base + ramp
                    from ..oracle import nsmem
                    nat = nsmem.available()
                    if n_fresh <= (8192 if nat else 768):
                        # few keys: the host psi-walk (one C call when
                        # the native oracle is built) beats a padded
                        # device dispatch round trip
                        fv = (nsmem.sa_lookup_batch_native(
                            fm_host, fkeys) if nat else None)
                        if fv is None:
                            fv = np.asarray(
                                [fm_host.sa_lookup(int(kk))
                                 for kk in fkeys], np.int64)
                        fo = np.zeros(n_fresh, bool)
                    else:
                        fv, fo = self._resolve_keys_device(fkeys)
                    vals[~sel] = fv
                    over[~sel] = fo
            if over.any():
                base = np.repeat(x0k, szk)
                excl = np.concatenate([[0], np.cumsum(szk)[:-1]])
                ramp = (np.arange(total, dtype=np.int64)
                        - np.repeat(excl, szk))
                keys = base + ramp
                for idx in np.nonzero(over)[0]:  # host fallback
                    vals[idx] = fm_host.sa_lookup(int(keys[idx]))
            self._sa_prefetch = None
            read_ids = np.repeat(rdk, szk).astype(np.int32)
            qbeg = np.repeat(qbk, szk).astype(np.int32)
            slen_a = np.repeat(slk, szk).astype(np.int32)
            return read_ids, vals, qbeg, slen_a
        self._sa_prefetch = None
        base = np.repeat(x0k, szk)
        excl = np.concatenate([[0], np.cumsum(szk)[:-1]])
        ramp = np.arange(total, dtype=np.int64) - np.repeat(excl, szk)
        keys = base + ramp
        d = self.dfm
        kdt = np.int32 if d.sa.dtype == jnp.int32 else np.int64
        karr = keys.astype(kdt)
        vals = np.empty(total, dtype=np.int64)
        over = np.empty(total, dtype=bool)
        import jax
        pend = []
        for lo in range(0, total, SA_SLICE):
            sl = karr[lo:lo + SA_SLICE]
            pad = np.zeros(SA_SLICE, dtype=kdt)
            pad[:len(sl)] = sl
            pend.append((lo, len(sl), self._sa_dispatch(pad)))
        for lo, n_sl, dev in pend:
            fn = lambda dev=dev: jax.device_get(dev)
            v, o = (self.timer._timed(fn, _tag="sa")
                    if self.timer else fn())
            vals[lo:lo + n_sl] = v[:n_sl]
            over[lo:lo + n_sl] = o[:n_sl]
        for idx in np.nonzero(over)[0]:  # host fallback
            vals[idx] = fm_host.sa_lookup(int(keys[idx]))
        read_ids = np.repeat(rdk, szk).astype(np.int32)
        qbeg = np.repeat(qbk, szk).astype(np.int32)
        slen_a = np.repeat(slk, szk).astype(np.int32)
        return read_ids, vals, qbeg, slen_a

    def _resolve_keys_device(self, keys: np.ndarray):
        """Batched SA resolution of arbitrary keys via the device walk
        (SA_SLICE-padded dispatches); returns (vals int64, over bool)."""
        import jax
        d = self.dfm
        kdt = np.int32 if d.sa.dtype == jnp.int32 else np.int64
        karr = keys.astype(kdt)
        n = len(karr)
        vals = np.empty(n, dtype=np.int64)
        over = np.empty(n, dtype=bool)
        pend = []
        for lo in range(0, n, SA_SLICE):
            sl = karr[lo:lo + SA_SLICE]
            pad = np.zeros(SA_SLICE, dtype=kdt)
            pad[:len(sl)] = sl
            pend.append((lo, len(sl), self._sa_dispatch(pad)))
        for lo, n_sl, dev in pend:
            fn = lambda dev=dev: jax.device_get(dev)
            v, o = (self.timer._timed(fn, _tag="sa")
                    if self.timer else fn())
            vals[lo:lo + n_sl] = v[:n_sl]
            over[lo:lo + n_sl] = o[:n_sl]
        return vals, over

    def seed_positions_arrays(self, fm_host, intervals_per_read, opt):
        """seed_positions with flat-array output for the native chain
        builder: (read_ids, rbeg, qbeg, len) int arrays in the exact
        per-read, per-interval, per-occurrence order of the list form
        (the insertion order determines chain identity)."""
        keys: List[int] = []
        lay_i = []
        lay_qb = []
        lay_len = []
        lay_n = []
        for i, intervals in enumerate(intervals_per_read):
            for p in intervals:
                slen = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
                if slen < opt.min_seed_len or p[2] > opt.max_occ:
                    continue
                lay_i.append(i)
                lay_qb.append(p[3] >> 32)
                lay_len.append(slen)
                lay_n.append(p[2])
                keys.extend(range(p[0], p[0] + p[2]))
        n_seeds = len(keys)
        if n_seeds == 0:
            z32 = np.zeros(0, np.int32)
            return z32, np.zeros(0, np.int64), z32, z32
        d = self.dfm
        kdt = np.int32 if d.sa.dtype == jnp.int32 else np.int64
        karr = np.asarray(keys, dtype=kdt)
        vals = np.empty(len(karr), dtype=np.int64)
        over = np.empty(len(karr), dtype=bool)
        import jax
        pend = []
        for lo in range(0, len(karr), SA_SLICE):
            sl = karr[lo:lo + SA_SLICE]
            pad = np.zeros(SA_SLICE, dtype=kdt)
            pad[:len(sl)] = sl
            pend.append((lo, len(sl), self._sa_dispatch(pad)))
        for lo, n_sl, dev in pend:
            fn = lambda dev=dev: jax.device_get(dev)
            v, o = (self.timer._timed(fn, _tag="sa")
                    if self.timer else fn())
            vals[lo:lo + n_sl] = v[:n_sl]
            over[lo:lo + n_sl] = o[:n_sl]
        n_ovf = int(np.count_nonzero(over))
        if n_ovf and self.timer:
            self.timer._count("ovf_sa_keys", n_ovf)
        for idx in np.nonzero(over)[0]:  # host fallback
            vals[idx] = fm_host.sa_lookup(int(karr[idx]))
        n_occ = np.asarray(lay_n, dtype=np.int64)
        read_ids = np.repeat(np.asarray(lay_i, np.int32), n_occ)
        qbeg = np.repeat(np.asarray(lay_qb, np.int64), n_occ) \
            .astype(np.int32)
        slen_a = np.repeat(np.asarray(lay_len, np.int64), n_occ) \
            .astype(np.int32)
        return read_ids, vals, qbeg, slen_a


class _SliceRun:
    """Iterator state for one fixed-width lane group (see
    BatchedSeeder.interval_streams).  advance() does the host-side
    bookkeeping between rounds (ambiguous-base skip, straggler tail);
    dispatch() launches one fused smem_iter_step asynchronously;
    process() unpacks a round's results."""

    def __init__(self, seeder: "BatchedSeeder", opt, queries, base: int):
        self.seeder = seeder
        self.opt = opt
        self.queries = queries
        n = len(queries)
        B = LANES
        qpad = np.full((B, seeder.L), 4, dtype=np.int8)
        qlen = np.zeros(B, dtype=np.int32)
        for i, q in enumerate(queries):
            qlen[i] = len(q)
            qpad[i, :len(q)] = q
        from ..config import MEM_F_NO_EXACT
        self.start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        self.split_lens = np.zeros(B, dtype=np.int64)
        self.split_widths = np.zeros(B, dtype=np.int64)
        sl = int(opt.min_seed_len * opt.split_factor + .499)
        for i, q in enumerate(queries):
            self.split_lens[i] = min(sl, len(q))
            self.split_widths[i] = opt.split_width
        self.qlen = qlen
        self.start = np.zeros(B, dtype=np.int32)
        self.exhausted = np.zeros(B, dtype=bool)
        self.exhausted[n:] = True
        self.out: List[List[Intv]] = [[] for _ in range(n)]
        # upload loop-invariant arrays once (the query buffer alone is
        # ~0.25 MB per group; re-uploading it every round doubles the
        # per-dispatch transfer volume)
        self.qpad_d = jnp.asarray(qpad)
        self.qlen_d = jnp.asarray(qlen)
        self.slens_d = jnp.asarray(self.split_lens)
        self.swid_d = jnp.asarray(self.split_widths)
        self.active = None
        self.ori_start = None

    def advance(self) -> bool:
        """Host bookkeeping between rounds; True if a device round
        should be dispatched."""
        sdr = self.seeder
        # skip ambiguous bases (software/bwamem.c:258-259)
        for i in np.nonzero(~self.exhausted)[0]:
            q = self.queries[i]
            s = self.start[i]
            while s < self.qlen[i] and q[s] > 3:
                s += 1
            self.start[i] = s
            if s >= self.qlen[i]:
                self.exhausted[i] = True
        active = ~self.exhausted
        n_live = int(active.sum())
        if n_live == 0:
            return False
        if n_live < MIN_SEED_WAVE and sdr.fm_host is not None:
            # straggler tail: finish the few live reads on the host
            # oracle instead of paying full-width dispatch round trips
            for i in np.nonzero(active)[0]:
                sdr._oracle_finish(
                    self.opt, self.queries[i], int(self.start[i]),
                    self.start_width, int(self.split_lens[i]),
                    int(self.split_widths[i]), self.out[i])
                self.exhausted[i] = True
            return False
        self.active = active
        return True

    def dispatch(self):
        from .smem import smem_iter_step
        sdr = self.seeder
        d = sdr.dfm
        self.ori_start = self.start.copy()
        x = np.where(self.active, self.start, 0).astype(np.int32)
        mi = np.full(LANES, self.start_width, dtype=np.int64)
        return smem_iter_step(
            d.blocks, d.primary, d.L2,
            self.qpad_d, self.qlen_d, jnp.asarray(x),
            jnp.asarray(mi), jnp.asarray(self.active),
            self.slens_d, self.swid_d,
            L=sdr.L, M=sdr.M, M_OUT=sdr.m_out)

    def process(self, res) -> None:
        sdr = self.seeder
        (ret, n_mem, m0, m1, ms, mqb, mqe, over1, need2,
         _r2, n2, s0, s1, ss, sqb, sqe, over2) = res
        n_mem = np.where(over1, sdr.M + 1, n_mem)
        n2 = np.where(over2, sdr.M + 1, n2)
        ori_start = self.ori_start
        active = self.active
        ret = ret.astype(np.int32)
        qe_wrap = sdr.L == 256
        if qe_wrap:
            # uint8 wire: ret/qe==256 wire as 0 (real values are >= 1)
            ret = np.where(ret == 0, 256, ret)
        self.start = np.where(active, ret, self.start).astype(np.int32)
        out = self.out
        for i in np.nonzero(active)[0]:
            if int(n_mem[i]) > sdr.m_out:
                # host fallback: the whole iterator step via oracle
                oret, matches = sdr._oracle_step(
                    self.opt, self.queries[i], int(ori_start[i]),
                    self.start_width, int(self.split_lens[i]),
                    int(self.split_widths[i]))
                self.start[i] = oret
                out[i].extend(matches)
                continue
            matches = [(int(m0[i, j]), int(m1[i, j]), int(ms[i, j]),
                        (int(mqb[i, j]) << 32)
                        | (int(mqe[i, j]) or (256 if qe_wrap else 0)))
                       for j in range(int(n_mem[i]))]
            if need2[i] and matches:
                best_len, best = 0, 0
                for j, p in enumerate(matches):
                    ln = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
                    if best_len < ln:
                        best_len, best = ln, j
                pm = matches[best]
                if int(n2[i]) > sdr.m_out:  # pass-2 overflow
                    from ..oracle.smem import smem1
                    _, sub = smem1(
                        sdr.fm_host, self.queries[i],
                        ((pm[3] >> 32) + (pm[3] & 0xFFFFFFFF)) >> 1,
                        pm[2] + 1)
                else:
                    sub = [(int(s0[i, j]), int(s1[i, j]), int(ss[i, j]),
                            (int(sqb[i, j]) << 32)
                            | (int(sqe[i, j]) or (256 if qe_wrap else 0)))
                           for j in range(int(n2[i]))]
                matches = _merge(matches, sub, best_len,
                                 int(ori_start[i]), int(self.qlen[i]))
            out[i].extend(matches)


def _merge(matches: List[Intv], sub: List[Intv], max_len: int,
           ori_start: int, qlen: int) -> List[Intv]:
    """Ordered merge of main and re-seeded matches
    (software/bwamem.c:206-238): keep sub-matches at least half the max
    length that end after the original start."""
    merged: List[Intv] = []
    i = j = 0
    while i < len(matches) and j < len(sub):
        pi, pj = matches[i], sub[j]
        xi = (pi[3] >> 32 << 32) | (qlen - (pi[3] & 0xFFFFFFFF))
        xj = (pj[3] >> 32 << 32) | (qlen - (pj[3] & 0xFFFFFFFF))
        if xi < xj:
            merged.append(pi)
            i += 1
        elif ((pj[3] & 0xFFFFFFFF) - (pj[3] >> 32) >= (max_len >> 1)
                and (pj[3] & 0xFFFFFFFF) > ori_start):
            merged.append(pj)
            j += 1
        else:
            j += 1
    merged.extend(matches[i:])
    for pj in sub[j:]:
        if ((pj[3] & 0xFFFFFFFF) - (pj[3] >> 32) >= (max_len >> 1)
                and (pj[3] & 0xFFFFFFFF) > ori_start):
            merged.append(pj)
    return merged
