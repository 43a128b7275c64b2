"""Batched local Smith-Waterman (ksw_align2) on device.

The reference's ksw_u8/ksw_i16 are SSE2 Farrar-striped kernels
(software/ksw.c:110-364); their striped layout is equivalent to
standard SW over a virtual query padded to slen*p positions with
zero-score pads (see oracle/ksw.py) — which is exactly the layout a
vectorized row DP wants, so the batched kernel computes the same
recurrence over [B, VLEN] lanes with the u8 saturation semantics
reproduced by clipping.

The kernel returns per-row maxima so the host can replay the
second-best bookkeeping (the b-list run-splitting quirk,
software/ksw.c:180-186) exactly; start positions come from the
reference's own reversed-prefix rerun (software/ksw.c:355-363) as a
second batched dispatch.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .select import sel_col, set_col, score_profile

NEG = jnp.int32(-0x40000000)


@partial(jax.jit, static_argnames=("size", "LQV", "LT", "o_del",
                                   "e_del", "o_ins", "e_ins"))
def ksw_align_batched(
        query: jnp.ndarray,    # int32[B, LQV] nt4 (pad 4; qp pad = 0)
        target: jnp.ndarray,   # int32[B, LT] nt4 (pad 4)
        qlen: jnp.ndarray,     # int32[B] true query length
        tlen: jnp.ndarray,     # int32[B]
        mat: jnp.ndarray,      # int32[25]
        o_del: int, e_del: int, o_ins: int, e_ins: int,
        minsc: jnp.ndarray,    # int32[B] (0x10000 when unused)
        endsc: jnp.ndarray,    # int32[B] (0x10000 when unused)
        size: int, LQV: int, LT: int):
    """One ksw_u8 (size=1) / ksw_i16 (size=2) pass per lane.

    Returns (gmax, te, qe, saturated, row_max, last_row):
      gmax int32[B]       — best score (unshifted domain)
      te   int32[B]       — its target end row
      qe   int32[B]       — smallest virtual query position of the max
      saturated bool[B]   — u8 255 saturation hit
      row_max int32[B,LT] — per-row maxima (for host score2 replay)
      last_row int32[B]   — last row actually computed (early breaks)
    """
    B = query.shape[0]
    i32 = jnp.int32
    query = query.astype(i32)   # int8 on the wire (see ksw_extend2)
    target = target.astype(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    mat55 = mat.reshape(5, 5)
    shift = (-jnp.min(mat)).astype(i32) if size == 1 else jnp.int32(0)

    sat = jnp.int32(255) - shift

    jq = jnp.arange(LQV, dtype=i32)[None, :]
    qvalid = jq < qlen[:, None]
    # the striped kernels operate on a virtual query of exactly
    # ceil(qlen/p)*p positions (p = 16 for u8, 8 for i16); positions
    # beyond that do not exist and must not join the row maxima
    p_lanes = 16 if size == 1 else 8
    vlen = ((qlen + p_lanes - 1) // p_lanes) * p_lanes
    vmask = jq < vlen[:, None]

    state = dict(
        i=jnp.zeros(B, i32),
        H=jnp.zeros((B, LQV), i32), E=jnp.zeros((B, LQV), i32),
        Hmax=jnp.zeros((B, LQV), i32),
        gmax=jnp.zeros(B, i32), te=jnp.full(B, -1, i32),
        row_max=jnp.zeros((B, LT), i32),
        done=tlen <= 0, saturated=jnp.zeros(B, bool),
        last=jnp.full(B, -1, i32),
    )

    def body(st):
        i = st["i"]
        run = ~st["done"] & (i < tlen)
        ii = jnp.clip(i, 0, LT - 1)
        tch = sel_col(target, ii)
        qp = jnp.where(qvalid, score_profile(mat55, tch, query), 0)
        hdiag = jnp.concatenate(
            [jnp.zeros((B, 1), i32), st["H"][:, :-1]], axis=1)
        g = hdiag + qp
        if size == 1:
            g = jnp.clip(g, 0, sat)
        g = jnp.maximum(g, st["E"])
        a_vec = g + jq * e_ins
        cm = lax.associative_scan(jnp.maximum, a_vec, axis=1)
        cm_prev = jnp.concatenate(
            [jnp.full((B, 1), NEG, i32), cm[:, :-1]], axis=1)
        F = jnp.maximum(cm_prev - oe_ins - (jq - 1) * e_ins, 0)
        F = F.at[:, 0].set(0)
        H = jnp.where(vmask, jnp.maximum(g, F), 0)
        imax = jnp.max(H, axis=1).astype(i32)
        E = jnp.maximum(st["E"] - e_del, jnp.maximum(H - oe_del, 0))

        Hn = jnp.where(run[:, None], H, st["H"])
        En = jnp.where(run[:, None], E, st["E"])
        row_max = set_col(st["row_max"], jnp.where(run, ii, LT), imax)
        improved = run & (imax > st["gmax"])
        gmax = jnp.where(improved, imax, st["gmax"])
        te = jnp.where(improved, i, st["te"])
        Hmax = jnp.where(improved[:, None], H, st["Hmax"])
        last = jnp.where(run, i, st["last"])
        sat_brk = improved & (size == 1) & (gmax + shift >= 255)
        end_brk = improved & (gmax >= endsc)
        done = st["done"] | (~run & ~st["done"]) | sat_brk | end_brk
        return dict(i=i + 1, H=Hn, E=En, Hmax=Hmax, gmax=gmax, te=te,
                    row_max=row_max, done=done,
                    saturated=st["saturated"] | sat_brk, last=last)

    def cond(st):
        return jnp.any(~st["done"] & (st["i"] < tlen))

    from .loops import unroll_body
    st = lax.while_loop(cond, unroll_body(body), state)
    # qe: smallest virtual position achieving max(Hmax)
    mx = jnp.max(st["Hmax"], axis=1)
    hit = st["Hmax"] >= mx[:, None]
    qe = jnp.argmax(hit, axis=1).astype(i32)
    qe = jnp.where(mx > -1, qe, -1)
    return (st["gmax"], st["te"], qe, st["saturated"], st["row_max"],
            st["last"])


def align2_wave(opt, reqs, wave_width: int, lq_cap: int = 128,
                lt_cap: int = 544, timed=None):
    """Serve a wave of ('align2', qs, rs, xtra) requests with batched
    device kernels, replaying ksw_align2's host-side bookkeeping
    (software/ksw.c:330-364) exactly.  Oversize/saturated lanes fall
    back to the scalar oracle."""
    from ..oracle import ksw as oksw
    from ..oracle.ksw import KswR
    from ..core.swdrive import serve_host

    n = len(reqs)
    outs = [None] * n
    mat_i64 = np.asarray(opt.mat, dtype=np.int64)
    mat_dev = jnp.asarray(mat_i64.astype(np.int32))
    max_sc = int(mat_i64.max())

    groups = {1: [], 2: []}
    for i, r in enumerate(reqs):
        _, qs, rs, xtra = r
        size = 1 if (xtra & oksw.KSW_XBYTE) else 2
        if len(qs) <= lq_cap and 0 < len(rs) <= lt_cap and len(qs) > 0:
            groups[size].append(i)
        else:
            outs[i] = serve_host(r, opt)

    def run_group(idxs, size, rev_info=None):
        """One batched dispatch; rev_info marks the reversed-prefix
        rerun (seq slices + endsc from the forward result)."""
        res = {}
        pend = []  # dispatch-all-then-collect (see engine._extend_wave)
        for lo in range(0, len(idxs), wave_width):
            grp = idxs[lo:lo + wave_width]
            B = wave_width
            qb = np.full((B, lq_cap), 4, np.int8)
            tb = np.full((B, lt_cap), 4, np.int8)
            qlen = np.zeros(B, np.int32)
            tlen = np.zeros(B, np.int32)
            mins = np.full(B, 0x10000, np.int32)
            ends = np.full(B, 0x10000, np.int32)
            for bi, i in enumerate(grp):
                _, qs, rs, xtra = reqs[i]
                if rev_info is not None:
                    r0 = rev_info[i]
                    qs = qs[:r0.qe + 1][::-1]
                    rs = rs[:r0.te + 1][::-1]
                    ends[bi] = r0.score
                else:
                    if xtra & oksw.KSW_XSUBO:
                        mins[bi] = xtra & 0xFFFF
                    if xtra & oksw.KSW_XSTOP:
                        ends[bi] = xtra & 0xFFFF
                qb[bi, :len(qs)] = qs
                tb[bi, :len(rs)] = rs
                qlen[bi], tlen[bi] = len(qs), len(rs)
            dev = ksw_align_batched(
                jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(qlen),
                jnp.asarray(tlen), mat_dev,
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                jnp.asarray(mins), jnp.asarray(ends),
                size=size, LQV=lq_cap, LT=lt_cap)
            pend.append((grp, dev, mins))
        for grp, dev, mins in pend:
            fn = lambda dev=dev: jax.device_get(dev)
            out = timed(fn) if timed else fn()
            gmax, te, qe, satu, row_max, last = out
            for bi, i in enumerate(grp):
                res[i] = (int(gmax[bi]), int(te[bi]), int(qe[bi]),
                          bool(satu[bi]), row_max[bi], int(last[bi]),
                          int(mins[bi]))
        return res

    fwd = {}
    for size in (1, 2):
        if groups[size]:
            fwd.update(run_group(groups[size], size))

    results = {}
    need_rev = {1: [], 2: []}
    for i, vals in fwd.items():
        _, qs, rs, xtra = reqs[i]
        gmax, te, qe, satu, row_max, last, minsc = vals
        size = 1 if (xtra & oksw.KSW_XBYTE) else 2
        r = KswR()
        r.score = 255 if (size == 1 and satu) else gmax
        r.te = te
        if size != 1 or r.score != 255:
            r.qe = qe
            # replay the b-list (software/ksw.c:180-186,335-341)
            b = []
            for row in range(last + 1):
                imax = int(row_max[row])
                if imax >= minsc:
                    if not b or b[-1][1] + 1 != row:
                        b.append((imax, row))
                    elif b[-1][0] < imax:
                        b[-1] = (imax, row)
            if b:
                ii = (r.score + max_sc - 1) // max_sc
                low, high = te - ii, te + ii
                for rm, e_row in b:
                    if (e_row < low or e_row > high) and rm > r.score2:
                        r.score2, r.te2 = rm, e_row
        results[i] = r
        if (xtra & oksw.KSW_XSTART) and not (
                (xtra & oksw.KSW_XSUBO) and r.score < (xtra & 0xFFFF)):
            if size == 1 and r.score == 255:
                # saturated: unreachable for bwa's callers; oracle path
                outs[i] = serve_host(reqs[i], opt)
                results.pop(i)
            else:
                need_rev[size].append(i)

    rev = {}
    for size in (1, 2):
        if need_rev[size]:
            rev.update(run_group(need_rev[size], size,
                                 rev_info=results))
    for i, vals in rev.items():
        gmax, te, qe, satu, _rm, _last, _mins = vals
        r = results[i]
        rr_score = 255 if ((reqs[i][3] & oksw.KSW_XBYTE) and satu) \
            else gmax
        if r.score == rr_score:
            r.tb = r.te - te
            r.qb = r.qe - qe

    for i, r in results.items():
        if outs[i] is None:
            outs[i] = r
    return outs
