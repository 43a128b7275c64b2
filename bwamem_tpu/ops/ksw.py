"""Batched banded Smith-Waterman extension on device.

ksw_extend2 (software/ksw.c:379-477) for a whole wave of (read, chain,
side) extension lanes at once: each DP row is vectorized across the
query dimension AND across lanes, with the horizontal F-dependency
resolved by a prefix max-scan (F(j) unrolls to a running maximum of
G(k)+k*e_ins — same trick the host oracle uses, oracle/ksw.py).

Matches the scalar C semantics exactly: band clamping, the adaptive
band-narrowing scans over the freshly stored H row, z-drop, end-bonus
gscore tracking, and the tie rule that row maxima take the LAST query
index.  Verified lane-for-lane against the host oracle.

All scores are int32 (C uses int32 eh_t); coordinates int32.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .select import sel_col, set_col, sel_row, score_profile

NEG = jnp.int32(-0x40000000)
# out-of-band fill for the prefix scan: strictly below every in-band
# value, with headroom so the downstream subtractions can't wrap int32
NEG2 = jnp.int32(-0x60000000)


def cigar_from_traceback(ops_row: np.ndarray, n: int, rem_i: int,
                         rem_k: int) -> list:
    """Assemble the BAM cigar from a device traceback: append the
    trailing deletion/insertion runs (ksw.c:580-581), reverse, RLE."""
    seq = list(ops_row[:n])
    if rem_i >= 0:
        seq.extend([2] * (rem_i + 1))
    if rem_k >= 0:
        seq.extend([1] * (rem_k + 1))
    seq.reverse()
    cigar = []
    for op in seq:
        if cigar and (cigar[-1] & 0xF) == op:
            cigar[-1] += 16
        else:
            cigar.append(16 | int(op))
    return cigar


def cigars_from_tracebacks(ops: np.ndarray, n_ops: np.ndarray,
                           rem_i: np.ndarray, rem_k: np.ndarray,
                           rows) -> list:
    """Batched cigar_from_traceback over a whole wave: one run-length
    pass over the concatenation of every lane's (reversed) op sequence,
    separated by sentinels, instead of a per-op Python loop (the RLE
    dominated the global-wave host time at ~110 ops/lane)."""
    segs = []
    bounds = [0]
    for bi in rows:
        n = int(n_ops[bi])
        ri, rk = int(rem_i[bi]), int(rem_k[bi])
        parts = [ops[bi, :n]]
        if ri >= 0:
            parts.append(np.full(ri + 1, 2, np.uint8))
        if rk >= 0:
            parts.append(np.full(rk + 1, 1, np.uint8))
        seq = (np.concatenate(parts) if len(parts) > 1
               else parts[0])[::-1]
        segs.append(seq)
        bounds.append(bounds[-1] + len(seq) + 1)   # +1 sentinel slot
    if not segs:
        return []
    total = bounds[-1]
    flat = np.full(total, 255, np.uint8)   # 255 = sentinel, not an op,
    for seq, lo in zip(segs, bounds[:-1]):  # so runs never straddle lanes
        flat[lo:lo + len(seq)] = seq
    brk = np.nonzero(np.diff(flat.astype(np.int16)))[0]
    starts = np.concatenate([[0], brk + 1])
    lens = np.diff(np.concatenate([starts, [total]]))
    vals = flat[starts]
    keep = vals != 255
    starts, lens, vals = starts[keep], lens[keep], vals[keep]
    lane_of = np.searchsorted(np.asarray(bounds), starts,
                              side="right") - 1
    packed = (lens.astype(np.int64) << 4) | vals
    out = [[] for _ in segs]
    for ln, pk in zip(lane_of, packed):
        out[ln].append(int(pk))
    return out


@partial(jax.jit, static_argnames=("LQ", "LT", "o_del", "e_del",
                                   "o_ins", "e_ins", "zdrop", "packed"))
def ksw_extend2_batched(
        query: jnp.ndarray,    # int32[B, LQ] nt4 (pad 4)
        target: jnp.ndarray,   # int32[B, LT] nt4 (pad 4)
        qlen: jnp.ndarray,     # int32[B]
        tlen: jnp.ndarray,     # int32[B]
        mat: jnp.ndarray,      # int32[25] scoring matrix
        o_del: int, e_del: int, o_ins: int, e_ins: int,
        w_in: jnp.ndarray,     # int32[B] band width per lane
        end_bonus: jnp.ndarray,  # int32[B]
        zdrop: int,
        h0: jnp.ndarray,       # int32[B]
        LQ: int, LT: int, packed: bool = False):
    """Returns (best, qle, tle, gtle, gscore, max_off), each int32[B]."""
    if packed:
        query = _unpack4(query, LQ)
        target = _unpack4(target, LT)
    return _extend_impl(query, target, qlen, tlen, mat, o_del, e_del,
                        o_ins, e_ins, w_in, end_bonus, zdrop, h0,
                        LQ, LT, None)


def _unpack4(p: jnp.ndarray, L: int) -> jnp.ndarray:
    """Expand the 4-bit-packed wire format (two bases per byte, values
    0..4 so the byte stays < 0x7F) back to one int8 base per column —
    sequences ship at 2 bases/byte to halve the wave upload."""
    lo = (p & 0xF).astype(jnp.int8)
    hi = ((p >> 4) & 0xF).astype(jnp.int8)
    return jnp.stack([lo, hi], axis=-1).reshape(p.shape[0], L)


def _extend_impl(query, target, qlen, tlen, mat,
                 o_del, e_del, o_ins, e_ins, w_in, end_bonus, zdrop, h0,
                 LQ: int, LT: int, active):
    """Traceable body of ksw_extend2_batched; `active` (bool[B] or
    None) masks lanes off entirely (used by the fused left+right
    kernel's masked band-retry passes)."""
    B = query.shape[0]
    i32 = jnp.int32
    # sequences ship from the host as int8 (bases are 0..4) to quarter
    # the per-wave transfer volume; widen on-device
    query = query.astype(i32)
    target = target.astype(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    h0 = jnp.maximum(h0, 0)

    mat55 = mat.reshape(5, 5)
    max_sc = jnp.max(mat).astype(i32)

    # band clamp (ksw.c:398-406); the C float math truncates toward zero
    qlen_f = qlen.astype(jnp.float64)
    max_ins = (((qlen_f * max_sc + end_bonus - o_ins) / e_ins + 1.0)
               .astype(i32))
    max_ins = jnp.maximum(max_ins, 1)
    w = jnp.minimum(w_in, max_ins)
    max_del = (((qlen_f * max_sc + end_bonus - o_del) / e_del + 1.0)
               .astype(i32))
    max_del = jnp.maximum(max_del, 1)
    w = jnp.minimum(w, max_del)


    jv = jnp.arange(LQ + 1, dtype=i32)[None, :]          # [1, LQ+1]
    jq = jnp.arange(LQ, dtype=i32)[None, :]              # [1, LQ]

    # profile: qp[b, j] per row is mat55[target[b,i], query[b,j]]
    # initial eh (ksw.c:390-396): eh_h[j] = max(h0 - oe_ins - (j-1)e_ins, 0)
    eh_h = jnp.where(jv == 0, h0[:, None],
                     jnp.maximum(h0[:, None] - oe_ins
                                 - (jv - 1) * e_ins, 0)).astype(i32)
    eh_h = jnp.where(jv <= qlen[:, None], eh_h, 0)
    eh_e = jnp.zeros((B, LQ + 1), i32)

    done0 = tlen <= 0
    if active is not None:
        done0 = done0 | ~active
    state = dict(
        i=jnp.zeros(B, i32),
        eh_h=eh_h, eh_e=eh_e,
        beg=jnp.zeros(B, i32), end=qlen.astype(i32),
        best=h0.astype(i32),
        max_i=jnp.full(B, -1, i32), max_j=jnp.full(B, -1, i32),
        max_ie=jnp.full(B, -1, i32), gscore=jnp.full(B, -1, i32),
        max_off=jnp.zeros(B, i32),
        done=done0,
    )

    def body(st):
        i = st["i"]
        alive = ~st["done"] & (i < tlen)
        h1 = jnp.maximum(h0 - (o_del + e_del * (i + 1)), 0)
        beg = jnp.maximum(st["beg"], i - w)
        end = jnp.minimum(jnp.minimum(st["end"], i + w + 1), qlen)
        degen = beg >= end
        run = alive & ~degen

        # row profile (mask-select over the 5x5 matrix)
        ii = jnp.clip(i, 0, LT - 1)
        tch = sel_col(target, ii)                                   # [B]
        qp = score_profile(mat55, tch, query)                       # [B, LQ]
        band = (jq >= beg[:, None]) & (jq < end[:, None])

        hdiag = st["eh_h"][:, :LQ]
        e = st["eh_e"][:, :LQ]
        g = jnp.where(band, hdiag + qp, NEG)
        g = jnp.maximum(g, jnp.where(band, e, NEG))
        # F prefix scan within the band
        a_vec = jnp.where(band, g + jq * e_ins, NEG)
        cm = lax.associative_scan(jnp.maximum, a_vec, axis=1)
        cm_prev = jnp.concatenate(
            [jnp.full((B, 1), NEG, i32), cm[:, :-1]], axis=1)
        f = jnp.maximum(cm_prev - oe_ins - (jq - 1) * e_ins, 0)
        f = jnp.where(jq == beg[:, None], 0, f)
        h = jnp.maximum(g, f)
        h = jnp.where(band, h, 0)

        mrow = jnp.max(jnp.where(band, h, 0), axis=1).astype(i32)
        # mj: LAST band index achieving mrow (ties take later index);
        # when mrow == 0 the C running-max never fires -> mj = end-1
        hit = band & (h >= mrow[:, None]) & (mrow[:, None] > 0)
        mj = jnp.max(jnp.where(hit, jq, -1), axis=1).astype(i32)
        mj = jnp.where(mrow > 0, mj, end - 1)

        # E update + H shift-store (ksw.c:436-447)
        t_ = jnp.maximum(h - oe_del, 0)
        new_e = jnp.maximum(e - e_del, t_)
        eh_e = jnp.where(band & run[:, None], new_e, st["eh_e"][:, :LQ])
        eh_e = jnp.concatenate([eh_e, st["eh_e"][:, LQ:]], axis=1)
        # eh_e[end] = 0
        eh_e = jnp.where(run[:, None] & (jv == end[:, None]), 0, eh_e)

        h_shift = jnp.concatenate([jnp.zeros((B, 1), i32), h], axis=1)
        store = (jv >= beg[:, None] + 1) & (jv <= end[:, None])
        eh_h_new = jnp.where(store, h_shift, st["eh_h"])
        eh_h_new = jnp.where(jv == beg[:, None], h1[:, None], eh_h_new)
        eh_h_new = jnp.where(run[:, None], eh_h_new, st["eh_h"])

        h1_last = sel_col(h, jnp.clip(end - 1, 0, LQ - 1))
        at_q_end = run & (end == qlen)
        g_upd = at_q_end & (st["gscore"] <= h1_last)
        # a degenerate band (C's empty inner row, j stays at beg) still
        # applies the j==qlen gscore update with the first-column h1
        # before its m==0 break (software/ksw.c:450-456)
        g_upd_d = alive & degen & (beg == qlen) & (st["gscore"] <= h1)
        max_ie = jnp.where(g_upd | g_upd_d, i, st["max_ie"])
        gscore = jnp.where(g_upd, h1_last,
                           jnp.where(g_upd_d, h1, st["gscore"]))

        zero_brk = run & (mrow == 0)
        improved = run & ~zero_brk & (mrow > st["best"])
        best = jnp.where(improved, mrow, st["best"])
        max_i = jnp.where(improved, i, st["max_i"])
        max_j = jnp.where(improved, mj, st["max_j"])
        off = jnp.abs(mj - i)
        max_off = jnp.where(improved & (st["max_off"] < off), off,
                            st["max_off"])
        # z-drop (ksw.c:455-462) on non-improving rows
        di = i - st["max_i"]
        dj = mj - st["max_j"]
        zd = jnp.where(
            di > dj,
            st["best"] - mrow - (di - dj) * e_del,
            st["best"] - mrow - (dj - di) * e_ins)
        z_brk = (run & ~zero_brk & ~improved & (zdrop > 0)
                 & (zd > zdrop))

        done = st["done"] | (alive & degen) | zero_brk | z_brk \
            | (~alive & ~st["done"])
        cont = run & ~zero_brk & ~z_brk

        # band narrowing over the NEW eh_h (ksw.c:463-466)
        z0 = eh_h_new == 0
        lowz = z0 & (jv >= beg[:, None]) & (jv <= mj[:, None])
        beg_new = jnp.max(jnp.where(lowz, jv, beg[:, None] - 1),
                          axis=1).astype(i32) + 1
        hiz = z0 & (jv >= mj[:, None] + 2) & (jv <= end[:, None])
        first_hi = jnp.min(jnp.where(hiz, jv, LQ + 2), axis=1).astype(i32)
        end_cap = jnp.maximum(mj + 2, end + 1)
        end_new = jnp.minimum(first_hi, end_cap)

        return dict(
            i=jnp.where(cont, i + 1, i),
            eh_h=eh_h_new, eh_e=eh_e,
            beg=jnp.where(cont, beg_new, beg),
            end=jnp.where(cont, end_new, end),
            best=best, max_i=max_i, max_j=max_j,
            max_ie=max_ie, gscore=gscore, max_off=max_off,
            done=done,
        )

    def cond(st):
        return jnp.any(~st["done"] & (st["i"] < tlen))

    from .loops import unroll_body
    st = lax.while_loop(cond, unroll_body(body), state)
    return (st["best"], st["max_j"] + 1, st["max_i"] + 1,
            st["max_ie"] + 1, st["gscore"], st["max_off"])


@partial(jax.jit, static_argnames=("LQ", "LT", "o_del", "e_del",
                                   "o_ins", "e_ins", "packed"))
def ksw_global2_batched(
        query: jnp.ndarray,    # int32[B, LQ] nt4 (pad 4)
        target: jnp.ndarray,   # int32[B, LT] nt4 (pad 4)
        qlen: jnp.ndarray,     # int32[B]
        tlen: jnp.ndarray,     # int32[B]
        mat: jnp.ndarray,      # int32[25]
        o_del: int, e_del: int, o_ins: int, e_ins: int,
        w_in: jnp.ndarray,     # int32[B] band width per lane
        LQ: int, LT: int, packed: bool = False):
    """Batched banded global alignment with on-device traceback
    (software/ksw.c:501-585).  Direction flags are stored at absolute
    query columns (the reference's banded z-matrix addressing collapses
    to plain [row, column] when the matrix isn't compacted).

    Returns (score, ops, n_ops, rem_i, rem_k):
      score int32[B]   — eh_h[qlen]
      ops  uint8[B, LT+LQ] — traceback ops (0=M 1=I 2=D) in reverse order
      n_ops int32[B]
      rem_i/rem_k int32[B] — the loop-exit i/k; the host appends
      (rem_i+1) deletions / (rem_k+1) insertions then reverses + RLEs.
    """
    B = query.shape[0]
    i32 = jnp.int32
    if packed:
        query = _unpack4(query, LQ)
        target = _unpack4(target, LT)
    query = query.astype(i32)   # int8 on the wire (see ksw_extend2)
    target = target.astype(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    w = w_in.astype(i32)

    mat55 = mat.reshape(5, 5)
    jv = jnp.arange(LQ + 1, dtype=i32)[None, :]
    jq = jnp.arange(LQ, dtype=i32)[None, :]

    # init (ksw.c:520-526)
    eh_h = jnp.where(jv == 0, 0,
                     jnp.where((jv >= 1) & (jv <= jnp.minimum(qlen, w)[:, None]),
                               -(o_ins + e_ins * jv), NEG)).astype(i32)
    eh_e = jnp.full((B, LQ + 1), NEG, i32)

    def row(i, carry):
        eh_h, eh_e, z = carry
        run = i < tlen
        beg = jnp.maximum(i - w, 0)
        end = jnp.minimum(i + w + 1, qlen)
        h1 = jnp.where(beg == 0, -(o_del + e_del * (i + 1)), NEG)
        degen = end <= beg
        do = run & ~degen

        # row index is uniform across lanes: a dynamic slice, not a gather
        tch = lax.dynamic_slice_in_dim(
            target, jnp.clip(i, 0, LT - 1), 1, axis=1)[:, 0]
        qp = score_profile(mat55, tch, query)                   # [B, LQ]
        band = (jq >= beg[:, None]) & (jq < end[:, None])

        hdiag = eh_h[:, :LQ]
        e = eh_e[:, :LQ]
        mm = jnp.where(band, hdiag + qp, NEG)
        a_vec = jnp.where(band, mm + jq * e_ins, NEG2)
        cm = lax.associative_scan(jnp.maximum, a_vec, axis=1)
        cm_prev = jnp.concatenate(
            [jnp.full((B, 1), NEG2, i32), cm[:, :-1]], axis=1)
        # decayed band-edge init term matters for exact direction flags
        f = jnp.maximum(cm_prev - oe_ins - (jq - 1) * e_ins,
                        NEG - (jq - beg[:, None]) * e_ins)
        f = jnp.where(jq == beg[:, None], NEG, f)

        d = jnp.where(mm >= e, 0, 1).astype(jnp.uint8)
        h = jnp.maximum(mm, e)
        d = jnp.where(h >= f, d, jnp.uint8(2))
        h = jnp.maximum(h, f)
        e2 = e - e_del
        t_ = mm - oe_del
        d = d | jnp.where(e2 > t_, jnp.uint8(1 << 2), jnp.uint8(0))
        new_e = jnp.maximum(e2, t_)
        f2 = f - e_ins
        t2 = mm - oe_ins
        d = d | jnp.where(f2 > t2, jnp.uint8(2 << 4), jnp.uint8(0))

        z = z.at[:, i, :].set(
            jnp.where(band & do[:, None], d, z[:, i, :]))

        eh_e_new = jnp.where(band, new_e, e)
        eh_e_new = jnp.concatenate([eh_e_new, eh_e[:, LQ:]], axis=1)
        eh_e_new = jnp.where(jv == end[:, None], NEG, eh_e_new)
        h_shift = jnp.concatenate([jnp.zeros((B, 1), i32), h], axis=1)
        store = (jv >= beg[:, None] + 1) & (jv <= end[:, None])
        eh_h_new = jnp.where(store, h_shift, eh_h)
        eh_h_new = jnp.where(jv == beg[:, None], h1[:, None], eh_h_new)

        # degenerate rows only store eh_h[end]=h1, eh_e[end]=NEG
        eh_h_deg = jnp.where(jv == end[:, None], h1[:, None], eh_h)
        eh_e_deg = jnp.where(jv == end[:, None], NEG, eh_e)

        eh_h = jnp.where(do[:, None], eh_h_new,
                         jnp.where(run[:, None] & degen[:, None],
                                   eh_h_deg, eh_h))
        eh_e = jnp.where(do[:, None], eh_e_new,
                         jnp.where(run[:, None] & degen[:, None],
                                   eh_e_deg, eh_e))
        return eh_h, eh_e, z

    from .loops import unroll_body
    z0 = jnp.zeros((B, LT, LQ), jnp.uint8)
    # early-exit row loop: rows past every lane's tlen are no-ops (the
    # row body masks on i < tlen), so a while_loop stops at the max
    # LIVE target length instead of always paying LT rows
    def wrow(st):
        i, carry = st
        return i + 1, row(i, carry)

    def wcond(st):
        return st[0] < jnp.max(tlen)

    _, (eh_h, eh_e, z) = lax.while_loop(
        wcond, unroll_body(wrow), (jnp.int32(0), (eh_h, eh_e, z0)))
    score = sel_col(eh_h, qlen)

    # traceback (ksw.c:570-584)
    MAXOPS = LT + LQ
    ops0 = jnp.zeros((B, MAXOPS), jnp.uint8)

    def tb_body(st):
        i, k, which, n, ops, done = st
        act = ~done
        zi = jnp.clip(i, 0, LT - 1)
        zk = jnp.clip(k, 0, LQ - 1)
        dcode = sel_col(sel_row(z, zi), zk).astype(i32)
        which_new = (dcode >> (which << 1)) & 3
        op = jnp.where(which_new == 0, 0,
                       jnp.where(which_new == 1, 2, 1)).astype(jnp.uint8)
        idx = jnp.where(act, n, MAXOPS)
        ops = set_col(ops, idx, op)
        di = jnp.where(which_new != 2, 1, 0)
        dk = jnp.where(which_new != 1, 1, 0)
        i = jnp.where(act, i - di, i)
        k = jnp.where(act, k - dk, k)
        which = jnp.where(act, which_new, which)
        n = n + act.astype(i32)
        done = done | (i < 0) | (k < 0)
        return i, k, which, n, ops, done

    def tb_cond(st):
        return jnp.any(~st[-1])

    i0 = tlen - 1
    k0 = jnp.minimum(i0 + w + 1, qlen) - 1
    st = (i0, k0, jnp.zeros(B, i32), jnp.zeros(B, i32), ops0,
          (i0 < 0) | (k0 < 0))
    i_f, k_f, _, n_ops, ops, _ = lax.while_loop(
        tb_cond, unroll_body(tb_body), st)
    return score, ops, n_ops, i_f, k_f


@partial(jax.jit, static_argnames=("LQ", "LT", "o_del", "e_del",
                                   "o_ins", "e_ins", "w0", "pc5",
                                   "pc3", "zdrop", "packed"))
def ksw_extend_lr_batched(
        lq, lt,                # int8[B, LQ]/[B, LT] left query/target
                               # (both pre-reversed, bwamem.c:1123-1128)
        llq, llt,              # int32[B] left lengths (0 = no left ext)
        rq, rt,                # int8[B, LQ]/[B, LT] right query/target
        rlq, rlt,              # int32[B] right lengths (0 = no right)
        mat,                   # int32[25]
        o_del: int, e_del: int, o_ins: int, e_ins: int,
        w0: int,               # opt.w (band attempt 0; attempt 1 = 2w)
        pc5: int, pc3: int,    # pen_clip5 / pen_clip3
        zdrop: int,
        sc_seed,               # int32[B] s_len * opt.a
        s_qbeg,                # int32[B]
        s_rbeg,                # int64[B]
        rmax0,                 # int64[B]
        l_query,               # int32[B]
        s_len,                 # int32[B]
        LQ: int, LT: int, packed: bool = False):
    """One seed's whole left+right extension with the x2 band-doubling
    retries on device (the C logic around ksw_extend2,
    software/bwamem.c:1120-1176; scalar twin core.swdrive.extend_seed_lr)
    — ONE dispatch replaces up to four per-call waves.

    Returns (score, truesc, qb, rb, qe, re, aw0, aw1): rb/re int64
    genome coordinates, the rest int32[B]."""
    if packed:
        lq, rq = _unpack4(lq, LQ), _unpack4(rq, LQ)
        lt, rt = _unpack4(lt, LT), _unpack4(rt, LT)
    i32 = jnp.int32
    B = lq.shape[0]
    w0v = jnp.full(B, w0, i32)
    w1v = jnp.full(B, w0 * 2, i32)
    pc5v = jnp.full(B, pc5, i32)
    pc3v = jnp.full(B, pc3, i32)
    retry_hi = (w0 >> 1) + (w0 >> 2)       # max_off threshold at w0

    has_l = llq > 0
    a0 = _extend_impl(lq, lt, llq, llt, mat, o_del, e_del, o_ins, e_ins,
                      w0v, pc5v, zdrop, sc_seed, LQ, LT, has_l)
    sc_a0, qle0, tle0, gtle0, gsc0, mo0 = a0
    # bwamem.c:1136-1138: break if score == prev (== -1 on attempt 0)
    # or max_off small; else retry at double band
    retry_l = has_l & (sc_a0 != -1) & (mo0 >= retry_hi)
    a1 = _extend_impl(lq, lt, llq, llt, mat, o_del, e_del, o_ins, e_ins,
                      w1v, pc5v, zdrop, sc_seed, LQ, LT, retry_l)

    def pick(r, v0, v1):
        return jnp.where(r, v1, v0)
    lsc = pick(retry_l, sc_a0, a1[0])
    lqle = pick(retry_l, qle0, a1[1])
    ltle = pick(retry_l, tle0, a1[2])
    lgtle = pick(retry_l, gtle0, a1[3])
    lgsc = pick(retry_l, gsc0, a1[4])
    aw0 = jnp.where(has_l, pick(retry_l, w0v, w1v), w0v)

    # left decision (bwamem.c:1140-1148)
    g_ok = (lgsc <= 0) | (lgsc <= lsc - pc5)
    score = jnp.where(has_l, lsc, sc_seed)
    truesc = jnp.where(has_l, jnp.where(g_ok, lsc, lgsc), sc_seed)
    qb = jnp.where(has_l & g_ok, s_qbeg - lqle, 0)
    rb = jnp.where(has_l,
                   jnp.where(g_ok, s_rbeg - ltle.astype(s_rbeg.dtype),
                             s_rbeg - lgtle.astype(s_rbeg.dtype)),
                   s_rbeg)

    has_r = rlq > 0
    sc0 = score
    b0 = _extend_impl(rq, rt, rlq, rlt, mat, o_del, e_del, o_ins, e_ins,
                      w0v, pc3v, zdrop, sc0, LQ, LT, has_r)
    sc_b0, rqle0, rtle0, rgtle0, rgsc0, rmo0 = b0
    retry_r = has_r & (sc_b0 != sc0) & (rmo0 >= retry_hi)
    b1 = _extend_impl(rq, rt, rlq, rlt, mat, o_del, e_del, o_ins, e_ins,
                      w1v, pc3v, zdrop, sc0, LQ, LT, retry_r)
    rsc = pick(retry_r, sc_b0, b1[0])
    rqle = pick(retry_r, rqle0, b1[1])
    rtle = pick(retry_r, rtle0, b1[2])
    rgtle = pick(retry_r, rgtle0, b1[3])
    rgsc = pick(retry_r, rgsc0, b1[4])
    aw1 = jnp.where(has_r, pick(retry_r, w0v, w1v), w0v)

    # right decision (bwamem.c:1168-1176)
    re0 = s_rbeg + s_len.astype(s_rbeg.dtype) - rmax0
    g_ok_r = (rgsc <= 0) | (rgsc <= rsc - pc3)
    qe0 = l_query - rlq
    qe = jnp.where(has_r,
                   jnp.where(g_ok_r, qe0 + rqle, l_query), l_query)
    re = jnp.where(has_r,
                   rmax0 + re0 + jnp.where(g_ok_r, rtle,
                                           rgtle).astype(s_rbeg.dtype),
                   s_rbeg + s_len.astype(s_rbeg.dtype))
    truesc = jnp.where(has_r,
                       truesc + jnp.where(g_ok_r, rsc, rgsc) - sc0,
                       truesc)
    score = jnp.where(has_r, rsc, score)
    return (score, truesc, qb, rb, qe, re, aw0, aw1)
