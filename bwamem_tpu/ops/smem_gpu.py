"""The SMEM superstep as one GPU kernel (Pallas, Triton route).

`ops.smem.smem_superstep` runs the whole per-read SMEM iterator
(software/bwamem.c:110-241) for a lane group.  Its XLA form is a
lock-step while_loop nest over every lane of the dispatch: a round loop
around a forward and a backward extension loop, each iteration several
small device kernels.  Here the same iterator is one kernel launch:
each program owns BLOCK lanes and runs their rounds to completion with
the loop state held in registers, gathering occ rows straight from the
table in device memory with masked indexed loads (the FPGA PE's two
occ-line fetches per step, hardware/afu_core.v:1428-1432).

Semantics are the XLA twin's, operation for operation: the same
forward pushes, backward dedup, re-seed test, ordered merge key
(software/bwamem.c:206-238) and overflow flags.  The one difference is
what a lane that overflows leaves in its stream buffer past its count;
callers read only the first n_out entries of clean lanes.  The per-lane
streams come back dense, (B, OUT_CAP), and the caller compacts them
(`smem._compact_streams`) exactly as it does the twin's.

Coordinates stay in the index's own dtype (int32 below ~1 Gbp, int64
above); both are native on the GPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# lanes per program and warps per program; B must be a multiple of
# BLOCK (the engine's lane widths are)
BLOCK = 8
NUM_WARPS = 4

_M55 = 0x55555555


def shapes_ok(n_lanes: int, L: int, M: int) -> bool:
    """Whether the kernel takes these shapes: whole BLOCK-lane
    programs, and power-of-two read and interval-buffer widths (Triton
    block shapes)."""
    pow2 = lambda n: n > 0 and n & (n - 1) == 0
    return n_lanes > 0 and n_lanes % BLOCK == 0 and pow2(L) and pow2(M)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _sel4(v, c):
    """v[c] for a per-element base c in 0..3 over four same-shape
    tensors (the per-base candidate intervals of bwt_extend)."""
    return jnp.where(c == 0, v[0], jnp.where(
        c == 1, v[1], jnp.where(c == 2, v[2], v[3])))


def _any(x) -> jnp.ndarray:
    """Scalar any() (a max reduction: Triton has no or-reduce)."""
    return jnp.max(x.astype(jnp.int32)) > 0


def _any_rows(mask):
    return jnp.max(mask.astype(jnp.int32), axis=1) > 0


def _sel_col(vals, idx):
    """vals[b, idx[b]] over the small last axis."""
    jj = lax.broadcasted_iota(jnp.int32, vals.shape, 1)
    return jnp.sum(jnp.where(jj == idx[:, None], vals, 0), axis=1,
                   dtype=vals.dtype)


def _set_col(vals, idx, new):
    """vals with vals[b, idx[b]] = new[b]; idx == width drops."""
    jj = lax.broadcasted_iota(jnp.int32, vals.shape, 1)
    return jnp.where(jj == idx[:, None], new[:, None], vals)


def _gather_cols(vals, src, valid=None):
    """out[b, j] = vals[b, src[b, j]] (0 outside valid)."""
    B, M = vals.shape
    kk = lax.broadcasted_iota(jnp.int32, (B, M, M), 2)
    out = jnp.sum(jnp.where(src[:, :, None] == kk, vals[:, None, :], 0),
                  axis=2, dtype=vals.dtype)
    if valid is not None:
        out = jnp.where(valid, out, 0)
    return out


def _scatter_cols(vals, tgt):
    """out[b, j] = vals[b, k] where tgt[b, k] == j (unique targets;
    tgt == width drops)."""
    B, M = vals.shape
    jj = lax.broadcasted_iota(jnp.int32, (B, M, M), 1)
    return jnp.sum(jnp.where(tgt[:, None, :] == jj, vals[:, None, :], 0),
                   axis=2, dtype=vals.dtype)


def _count_before(mask, inclusive: bool):
    """Per-lane running count of `mask` along the last axis."""
    B, M = mask.shape
    j = lax.broadcasted_iota(jnp.int32, (B, M, M), 1)
    k = lax.broadcasted_iota(jnp.int32, (B, M, M), 2)
    before = (k <= j) if inclusive else (k < j)
    return jnp.sum((before & mask[:, None, :]).astype(jnp.int32), axis=2,
                   dtype=jnp.int32)


def _prev_valid_value(vals, valid, fill):
    """prev[b, j] = vals[b, j'] at the largest j' < j with valid, else
    fill."""
    B, M = vals.shape
    j = lax.broadcasted_iota(jnp.int32, (B, M, M), 1)
    k = lax.broadcasted_iota(jnp.int32, (B, M, M), 2)
    cand = (k < j) & valid[:, None, :]
    last = jnp.max(jnp.where(cand, k, -1), axis=2)
    got = _gather_cols(vals, jnp.maximum(last, 0))
    return jnp.where(last >= 0, got, jnp.asarray(fill, vals.dtype))


def _superstep_kernel(tab_ref, cst_ref, q_ref, qlen_ref, mi_ref, act_ref,
                      slen_ref, swid_ref,
                      o0_ref, o1_ref, os_ref, oqb_ref, oqe_ref, n_ref,
                      ov_ref, *, L: int, M: int, OUT_CAP: int,
                      packed: bool):
    i32 = jnp.int32
    cdt = cst_ref.dtype
    B = qlen_ref.shape[0]
    OC = o0_ref.shape[1]
    n_rows = tab_ref.shape[0]
    lanes = lax.broadcasted_iota(i32, (B,), 0)
    jj = lax.broadcasted_iota(i32, (B, M), 1)
    L2 = [cst_ref[c] for c in range(5)]
    primary = cst_ref[5]

    qlen = qlen_ref[...]
    min_intv0 = mi_ref[...]
    split_len = slen_ref[...]
    split_width = swid_ref[...].astype(cdt)

    for r in (o0_ref, o1_ref, os_ref, oqb_ref, oqe_ref):
        r[...] = jnp.zeros(r.shape, r.dtype)

    def qbase(ii):
        """Query base at column ii per lane (4 = ambiguous/pad)."""
        if packed:
            byte = q_ref[lanes, ii >> 1].astype(i32)
            return (byte >> ((ii & 1) * 4)) & 15
        return q_ref[lanes, ii].astype(i32)

    def occ4(k):
        """bwt_occ4 (software/bwt.c:187-204) per element of k: four
        per-base counts of bwt[0..k], 0 where k < 0."""
        shp = k.shape
        valid = k >= 0
        kk = jnp.where(valid, k - (k >= primary).astype(cdt), 0)
        # clamp like XLA's gather, so no lane can fault the load
        blk = jnp.clip((kk >> 7).astype(i32), 0, n_rows - 1)
        off = (kk & 127).astype(i32)
        wi = off >> 4
        r = (~off) & 15
        shp8 = shp + (8,)
        j8 = lax.broadcasted_iota(i32, shp8, len(shp))
        words = tab_ref[jnp.broadcast_to(blk[..., None], shp8), j8 + 8]
        pmask = ~((jnp.ones_like(r) << (r * 2)) - 1)
        wmask = jnp.where(j8 < wi[..., None], -1,
                          jnp.where(j8 == wi[..., None], pmask[..., None],
                                    0))
        w = words & wmask
        hb = lax.shift_right_logical(w, jnp.int32(1)) & _M55
        lb = w & _M55
        c3 = jnp.sum(lax.population_count(hb & lb), axis=-1,
                     dtype=i32)
        c2 = jnp.sum(lax.population_count(hb & ~lb), axis=-1,
                     dtype=i32)
        c1 = jnp.sum(lax.population_count(lb & ~hb), axis=-1,
                     dtype=i32)
        c0 = (off + 1) - c1 - c2 - c3
        out = []
        for b, cb in enumerate((c0, c1, c2, c3)):
            lo = tab_ref[blk, 2 * b]
            if cdt == jnp.int64:
                ck = ((lo.astype(jnp.int64) & 0xFFFFFFFF)
                      | (tab_ref[blk, 2 * b + 1].astype(jnp.int64) << 32))
            else:
                ck = lo
            out.append(jnp.where(valid, ck + cb.astype(cdt), 0))
        return out

    def extend_sel(x0, x1, s, c, is_back: bool):
        """bwt_extend (software/bwt.c:416-429) for the one base c."""
        fwd = x0 if is_back else x1
        tk = occ4(fwd - 1)
        tl = occ4(fwd - 1 + s)
        oks = [tl[b] - tk[b] for b in range(4)]
        occ_side = [L2[b] + 1 + tk[b] for b in range(4)]
        bump = ((fwd <= primary) & (fwd + s - 1 >= primary)).astype(cdt)
        same3 = (x1 if is_back else x0) + bump
        same2 = same3 + oks[3]
        same1 = same2 + oks[2]
        same0 = same1 + oks[1]
        same = _sel4((same0, same1, same2, same3), c)
        side = _sel4(occ_side, c)
        ns = _sel4(oks, c)
        return (side, same, ns) if is_back else (same, side, ns)

    def smem1(x, min_intv, active):
        """bwt_smem1 (software/bwt.c:776-835) for every lane; see
        smem._smem1_impl."""
        qx = qbase(jnp.clip(x, 0, L - 1))
        bad = (qx > 3) | ~active
        qx_c = jnp.where(bad, 0, qx)
        min_intv = jnp.maximum(min_intv, 1).astype(cdt)
        ik0 = cst_ref[qx_c] + 1
        ik1 = cst_ref[3 - qx_c] + 1
        iks = cst_ref[qx_c + 1] - cst_ref[qx_c]
        zc = jnp.zeros((B, M), cdt)
        zi = jnp.zeros((B, M), i32)

        def fwd_body(st):
            (i, ik0, ik1, iks, ikend, c0, c1, cs, cend, n_curr,
             done_c) = st
            done = done_c != 0
            at_end = i >= qlen
            ii = jnp.clip(jnp.minimum(i, qlen - 1), 0, L - 1)
            cb = qbase(ii)
            is_amb = cb > 3
            cc = jnp.where(is_amb, 0, 3 - cb)
            n0, n1, ns = extend_sel(ik0, ik1, iks, cc, is_back=False)
            changed = ns != iks
            small = ns < min_intv
            push = ~done & (at_end | is_amb | changed)
            stop = ~done & (at_end | is_amb | (changed & small))
            idx = jnp.where(push, n_curr, M)
            c0 = _set_col(c0, idx, ik0)
            c1 = _set_col(c1, idx, ik1)
            cs = _set_col(cs, idx, iks)
            cend = _set_col(cend, idx, ikend)
            n_curr = n_curr + push.astype(i32)
            cont = ~done & ~stop
            ik0 = jnp.where(cont, n0, ik0)
            ik1 = jnp.where(cont, n1, ik1)
            iks = jnp.where(cont, ns, iks)
            ikend = jnp.where(cont, i + 1, ikend)
            done = done | stop
            i = i + (~done).astype(i32)
            return (i, ik0, ik1, iks, ikend, c0, c1, cs, cend, n_curr,
                    done.astype(i32))

        st = (x + 1, ik0, ik1, iks, x + 1, zc, zc, zc, zi,
              jnp.zeros((B,), i32), bad.astype(i32))
        st = lax.while_loop(lambda s: _any(s[-1] == 0), fwd_body, st)
        (_, _, _, _, _, c0, c1, cs, cend, n_curr, _) = st
        overflow = n_curr > M
        last = jnp.clip(n_curr - 1, 0, M - 1)
        ret = jnp.where(n_curr > 0, _sel_col(cend, last), x + 1)
        src = jnp.clip(n_curr[:, None] - 1 - jj, 0, M - 1)
        p0 = _gather_cols(c0, src)
        p1 = _gather_cols(c1, src)
        ps = _gather_cols(cs, src)
        pend = _gather_cols(cend, src)

        def bwd_body(st):
            (i, p0, p1, ps, pend, n_prev, m0, m1, ms, mqb, mqe, n_mem,
             done_c) = st
            done = done_c != 0
            cb = qbase(jnp.clip(i, 0, L - 1))
            c = jnp.where((i < 0) | (cb > 3), -1, cb)
            csel = jnp.broadcast_to(jnp.clip(c, 0, 3)[:, None], (B, M))
            n0, n1, ns = extend_sel(p0, p1, ps, csel, is_back=True)
            present = (jj < n_prev[:, None]) & ~done[:, None]
            fail = (c[:, None] < 0) | (ns < min_intv[:, None])
            nonfail = present & ~fail
            prev_s = _prev_valid_value(ns, nonfail, -1)
            nf_before = _count_before(nonfail, inclusive=False)
            first_nf = nonfail & (nf_before == 0)
            keep = nonfail & (first_nf | (ns != prev_s))
            pos = _count_before(keep, inclusive=True) - 1
            tgt = jnp.where(keep, pos, M)
            nc0 = _scatter_cols(n0, tgt)
            nc1 = _scatter_cols(n1, tgt)
            ncs = _scatter_cols(ns, tgt)
            ncend = _scatter_cols(pend, tgt)
            n_curr_new = jnp.sum(keep.astype(i32), axis=1, dtype=i32)
            cand = present & fail & (nf_before == 0)
            has_cand = _any_rows(cand)
            jstar = jnp.min(jnp.where(cand, jj, M), axis=1)
            jstar = jnp.where(has_cand, jstar, 0)
            lastm = jnp.maximum(n_mem - 1, 0)
            allow = (n_mem == 0) | ((i + 1) < _sel_col(mqb, lastm))
            do_mem = ~done & has_cand & allow
            midx = jnp.where(do_mem, n_mem, M)
            m0 = _set_col(m0, midx, _sel_col(p0, jstar))
            m1 = _set_col(m1, midx, _sel_col(p1, jstar))
            ms = _set_col(ms, midx, _sel_col(ps, jstar))
            mqb = _set_col(mqb, midx, i + 1)
            mqe = _set_col(mqe, midx, _sel_col(pend, jstar))
            n_mem = n_mem + do_mem.astype(i32)
            done = done | (n_curr_new == 0)
            i = i - (~done).astype(i32)
            return (i, nc0, nc1, ncs, ncend, n_curr_new, m0, m1, ms, mqb,
                    mqe, n_mem, done.astype(i32))

        st = (x - 1, p0, p1, ps, pend, n_curr, zc, zc, zc, zi, zi,
              jnp.zeros((B,), i32), (bad | (n_curr == 0)).astype(i32))
        st = lax.while_loop(lambda s: _any(s[-1] == 0), bwd_body, st)
        (_, _, _, _, _, _, m0, m1, ms, mqb, mqe, n_mem, _) = st
        # qb-ascending order (software/bwt.c:833)
        src = jnp.clip(n_mem[:, None] - 1 - jj, 0, M - 1)
        valid = jj < n_mem[:, None]
        return (ret, n_mem, _gather_cols(m0, src, valid),
                _gather_cols(m1, src, valid), _gather_cols(ms, src, valid),
                _gather_cols(mqb, src, valid),
                _gather_cols(mqe, src, valid), overflow)

    KR = 256 if L <= 256 else 1024
    BIG = 2 ** 30
    lanes2 = jnp.broadcast_to(lanes[:, None], (B, M))

    def put(col, mask, vals):
        # masked-off elements aim at the spare last column, which no
        # stream entry reaches (OC > OUT_CAP), so no address is shared
        # with a live entry even where a store is emulated
        colc = jnp.where(mask, col, OC - 1)
        for ref, v in zip((o0_ref, o1_ref, os_ref, oqb_ref, oqe_ref), vals):
            plgpu.store(ref.at[lanes2, colc], v.astype(ref.dtype),
                        mask=mask)

    def round_body(st):
        x, n_out, over_c, done_c = st
        act = done_c == 0
        ret, n_mem, m0, m1, ms, mqb, mqe, ov1 = smem1(x, min_intv0, act)
        ov1 = ov1 | (n_mem > M)
        # re-seeding test (software/bwamem.c:185-204)
        valid_m = jj < n_mem[:, None]
        lens = jnp.where(valid_m, mqe - mqb, -1)
        best_v = jnp.max(lens, axis=1)
        best = jnp.min(jnp.where(lens == best_v[:, None], jj, M), axis=1)
        best_len = _sel_col(lens, best)
        bs = _sel_col(ms, best)
        bqb = _sel_col(mqb, best)
        bqe = _sel_col(mqe, best)
        need2 = (act & (n_mem > 0) & (split_len > 0)
                 & (best_len >= split_len) & (bs <= split_width) & ~ov1)
        x2 = (bqb + bqe) >> 1
        _, n2, s0, s1, ss, sqb, sqe, ov2 = smem1(
            jnp.where(need2, x2, 0), jnp.where(need2, bs + 1, 1), need2)
        n2 = jnp.where(need2, n2, 0)
        ov2 = need2 & (ov2 | (n2 > M))

        # ordered merge (software/bwamem.c:206-238), sub first on key
        # ties; the key is the reference's (qb<<32)|(qlen-qe) in int32
        key_m = mqb * KR + (qlen[:, None] - mqe)
        key_s = sqb * KR + (qlen[:, None] - sqe)
        keep_s = ((jj < n2[:, None])
                  & ((sqe - sqb) >= (best_len[:, None] >> 1))
                  & (sqe > x[:, None]))
        pos_s = _count_before(keep_s, inclusive=True) - 1
        ns = jnp.sum(keep_s.astype(i32), axis=1, dtype=i32)
        km = jnp.where(valid_m, key_m, BIG)
        ks = jnp.where(keep_s, key_s, BIG)
        le = (ks[:, None, :] <= km[:, :, None]) & keep_s[:, None, :]
        rank_m = jj + jnp.sum(le.astype(i32), axis=2, dtype=i32)
        lt = (km[:, None, :] < ks[:, :, None]) & valid_m[:, None, :]
        rank_s = pos_s + jnp.sum(lt.astype(i32), axis=2, dtype=i32)

        n_new = n_out + jnp.where(act, n_mem + ns, 0)
        over_now = act & (ov1 | ov2 | (n_new > OUT_CAP))
        wr = (act & ~over_now)[:, None]
        put(n_out[:, None] + rank_m, wr & valid_m, (m0, m1, ms, mqb, mqe))
        put(n_out[:, None] + rank_s, wr & keep_s, (s0, s1, ss, sqb, sqe))
        over = (over_c != 0) | over_now
        n_out = jnp.where(act & ~over_now, n_new, n_out)
        x = jnp.where(act, ret, x)
        done = ~act | over_now | (x >= qlen)
        return x, n_out, over.astype(i32), done.astype(i32)

    active = act_ref[...] != 0
    x0 = jnp.zeros((B,), i32)
    st = (x0, jnp.zeros((B,), i32), jnp.zeros((B,), i32),
          (~active | (x0 >= qlen)).astype(i32))
    st = lax.while_loop(lambda s: _any(s[-1] == 0), round_body, st)
    _, n_out, over_c, _ = st
    n_ref[...] = n_out
    ov_ref[...] = over_c


@partial(jax.jit, static_argnames=("L", "M", "OUT_CAP", "packed",
                                   "interpret"))
def superstep(blocks, primary, L2, q, qlen, min_intv, active, split_len,
              split_width, *, L: int, M: int, OUT_CAP: int,
              packed: bool = False, interpret: bool = False):
    """The SMEM superstep for B lanes (B % BLOCK == 0).

    blocks: (n_blocks, 16) uint32 occ table; q: (B, L) int8 bases, or
    (B, L/2) two per byte when `packed`.  Returns (o0, o1, os, oqb,
    oqe, n_out, overflow): per-lane streams (B, OUT_CAP) in the
    coordinate dtype / int32, counts int32[B], overflow bool[B].
    `interpret` runs the kernel body through the Pallas interpreter
    (tests on hosts without a GPU)."""
    B = q.shape[0]
    assert shapes_ok(B, L, M), (B, L, M)
    cdt = L2.dtype
    i32 = jnp.int32
    tab = lax.bitcast_convert_type(blocks, i32)
    cst = jnp.concatenate([L2.astype(cdt), jnp.reshape(primary, (1,)).astype(cdt),
                           jnp.zeros(2, cdt)])
    OC = _pow2_at_least(OUT_CAP + 1)
    QW = q.shape[1]
    lane = lambda w: pl.BlockSpec((BLOCK, w), lambda g: (g, 0))
    vec = pl.BlockSpec((BLOCK,), lambda g: (g,))
    full = lambda a: pl.BlockSpec(a.shape, lambda g: (0,) * a.ndim)
    outs = pl.pallas_call(
        partial(_superstep_kernel, L=L, M=M, OUT_CAP=OUT_CAP,
                packed=packed),
        grid=(B // BLOCK,),
        in_specs=[full(tab), full(cst), lane(QW), vec, vec, vec, vec, vec],
        out_specs=[lane(OC)] * 5 + [vec, vec],
        out_shape=[jax.ShapeDtypeStruct((B, OC), cdt)] * 3
        + [jax.ShapeDtypeStruct((B, OC), i32)] * 2
        + [jax.ShapeDtypeStruct((B,), i32)] * 2,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="smem_superstep",
    )(tab, cst, q, qlen.astype(i32), min_intv.astype(cdt),
      active.astype(i32), split_len.astype(i32), split_width.astype(i32))
    o0, o1, os_, oqb, oqe, n_out, over = outs
    cut = lambda a: a[:, :OUT_CAP]
    return (cut(o0), cut(o1), cut(os_), cut(oqb), cut(oqe), n_out,
            over != 0)
