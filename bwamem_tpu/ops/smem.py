"""Batched SMEM search on device — the equivalent of the reference's
16-PE FPGA SMEM engine.

One `smem1_batched` call runs bwt_smem1 (software/bwt.c:776-835; RTL
PE_read hardware/afu_core.v:4371-5402; batched CPU transcription
software/bwt.c:299-414) for a whole batch of reads in lock-step, the
analog of one accelerator dispatch (software/bwt.c:558-757).  Where each
FPGA PE walks one read and issues its two occ-line fetches per step, here
every extension step issues the occ gathers for *all* lanes of the batch
at once — latency hiding by width instead of by 16-way multithreading.

Shapes are static: B reads of length <= L, interval buffers of width
M = L + 1 (an upper bound: forward pushes at most one interval per query
position, the backward pass keeps at most one interval per distinct
size, and sizes strictly shrink along positions — so M never overflows
and there is no fallback path to take).

Interval info is carried as explicit (qb, qe) int32 coordinates instead
of the reference's packed (start<<32|end) uint64 (software/bwt.c:592).

`smem_superstep` has two implementations with identical results: the
lock-step XLA while_loop nest below (the reference twin, and the path
under table-sharded meshes) and the one-launch GPU kernel in
`ops.smem_gpu`, chosen on the GPU backend.
"""

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import fm
from . import smem_gpu
from .fm import extend
from .loops import unroll_body
from .select import (sel_col as _sel_col, set_col as _set_col,
                     permute_cols as _permute_cols,
                     scatter_cols as _scatter_cols)


def _prev_valid_value(vals: jnp.ndarray, valid: jnp.ndarray, fill
                      ) -> jnp.ndarray:
    """vals/valid: [..., M]. Returns prev[..., j] = vals at the largest
    j' < j with valid[j'], else fill."""
    def op(a, b):
        av, af = a
        bv, bf = b
        return (jnp.where(bf, bv, av), af | bf)

    scanned_v, _ = lax.associative_scan(
        op, (jnp.where(valid, vals, fill), valid), axis=-1)
    # shift right by one: prev strictly before j
    prev = jnp.roll(scanned_v, 1, axis=-1)
    prev = prev.at[..., 0].set(fill)
    return prev


@partial(jax.jit, static_argnames=("L", "M", "M_OUT", "QPACKED"))
def smem_iter_step(blocks, primary, L2,
                   q, qlen, x, min_intv, active,
                   split_len, split_width,
                   L: int, M: int, M_OUT: int, QPACKED: bool = False):
    """One fused iterator step: the main smem1 pass plus, for lanes
    whose longest SMEM trips the re-seeding test
    (software/bwamem.c:185-204), the second smem1 pass from the middle
    of that SMEM with min_intv = occ+1 — one device dispatch instead of
    two (the reference pays one FPGA round trip per pass).

    Returns (pass1 outputs..., need2, pass2 outputs...)."""
    if QPACKED:
        q = _unpack_q4(q, L)

    def _impl(x_, mi_, act_):
        return _smem1_impl(blocks, primary, L2, q, qlen, x_, mi_,
                           act_, L, M, 0)
    r1 = _impl(x, min_intv, active)
    ret, n_mem, m0, m1, ms, mqb, mqe, over = r1
    lens = mqe - mqb                       # int32
    jj = jnp.arange(M, dtype=jnp.int32)[None, :]
    validm = jj < n_mem[:, None]
    lens = jnp.where(validm, lens, -1)
    best = jnp.argmax(lens, axis=1).astype(jnp.int32)
    best_len = _sel_col(lens, best)
    bs = _sel_col(ms, best)
    bqb = _sel_col(mqb, best)
    bqe = _sel_col(mqe, best)
    need2 = (active & (n_mem > 0) & (split_len > 0)
             & (best_len >= split_len.astype(jnp.int32))
             & (bs <= split_width.astype(bs.dtype)) & ~over)
    x2 = ((bqb + bqe) >> 1).astype(jnp.int32)
    mi2 = bs + 1
    r2 = _impl(jnp.where(need2, x2, 0), jnp.where(need2, mi2, 1), need2)
    return (_pack(_truncate(r1, M, M_OUT), L) + (need2,)
            + _pack(_truncate(r2, M, M_OUT), L))


def _truncate(r, M: int, M_OUT: int):
    """Apply the M_OUT column truncation to a full-width result."""
    ret, n_mem, m0, m1, ms, mqb, mqe, over = r
    if M_OUT <= 0 or M_OUT >= M:
        return r
    return (ret, n_mem, m0[:, :M_OUT], m1[:, :M_OUT], ms[:, :M_OUT],
            mqb[:, :M_OUT], mqe[:, :M_OUT], over)


def _pack(r, L: int = 128):
    """Wire-pack a round's outputs for the device->host hop: query
    coordinates (<= L+1 <= 256) and counts (<= M+1) travel as uint8.
    The 512 bp bucket's coordinates exceed uint8 and stay int32."""
    ret, n_mem, m0, m1, ms, mqb, mqe, over = r
    wdt = jnp.uint8 if L <= 256 else jnp.int32
    return (ret.astype(wdt), n_mem.astype(jnp.uint8), m0, m1, ms,
            mqb.astype(wdt), mqe.astype(wdt), over)


def _compact_streams(o0, o1, os_, oqb, oqe, n_out, over, OUT_CAP,
                     GCAP, NEED_X1, wdt=jnp.uint8):
    """Cross-lane compaction of the per-lane interval streams before
    the device->host fetch: one lax.sort (valid-first, stable order =
    lane-major) packs the sparsely occupied (B, OUT_CAP) buffers into
    GCAP flat slots.  Lanes whose stream would spill past GCAP are
    flagged overflow (host-oracle re-run, the usual cap fallback)."""
    B = n_out.shape[0]
    i32 = jnp.int32
    n_eff = jnp.where(over, 0, n_out.astype(i32))
    base = jnp.cumsum(n_eff) - n_eff
    over = over | (base + n_eff > GCAP)
    n_eff = jnp.where(over, 0, n_eff)
    base = jnp.cumsum(n_eff) - n_eff

    jj = jnp.arange(OUT_CAP, dtype=i32)[None, :]
    valid = jj < n_eff[:, None]
    key = jnp.where(valid, jnp.int32(0), jnp.int32(1)).reshape(-1)
    idx = jnp.arange(B * OUT_CAP, dtype=i32)
    ops = [o0.reshape(-1), os_.reshape(-1),
           oqb.astype(i32).reshape(-1), oqe.astype(i32).reshape(-1)]
    if NEED_X1:
        ops.append(o1.reshape(-1))
    out = jax.lax.sort(tuple([key, idx] + ops), num_keys=2,
                       is_stable=False)
    c0, cs, cqb, cqe = (o[:GCAP] for o in out[2:6])
    c1 = out[6][:GCAP] if NEED_X1 else jnp.zeros((1,), o0.dtype)
    return (c0, c1, cs, cqb.astype(wdt), cqe.astype(wdt),
            n_eff.astype(jnp.uint8), over)


def _unpack_q4(q, L):
    """(B, L/2) two-bases-per-byte -> (B, L) int8 (device-side; the
    host packs so the upload pays half the bytes)."""
    lo = q & np.int8(15)
    hi = (q >> np.int8(4)) & np.int8(15)
    return jnp.stack([lo, hi], axis=-1).reshape(q.shape[0], L)


def superstep_impl(n_lanes: int, L: int, M: int) -> str:
    """The superstep implementation for a dispatch on this backend:
    "gpu" (the one-launch kernel, ops.smem_gpu) on the GPU when the
    shapes tile into its blocks and the tables are not mesh-sharded
    (sharded gathers are collectives only the XLA loop expresses),
    else "xla"."""
    if (jax.default_backend() == "gpu" and fm._TABLE_AXIS is None
            and smem_gpu.shapes_ok(n_lanes, L, M)):
        return "gpu"
    return "xla"


@partial(jax.jit, static_argnames=("L", "M", "OUT_CAP", "NEED_X1",
                                   "GCAP", "QPACKED", "IMPL"))
def smem_superstep(blocks, primary, L2,
                   q, qlen, min_intv, active,
                   split_len, split_width,
                   L: int, M: int, OUT_CAP: int,
                   NEED_X1: bool = True, GCAP: int = 0,
                   QPACKED: bool = False, IMPL: str = "auto"):
    """The WHOLE per-read SMEM iterator fused into one dispatch: every
    lane's iterator rounds (pass1 + re-seed test + pass2 + ordered
    merge, software/bwamem.c:110-241) run to completion, appending each
    round's merged interval list to a per-lane output stream — the FPGA
    analog is the manager batching a whole read's seeding into one
    accelerator session rather than one handshake per iterator call.

    IMPL: "auto" (superstep_impl), "xla" (the lock-step while_loop
    nest), "gpu" (ops.smem_gpu) or "interpret" (that kernel through
    the Pallas interpreter, for tests off the GPU).

    Returns (o0, o1, os, oqb, oqe, n_out, overflow): the interval
    stream per lane, qb-major ordering identical to the host iterator;
    `overflow` lanes (interval buffer M, pass-2 width, or OUT_CAP
    exceeded) must re-run entirely on the host oracle."""
    wdt = jnp.uint8 if L <= 256 else jnp.int32
    if IMPL == "auto":
        IMPL = superstep_impl(q.shape[0], L, M)
    if IMPL == "xla":
        o0, o1, os_, oqb, oqe, n_out, over = _superstep_xla(
            blocks, primary, L2, _unpack_q4(q, L) if QPACKED else q,
            qlen, min_intv, active, split_len, split_width, L, M, OUT_CAP)
    else:
        assert IMPL in ("gpu", "interpret"), IMPL
        o0, o1, os_, oqb, oqe, n_out, over = smem_gpu.superstep(
            blocks, primary, L2, q, qlen, min_intv, active, split_len,
            split_width, L=L, M=M, OUT_CAP=OUT_CAP, packed=QPACKED,
            interpret=IMPL == "interpret")
    if GCAP:
        return _compact_streams(o0, o1, os_, oqb, oqe, n_out, over,
                                OUT_CAP, GCAP, NEED_X1, wdt=wdt)
    if not NEED_X1:
        # the mem path only consumes (x0, s, qb, qe); skipping x1 cuts
        # a third of the coordinate download (fastmap/tests pass
        # NEED_X1=True for full-tuple parity)
        o1 = jnp.zeros((1, 1), o0.dtype)
    return (o0, o1, os_, oqb.astype(wdt), oqe.astype(wdt),
            n_out.astype(jnp.uint8), over)


def _superstep_xla(blocks, primary, L2, q, qlen, min_intv, active,
                   split_len, split_width, L: int, M: int, OUT_CAP: int):
    """smem_superstep as a lock-step XLA while_loop nest: an outer loop
    advances every lane's iterator round together; returns the dense
    (B, OUT_CAP) streams, int32 counts and the overflow mask."""
    B = q.shape[0]
    cdt = L2.dtype
    i32 = jnp.int32
    split_len32 = split_len.astype(i32)
    kk2 = jnp.arange(2 * M, dtype=i32)[None, :]
    jj = jnp.arange(M, dtype=i32)[None, :]

    def round_body(st):
        # over/done carried as int32 (one dtype for every carry flag)
        (x, n_out, o0, o1, os_, oqb, oqe, over_c, done_c) = st
        over = over_c != 0
        done = done_c != 0
        act = ~done
        ret, n_mem, m0, m1, ms, mqb, mqe, ov1 = _smem1_impl(
            blocks, primary, L2, q, qlen, x, min_intv, act, L, M, 0)
        ov1 = ov1 | (n_mem > M)  # mem list outgrew the buffer too
        # re-seeding test (software/bwamem.c:185-204)
        lens = mqe - mqb
        validm = jj < n_mem[:, None]
        lens = jnp.where(validm, lens, -1)
        best = jnp.argmax(lens, axis=1).astype(i32)
        best_len = _sel_col(lens, best)
        bs = _sel_col(ms, best)
        bqb = _sel_col(mqb, best)
        bqe = _sel_col(mqe, best)
        need2 = (act & (n_mem > 0) & (split_len > 0)
                 & (best_len >= split_len32)
                 & (bs <= split_width.astype(bs.dtype)) & ~ov1)
        x2 = ((bqb + bqe) >> 1).astype(i32)
        s0, s1, ss, sqb, sqe = m0, m1, ms, mqb, mqe  # placeholders
        _r2ret, n2, s0, s1, ss, sqb, sqe, ov2 = _smem1_impl(
            blocks, primary, L2, q, qlen,
            jnp.where(need2, x2, 0),
            jnp.where(need2, bs + 1, 1), need2, L, M, 0)
        n2 = jnp.where(need2, n2, 0)
        ov2 = need2 & (ov2 | (n2 > M))

        # ordered merge (software/bwamem.c:206-238): key is qb-major,
        # (qlen-qe)-minor — one int32 encodes the reference's
        # (qb<<32)|(qlen-qe) uint64 comparator exactly (radix 256 for
        # the classic <=256 bp buckets, 1024 for the 512 bp bucket)
        KR = 256 if L <= 256 else 1024
        key_m = mqb * KR + (qlen[:, None] - mqe)
        key_s = sqb * KR + (qlen[:, None] - sqe)
        valid_m = jj < n_mem[:, None]
        # sub filter: len >= best_len/2 and ends after the round's start
        keep_s = ((jj < n2[:, None]) & ((sqe - sqb) >= (best_len[:, None] >> 1))
                  & (sqe > x[:, None]))
        # compact kept sub entries
        pos_s = jnp.cumsum(keep_s.astype(i32), axis=1) - 1
        tgt_s = jnp.where(keep_s, pos_s, M)
        cs0 = _scatter_cols(s0, tgt_s)
        cs1 = _scatter_cols(s1, tgt_s)
        css = _scatter_cols(ss, tgt_s)
        csqb = _scatter_cols(sqb, tgt_s)
        csqe = _scatter_cols(sqe, tgt_s)
        ckey_s = _scatter_cols(key_s, tgt_s)
        ns = jnp.sum(keep_s, axis=1, dtype=i32)
        valid_s = jj < ns[:, None]
        # stable merge, sub first on key ties (the C loop emits main
        # only when xi < xj): rank_m[i] = i + #{j: key_s[j] <= key_m[i]},
        # rank_s[j] = j + #{i: key_m[i] < key_s[j]}
        km = jnp.where(valid_m, key_m, jnp.int32(2 ** 30))
        ks = jnp.where(valid_s, ckey_s, jnp.int32(2 ** 30))
        le = (ks[:, :, None] <= km[:, None, :]) & valid_s[:, :, None]
        rank_m = jj + jnp.sum(le, axis=1, dtype=i32)
        lt = (km[:, :, None] < ks[:, None, :]) & valid_m[:, :, None]
        rank_s = jj + jnp.sum(lt, axis=1, dtype=i32)
        rank_m = jnp.where(valid_m, rank_m, 2 * M)
        rank_s = jnp.where(valid_s, rank_s, 2 * M)
        # gather merged[k] from (main | sub) by rank
        oh_m = rank_m[:, None, :] == kk2[:, :, None]     # [B, 2M, M]
        oh_s = rank_s[:, None, :] == kk2[:, :, None]

        def take(mv, sv):
            return (jnp.sum(jnp.where(oh_m, mv[:, None, :], 0), axis=2,
                            dtype=mv.dtype)
                    + jnp.sum(jnp.where(oh_s, sv[:, None, :], 0), axis=2,
                              dtype=sv.dtype))
        g0 = take(m0, cs0)
        g1 = take(m1, cs1)
        gs = take(ms, css)
        gqb = take(mqb, csqb)
        gqe = take(mqe, csqe)
        n_mrg = n_mem + ns

        # append to the per-lane stream at cursor n_out
        col = n_out[:, None] + kk2                        # [B, 2M]
        in_mrg = kk2 < n_mrg[:, None]
        cap = jnp.arange(OUT_CAP, dtype=i32)[None, :]
        sel = (col[:, None, :] == cap[:, :, None]) & in_mrg[:, None, :]

        def put(buf, vals):
            upd = jnp.sum(jnp.where(sel, vals[:, None, :], 0), axis=2,
                          dtype=buf.dtype)
            hit = jnp.any(sel, axis=2)
            return jnp.where(hit, upd, buf)
        o0 = put(o0, g0.astype(o0.dtype))
        o1 = put(o1, g1.astype(o1.dtype))
        os_ = put(os_, gs.astype(os_.dtype))
        oqb = put(oqb, gqb.astype(i32))
        oqe = put(oqe, gqe.astype(i32))
        n_new = n_out + jnp.where(act, n_mrg, 0)
        over_now = act & (ov1 | ov2 | (n_new > OUT_CAP))
        over = over | over_now
        n_out = jnp.where(act & ~over_now, n_new, n_out)
        x = jnp.where(act, ret.astype(i32), x)
        done = done | over_now | (x >= qlen)
        return (x, n_out, o0, o1, os_, oqb, oqe,
                over.astype(i32), done.astype(i32))

    def round_cond(st):
        # global across table shards: the body's gathers are
        # collectives when the index is mesh-sharded (fm.global_any)
        return fm.global_any(st[-1] == 0)

    x0 = jnp.zeros(B, i32)
    st = (x0, jnp.zeros(B, i32),
          jnp.zeros((B, OUT_CAP), cdt), jnp.zeros((B, OUT_CAP), cdt),
          jnp.zeros((B, OUT_CAP), cdt), jnp.zeros((B, OUT_CAP), i32),
          jnp.zeros((B, OUT_CAP), i32),
          jnp.zeros(B, i32), (~active | (x0 >= qlen)).astype(i32))
    st = lax.while_loop(round_cond, round_body, st)
    (_, n_out, o0, o1, os_, oqb, oqe, over_c, _) = st
    return o0, o1, os_, oqb, oqe, n_out, over_c != 0


@partial(jax.jit, static_argnames=("L", "M", "M_OUT"))
def smem1_batched(blocks, primary, L2,
                  q: jnp.ndarray,        # int32[B, L] nt4, pad 4
                  qlen: jnp.ndarray,     # int32[B]
                  x: jnp.ndarray,        # int32[B] start position
                  min_intv: jnp.ndarray,  # int64[B]
                  active: jnp.ndarray,   # bool[B]
                  L: int, M: int, M_OUT: int = 0):
    """See _smem1_impl; M is the static interval-buffer width.  Lanes
    whose interval lists outgrow M are flagged in the returned overflow
    mask and must re-run on the host oracle (the reference's own
    fixed-BRAM push_mem cap + CPU fallback, hardware/afu_core.v:5946-5969,
    software/bwt.c:603-717)."""
    return _smem1_impl(blocks, primary, L2, q, qlen, x, min_intv, active,
                       L, M, M_OUT)


def _smem1_impl(blocks, primary, L2, q, qlen, x, min_intv, active,
                L: int, M: int, M_OUT: int):
    """Batched smem1: collect SMEMs covering position x per lane.

    Returns (ret, n_mem, m0, m1, ms, mqb, mqe, overflow):
      ret  int32[B]    — next iterator start (curr[0].info low bits)
      n_mem int32[B]   — number of SMEMs (0 for inactive/bad lanes)
      m0/m1/ms coord-dtype[B, M], mqb/mqe int32[B, M] — SMEM bi-intervals and
      query [qb, qe) coordinates, sorted by qb ascending.
    """
    B = q.shape[0]
    cdt = L2.dtype  # coordinate dtype (int32 fast path on small genomes)
    i32 = jnp.int32
    q = q.astype(i32)  # int8 on the wire (bases 0..4); widen on-device

    qx = _sel_col(q, x)                                          # base at x
    bad = (qx > 3) | ~active
    qx_c = jnp.where(bad, 0, qx).astype(jnp.int32)
    min_intv = jnp.maximum(min_intv, 1).astype(cdt)

    # bwt_set_intv (software/bwt.h:80)
    ik0 = jnp.take(L2, qx_c) + 1
    ik1 = jnp.take(L2, 3 - qx_c) + 1
    iks = jnp.take(L2, qx_c + 1) - jnp.take(L2, qx_c)
    ikend = x + 1

    zbufs = dict(
        c0=jnp.zeros((B, M), cdt), c1=jnp.zeros((B, M), cdt),
        cs=jnp.zeros((B, M), cdt), cend=jnp.zeros((B, M), i32))

    # ---- forward extension (software/bwt.c:790-801) ----------------------
    def fwd_body(st):
        (i, ik0, ik1, iks, ikend, c0, c1, cs, cend, n_curr,
         done_c) = st
        done = done_c != 0
        at_end = i >= qlen
        ii = jnp.minimum(i, qlen - 1)
        ii = jnp.clip(ii, 0, L - 1)
        cb = _sel_col(q, ii)
        is_amb = cb > 3
        o0, o1, os_ = extend(blocks, primary, L2, ik0, ik1, iks,
                             is_back=False)
        cc = jnp.where(is_amb, 0, 3 - cb).astype(i32)
        n0 = _sel_col(o0, cc)
        n1 = _sel_col(o1, cc)
        ns = _sel_col(os_, cc)
        changed = ns != iks
        small = ns < min_intv
        # push ik when: at_end | ambiguous | (changed)
        push = ~done & (at_end | is_amb | changed)
        stop = ~done & (at_end | is_amb | (changed & small))
        idx = jnp.where(push, n_curr, M)  # M = out of bounds, dropped
        c0 = _set_col(c0, idx, ik0)
        c1 = _set_col(c1, idx, ik1)
        cs = _set_col(cs, idx, iks)
        cend = _set_col(cend, idx, ikend)
        n_curr = n_curr + push.astype(i32)
        # advance ik (only when continuing)
        cont = ~done & ~stop
        ik0 = jnp.where(cont, n0, ik0)
        ik1 = jnp.where(cont, n1, ik1)
        iks = jnp.where(cont, ns, iks)
        ikend = jnp.where(cont, i + 1, ikend)
        done = done | stop
        i = i + (~done).astype(i32)
        return (i, ik0, ik1, iks, ikend, c0, c1, cs, cend, n_curr,
                done.astype(i32))

    def fwd_cond(st):
        # global across table shards: the body's gathers are
        # collectives when the index is mesh-sharded (fm.global_any)
        return fm.global_any(st[-1] == 0)

    st = (x + 1, ik0, ik1, iks, ikend, zbufs["c0"], zbufs["c1"], zbufs["cs"],
          zbufs["cend"], jnp.zeros(B, i32), bad.astype(i32))
    st = lax.while_loop(fwd_cond, unroll_body(fwd_body), st)
    (_, _, _, _, _, c0, c1, cs, cend, n_curr, _) = st
    overflow = n_curr > M

    # ret = info of last pushed interval (curr[0] after reversal,
    # software/bwt.c:803-805); bad lanes return x+1
    last = jnp.clip(n_curr - 1, 0, M - 1)
    ret = jnp.where(n_curr > 0, _sel_col(cend, last), x + 1)

    # reverse first n_curr entries per lane: prev[j] = curr[n_curr-1-j]
    jj = jnp.arange(M, dtype=i32)[None, :]
    src = jnp.clip(n_curr[:, None] - 1 - jj, 0, M - 1)
    p0 = _permute_cols(c0, src)
    p1 = _permute_cols(c1, src)
    ps = _permute_cols(cs, src)
    pend = _permute_cols(cend, src)

    # ---- backward extension (software/bwt.c:808-831) ---------------------
    def bwd_body(st):
        (i, p0, p1, ps, pend, n_prev, m0, m1, ms, mqb, mqe, n_mem,
         done_c) = st
        done = done_c != 0
        ii = jnp.clip(i, 0, L - 1)
        cb = _sel_col(q, ii)
        c = jnp.where((i < 0) | (cb > 3), -1, cb)                  # int32[B]
        o0, o1, os_ = extend(blocks, primary, L2, p0, p1, ps, is_back=True)
        csel = jnp.clip(c, 0, 3).astype(i32)[:, None, None]
        j4 = jnp.arange(4, dtype=i32)
        n0 = jnp.sum(jnp.where(j4 == csel, o0, 0), axis=2, dtype=o0.dtype)
        n1 = jnp.sum(jnp.where(j4 == csel, o1, 0), axis=2, dtype=o1.dtype)
        ns = jnp.sum(jnp.where(j4 == csel, os_, 0), axis=2, dtype=os_.dtype)
        present = (jj < n_prev[:, None]) & ~done[:, None]
        fail = (c[:, None] < 0) | (ns < min_intv[:, None])
        nonfail = present & ~fail
        # dedup: keep the first nonfail and later nonfails whose size
        # differs from the previous nonfail's size (== last kept's size)
        prev_s = _prev_valid_value(ns, nonfail, jnp.asarray(-1, ns.dtype))
        # first nonfail: nonfail with zero nonfails strictly before
        nf_before = jnp.cumsum(nonfail.astype(i32), axis=1) \
            - nonfail.astype(i32)
        first_nf = nonfail & (nf_before == 0)
        keep = nonfail & (first_nf | (ns != prev_s))
        pos = jnp.cumsum(keep.astype(i32), axis=1) - 1
        tgt = jnp.where(keep, pos, M)  # M = out of bounds, dropped
        nc0 = _scatter_cols(n0, tgt)
        nc1 = _scatter_cols(n1, tgt)
        ncs = _scatter_cols(ns, tgt)
        ncend = _scatter_cols(pend, tgt)
        n_curr_new = jnp.sum(keep, axis=1, dtype=i32)
        # mem append: first present&fail with all-fail prefix
        cand = present & fail & (nf_before == 0)
        cand_before = jnp.cumsum(cand.astype(i32), axis=1) \
            - cand.astype(i32)
        first_cand = cand & (cand_before == 0)
        has_cand = jnp.any(first_cand, axis=1)
        jstar = jnp.argmax(first_cand, axis=1).astype(i32)
        lastm = jnp.maximum(n_mem - 1, 0)
        allow = (n_mem == 0) | ((i + 1) < _sel_col(mqb, lastm))
        do_mem = ~done & has_cand & allow
        midx = jnp.where(do_mem, n_mem, M)  # M = out of bounds, dropped
        sel = lambda a: _sel_col(a, jstar)
        m0 = _set_col(m0, midx, sel(p0))
        m1 = _set_col(m1, midx, sel(p1))
        ms = _set_col(ms, midx, sel(ps))
        mqb = _set_col(mqb, midx, i + 1)
        mqe = _set_col(mqe, midx, sel(pend))
        n_mem = n_mem + do_mem.astype(i32)
        done = done | (n_curr_new == 0)
        i = i - (~done).astype(i32)
        return (i, nc0, nc1, ncs, ncend, n_curr_new, m0, m1, ms, mqb, mqe,
                n_mem, done.astype(i32))

    def bwd_cond(st):
        # global across table shards: the body's gathers are
        # collectives when the index is mesh-sharded (fm.global_any)
        return fm.global_any(st[-1] == 0)

    st = (x - 1, p0, p1, ps, pend, n_curr,
          jnp.zeros((B, M), cdt), jnp.zeros((B, M), cdt),
          jnp.zeros((B, M), cdt), jnp.zeros((B, M), i32),
          jnp.zeros((B, M), i32), jnp.zeros(B, i32),
          (bad | (n_curr == 0)).astype(i32))
    st = lax.while_loop(bwd_cond, unroll_body(bwd_body), st)
    (_, _, _, _, _, _, m0, m1, ms, mqb, mqe, n_mem, _) = st

    # reverse mem to qb-ascending order (software/bwt.c:833); truncate the
    # returned buffers to M_OUT columns to bound the device->host transfer
    # (n_mem is returned untruncated so the caller can detect overflow and
    # route the lane to the host oracle — the HW-caps/CPU-fallback pattern)
    if M_OUT <= 0 or M_OUT > M:
        M_OUT = M
    jo = jj[:, :M_OUT]
    src = jnp.clip(n_mem[:, None] - 1 - jo, 0, M - 1)
    valid = jo < n_mem[:, None]
    m0 = _permute_cols(m0, src, valid)
    m1 = _permute_cols(m1, src, valid)
    ms = _permute_cols(ms, src, valid)
    mqb = _permute_cols(mqb, src, valid)
    mqe = _permute_cols(mqe, src, valid)
    return ret, n_mem, m0, m1, ms, mqb, mqe, overflow


def ragged_expand(x0, sizes, K: int):
    """Device-side ragged expansion: keys[g] = x0[i] + (g - excl[i])
    for the interval i owning global slot g (the occurrence keys
    bwt_sa consumes, software/bwamem.c:420) — built with two lax.sorts
    and a forward-fill scan instead of jnp.repeat.

    Returns (keys[K] in x0.dtype, total): slots >= total are zeroed;
    callers detect total > K and fall back to the host expansion."""
    i32 = jnp.int32
    G = x0.shape[0]
    sizes = sizes.astype(i32)
    cum = jnp.cumsum(sizes)
    excl = cum - sizes
    total = cum[-1]
    BIGV = jnp.int32(2 ** 30)
    startv = jnp.where(sizes > 0, excl, BIGV)
    ev_val = jnp.concatenate([startv, jnp.arange(K, dtype=i32)])
    # starts sort before slots on equal value (flag 0 < 1), so the
    # inclusive forward fill covers a start landing exactly on its slot
    ev_flag = jnp.concatenate([jnp.zeros(G, i32), jnp.ones(K, i32)])
    ev_x0 = jnp.concatenate([x0, jnp.zeros(K, x0.dtype)])
    ev_off = jnp.concatenate([excl, jnp.zeros(K, i32)])
    sv, sf, sx, so = lax.sort((ev_val, ev_flag, ev_x0, ev_off),
                              num_keys=2)

    def fill(a, b):
        ax, ao, as_ = a
        bx, bo, bs = b
        keep_b = bs != 0
        return (jnp.where(keep_b, bx, ax), jnp.where(keep_b, bo, ao),
                as_ | bs)

    fx, fo, _ = lax.associative_scan(
        fill, (sx, so, jnp.where(sf == 0, 1, 0)))
    keyv = fx + (sv - fo).astype(x0.dtype)
    # pull the K slot entries back out, in slot order: starts first
    # (flag 0), slots ordered by sv == slot id
    _, _, out = lax.sort((sf, sv, keyv), num_keys=2)
    keys = out[G:G + K]
    gk = jnp.arange(K, dtype=i32)
    return jnp.where(gk < total, keys, jnp.zeros((), x0.dtype)), total


@partial(jax.jit, static_argnames=(
    "L", "M", "OUT_CAP", "GCAP", "QPACKED", "KEY_CAP", "SA_INTV",
    "SA_STEPS", "IMPL"))
def smem_superstep_sa(blocks, primary, L2, seq_len, sa,
                      q, qlen, min_intv, active, split_len, split_width,
                      min_seed_len, max_occ,
                      L: int, M: int, OUT_CAP: int, GCAP: int,
                      QPACKED: bool, KEY_CAP: int, SA_INTV: int,
                      SA_STEPS: int, IMPL: str = "auto"):
    """Superstep + the whole seed SA resolution in ONE dispatch: the
    compact interval stream stays on device, expands into per-occurrence
    keys (ragged_expand, the exact key order of the host expansion in
    seeding.seeds_from_arrays), and the inverse-Psi walk runs
    immediately — one result fetch returns intervals AND SA values,
    saving a fetch round trip and the key upload per chunk.

    Returns superstep's 7-tuple + (sa_vals[KEY_CAP], sa_over[KEY_CAP],
    n_keys, key_overflow); key_overflow means the expansion spilled
    KEY_CAP and the caller must redo SA the split way."""
    assert GCAP > 0, "the fused SA path requires the compact wire"
    r = smem_superstep(blocks, primary, L2, q, qlen, min_intv, active,
                       split_len, split_width, L=L, M=M,
                       OUT_CAP=OUT_CAP, NEED_X1=False, GCAP=GCAP,
                       QPACKED=QPACKED, IMPL=IMPL)
    c0, _c1, cs, cqb, cqe, n, over = r
    i32 = jnp.int32
    total = jnp.sum(n.astype(i32))
    gk = jnp.arange(GCAP, dtype=i32)
    slen = cqe.astype(i32) - cqb.astype(i32)
    keep = ((gk < total) & (slen >= min_seed_len.astype(i32))
            & (cs <= max_occ.astype(cs.dtype)))
    sizes = jnp.where(keep, cs, 0).astype(i32)
    keys, n_keys = ragged_expand(c0, sizes, KEY_CAP)
    kovf = n_keys > KEY_CAP
    vals, over_sa = fm.sa_lookup_batched(
        blocks, primary, L2, seq_len, sa, SA_INTV, keys,
        max_steps=SA_STEPS)
    return r + (vals, over_sa, n_keys.astype(i32), kovf)
