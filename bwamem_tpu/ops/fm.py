"""Device-resident FM-index and batched occ/extend/SA primitives.

This is the device equivalent of the reference's accelerator data
path: the interleaved BWT+occ array lives in device memory as a
(n_blocks, 16) uint32 table (one row == one 64-byte occ block — the unit
the FPGA gathers per extension step, hardware/afu_core.v:1428-1432), and
each batched `extend` performs the two occ-block gathers per lane that
the hardware's BWT_OCC4 modules perform per PE step
(hardware/afu_core.v:5427-5897; software oracle software/bwt.c:416-429,
bwt_occ4 software/bwt.c:187-204).

Coordinates are carried in a genome-size-dependent dtype: int32 when the
doubled pack fits in 31 bits (every genome under ~1 Gbp), int64 beyond
(mammalian scale).  The narrow path halves the table-side arithmetic
width and the device<->host transfer volume; the dtype is chosen once
at index upload (DeviceFmIndex.from_host) and every kernel derives it
from L2.dtype.  JAX x64 mode is required and enabled on import.

Popcounts use jax.lax.population_count over 2-bit-field masks instead of
the reference's cnt_table byte LUT (software/bwt.c:60-69,183-185) — the
device has a native popcount, the LUT was a CPU/RTL trick.
"""

from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np

import os

import jax

jax.config.update("jax_enable_x64", True)
# persistent compile cache, shared across processes: JAX reads
# JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise a fixed
# directory inside the checkout (the path is part of the cache key)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import jax.numpy as jnp
from jax import lax

WORDS_PER_BLOCK = 16
_M55 = jnp.uint32(0x55555555)
_ALL1 = jnp.uint32(0xFFFFFFFF)

# when tracing inside a shard_map whose index tables are row-sharded
# over a mesh axis (genomes too big for one card's memory — the analog of
# the reference's host-DRAM-resident 3 GB table fetched per-step over
# CCI-P, software/HelloALINLB.cpp:59-63), this names that axis and
# every table gather becomes all_gather(indices) -> local gather ->
# psum_scatter(rows).  Set via the table_axis() context manager by
# parallel/mesh.py ShardedKernels(shard_tables=True).
_TABLE_AXIS = None


@contextmanager
def table_axis(name):
    """Trace-time context: gathers against mesh-axis-sharded tables."""
    global _TABLE_AXIS
    prev = _TABLE_AXIS
    _TABLE_AXIS = name
    try:
        yield
    finally:
        _TABLE_AXIS = prev


def _sharded_lookup(local_rows_fn, idx: jnp.ndarray, axis: str,
                    local_n: int):
    """Generic sharded-table gather: every shard holds `local_n`
    consecutive rows of the global table and 1/n of the lanes.  The
    lanes' global indices ride an all_gather; each shard answers the
    rows it owns (zeros elsewhere); one psum_scatter returns each
    shard its own lanes' rows — two collectives over the mesh axis.

    local_rows_fn(rel, ok) -> rows for in-range rel (masked to zero
    where ~ok); idx any integer shape."""
    shp = idx.shape
    flat = idx.reshape(-1).astype(jnp.int32)
    i = lax.axis_index(axis)
    g = lax.all_gather(flat, axis)                    # (n, L)
    rel = g - i * local_n
    ok = (rel >= 0) & (rel < local_n)
    rows = local_rows_fn(jnp.where(ok, rel, 0), ok)   # (n, L[, W])
    summed = lax.psum_scatter(
        rows, axis, scatter_dimension=0, tiled=False)  # (L[, W])
    return summed.reshape(shp + summed.shape[1:])


def global_any(x: jnp.ndarray) -> jnp.ndarray:
    """jnp.any(), made uniform across table shards.  Every while_loop
    whose body gathers from a sharded table MUST use this in its cond:
    the gathers are collectives, so all shards have to agree on the
    trip count or the all_gather deadlocks mid-loop."""
    v = jnp.any(x)
    if _TABLE_AXIS is not None:
        v = lax.psum(v.astype(jnp.int32), _TABLE_AXIS) > 0
    return v


def _gather_rows(blocks: jnp.ndarray, blk: jnp.ndarray) -> jnp.ndarray:
    """Block gather from the (n_blocks, 16) uint32 occ table: returns
    [..., 16] uint32 rows (a collective gather when the table rows are
    sharded over the mesh)."""
    if _TABLE_AXIS is not None:
        def local(rel, ok):
            return jnp.where(ok[..., None], blocks[rel],
                             jnp.zeros((), blocks.dtype))

        return _sharded_lookup(local, blk, _TABLE_AXIS, blocks.shape[0])
    return blocks[blk]


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceFmIndex:
    """bwt_t resident in device memory (analog of SPL_BWT_ref +
    SPL_CNT_table upload, software/bwa.c:286-301)."""
    blocks: jnp.ndarray    # (n_blocks, 16) uint32
    L2: jnp.ndarray        # (5,) int64 cumulative base counts
    primary: jnp.ndarray   # () int64
    seq_len: jnp.ndarray   # () int64
    sa: jnp.ndarray        # (n_sa,) int64 sampled suffix array
    sa_intv: int           # static python int (power of two)

    def tree_flatten(self):
        return ((self.blocks, self.L2, self.primary, self.seq_len, self.sa),
                (self.sa_intv,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])

    @property
    def cdt(self):
        """Coordinate dtype (int32 for sub-Gbp genomes, else int64)."""
        return self.L2.dtype

    @property
    def n_blocks(self):
        return self.blocks.shape[0]

    @classmethod
    def from_host(cls, fm) -> "DeviceFmIndex":
        """Upload a host FmIndex (bwamem_tpu.index.fmindex.FmIndex).

        The on-disk interleaved array is compact — the final block may
        carry fewer than 8 bwt words, with the closing checkpoint packed
        right after them (software/bwtindex.c:128-150).  The device copy
        is repacked to uniform 16-word rows (zero-padded tail) so one
        gather row == one occ block; the closing checkpoint is dropped
        (occ queries never index past block seq_len>>7)."""
        blocks = jnp.asarray(_uniform_blocks(fm.bwt, int(fm.seq_len)))
        # +2 margin: interval arithmetic forms seq_len+1 style values
        cdt = np.int32 if int(fm.seq_len) + 2 < (1 << 31) else np.int64
        if os.environ.get("BWAMEM_TPU_FORCE_I64"):  # test the wide path
            cdt = np.int64
        # denser sample when the index ships the .sa8 sidecar:
        # identical values, ~4x fewer lock-step psi-walk iterations.
        # Past the size cap (MB of device memory/upload) the sparse .sa
        # is kept: the walk is table-size-independent on device.
        sa8 = getattr(fm, "sa8", None)
        if sa8 is not None:
            cap_mb = float(os.environ.get("BWAMEM_TPU_SA8_MAX_MB",
                                          "2048"))
            if sa8.nbytes > cap_mb * (1 << 20):
                sa8 = None
        sa_arr = (sa8 if sa8 is not None else fm.sa).astype(cdt)
        return cls(
            blocks=blocks,
            L2=jnp.asarray(fm.L2.astype(cdt)),
            primary=jnp.asarray(cdt(fm.primary)),
            seq_len=jnp.asarray(cdt(fm.seq_len)),
            sa=jnp.asarray(sa_arr),
            sa_intv=int(fm.sa8_intv if sa8 is not None
                        else fm.sa_intv),
        )


def _uniform_blocks(bwt: np.ndarray, seq_len: int) -> np.ndarray:
    """Repack the compact interleaved uint32 array into (n_blocks, 16)."""
    n_blocks = (seq_len + 127) >> 7
    n_plain_words = (seq_len + 15) >> 4
    out = np.zeros((n_blocks, WORDS_PER_BLOCK), dtype=np.uint32)
    # all blocks except possibly the last are full 16-word stripes
    full = n_plain_words >> 3  # blocks with all 8 bwt words present
    out[:full] = bwt[:full * 16].reshape(-1, 16)
    if full < n_blocks:
        rem = n_plain_words - full * 8
        out[full, :8 + rem] = bwt[full * 16:full * 16 + 8 + rem]
    return out


def occ4(blocks: jnp.ndarray, primary: jnp.ndarray, k: jnp.ndarray
         ) -> jnp.ndarray:
    """Batched bwt_occ4 (software/bwt.c:187-204): per-base counts of
    bwt[0..k] inclusive (sentinel-adjusted), 0 for k == -1.

    k: int64[...]; returns int64[..., 4].
    """
    cdt = primary.dtype
    k = k.astype(cdt)
    valid = k >= 0
    kk = k - (k >= primary).astype(cdt)
    kk = jnp.where(valid, kk, 0)
    blk = (kk >> 7).astype(jnp.int32)
    row = _gather_rows(blocks, blk)                    # [..., 16] uint32
    lo = row[..., 0:8:2].astype(cdt)
    if cdt == jnp.int64:
        hi = row[..., 1:8:2].astype(jnp.int64)
        ck = lo | (hi << 32)                           # [..., 4] checkpoint
    else:
        # narrow path: counts < 2^31, the hi checkpoint words are zero
        ck = lo
    words = row[..., 8:16]                             # [..., 8] uint32

    off = (kk & 127).astype(jnp.int32)                 # 0..127 within block
    wi = off >> 4                                      # word holding position
    r = (~off) & 15                                    # masked trailing bases
    j = jnp.arange(8, dtype=jnp.int32)
    full = j < wi[..., None]
    part = j == wi[..., None]
    pmask = ~((jnp.uint32(1) << (r[..., None].astype(jnp.uint32) * 2))
              - jnp.uint32(1))
    wmask = jnp.where(full, _ALL1, jnp.where(part, pmask, jnp.uint32(0)))
    w = words & wmask
    hb = (w >> 1) & _M55
    lb = w & _M55
    c3 = lax.population_count(hb & lb).astype(jnp.int32).sum(axis=-1)
    c2 = lax.population_count(hb & ~lb).astype(jnp.int32).sum(axis=-1)
    c1 = lax.population_count(lb & ~hb).astype(jnp.int32).sum(axis=-1)
    c0 = (off + 1) - c1 - c2 - c3
    within = jnp.stack([c0, c1, c2, c3], axis=-1).astype(cdt)
    return jnp.where(valid[..., None], ck + within, jnp.zeros((), cdt))


def extend(blocks: jnp.ndarray, primary: jnp.ndarray, L2: jnp.ndarray,
           x0: jnp.ndarray, x1: jnp.ndarray, s: jnp.ndarray,
           is_back: bool) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched bwt_extend (software/bwt.c:416-429; RTL
    hardware/afu_core.v:5427-5639).

    x0/x1/s: int64[...]; is_back is static. Returns (ok0, ok1, oks),
    each int64[..., 4] — candidate bi-intervals for bases 0..3.
    """
    fwd = x0 if is_back else x1
    # one stacked occ4 for both interval ends: halves the table-lookup
    # matmuls (and the kernel's compile size) per extension step
    both = occ4(blocks, primary,
                jnp.stack([fwd - 1, fwd - 1 + s]))     # [2, ..., 4]
    tk, tl = both[0], both[1]
    occ_side = L2[:4] + 1 + tk
    oks = tl - tk
    bump = ((fwd <= primary) & (fwd + s - 1 >= primary)).astype(primary.dtype)
    prev = (x1 if is_back else x0) + bump
    same3 = prev
    same2 = same3 + oks[..., 3]
    same1 = same2 + oks[..., 2]
    same0 = same1 + oks[..., 1]
    same = jnp.stack([same0, same1, same2, same3], axis=-1)
    # is_back: occ computes the forward-index side x0, carry updates x1;
    # forward: occ computes the reverse-index side x1, carry updates x0
    if is_back:
        return occ_side, same, oks
    return same, occ_side, oks


def bwt_b0(blocks: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_B0 (software/bwt.h:72-78): BWT base at $-removed
    position x. x: int64[...] in [0, seq_len)."""
    blk = (x >> 7).astype(jnp.int32)
    wi = ((x >> 4) & 7).astype(jnp.int32)
    row = _gather_rows(blocks, blk)                     # [..., 16]
    w = jnp.take_along_axis(row, (8 + wi)[..., None], axis=-1)[..., 0]
    sh = (((~x) & 15) * 2).astype(jnp.uint32)
    return ((w >> sh) & jnp.uint32(3)).astype(jnp.int32)


def occ1(blocks: jnp.ndarray, primary: jnp.ndarray, L2: jnp.ndarray,
         seq_len: jnp.ndarray, k: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_occ (software/bwt.c:125-147) via occ4 + select;
    k == seq_len and k == -1 handled like the reference."""
    all4 = occ4(blocks, primary, jnp.where(k == seq_len, -1, k))
    sel = jnp.take_along_axis(all4, c[..., None].astype(jnp.int32),
                              axis=-1)[..., 0]
    full = jnp.take(L2, c + 1) - jnp.take(L2, c)
    return jnp.where(k == seq_len, full, sel)


def inv_psi(blocks, primary, L2, seq_len, k):
    """Batched bwt_invPsi (software/bwt.c:71-77). k: coord dtype[...]"""
    cdt = primary.dtype
    x = k - (k > primary).astype(cdt)
    c = bwt_b0(blocks, x).astype(jnp.int32)
    nxt = jnp.take(L2, c) + occ1(blocks, primary, L2, seq_len, k, c)
    return jnp.where(k == primary, jnp.zeros((), cdt), nxt)


@partial(jax.jit, static_argnames=("sa_intv", "max_steps"))
def sa_lookup_batched(blocks, primary, L2, seq_len, sa, sa_intv: int,
                      k: jnp.ndarray, max_steps: int = 128
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched bwt_sa (software/bwt.c:104-114): inverse-Psi walk to the
    previous sampled row.  Walks all lanes in lock-step for up to
    max_steps; returns (sa_values, overflowed) where overflowed lanes
    must be resolved by the host fallback (the reference's own
    HW-caps/CPU-fallback pattern, software/bwt.c:603-717)."""
    cdt = primary.dtype
    assert sa_intv & (sa_intv - 1) == 0, \
        f"sa_intv must be a power of two, got {sa_intv}"
    mask = jnp.asarray(sa_intv - 1, cdt)

    def body(state):
        k, steps, it = state
        # strict per-lane cap: without the steps bound the unroll
        # overshoots max_steps by up to UNROLL-1 applications, making
        # the overflow set depend on the unroll factor
        act = ((k & mask) != 0) & (steps < max_steps)
        k2 = inv_psi(blocks, primary, L2, seq_len, k)
        k = jnp.where(act, k2, k)
        steps = steps + act.astype(cdt)
        return k, steps, it + 1

    def cond(state):
        k, _, it = state
        return global_any((k & mask) != 0) & (it < max_steps)

    from .loops import unroll_body
    k = k.astype(cdt)
    state = (k, jnp.zeros_like(k), jnp.int32(0))
    k_fin, steps, _ = lax.while_loop(cond, unroll_body(body), state)
    over = (k_fin & mask) != 0
    si = (k_fin >> int(np.log2(sa_intv))).astype(jnp.int32)
    if _TABLE_AXIS is not None:
        # sampled-SA table sharded over the mesh like the occ blocks
        vals = steps + _sharded_lookup(
            lambda rel, ok: jnp.where(ok, sa[rel], jnp.zeros((), cdt)),
            si, _TABLE_AXIS, sa.shape[0])
    else:
        vals = steps + sa[si]
    return jnp.where(over, jnp.asarray(-1, cdt), vals), over
