"""Shared SMEM test inputs: a small random genome and lane batches with
the edge cases the seeding kernels must agree on (ambiguous bases,
mutations, short reads, an inactive lane, repetitive low-complexity
reads that overflow small interval buffers)."""

import numpy as np


def small_genome(seed: int = 11, n: int = 3000):
    """(forward strand, FmIndex over forward + reverse complement)."""
    from bwamem_tpu.index.fmindex import FmIndex
    rng = np.random.default_rng(seed)
    fwd = rng.integers(0, 4, n).astype(np.uint8)
    return fwd, FmIndex.build(np.concatenate([fwd, 3 - fwd[::-1]]))


def lane_batch(fwd, B: int, L: int, rng, amb: bool = False,
               repeats: bool = False, min_len: int = 21):
    """(q int8[B, L] padded with 4, qlen int32[B], active bool[B])."""
    q = np.full((B, L), 4, dtype=np.int8)
    qlen = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(min_len, L + 1))
        off = int(rng.integers(0, len(fwd) - n))
        if repeats and i % 5 == 0:
            q[i, :n] = np.tile(fwd[off:off + 8], L // 8 + 1)[:n]
        else:
            q[i, :n] = fwd[off:off + n]
        if rng.random() < 0.3:
            for _ in range(int(rng.integers(1, 4))):
                q[i, int(rng.integers(0, n))] = int(rng.integers(0, 4))
        if amb and rng.random() < 0.5:
            q[i, int(rng.integers(0, n))] = 4
        qlen[i] = n
    act = np.ones(B, bool)
    act[B - 1] = False
    return q, qlen, act


def pack_q4(q: np.ndarray) -> np.ndarray:
    """Two bases per byte, the engine's query wire format."""
    return q[:, 0::2] | (q[:, 1::2] << np.int8(4))


def superstep_args(d, q, qlen, act, split_len=29, split_width=10,
                   packed=False):
    """Positional arguments of ops.smem.smem_superstep."""
    import jax.numpy as jnp
    B = q.shape[0]
    return (d.blocks, d.primary, d.L2,
            jnp.asarray(pack_q4(q) if packed else q), jnp.asarray(qlen),
            jnp.ones(B, d.L2.dtype), jnp.asarray(act),
            jnp.full(B, split_len, jnp.int32),
            jnp.full(B, split_width, jnp.int32))


def assert_streams_equal(ref, out, out_cap: int):
    """Two dense superstep results agree: overflow flags and counts
    exactly, and every clean lane's first n_out stream entries."""
    r = [np.asarray(a).astype(np.int64) for a in ref]
    o = [np.asarray(a).astype(np.int64) for a in out]
    np.testing.assert_array_equal(r[6], o[6], err_msg="overflow flags")
    n_r = np.where(r[6] != 0, 0, r[5])
    n_o = np.where(o[6] != 0, 0, o[5])
    np.testing.assert_array_equal(n_r, n_o, err_msg="stream counts")
    mask = np.arange(out_cap)[None, :] < n_r[:, None]
    for name, a, b in zip(["x0", "x1", "size", "qb", "qe"], r[:5], o[:5]):
        if a.shape[-1] != out_cap or b.shape[-1] != out_cap:
            continue  # NEED_X1=False placeholder
        np.testing.assert_array_equal(a[mask], b[mask],
                                      err_msg=f"stream field {name}")
    return int(n_r.sum())


def host_streams(fm, queries, opt):
    """Per-read interval streams from the host SmemIterator oracle."""
    from bwamem_tpu.oracle.smem import SmemIterator
    out = []
    for q in queries:
        want = []
        if len(q) >= opt.min_seed_len:
            itr = SmemIterator(fm, q)
            sl = min(int(opt.min_seed_len * opt.split_factor + .499),
                     len(q))
            while True:
                a = itr.next(sl, opt.split_width, 1)
                if a is None:
                    break
                want.extend(a)
        out.append([tuple(int(v) for v in p) for p in want])
    return out
