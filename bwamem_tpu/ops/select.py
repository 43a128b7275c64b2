"""Mask-select replacements for per-lane dynamic gather/scatter.

Over small static axes (interval buffers M<=48, sequence caps L<=544,
score profiles of 25) a compare+masked-sum reads "one element per lane"
as pure elementwise work that XLA fuses into its neighbours, instead of
a separate per-lane dynamic gather or scatter.
These helpers are the batched-kernel building blocks used by
ops.smem and ops.ksw (the same trade the reference's RTL makes by
addressing BRAM lines with one-hot word enables,
hardware/afu_core.v:5946-5969).
"""

import jax.numpy as jnp


def sel_col(vals: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """vals[..., idx] per lane over the (small, static) last axis."""
    M = vals.shape[-1]
    jj = jnp.arange(M, dtype=jnp.int32)
    return jnp.sum(jnp.where(jj == idx[..., None], vals, 0), axis=-1,
                   dtype=vals.dtype)


def set_col(vals: jnp.ndarray, idx: jnp.ndarray, new: jnp.ndarray
            ) -> jnp.ndarray:
    """vals with vals[..., idx] = new per lane (idx == size drops)."""
    M = vals.shape[-1]
    jj = jnp.arange(M, dtype=jnp.int32)
    return jnp.where(jj == idx[..., None], new[..., None], vals)


def sel_row(vals: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """vals[..., idx, :] per lane: one-hot select over axis -2."""
    R = vals.shape[-2]
    rr = jnp.arange(R, dtype=jnp.int32)
    oh = rr == idx[..., None]                       # [..., R]
    return jnp.sum(jnp.where(oh[..., None], vals, 0), axis=-2,
                   dtype=vals.dtype)


def permute_cols(vals: jnp.ndarray, src: jnp.ndarray,
                 valid=None) -> jnp.ndarray:
    """out[..., j] = vals[..., src[..., j]] (0 outside valid)."""
    M = vals.shape[-1]
    jj = jnp.arange(M, dtype=jnp.int32)
    oh = src[..., :, None] == jj                    # [..., M_out, M]
    out = jnp.sum(jnp.where(oh, vals[..., None, :], 0), axis=-1,
                  dtype=vals.dtype)
    if valid is not None:
        out = jnp.where(valid, out, 0)
    return out


def scatter_cols(vals: jnp.ndarray, tgt: jnp.ndarray) -> jnp.ndarray:
    """out[..., j] = vals[..., k] where tgt[..., k] == j (tgt == size
    drops; targets unique per lane) — the inverse of permute_cols."""
    M = vals.shape[-1]
    jj = jnp.arange(M, dtype=jnp.int32)
    oh = tgt[..., None, :] == jj[:, None]           # [..., M_out(j), M(k)]
    return jnp.sum(jnp.where(oh, vals[..., None, :], 0), axis=-1,
                   dtype=vals.dtype)


def score_profile(mat55: jnp.ndarray, tch: jnp.ndarray,
                  query: jnp.ndarray) -> jnp.ndarray:
    """qp[b, j] = mat55[tch[b], query[b, j]] without the 2-D table
    gather: a 25-way compare+select (mat is 5x5)."""
    idx = tch[:, None] * 5 + query                  # [B, LQ]
    flat = mat55.reshape(-1)
    kk = jnp.arange(25, dtype=jnp.int32)
    return jnp.sum(jnp.where(kk == idx[..., None], flat, 0), axis=-1,
                   dtype=mat55.dtype)
