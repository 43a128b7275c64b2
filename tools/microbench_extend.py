"""Time one banded-extension wave (the XLA row loop, ksw._extend_impl)
on realistic wave shapes:

    python tools/microbench_extend.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from functools import partial

from bwamem_tpu.ops import ksw

B, LQ, LT = 512, 128, 544
rng = np.random.default_rng(0)

q = rng.integers(0, 4, size=(B, LQ)).astype(np.int8)
t = rng.integers(0, 4, size=(B, LT)).astype(np.int8)
# most lanes: near-match extensions (the realistic case — reads align),
# lengths like the bench: qlen ~100, tlen ~ qlen + band
for b in range(B):
    n = LQ
    t[b, :n] = q[b, :n]
    muts = rng.integers(0, n, size=3)
    t[b, muts] = (t[b, muts] + 1) % 4
qlen = np.full(B, 100, np.int32)
tlen = np.minimum(np.full(B, 200, np.int32), LT)
w = np.full(B, 100, np.int32)
eb = np.full(B, 5, np.int32)
h0 = np.full(B, 30, np.int32)
mat = np.zeros(25, np.int32)
for i in range(4):
    for j in range(4):
        mat[i * 5 + j] = 1 if i == j else -4
for k in range(5):
    mat[k * 5 + 4] = -1
    mat[4 * 5 + k] = -1

args = (jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen),
        jnp.asarray(tlen), jnp.asarray(mat), 6, 1, 6, 1,
        jnp.asarray(w), jnp.asarray(eb), 100, jnp.asarray(h0))


@partial(jax.jit, static_argnames=("LQ", "LT"))
def xla_path(*a, LQ, LT):
    return ksw._extend_impl(*a, LQ, LT, None)


def timed(fn, n=20):
    r = fn()
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


print("backend:", jax.default_backend())
t0 = time.perf_counter()
rx = xla_path(*args, LQ=LQ, LT=LT)
jax.block_until_ready(rx)
print(f"xla compile+run {time.perf_counter()-t0:.1f}s")
tx = timed(lambda: xla_path(*args, LQ=LQ, LT=LT))
print(f"xla: {tx*1e3:.3f} ms/wave ({B} lanes, LQ={LQ}, LT={LT})")
