"""Microbenchmark the SMEM kernel's building blocks on the device.

Times, per while_loop-iteration equivalent:
  - extend on (B,) lanes (the forward-pass shape)
  - extend on (B, M) lanes (the backward-pass shape)
  - a full smem_iter_step round on real reads
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np

B = int(os.environ.get("MB_B", "2048"))
M = int(os.environ.get("MB_M", "16"))
ITERS = int(os.environ.get("MB_ITERS", "100"))


def main():
    from bwamem_tpu.index import load_index
    from bwamem_tpu.ops.fm import DeviceFmIndex, extend
    import jax
    import jax.numpy as jnp
    from jax import lax
    from functools import partial

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "tests", "data")
    fm, bns = load_index(os.path.join(data, "genome.fa"))
    d = DeviceFmIndex.from_host(fm)
    n = int(fm.seq_len)
    print(f"n_blocks={d.blocks.shape[0]} B={B} M={M} iters={ITERS}")

    rng = np.random.default_rng(0)

    @partial(jax.jit, static_argnames=("iters",))
    def loop_extend(blocks, primary, L2, x0, x1, s, iters):
        def body(c, _):
            x0, x1, s = c
            o0, o1, os_ = extend(blocks, primary, L2, x0, x1, s,
                                 is_back=True)
            # feed one candidate back to serialize iterations
            cdt = o0.dtype
            x0n = jnp.clip(o0[..., 1], cdt.type(1), cdt.type(n - 2))
            x1n = jnp.clip(o1[..., 1], cdt.type(1), cdt.type(n - 2))
            sn = jnp.clip(os_[..., 1], cdt.type(1), cdt.type(64))
            return (x0n, x1n, sn), None
        (x0, x1, s), _ = lax.scan(body, (x0, x1, s), None, length=iters)
        return x0

    def bench(shape, label):
        x0 = jnp.asarray(rng.integers(1, n // 2, size=shape),
                         dtype=d.cdt)
        x1 = jnp.asarray(rng.integers(1, n // 2, size=shape),
                         dtype=d.cdt)
        s = jnp.asarray(rng.integers(1, 64, size=shape), dtype=d.cdt)
        r = loop_extend(d.blocks, d.primary, d.L2, x0, x1, s,
                        ITERS).block_until_ready()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = loop_extend(d.blocks, d.primary, d.L2, x0, x1, s,
                            ITERS).block_until_ready()
            ts.append(time.perf_counter() - t0)
        dt = min(ts)
        print(f"{label}: {dt*1e3:.1f} ms total, "
              f"{dt/ITERS*1e6:.1f} us/iter")

    bench((B,), "extend (B,)   fwd-shape")
    bench((B, M), f"extend (B,{M}) bwd-shape")

    n_blocks = d.blocks.shape[0]

    # null loop: same carry structure, trivial compute — isolates the
    # per-iteration while_loop/launch overhead
    @partial(jax.jit, static_argnames=("iters",))
    def loop_null(x0, x1, s, iters):
        def body(c, _):
            x0, x1, s = c
            return (x1 + 1, x0 ^ s, jnp.clip(s + x0, 1, 64)), None
        c, _ = lax.scan(body, (x0, x1, s), None, length=iters)
        return c[0]

    # one-hot-only loop: generate bf16 one-hot + dot, int32 carries —
    # isolates the gather-matmul cost
    @partial(jax.jit, static_argnames=("iters", "dtype"))
    def loop_onehot(t8, idx, iters, dtype):
        nb = t8.shape[0]
        def body(c, _):
            idx = c
            oh = (idx[:, None] == jnp.arange(nb, dtype=jnp.int32)[None, :]
                  ).astype(dtype)
            out = lax.dot_general(oh, t8, (((1,), (0,)), ((), ())),
                                  preferred_element_type=(
                                      jnp.int32 if dtype == jnp.int8
                                      else jnp.float32))
            nxt = out[:, 0].astype(jnp.int32) % nb
            return nxt, None
        idx, _ = lax.scan(body, idx, None, length=iters)
        return idx

    x0 = jnp.asarray(rng.integers(1, n // 2, size=(B,)), dtype=jnp.int64)
    r = loop_null(x0, x0, x0, ITERS).block_until_ready()
    import timeit
    t = min(timeit.repeat(lambda: loop_null(x0, x0, x0, ITERS)
                          .block_until_ready(), number=1, repeat=3))
    print(f"null loop (B,) i64 carries: {t/ITERS*1e6:.1f} us/iter")

    idx = jnp.asarray(rng.integers(0, n_blocks, size=(4 * B,)),
                      dtype=jnp.int32)
    sh = jnp.arange(4, dtype=jnp.int64) * 8
    t8b = ((d.blocks.astype(jnp.int64)[:, :, None] >> sh) & 0xFF
           ).reshape(n_blocks, 64).astype(jnp.bfloat16)
    r = loop_onehot(t8b, idx, ITERS, jnp.bfloat16).block_until_ready()
    t = min(timeit.repeat(lambda: loop_onehot(t8b, idx, ITERS,
                                              jnp.bfloat16)
                          .block_until_ready(), number=1, repeat=3))
    print(f"one-hot bf16 ({4*B}x{n_blocks}): {t/ITERS*1e6:.1f} us/iter")

    sh4 = jnp.arange(8, dtype=jnp.int64) * 4
    t4 = ((d.blocks.astype(jnp.int64)[:, :, None] >> sh4) & 0xF
          ).reshape(n_blocks, 128).astype(jnp.int8)
    r = loop_onehot(t4, idx, ITERS, jnp.int8).block_until_ready()
    t = min(timeit.repeat(lambda: loop_onehot(t4, idx, ITERS, jnp.int8)
                          .block_until_ready(), number=1, repeat=3))
    print(f"one-hot s8-nibble ({4*B}x{n_blocks}): {t/ITERS*1e6:.1f} us/iter")

    # full iterator round on real reads
    from bwamem_tpu.io.fastq import ChunkReader
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.core.pipeline import encode_read
    from bwamem_tpu.ops.smem import smem_iter_step
    opt = MemOptions()
    reader = ChunkReader(os.path.join(data, "reads_se.fq"))
    reads = reader.read_chunk(1 << 30)
    for r in reads:
        encode_read(r)
    L = 128
    qpad = np.full((B, L), 4, dtype=np.int8)
    qlen = np.zeros(B, dtype=np.int32)
    for i in range(B):
        q = reads[i % len(reads)].seq_nt4
        qpad[i, :len(q)] = q
        qlen[i] = len(q)
    args = (d.blocks, d.primary, d.L2, jnp.asarray(qpad),
            jnp.asarray(qlen), jnp.zeros(B, jnp.int32),
            jnp.ones(B, d.cdt), jnp.ones(B, bool),
            jnp.full(B, 29, d.cdt), jnp.full(B, 10, d.cdt))
    out = smem_iter_step(*args, L=L, M=M, M_OUT=M)
    jax.block_until_ready(out)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = smem_iter_step(*args, L=L, M=M, M_OUT=M)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    print(f"smem_iter_step round: {min(ts)*1e3:.1f} ms")


if __name__ == "__main__":
    main()
