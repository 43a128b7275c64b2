"""Loop-body unrolling for the device while_loops.

A device while_loop iteration carries a fixed cost (the loop predicate,
and on the GPU one launch per fused body kernel) regardless of how much
work its body does, so the iteration COUNT is the cost.  Every kernel
loop body here is a no-op for lanes whose `done` mask is set (updates
are masked per lane), so running the body k times per while_loop
iteration is semantically exact: the loop condition is simply checked k
times less often, and any extra body applications after all lanes
finish do nothing.  This divides the per-iteration overhead by k at the
price of up to k-1 wasted (no-op) body applications and a k-times
larger compiled body.

The FPGA analog: the reference's PE pipelines one bwt_extend per clock
with no per-step control-flow cost (hardware/afu_core.v:4371-5402); the
unroll recovers part of that by amortizing the per-step loop overhead
over k algorithm steps.
"""

import os

UNROLL = int(os.environ.get("BWAMEM_TPU_UNROLL", "4"))


def unroll_body(body, k: int = 0):
    """k-fold composition of a masked while_loop body (state -> state).
    Requires the body to be a per-lane no-op once that lane's done/mask
    condition holds — true for every kernel loop in this package."""
    k = k or UNROLL
    if k <= 1:
        return body

    def composed(st):
        for _ in range(k):
            st = body(st)
        return st

    return composed


def unroll_fori(n: int, row, init, k: int = 0):
    """fori_loop(0, n, row, init) with the row body applied k indices
    per iteration.  Indices beyond n-1 (when k does not divide n) must
    be no-ops in `row` (every DP row body masks on `i < tlen`)."""
    from jax import lax
    k = k or UNROLL
    if k <= 1:
        return lax.fori_loop(0, n, row, init)
    groups = (n + k - 1) // k

    def grouped(g, carry):
        base = g * k
        for j in range(k):
            carry = row(base + j, carry)
        return carry

    return lax.fori_loop(0, groups, grouped, init)
