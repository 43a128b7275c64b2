"""Multi-host scale-out via jax.distributed.

The reference is strictly single-host/single-FPGA (SURVEY.md §2.4:
"no NCCL/MPI/Gloo and no multi-node capability"); scale-out is new
surface this framework adds.  The model:

- every host runs the same CLI on its own FASTQ shard (split upstream,
  or use --shard i/n to stride one file),
- the FM index is replicated per host (the analog of the reference's
  one-time per-host SPL_BWT_ref upload),
- device batches shard over the GLOBAL reads mesh; the pestat
  orientation histogram is the only cross-host collective
  (parallel.mesh.pestat_histograms: the cards' own links within a host,
  the network between hosts),
- SAM output stays shard-local; ordering within a shard matches the
  reference because `n_processed` numbering is per-shard deterministic
  (mem_mark_primary_se hash tie-breaks, software/bwamem.c:761).

Single-chip and single-host paths never pay for any of this: the module
is imported only when --distributed is requested.
"""

from typing import Optional

import numpy as np

import jax


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Bring up the jax.distributed runtime (network rendezvous)."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_reads_mesh():
    """1-D reads mesh spanning every device of every host."""
    from .mesh import READS_AXIS
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (READS_AXIS,))


def local_shard_bounds(n_items: int) -> range:
    """The contiguous slice of a globally-indexed workload this process
    owns (used to stride one FASTQ across hosts)."""
    p = jax.process_index()
    n = jax.process_count()
    per = (n_items + n - 1) // n
    return range(p * per, min((p + 1) * per, n_items))
