"""tpu-bwa-mem: a JAX BWA-MEM-class short-read aligner.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
TianheYu/bwa-mem-harp2 (BWA-MEM 0.7.8 with FPGA-offloaded SMEM seeding).
The seeding/extension hot loops run as batched GPU kernels; index
construction, finalization and SAM emission run on the host with
bit-exact BWA-MEM 0.7.8 semantics.

Layering (bottom-up), mirroring SURVEY.md section 1:
  index/     FM-index + reference metadata construction and I/O
  oracle/    pure-NumPy scalar reference engine (the executable spec,
             analog of the reference's USE_SW CPU-fallback path)
  ops/       batched JAX/Pallas device kernels (SMEM, SA lookup, SW)
  core/      the BWA-MEM pipeline: seeding -> chaining -> extension ->
             dedup/markprimary -> CIGAR/SAM, plus paired-end resolution
  io/        FASTQ chunk reader, SAM writer
  parallel/  jax.sharding mesh utilities for multi-card scale-out
"""

__version__ = "0.1.0"

# Version string of the reference whose output we reproduce byte-for-byte
# (reference: software/top.c:10 PACKAGE_VERSION "0.7.8-r455").
BWA_COMPAT_VERSION = "0.7.8-r455"
