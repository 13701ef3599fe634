"""rkmh-tpu: a GPU-accelerated MinHash sequence-classification framework.

A from-scratch JAX/XLA reimplementation of the *capabilities* of
edawson/rkmh: classify individual sequencing reads against
reference-genome panels with MinHash sketches, filter reads, stream with
constant-memory k-mer counters, dump/load Mash-compatible sketches, and
call variants by brute-force k-mer mutation enumeration — all with the
hot compute path (MurmurHash3 over every k-mer window, bottom-s sketch
selection, batched sketch-intersection counting) running on the
accelerator.

Design notes
------------
* hash_t is uint64 (MurmurHash3_x64_128, seed 42, low 64 bits), exactly as
  rkmh documents in its JSON metadata (rkmh.cpp:494-497).  We therefore
  enable jax_enable_x64 at import time.
* Reads/references are 2-bit packed host-side into fixed-shape [batch, L]
  uint8 code tensors; every per-k-mer inner loop from the reference
  (rkmh.cpp:293-433 hash_sequences / mkmh calc_hashes) becomes a batched
  vectorized device op.
* Parallelism is a jax.sharding Mesh: reads are data-parallel on the batch
  axis, reference panels can be tensor-parallel on the panel axis (merged
  with psum-style argmax), long genomes hash sequence-parallel in (k-1)-
  overlapped chunks.  The reference's OpenMP pragmas have no analog here.
"""

import os

import jax

# hash_t is 64-bit; enable x64 before any array is created.
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: every command compiles a fixed set of
# shapes per length bucket, so later runs reuse the programs.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only without it does the cache go to
# the repository's fixed .jax_cache (a fixed path, because the path is
# part of the cache key).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".jax_cache")),
    )

__version__ = "0.1.0"
